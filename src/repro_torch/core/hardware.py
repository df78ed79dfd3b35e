"""Target hardware of the roofline latency model, the knee analysis and
the efficacy search: ``Hardware`` and the port's default, ``H100``.

An allocation is an integer count of **units** out of ``chips_per_pod``;
the attribute names are the JAX package's (``chips_per_pod``,
``RunRequest.chips``, ``SimConfig.total_chips``), so the scheduler reads
the same fields on either package. What a unit is depends on the
hardware:

* on the H100 one unit is one percent of the GPU's streaming
  multiprocessors — the paper's CUDA-MPS GPU% (§3.2) — so
  ``chips_per_pod = 100``, ``sm_count`` > 0 says an allocation is a share
  of one device, and the rates are per percent. MPS partitions SMs, not
  HBM: every share sees the whole ``hbm_bytes``;
* with ``sm_count == 0`` a unit is a whole chip of a pod (a TPU sub-mesh):
  ``hbm_bytes`` is per chip, and the inter-chip terms (``ici_bw``,
  ``ici_links``, the tensor-parallel cap ``tp_cap`` with its per-chip
  width ``tp_shard_width``, the ring hop ``hop_latency``) price tensor
  parallelism. Their defaults switch them off, which is the H100's case.

``levels`` are the allocations profiles, policies and standby engines
plan over: every allocation a policy grants is one of them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True, kw_only=True)
class Hardware:
    name: str
    peak_flops: float               # bf16 FLOP/s per unit
    hbm_bw: float                   # HBM bytes/s per unit
    hbm_bytes: float                # per unit, or the device's (sm_count > 0)
    chips_per_pod: int              # units in the whole allocation domain
    levels: Tuple[int, ...]         # allocations planned over, ascending
    dispatch_overhead: float        # s per layer of a step (the paper's t_np)
    mxu_tile: int                   # matmul rows that fill the array / tile
    # host-side contention when many engines multiplex one device (paper
    # §4.2 finds <3% with SM isolation)
    multiplex_dilation: float
    # > 0: an allocation is a share of one device with this many SMs
    sm_count: int = 0
    # inter-chip terms (off by default: a share of one device has none)
    ici_bw: float = 0.0             # bytes/s per link
    ici_links: int = 0
    tp_cap: int = 1                 # widest tensor-parallel group searched
    tp_shard_width: int = 0         # widest dim per chip that keeps TP fed
    hop_latency: float = 0.0        # s per ring hop of a collective

    @property
    def step(self) -> int:
        """The smallest grant: uncontrolled sharing divides the domain in
        multiples of it."""
        return self.levels[0]

    def level_at_most(self, units: float) -> int:
        """The largest level <= ``units`` (0 when none is)."""
        fit = [c for c in self.levels if c <= units + 1e-9]
        return fit[-1] if fit else 0


# NVIDIA H100 SXM: the data sheet's dense bf16 peak and HBM rate over 100
# units of one percent each; 132 SMs and 80 GB. ``dispatch_overhead`` is
# the per-layer time a graphed 1-slot step takes beyond its roofline,
# measured by ``chip_smoke.py`` phase (g) on an NVIDIA H100 80GB HBM3 at a
# 700 W power limit: 106.8, 99.3 and 113.4 µs for qwen2-0.5b, olmo-1b and
# mamba2-1.3b at full width in bf16; their mean.
H100 = Hardware(
    name="h100-sxm",
    peak_flops=989e12 / 100,
    hbm_bw=3.35e12 / 100,
    hbm_bytes=80e9,
    chips_per_pod=100,
    levels=tuple(range(10, 101, 10)),
    dispatch_overhead=106.5e-6,
    mxu_tile=64,                    # the wgmma M tile
    multiplex_dilation=0.02,
    sm_count=132,
)


def local_gpu(device: Optional[object] = None) -> Hardware:
    """``H100`` with the SM count, memory and name of the CUDA device
    present (the published rates stay: the card cannot report them)."""
    import torch
    props = torch.cuda.get_device_properties(
        torch.device("cuda" if device is None else device))
    return dataclasses.replace(H100, name=props.name,
                               sm_count=props.multi_processor_count,
                               hbm_bytes=float(props.total_memory))
