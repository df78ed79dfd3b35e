"""Roofline latency model f_L(units, batch) — the derived analogue of the
paper's profiled latency function f_L(GPU%, batch) (§5, Table 5).

The paper profiles each DNN on a V100 at every (GPU%, batch) grid point;
here f_L is *derived* from per-architecture operation counts (``costs``,
the JAX package's counts) and the ``Hardware`` fields, as the larger of a
compute and a memory term plus a serial per-layer term, with the paper's
parallelism limit (Eq. 2's ``min(S, N_i)``) as two clamps. What a unit is
sets what the clamps mean (``repro_torch.core.hardware``):

* a share of one GPU (``sm_count`` > 0; the H100): compute and memory
  scale with the allocated SM share; the parallelism clamp is the SMs the
  step's widest product can fill — its 128-column tiles times its
  ``mxu_tile``-row tiles, read as CTAs and converted to percent of the SM
  count; the occupancy clamp is the decode batch over the 64-row
  ``wgmma`` M tile; there is no tensor-parallel search and no
  collective, and the model fits (f_L finite) or not against the whole
  device's memory;
* whole chips of a pod (``sm_count == 0``): the JAX package's model — a
  search over tensor-parallel widths up to ``tp_cap``, the shard-
  granularity and MXU-occupancy clamps, ring all-reduce, hop and
  all-to-all terms over ``ici_bw``, and a per-chip memory floor.

``CostOverride`` lets measured costs replace the analytic counts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hardware import H100, Hardware


@dataclasses.dataclass(frozen=True)
class CostOverride:
    """Measured costs for one (arch, mode, seq, batch) point."""
    flops: float
    hbm_bytes: float
    ar_bytes: float                 # all-reduce'd activation bytes
    a2a_bytes: float = 0.0          # all-to-all (MoE dispatch) bytes
    batch: int = 1                  # batch the measurement was taken at


@dataclasses.dataclass
class LatencyModel:
    cfg: ModelConfig
    mode: str = "prefill"           # decode | prefill | train
    seq: int = 128                  # context / prompt length
    hw: Hardware = H100
    override: Optional[CostOverride] = None

    # ------------------------------------------------------------ op counts
    def _attn_layers(self) -> int:
        if self.cfg.family == "ssm":
            return 0
        if self.cfg.family == "hybrid":
            return self.cfg.num_layers // self.cfg.attn_every
        return self.cfg.num_layers

    def _ssm_layers(self) -> int:
        return self.cfg.num_layers if self.cfg.family in ("ssm", "hybrid") else 0

    def costs(self, batch: int):
        """Returns (flops, hbm_bytes, ar_bytes, a2a_bytes) for one step.

        ar_bytes: activation bytes entering tensor-parallel all-reduces
        (summed over layers, for the *full* token set — the per-chip time in
        ``latency`` rescales by the allocation's data/model split).
        a2a_bytes: MoE expert-dispatch all-to-all traffic.
        """
        if self.override is not None:
            scale = batch / self.override.batch
            return (self.override.flops * scale,
                    self.override.hbm_bytes * scale,
                    self.override.ar_bytes * scale,
                    self.override.a2a_bytes * scale)

        cfg = self.cfg
        d, hd = cfg.d_model, cfg.resolved_head_dim
        la = self._attn_layers()
        ls = self._ssm_layers()
        n_active = cfg.active_param_count()
        bpe = 2                                          # bf16
        ctx = min(self.seq, cfg.sliding_window) if cfg.sliding_window else self.seq

        if self.mode == "decode":
            tokens = batch
            flops = 2.0 * n_active * tokens
            flops += 4.0 * la * cfg.num_heads * hd * ctx * batch
            if ls:
                ssd = 6.0 * cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim
                flops += ls * batch * ssd
            hbm = n_active * bpe
            hbm += 2.0 * la * batch * ctx * cfg.num_kv_heads * hd * bpe   # KV read
            if ls:
                hbm += 2.0 * ls * batch * cfg.ssm_heads * cfg.ssm_state \
                    * cfg.ssm_head_dim * 4                                # state rw
            coll = 2.0 * cfg.num_layers * tokens * d * bpe
        else:
            tokens = batch * self.seq
            mult = 3.0 if self.mode == "train" else 1.0
            flops = 2.0 * n_active * tokens * mult
            # causal attention: S·ctx/2 effective context per token
            flops += mult * 2.0 * la * cfg.num_heads * hd * tokens * min(ctx, self.seq)
            if ls:
                # SSD chunked: ~2x the recurrent op count (dual quadratic form)
                ssd = 12.0 * cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim
                flops += mult * ls * tokens * ssd
            hbm = n_active * bpe * (3.0 if self.mode == "train" else 1.0)
            hbm += 4.0 * cfg.num_layers * tokens * d * bpe                # activations
            coll = 2.0 * cfg.num_layers * tokens * d * bpe
            if self.mode == "train":
                coll += 2.0 * cfg.param_count() * 4                       # grad AR
        a2a = 0.0
        if cfg.num_experts:
            # expert-parallel all-to-all: each routed token crosses twice
            a2a = 2.0 * cfg.num_layers * tokens * d * bpe \
                * cfg.experts_per_token
        return flops, hbm, coll, a2a

    # ------------------------------------------------------------- latency
    def max_useful_chips(self) -> int:
        """Shard-granularity clamp (paper Eq. 2's min(S, N_i)) of a pod:
        tensor-parallel splitting past the widest dim's 128-wide tiles
        feeds nothing."""
        return max(1, min(self.hw.chips_per_pod, self._widest() // 128))

    def _widest(self) -> int:
        cfg = self.cfg
        return max(cfg.d_ff or 0, cfg.d_inner if cfg.ssm_state else 0,
                   cfg.num_heads * cfg.resolved_head_dim, cfg.d_model)

    def tp_width(self, chips: int) -> int:
        """Default tensor-parallel width (``latency`` searches over
        candidate widths; this is the cap): wider models support wider TP,
        up to ``hw.tp_cap`` (1 on a share of one device)."""
        if self.hw.tp_cap <= 1:
            return 1
        return max(1, min(chips, self._widest() // self.hw.tp_shard_width,
                          self.hw.tp_cap))

    def _tp_candidates(self, chips: int):
        cap = self.tp_width(chips)
        m = 1
        while m <= cap:
            yield m
            m *= 2

    def _batch_parallelism(self, batch: int) -> int:
        """How many data/sequence shards the workload can actually feed —
        the paper Eq. 2's inherent-parallelism limit N_i, TPU flavoured."""
        if self.mode == "decode":
            return max(1, batch)
        return max(1, batch * max(1, self.seq // 512))

    def _parallel_units(self, batch: int, m: int) -> int:
        """Eq. 2's clamp: the most units the step can keep busy at
        tensor-parallel width ``m``."""
        if self.hw.sm_count:
            tokens = batch if self.mode == "decode" else batch * self.seq
            ctas = (self._widest() // 128) * math.ceil(
                tokens / self.hw.mxu_tile)
            return math.ceil(ctas * self.hw.chips_per_pod / self.hw.sm_count)
        return min(m * self._batch_parallelism(batch),
                   self.max_useful_chips())

    def usable_chips(self, chips: int, batch: int) -> int:
        return max(1, min(chips, self._parallel_units(
            batch, self.tp_width(chips))))

    def min_chips_to_fit(self, batch: int = 1) -> float:
        """Memory feasibility floor. Whole chips: the fewest whose HBM
        holds the weights (and the decode KV); a share of one device: 1
        when the device's memory holds them, else inf — MPS partitions
        SMs, not HBM."""
        cfg = self.cfg
        bytes_needed = cfg.param_count() * 2.0
        if self.mode == "decode" and not cfg.is_attention_free:
            ctx = min(self.seq, cfg.sliding_window) if cfg.sliding_window else self.seq
            bytes_needed += (2.0 * self._attn_layers() * batch * ctx
                             * cfg.num_kv_heads * cfg.resolved_head_dim * 2)
        if self.mode == "train":
            bytes_needed = cfg.param_count() * 16.0      # fp32 master + adam + grads
        usable = self.hw.hbm_bytes * 0.9
        if self.hw.sm_count:
            return 1 if bytes_needed <= usable else math.inf
        return max(1, int(np.ceil(bytes_needed / usable)))

    def latency(self, chips: int, batch: int) -> float:
        """min over tensor-parallel widths — the launcher picks the best
        (data × model) split for each allocation size (width 1 only on a
        share of one device)."""
        chips = max(1, int(chips))
        if chips < self.min_chips_to_fit(batch):
            return float("inf")
        flops, hbm, ar_bytes, a2a_bytes = self.costs(batch)
        return min(self._latency_with_m(chips, batch, m, flops, hbm,
                                        ar_bytes, a2a_bytes)
                   for m in self._tp_candidates(chips))

    def _latency_with_m(self, chips, batch, m, flops, hbm, ar_bytes,
                        a2a_bytes) -> float:
        c_use = max(1, min(chips, self._parallel_units(batch, m)))

        # matmul occupancy: decode has `batch` rows in flight vs the tile
        occupancy = (min(1.0, batch / self.hw.mxu_tile)
                     if self.mode == "decode" else 1.0)
        t_compute = flops / (c_use * self.hw.peak_flops * max(occupancy, 1e-3))
        t_memory = hbm / (c_use * self.hw.hbm_bw)

        # collectives: bandwidth term — ring all-reduce inside the TP group
        # on each data shard; latency term — 2 collectives per layer pay the
        # (m-1)-hop ring setup, the analogue of the paper's Eq.3 memory term
        # that *grows* with allocation size. All zero without links.
        links = self.hw.ici_bw * 2                      # 2 usable directions
        t_ar = t_a2a = 0.0
        if links:
            d_par = max(1, c_use // m)
            t_ar = 2.0 * (ar_bytes / d_par) * (m - 1) / max(m, 1) / links
            t_a2a = a2a_bytes / (c_use * links)
        t_hop = 2.0 * self.cfg.num_layers * (m - 1) * self.hw.hop_latency
        t_serial = self.hw.dispatch_overhead * self.cfg.num_layers

        return max(t_compute, t_memory) + t_ar + t_hop + t_a2a + t_serial

    def latency_frac(self, frac: float, batch: int) -> float:
        return self.latency(round(frac * self.hw.chips_per_pod), batch)

    def throughput(self, chips: int, batch: int) -> float:
        """Inferences (batch items) per second."""
        return batch / self.latency(chips, batch)

    # ---------------------------------------------------------------- knee
    def knee_chips(self, batch: int, rel_tol: float = 0.05,
                   levels: Optional[Sequence[int]] = None) -> int:
        """Right-sizing knee (paper §3.1): the smallest feasible allocation
        whose latency is within ``rel_tol`` of the best achievable —
        "latency remains unchanged above the knee"."""
        levels = levels or self.hw.levels
        lats = np.array([self.latency(c, batch) for c in levels])
        finite = lats[np.isfinite(lats)]
        if finite.size == 0:
            return levels[-1]
        best = finite.min()
        for c, lat in zip(levels, lats):
            if np.isfinite(lat) and lat <= best * (1 + rel_tol):
                return int(c)
        return levels[-1]

    def knee_frac(self, batch: int, rel_tol: float = 0.05) -> float:
        return self.knee_chips(batch, rel_tol) / self.hw.chips_per_pod

    def utility_curve(self, batch: int,
                      levels: Optional[Sequence[int]] = None):
        """1/(E_t·S) per allocation — paper Eq. 6's maximization target."""
        return np.array([1.0 / (self.latency(c, batch) * c)
                         for c in levels or self.hw.levels])
