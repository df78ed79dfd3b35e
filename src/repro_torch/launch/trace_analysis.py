"""Roofline terms from one eager trace of a step: the port's counterpart of
the JAX package's ``repro.launch.hlo_analysis``.

The JAX module reads a compiled XLA artifact (``cost_analysis``,
``memory_analysis``, the post-SPMD HLO text). The port has no HLO: it runs
the step once, eagerly, on DTensors whose local shards are fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``: shapes and dtypes, no
storage), and counts what one device would do:

- ``cost_summary``: flops by ``torch.utils.flop_counter.FlopCounterMode``'s
  formulas, and bytes accessed — every aten op's operand and result bytes
  summed (no fusion: an upper bound on what a fused step moves);
- ``collective_stats``: bytes and counts by kind of every collective that
  ``torch.distributed.tensor.debug.CommDebugMode`` sees, a collective's
  bytes being its result's size on one device, as the JAX parser counts
  them;
- ``memory_summary``: per-device argument bytes (the local shards of the
  step's inputs that it reads: XLA prunes an argument its computation
  never uses, as ``jax.jit`` does by default, e.g. whisper's encoder
  weights in a decode step), output bytes, and the peak of the live
  bytes the step allocated beyond its arguments (its temporaries and its
  new outputs).

``TraceModes`` enters the three counting modes on top of the fake mode.
Each counts only ops on the LOCAL shards: it returns ``NotImplemented`` for
an op on DTensors, so DTensor desugars the op into local ops and
collectives first, which the modes then see.

The JAX module's ``weighted_cost`` exists because XLA's ``cost_analysis``
counts a while-loop body once (a scan over layers under-reports by about
the layer count). An eager trace runs and counts every layer, so the port
has no such correction and drops it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# op-name fragments -> the JAX parser's collective kinds
_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"),
          ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"))


def _kind(func) -> str:
    """The JAX kind of a collective; point-to-point and broadcast ones
    are the collective permutes."""
    name = func._overloadpacket.__name__
    for frag, kind in _KINDS:
        if frag in name:
            return kind
    return "collective-permute"


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def _tensors(tree):
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _on_dtensors(types) -> bool:
    return any(issubclass(t, DTensor) for t in types)


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def ar_bytes(self) -> int:
        return sum(self.bytes_by_kind.get(k, 0) for k in
                   ("all-reduce", "reduce-scatter", "all-gather",
                    "collective-permute"))

    @property
    def a2a_bytes(self) -> int:
        return self.bytes_by_kind.get("all-to-all", 0)


class CommTrace(CommDebugMode):
    """``CommDebugMode`` that also keeps each collective's kind and result
    bytes on one device."""

    def __init__(self):
        super().__init__()
        self.events = []          # (kind, bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        seen = self.get_total_counts()
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if self.get_total_counts() > seen:    # CommDebugMode counted it
            # a functional collective returns its result; a c10d one works
            # in place on its (first) tensor operand
            res = _tensors(out) if "_c10d_functional" in str(func) else \
                _tensors(args)[:1]
            self.events.append((_kind(func),
                                sum(_nbytes(x) for x in res)))
        return out


def collective_stats(comm: CommTrace) -> CollectiveStats:
    """Bytes and counts by kind of the collectives ``comm`` saw."""
    by_kind = {k: 0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for kind, nbytes in comm.events:
        by_kind[kind] += nbytes
        counts[kind] += 1
    return CollectiveStats(by_kind, counts)


class CostTrace(TorchDispatchMode):
    """Flops, bytes accessed and live memory of the local ops of a step.

    Flops come from ``FlopCounterMode``'s registry of formulas; bytes
    accessed sum every op's tensor operands and results. Live memory
    tracks the storages that ops create (not the arguments', registered
    by ``add_arguments``), by storage, freed when their last tensor goes:
    ``peak_temp`` is the most that were alive at once."""

    def __init__(self, fake_mode):
        super().__init__()
        self.fake_mode = fake_mode
        self.registry = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.arg_storages = set()
        self.arg_bytes: Dict[int, int] = {}
        self.read_args = set()
        self._refs: Dict[int, int] = {}
        self._size: Dict[int, int] = {}
        self.live = 0
        self.peak_temp = 0

    def add_arguments(self, tensors) -> None:
        for x in tensors:
            key = x.untyped_storage()._cdata
            self.arg_storages.add(key)
            self.arg_bytes[key] = self.arg_bytes.get(key, 0) + _nbytes(x)

    @property
    def argument_bytes(self) -> int:
        """The local bytes of the arguments that an op of the step read
        (other than by taking a view)."""
        return sum(self.arg_bytes[k] for k in self.read_args)

    def _mine(self, tensors) -> bool:
        # DTensor's own shape propagation runs ops on fake tensors of
        # another fake mode, at global shapes: not one device's work
        return all(getattr(x, "fake_mode", self.fake_mode) is self.fake_mode
                   for x in tensors)

    def _track(self, x) -> None:
        key = x.untyped_storage()._cdata
        if key in self.arg_storages:
            return
        if key not in self._refs:
            self._refs[key] = 0
            self._size[key] = x.untyped_storage().nbytes()
            self.live += self._size[key]
            self.peak_temp = max(self.peak_temp, self.live)
        self._refs[key] += 1
        weakref.finalize(x, self._release, key)

    def _release(self, key) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            self.live -= self._size.pop(key)
            del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _on_dtensors(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if isinstance(func, torch._ops.HigherOrderOperator) or not \
                self._mine(ins):
            return out
        if not (getattr(func, "is_view", False)
                or getattr(func, "namespace", "") == "prim"):
            # a view (one of a stacked leaf's layers, say) or a query of
            # metadata reads nothing; an op on the view, which shares its
            # storage, does
            self.read_args.update(
                k for k in (x.untyped_storage()._cdata for x in ins)
                if k in self.arg_storages)
        outs = _tensors(out)
        formula = self.registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        self.bytes_accessed += sum(_nbytes(x) for x in ins + outs)
        for x in outs:
            if x.device.type != "meta" and not x.is_sparse:
                self._track(x)
        return out


@contextlib.contextmanager
def trace_modes(fake_mode):
    """(comm, cost): the two counting modes, entered over ``fake_mode``."""
    comm, cost = CommTrace(), CostTrace(fake_mode)
    with fake_mode, comm, cost:
        yield comm, cost


def cost_summary(cost: CostTrace) -> Dict[str, float]:
    return {"flops": float(cost.flops),
            "bytes_accessed": float(cost.bytes_accessed)}


def memory_summary(cost: CostTrace, outputs) -> Dict[str, float]:
    """Per-device memory of one traced step: ``argument_size_in_bytes``
    (the local shards of the step's arguments that it reads:
    ``CostTrace.argument_bytes``), ``output_size_in_bytes``
    (its outputs' local bytes), ``alias_size_in_bytes`` (the outputs that
    are arguments updated in place), ``temp_size_in_bytes`` (the peak of
    the live bytes the step allocated: its temporaries and its new
    outputs) and ``total_per_device`` = arguments + that peak."""
    locs = [x._local_tensor if isinstance(x, DTensor) else x
            for x in _tensors(outputs)]
    seen, out_b, alias_b = set(), 0, 0
    for x in locs:
        key = x.untyped_storage()._cdata
        if key in seen:
            continue
        seen.add(key)
        n = x.untyped_storage().nbytes()
        out_b += n
        alias_b += n if key in cost.arg_storages else 0
    argument_bytes = cost.argument_bytes
    return {"argument_size_in_bytes": float(argument_bytes),
            "output_size_in_bytes": float(out_b),
            "temp_size_in_bytes": float(cost.peak_temp),
            "alias_size_in_bytes": float(alias_b),
            "total_per_device": float(argument_bytes + cost.peak_temp)}
