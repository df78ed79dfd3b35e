"""Per-engine registry of step executables: the port's ``jax.jit``.

The JAX engine compiles one executable per bucket and keeps each in a
dict keyed by its bucket; ``jit_cache_sizes`` counts them, and the
no-recompile invariant holds a serve to adding none. This registry keeps
the same kinds under the same keys — four always:

* ``packed_prefill`` — ``(T, row_len, S)``: the packed prefill of an
  admission batch (and of a ring engine's prefix recompute) together with
  the packed-segment scatter into the slots, which the JAX engine jits
  apart as ``write_segments``;
* ``chunk_prefill`` — ``(T, row_len, S)``: the incremental chunk of paged
  continuations, with the same scatter;
* ``slot_step`` — the slot sampling config, as the JAX key: ``None``
  (greedy) or the ``SamplingParams``: one masked decode step over every
  slot;
* ``generate`` — ``(B, cache_len, sampling)``: one decode step of
  ``generate``, replayed once per token (the twin of the JAX engine's
  scan, keyed ``(max_new_tokens, greedy, sampling)``);

two more once the engine has a prefix cache (``PREFIX_KINDS``):

* ``copy_page`` — ``None``: the copy-on-write copy of one page of every
  paged leaf onto another;
* ``alias_slot`` — ``None``: a hit admission's block-table row and
  position;

and two more once a draft engine is attached (``SPEC_KINDS``):

* ``draft_scan`` — ``T``, the verify chunk's packed-token bucket: the
  draft's spec_k + 1 masked ring steps and the verify token row;
* ``spec_commit`` — ``(T, S)``: the end of a speculative round (the
  accepted horizon and both engines' pending tokens).

On a CUDA device an entry is a ``torch.cuda.CUDAGraph``:

* its first dispatch runs the step eagerly on a side stream — that is
  the dispatch's real work, and it builds the kernels, loads cuBLAS and
  fills every ``lru_cache`` before anything is captured — and then
  captures the same step on that stream under ``torch.cuda.graph`` into
  the engine's one memory pool, shared by all its captures (they never run at once, and
  whatever a step keeps it writes into engine state allocated outside
  the pool); every later dispatch of the key replays it;
* the step reads its per-dispatch host data from ONE static int32 buffer
  of the entry; the host fills a pinned staging twin and copies it over
  with one non-blocking copy ahead of the replay (``fill``, then
  ``launch``: between the two a caller may write a view on the device,
  as a speculative round writes the draft's verify row into the verify
  chunk's tokens); host data given as a tensor (an encoder model's
  float frame embeddings) gets a static device buffer of its own, of its
  shape and dtype, filled the same way;
* the kernel wrappers count launches in Python, which runs only at
  capture: the counts a capture added are taken back and added again at
  every replay;
* a sampled step draws its noise from the engine's ``torch.Generator``,
  registered with the graph before the capture
  (``CUDAGraph.register_generator_state``): every replay then reads the
  generator's seed and offset as it stands and advances the offset by
  what the step draws, so each replay draws fresh noise and a graphed run
  draws what an eager run from the same seed draws.

On the CPU, and on a CUDA engine whose ``graphs`` is off (the eager
comparison), an entry runs the same step function eagerly on the same
static buffers: the keys, the buffers and the step bodies are the ones
the CPU tests hold against the JAX engine.
"""
from __future__ import annotations

import gc
from typing import Any, Callable, Dict, Hashable, Iterable, Optional

import numpy as np
import torch

from repro_torch.kernels import ops

KINDS = ("packed_prefill", "chunk_prefill", "slot_step", "generate")
# the prefix cache's and speculation's kinds, registered by
# ``enable_prefix_cache`` and ``attach_draft``
PREFIX_KINDS = ("copy_page", "alias_slot")
SPEC_KINDS = ("draft_scan", "spec_commit")
# the kinds whose steps read and write the slot state of ``init_slots``
SLOT_KINDS = ("packed_prefill", "chunk_prefill", "slot_step") \
    + PREFIX_KINDS + SPEC_KINDS


class Step:
    """One executable: ``fn(views)`` runs a step, reading its host data
    from ``views`` — named int32 views of one static device buffer laid
    out as the first dispatch's numpy ``arrays``, and a static device
    buffer for each host tensor among them — and returns what the step
    computes (the logits; every lasting effect is an in-place write).
    ``out`` holds the last dispatch's result once the step has been
    replayed or run eagerly (a capture's own first dispatch returns its
    eager run's)."""

    def __init__(self, registry: "StepGraphs", kind: str,
                 fn: Callable[[Dict[str, torch.Tensor]], Any],
                 arrays: Dict[str, np.ndarray],
                 generator: Optional[torch.Generator] = None):
        self.registry = registry
        self.kind = kind
        self.fn = fn
        self.generator = generator
        self.layout = {k: np.shape(a) for k, a in arrays.items()
                       if not isinstance(a, torch.Tensor)}
        size = sum(int(np.prod(s)) for s in self.layout.values())
        dev = registry.device
        self.meta = torch.zeros((size,), dtype=torch.int32, device=dev)
        self.views, off = {}, 0
        for name, shape in self.layout.items():
            n = int(np.prod(shape))
            self.views[name] = self.meta[off:off + n].view(shape)
            off += n
        # host tensors: a device buffer each, staged through a pinned twin
        self.dense = {k: torch.zeros(a.shape, dtype=a.dtype, device=dev)
                      for k, a in arrays.items()
                      if isinstance(a, torch.Tensor)}
        self.views.update(self.dense)
        if dev.type == "cuda":
            self.staging = torch.zeros((size,), dtype=torch.int32,
                                       pin_memory=True)
            self.dense_staging = {
                k: torch.zeros(t.shape, dtype=t.dtype, pin_memory=True)
                for k, t in self.dense.items()}
            self.copied = torch.cuda.Event()
        else:
            self.staging, self.copied = self.meta, None
            self.dense_staging = self.dense
        self.host = self.staging.numpy()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}
        self.out = None

    def fill(self, arrays: Dict[str, np.ndarray]) -> None:
        """Stage the dispatch's host data and copy it to the device in
        one non-blocking copy (on the CPU the staging is the buffer)."""
        if not self.layout and not self.dense:
            return
        if self.copied is not None:
            self.copied.synchronize()     # the last copy has read it
        off = 0
        for name, shape in self.layout.items():
            a = arrays[name]
            assert np.shape(a) == shape, (self.kind, name, np.shape(a),
                                          shape)
            n = int(np.prod(shape))
            self.host[off:off + n] = np.reshape(a, -1)
            off += n
        for name, buf in self.dense_staging.items():
            assert arrays[name].shape == buf.shape, (self.kind, name)
            buf.copy_(arrays[name])
        if self.copied is not None:
            self.meta.copy_(self.staging, non_blocking=True)
            for name, buf in self.dense.items():
                buf.copy_(self.dense_staging[name], non_blocking=True)
            self.copied.record()

    def run(self, arrays: Dict[str, np.ndarray]):
        """One dispatch: stage ``arrays``, then ``launch``."""
        self.fill(arrays)
        return self.launch()

    def launch(self):
        """Replay the graph, or capture it (after an eager run that does
        the dispatch's work), or run eagerly where the registry does not
        capture — on the data of the last ``fill``."""
        if not self.registry.capturing:
            self.out = self.fn(self.views)
            return self.out
        if self.graph is None:
            return self._run_and_capture()
        self.graph.replay()
        ops.add_launches(self.launches)
        return self.out

    def _run_and_capture(self):
        reg = self.registry
        cur = torch.cuda.current_stream(reg.device)
        reg.side.wait_stream(cur)
        with torch.cuda.stream(reg.side):
            out = self.fn(self.views)
        cur.wait_stream(reg.side)
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        # captured on the stream the eager run warmed (cuBLAS keeps a
        # workspace per stream)
        # no garbage collection inside the capture: a collected engine's
        # graphs and pool would be freed there, a call that a capture
        # forbids and that invalidates it (``torch.cuda.graph`` collects
        # just before it begins)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=reg.pool, stream=reg.side):
                self.out = self.fn(self.views)
        finally:
            if collecting:
                gc.enable()
        # the capture launched nothing on the device: take its counts back
        # and add them at every replay
        after = ops.launch_counts()
        self.launches = {n: after[n] - before[n] for n in after
                         if after[n] != before[n]}
        ops.add_launches({n: -k for n, k in self.launches.items()})
        self.graph = graph
        return out


class StepGraphs:
    """The registry: ``entry(kind, key, fn, arrays)`` finds or makes the
    executable of ``key``; ``sizes()`` counts them as the JAX engine's
    ``jit_cache_sizes`` counts its executables — captured graphs on a
    CUDA device, entries on the CPU."""

    def __init__(self, device: torch.device, graphs: bool = True):
        self.device = device
        self.graphs = bool(graphs)
        self.entries: Dict[str, Dict[Hashable, Step]] = {k: {}
                                                         for k in KINDS}
        self._pool = None
        self._side = None

    @property
    def capturing(self) -> bool:
        """Whether steps are captured and replayed (a CUDA device with
        ``graphs`` on) rather than run eagerly."""
        return self.graphs and self.device.type == "cuda"

    @property
    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    @property
    def side(self) -> torch.cuda.Stream:
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def entry(self, kind: str, key: Hashable,
              fn: Callable[[Dict[str, torch.Tensor]], Any],
              arrays: Dict[str, np.ndarray],
              generator: Optional[torch.Generator] = None) -> Step:
        """The executable of ``key``, made on first use from ``fn`` (a
        step that draws random numbers passes the ``generator`` it draws
        from)."""
        got = self.entries[kind].get(key)
        if got is None:
            got = self.entries[kind][key] = Step(self, kind, fn, arrays,
                                                 generator)
        return got

    def add_kinds(self, kinds: Iterable[str]) -> None:
        """Register ``kinds`` (counted by ``sizes`` from now on, as the
        JAX engine reports an executable once it has built it)."""
        for kind in kinds:
            self.entries.setdefault(kind, {})

    def clear(self, kinds: Optional[Iterable[str]] = None) -> None:
        """Drop the executables of ``kinds`` (default: all; their buffers
        were replaced)."""
        for kind in (self.entries if kinds is None else kinds):
            if kind in self.entries:
                self.entries[kind].clear()

    def pool_bytes(self) -> int:
        """Device bytes the allocator holds for the registry's graph pool
        (0 before the first capture)."""
        if self._pool is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == tuple(self._pool))

    def sizes(self) -> Dict[str, int]:
        if self.device.type == "cuda":
            return {k: sum(e.graph is not None for e in v.values())
                    for k, v in self.entries.items()}
        return {k: len(v) for k, v in self.entries.items()}
