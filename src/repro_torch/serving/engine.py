"""Slot engine of the port — the data plane under the step planner.

The JAX package's ``InferenceEngine`` for the dense, Mamba2 and
encoder-decoder families, with the same method names, the same page
bookkeeping (``repro_torch.serving.kv_cache``) and the same
``EngineStats``:

* ``generate`` (and its per-token twin ``generate_eager``) runs a padded
  batch: one ``prefill`` into a contiguous cache of the bucketed length,
  then ``decode`` steps, greedy or sampled (``SamplingParams``);
* ``init_slots`` backs continuous-batching slots with a block-table page
  pool (``paged=True``) or with per-slot rings (``paged=False``, and every
  sliding-window config: the ring's overwrite is the window); a family
  with nothing to page (Mamba2: an SSM state and a conv tail per
  sequence) always takes per-slot rows, and an encoder-decoder keeps its
  cross K/V (one encoder block per slot) as a per-slot leaf beside its
  paged self-attention K/V;
* ``insert`` admits one request through a padded prefill; ``insert_many``
  admits a whole admission batch in ONE packed ragged prefill (prompts
  concatenated into one row, bucketed by ``_packed_bucket``) and scatters
  each segment's K/V straight into its slot's pages or ring rows;
* ``chunk_append`` advances every mid-prefill slot by one chunk in ONE
  dispatch: incrementally on paged slots (only the new tokens run,
  attending the K/V their slot holds in the page pool), by prefix
  recompute on ring slots (the whole prefix re-runs the packed prefill);
* ``step`` decodes one token for the stepped slots in ONE masked dispatch
  (teacher-forced slots write a prompt token's K/V in the same dispatch),
  greedy or with the slots' ``SamplingParams`` (``init_slots``);
* ``execute(plan)`` runs one ``StepPlan`` in at most these three
  dispatches per tick, plus a speculative round's;
* ``enable_prefix_cache`` attaches the radix prompt cache
  (``repro_torch.serving.prefix_cache``): a hit admission aliases cached
  pages into its block-table row (``alias_admit``: at most one
  copy-on-write page copy and one row write) and replays its uncovered
  prompt tail as teacher-forced decode steps;
* ``attach_draft`` pairs a ring-slot draft engine for speculative
  decoding: per round the draft proposes up to spec_k tokens in one
  dispatch, the target verifies them in one incremental chunk dispatch
  and one small dispatch commits the accepted horizon.

What differs from the JAX engine: the executables are CUDA graphs.
``repro_torch.serving.graphs`` keeps one per bucket, keyed as the JAX
engine keys its jitted functions, and ``jit_cache_sizes`` counts them: on
a CUDA device ``packed_prefill`` (which folds in the packed-segment
scatter the JAX engine jits apart as ``write_segments``),
``chunk_prefill`` and ``slot_step`` are captured at a bucket's first
dispatch and replayed at every later one, and so is ``generate``'s decode
step, once per token, and the prefix cache's ``copy_page`` and
``alias_slot`` and speculation's ``draft_scan`` and ``spec_commit``.
``prefill``, ``insert``, ``generate``'s padded prefill and
``generate_eager`` stay eager (the reference paths, as in JAX); on the
CPU, or with ``graphs=False``, every step runs eagerly through the same
registry. A graph reads and writes fixed addresses, so
every tensor that outlives a dispatch — each slot-cache leaf, the block
table, ``_last_tok`` — is allocated once by ``init_slots`` and updated IN
PLACE (the JAX engine donates and rebuilds them); ``init_slots`` drops
the slot executables with the buffers they bind. The packed metadata
(segment ids, lengths, destinations, table rows) is built on the host in
numpy and reaches the device as one int32 copy per dispatch — nothing on
the serving path reads a device value back except the one tick-end read
of the decoded tokens (and, in a speculative round, one read of the
draft's proposals and the verify chunk's argmax). An encoder model's
frame embeddings (``enc_embeds``, float) ride beside that copy in a
static device buffer of their own per executable.

Sampling draws Gumbel noise (``repro_torch.models.layers.gumbel_noise``)
from a ``torch.Generator`` of the engine's: one for the slots, seeded by
``init_slots(rng_seed=)`` (the JAX engine's ``_slot_rng``), and one for
``generate``, seeded by its ``rng``. Each sampled executable is captured
with its generator registered, so a replay draws what an eager step from
the same generator state draws, and the next replay draws afresh. As in
the JAX engine, a slot's first token after its prefill is the arg-max
even on a sampled engine.

The telemetry plane (``attach_telemetry``, ``repro_torch.serving.
telemetry``) traces each dispatch of ``execute`` with its host duration
and, on the card, its device time between two CUDA events on the
engine's stream, read once the device has passed them (no
synchronisation); the decode's token read is a ``readback`` span.
Detached, every site is one ``is None`` check.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import dtype_of
from repro_torch.models import layers as L
from repro_torch.models.registry import ModelAPI, build_model
from repro_torch.serving.faults import EngineFault, TransientFault
from repro_torch.serving.graphs import (PREFIX_KINDS, SLOT_KINDS,
                                       SPEC_KINDS, StepGraphs)
from repro_torch.serving.kv_cache import NULL_PAGE, OutOfPages, PagedKVCache
from repro_torch.serving.plan import StepResult
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.utils.sharding import tree_placements


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _packed_bucket(n: int) -> int:
    """Packed-token bucket: smallest of {2^k, 3·2^(k-1)} >= n (caps the
    padding of a packed prefill row at 33%)."""
    p = _pow2_at_least(n)
    half = 3 * p // 4
    return half if half >= n else p


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Static sampling configuration — hashable, so it keys the sampled
    executables (one per distinct setting, reused across requests).
    temperature <= 0 means greedy arg-max."""
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0


@dataclasses.dataclass
class EngineStats:
    """The JAX engine's counters, same names and meanings."""
    prefills: int = 0          # prefill DISPATCHES (a packed one counts 1)
    packed_prefills: int = 0   # of which packed multi-segment dispatches
    chunk_prefills: int = 0    # chunk-continuation dispatches
    prefill_tokens: int = 0    # prompt tokens prefilled (real, unpadded)
    decode_steps: int = 0
    tokens_out: int = 0
    inserts: int = 0
    grows: int = 0             # block-table extensions (lazy reservation)
    engine_retries: int = 0    # transient dispatch faults absorbed
    engine_resets: int = 0     # full resets (retries exhausted / stuck)
    prefix_hits: int = 0
    prefix_hit_tokens: int = 0
    cow_copies: int = 0
    forced_catchup_tokens: int = 0
    dedup_pages: int = 0
    incr_chunks: int = 0       # continuations computed incrementally
    draft_tokens: int = 0
    accepted_tokens: int = 0
    spec_rounds: int = 0
    rollbacks: int = 0


class InferenceEngine:
    def __init__(self, api: ModelAPI, params, *, cache_len: int = 256,
                 mesh=None, graphs: bool = True,
                 alloc_chips: Optional[int] = None):
        self.api = api
        self.cfg = api.cfg
        self.device = api.device
        # the device mesh this engine's parameters are laid out for, and
        # their DTensor placements on it (the JAX engine's shardings; the
        # engine itself runs on its one device)
        self.mesh = mesh
        self._param_sh = None if mesh is None else tree_placements(
            api.param_specs(mesh), mesh)
        # the allocation (GPU percent on the H100) this engine stands by
        # for — a label: the EnginePool keys standby engines by it, so a
        # policy's re-allocation switches to a pre-built engine and never
        # captures anew (the paper's fast re-allocation, §6.1.2)
        self.alloc_chips = alloc_chips
        # the step executables (CUDA graphs on a CUDA device with
        # ``graphs`` on; eager entries under the same keys otherwise)
        self._graphs = StepGraphs(api.device, graphs)
        # generate's fixed buffers per (B, cache length) executable
        self._gen_state: Dict[Tuple[int, int], Dict[str, Any]] = {}
        self.params = params
        self.cache_len = cache_len
        self.stats = EngineStats()
        # fault tolerance (repro_torch.serving.faults): an injector armed
        # at execute()'s dispatch site and in the page allocator;
        # transient dispatch faults retry up to retry_limit times with
        # exponential backoff before escalating to EngineFault
        self.fault_injector = None
        self.retry_limit = 2
        self.retry_backoff_s = 0.0
        # telemetry plane (repro_torch.serving.telemetry): when attached,
        # each of execute()'s dispatches is traced as a sub-span, timed on
        # the host and, on the card, by a pair of CUDA events. None =
        # every site is a single attribute check (no clock reads, no
        # events)
        self.telemetry = None
        # generate's and generate_eager's noise (seeded per call by rng)
        self._gen_rng = torch.Generator(device=self.device)
        # radix prompt cache (enable_prefix_cache): a host-side radix tree
        # over the page allocator; hit admissions dispatch the
        # ``copy_page`` and ``alias_slot`` executables
        self.prefix_cache = None
        # speculative decoding (attach_draft): a paired ring engine drafts
        # spec_k tokens per round in one ``draft_scan`` dispatch; the
        # target verifies them in one ``chunk_prefill`` dispatch and
        # commits in one ``spec_commit``. _draft_ready holds target slots
        # whose draft twin is admitted (target slot i drafts in draft
        # slot i)
        self._draft: Optional["InferenceEngine"] = None
        self._draft_ready: set = set()
        self.spec_k = 0

        # slot state (populated by init_slots)
        self.paged = False
        self._kv: Optional[PagedKVCache] = None
        self._slot_cache: Optional[Dict[str, torch.Tensor]] = None
        self._slot_free: List[int] = []
        self._slot_active: List[bool] = []
        self._slot_budget: List[Optional[int]] = []
        self._slot_generated: List[int] = []
        self._slot_pos: List[int] = []      # host mirror of cache["pos"]
        self._active_mask: Optional[np.ndarray] = None
        self._last_tok: Optional[torch.Tensor] = None
        self._step_skip = frozenset()
        self._ring_keys: Tuple[str, ...] = ()
        # the slot step's sampling config (None = greedy) and generator
        self._slot_sampling: Optional[SamplingParams] = None
        self._slot_gen: Optional[torch.Generator] = None

    # ------------------------------------------------------------------
    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, params) -> None:
        """The weights, prepared once (``ModelAPI.prepare``: the derived
        weights a step would otherwise make at every call) and bound by
        every captured step — new weights drop the captures."""
        self._params = self.api.prepare(params)
        self._graphs.clear()

    @property
    def graphs(self) -> bool:
        """Whether steps replay CUDA graphs (on a CUDA device; the CPU
        always runs eagerly). Off, the same engine runs every step
        eagerly through the same registry — the comparison the chip smoke
        and the gpu tests make; the captures already made are kept."""
        return self._graphs.graphs

    @graphs.setter
    def graphs(self, on: bool) -> None:
        self._graphs.graphs = bool(on)

    def jit_cache_sizes(self) -> Dict[str, int]:
        """Executables by the JAX engine's names, for the no-recompile
        invariant (a serve, a fault and its ``recover`` add none):
        captured CUDA graphs on a CUDA device, registry entries on the
        CPU. ``packed_prefill`` and ``chunk_prefill`` fold in the
        packed-segment scatter that the JAX engine counts apart as
        ``write_segments``; ``prefill``, ``insert`` and ``generate_eager``
        stay eager and have no executables. ``copy_page`` and
        ``alias_slot`` appear once the prefix cache is enabled,
        ``draft_scan`` and ``spec_commit`` once a draft is attached, as
        in the JAX engine."""
        return self._graphs.sizes()

    def graph_pool_bytes(self) -> int:
        """Device bytes held by the one memory pool of the engine's
        captures (0 on the CPU and before the first capture)."""
        return self._graphs.pool_bytes()

    def _tokens(self, batch) -> torch.Tensor:
        """``batch["tokens"]`` (numpy or tensor) as an int32 tensor on the
        engine's device."""
        t = batch["tokens"]
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.asarray(t, np.int32))
        return t.to(self.device)

    def _frames(self, batch, device=None) -> torch.Tensor:
        """``batch["enc_embeds"]`` (numpy or tensor) in the config's dtype,
        on ``device`` (default: the engine's)."""
        e = batch["enc_embeds"]
        if not isinstance(e, torch.Tensor):
            e = torch.from_numpy(np.array(e, np.float32))
        return e.to(device or self.device, dtype_of(self.cfg.dtype))

    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        """The model inputs of ``batch`` on the engine's device: the
        tokens, and an encoder model's frame embeddings."""
        out = {"tokens": self._tokens(batch)}
        if self.cfg.has_encoder:
            out["enc_embeds"] = self._frames(batch)
        return out

    def bucket_len(self, need: int) -> int:
        """Cache-length bucket for ``need`` tokens: next power of two,
        floored at the engine's base cache_len."""
        return max(self.cache_len, _pow2_at_least(need))

    def new_cache(self, batch: int, cache_len: Optional[int] = None):
        return self.api.init_cache(batch, cache_len or self.cache_len)

    def prefill(self, batch: Dict[str, Any],
                cache_len: Optional[int] = None):
        """Padded prefill of ``batch["tokens"]`` (B, S) into a fresh
        contiguous cache of ``cache_len`` rows (default: the engine's).
        Returns (last logits (B, V), cache)."""
        dev_batch = self._device_batch(batch)
        tokens = dev_batch["tokens"]
        logits, cache = self.api.prefill(self.params, dev_batch,
                                         cache_len or self.cache_len)
        self.stats.prefills += 1
        self.stats.prefill_tokens += int(tokens.shape[0] * tokens.shape[1])
        return logits, cache

    def decode(self, token, cache):
        logits, cache = self.api.decode_step(self.params, token, cache)
        self.stats.decode_steps += 1
        return logits, cache

    def generate(self, batch: Dict[str, Any], max_new_tokens: int,
                 rng: int = 0,
                 sampling: Optional[SamplingParams] = None) -> torch.Tensor:
        """Generation for a padded batch: one eager prefill into a cache of
        ``bucket_len(S + t_bucket)`` rows, then ``t_bucket`` dispatches of
        the ``generate`` step executable of (B, cache length, sampling)
        (the JAX engine's scan length: the next power of two of
        ``max_new_tokens``) whose surplus tokens are dropped. Returns
        (B, max_new_tokens) token ids on the device.

        ``sampling=None`` decodes greedily; a ``SamplingParams`` samples
        every token, the first included, with noise from the engine's
        generate generator seeded with ``rng`` (0 by default, as the JAX
        engine's default key is ``PRNGKey(0)``)."""
        dev_batch = self._device_batch(batch)
        b, s = dev_batch["tokens"].shape
        t_bucket = max(1, _pow2_at_least(max_new_tokens))
        clen = self.bucket_len(s + t_bucket)
        logits, cache = self.prefill(dev_batch, clen)
        if sampling is not None:
            self._gen_rng.manual_seed(rng)
        key = (int(b), clen)
        state = self._gen_state.get(key)
        if state is None:
            state = self._gen_state[key] = {
                "cache": self.api.init_cache(b, clen),
                "tok": torch.zeros((b,), dtype=torch.int64,
                                   device=self.device),
                "out": torch.zeros((b, clen), dtype=torch.int64,
                                   device=self.device),
                "i": torch.zeros((1,), dtype=torch.int64,
                                 device=self.device)}
        step = self._graphs.entry(
            "generate", key + (sampling,),
            lambda _: self._generate_body(state, sampling), {},
            None if sampling is None else self._gen_rng)
        for name, leaf in state["cache"].items():
            leaf.copy_(cache[name])
        state["tok"].copy_(_pick(logits, sampling, self._gen_rng))
        state["i"].zero_()
        del logits, cache
        for _ in range(t_bucket):
            step.run({})
        self.stats.decode_steps += t_bucket
        self.stats.tokens_out += b * max_new_tokens
        return state["out"][:, :max_new_tokens].clone()

    def _generate_body(self, state, mode: Optional[SamplingParams]):
        """One decode step of ``generate`` on its fixed buffers: record
        the pending token at column ``i``, step the cache in place, and
        leave the next token pending (picked by ``mode``)."""
        tok, cache = state["tok"], state["cache"]
        state["out"].index_copy_(1, state["i"], tok[:, None])
        logits, new = self.api.decode_step(self.params, tok, cache)
        for name, leaf in cache.items():
            if new[name] is not leaf:
                leaf.copy_(new[name])
        tok.copy_(_pick(logits, mode, self._gen_rng))
        state["i"].add_(1)
        return logits

    def generate_eager(self, batch: Dict[str, Any], max_new_tokens: int,
                       greedy: bool = True, rng: int = 0) -> torch.Tensor:
        """The JAX engine's reference path: an unbucketed prefill of exactly
        ``max(cache_len, S + max_new_tokens)`` rows, then one counted
        ``decode`` per token. Equal to ``generate`` under greedy decoding
        (the counters differ as they do in the JAX engine). With
        ``greedy=False`` each token after the first is drawn from the raw
        logits (no temperature or filter, as the JAX path's
        ``categorical``) with noise from the generate generator seeded
        with ``rng``; the first token is the arg-max either way."""
        dev_batch = self._device_batch(batch)
        b, s = dev_batch["tokens"].shape
        need = max(self.cache_len, s + max_new_tokens)
        if need != self.cache_len:
            logits, cache = self.api.prefill(self.params, dev_batch, need)
            self.stats.prefills += 1
        else:
            logits, cache = self.prefill(dev_batch, self.cache_len)
        if not greedy:
            self._gen_rng.manual_seed(rng)
        outs = []
        tok = torch.argmax(logits, -1)
        for _ in range(max_new_tokens):
            outs.append(tok)
            logits, cache = self.decode(tok, cache)
            if greedy:
                tok = torch.argmax(logits, -1)
            else:
                tok = torch.argmax(
                    L.gumbel_noise(self._gen_rng, logits.shape) + logits, -1)
        self.stats.tokens_out += b * max_new_tokens
        return torch.stack(outs, dim=1)

    # ------------------------------------------------------------------
    @property
    def n_slots(self) -> int:
        return 0 if self._slot_cache is None else len(self._slot_active)

    @property
    def free_slots(self) -> int:
        return len(self._slot_free)

    @property
    def free_pages(self) -> int:
        return self._kv.free_pages if self.paged else 0

    @property
    def total_pages(self) -> int:
        return self._kv.allocator.num_pages if self.paged else 0

    def init_slots(self, n_slots: int, cache_len: Optional[int] = None, *,
                   paged: bool = True, page_size: int = 8,
                   total_pages: Optional[int] = None,
                   sampling: Optional[SamplingParams] = None,
                   rng_seed: int = 0):
        """Allocate ``n_slots`` slots of ``cache_len`` tokens.
        ``paged=True`` backs them with a block-table page pool of
        ``total_pages`` usable pages (default ``n_slots * cache_len /
        page_size``); ``paged=False`` gives each slot its own ring (the
        parity baseline). Sliding-window configs stay on ring slots even
        when ``paged`` is asked for: the ring's overwrite is the window,
        while a paged slot keeps its full history. ``sampling`` fixes the
        slot step's sampling config (None = greedy); its noise comes from
        a generator on the engine's device seeded with ``rng_seed``."""
        self.slot_len = cache_len or self.cache_len
        self._slot_sampling = sampling
        self._slot_gen = torch.Generator(device=self.device).manual_seed(
            rng_seed)
        self.paged = (bool(paged) and bool(self.api.paged_keys)
                      and not getattr(self.cfg, "sliding_window", 0))
        if self.paged:
            if self.slot_len % page_size:
                raise ValueError(
                    f"cache_len {self.slot_len} must be a multiple of "
                    f"page_size {page_size}")
            self.page_size = page_size
            self.max_pages = self.slot_len // page_size
            usable = total_pages or n_slots * self.max_pages
            self._kv = PagedKVCache(n_slots, page_size, self.max_pages,
                                    num_pages=usable)
            self._kv.allocator.fault_injector = self.fault_injector
            # +1 physical page: id 0 is the reserved null page
            self._slot_cache = self.api.init_paged_cache(
                n_slots, usable + 1, page_size, self.max_pages)
        else:
            self._kv = None
            self._slot_cache = self.api.init_cache(n_slots, self.slot_len)
        # decode dispatches merge per-row leaves through the step mask. The
        # K/V leaves pass through: paged, their masked-off rows' dead
        # writes land on the null page or at a not-yet-valid position; on
        # a ring the step restores the one entry each masked-off row wrote
        # (``_ring_keys``), which is all the JAX engine's merge keeps
        self._step_skip = frozenset(self.api.paged_keys) | (
            {"block_tables"} if self.paged else frozenset())
        self._ring_keys = () if self.paged else tuple(self.api.paged_keys)
        self._slot_free = list(range(n_slots))
        self._slot_active = [False] * n_slots
        self._slot_budget = [None] * n_slots
        self._slot_generated = [0] * n_slots
        self._slot_pos = [0] * n_slots
        self._active_mask = np.zeros((n_slots,), bool)
        self._last_tok = torch.zeros((n_slots,), dtype=torch.int64,
                                     device=self.device)
        # the slot executables bind the buffers just replaced
        self._graphs.clear(SLOT_KINDS)
        return self

    def seed_slots(self, rng_seed: int) -> None:
        """Restart the slot step's noise from ``rng_seed`` (what
        ``init_slots(rng_seed=)`` seeds), keeping the slots' executables:
        a sampled serve after it draws what a serve on freshly initialised
        slots of that seed draws, graphed or eager."""
        self._slot_gen.manual_seed(rng_seed)

    # ------------------------------------------------ admission accounting
    def _need_tokens(self, prompt_len: int, n_tokens: Optional[int]) -> int:
        """KV entries a request pins: prompt + decode budget, capped at the
        slot maximum (an unbudgeted request reserves the full slot)."""
        if n_tokens is None:
            return self.slot_len
        return min(self.slot_len, int(prompt_len) + max(1, int(n_tokens)))

    def pages_needed(self, prompt_len: int, n_tokens: Optional[int]) -> int:
        if not self.paged:
            return 0
        return self._kv.pages_needed(self._need_tokens(prompt_len, n_tokens))

    def can_admit(self, prompt_len: int, n_tokens: Optional[int]) -> bool:
        """A free slot and, when paged, a prompt that leaves decode room
        and enough free pages for the request's whole horizon."""
        if not self._slot_free:
            return False
        if not self.paged:
            return True
        if prompt_len >= self.slot_len:
            return False
        return self._kv.allocator.can_alloc(
            self.pages_needed(prompt_len, n_tokens))

    def insert(self, batch: Dict[str, Any], n_tokens: Optional[int] = None,
               reserve_tokens: Optional[int] = None) -> int:
        """Admit one request (batch size 1) into a free slot through a
        padded prefill of ``slot_len`` rows: paged, its cache scatters into
        freshly allocated pages and the slot's table row is set; ring, it
        fills the slot's rows. ``n_tokens`` is the decode budget (paged:
        capped at the page capacity); ``reserve_tokens`` overrides the
        page horizon claimed now. Raises ``OutOfPages`` with the slot
        untouched when the pool cannot cover it."""
        if not self._slot_free:
            raise RuntimeError("no free slots")
        dev_batch = self._device_batch(batch)
        tokens = dev_batch["tokens"]
        assert tokens.shape[0] == 1, "insert admits one request"
        s = int(tokens.shape[1])
        slot = self._slot_free[0]          # claim only after pages are ours
        if self.paged:
            if s >= self.slot_len:
                raise ValueError(
                    f"prompt of {s} tokens leaves no decode room in a "
                    f"{self.slot_len}-token paged slot (pages are never "
                    f"evicted; use a longer cache_len)")
            room = self.slot_len - s
            budget = room if n_tokens is None else max(
                1, min(int(n_tokens), room))
            horizon = s + budget if reserve_tokens is None else max(
                s, min(int(reserve_tokens), self.slot_len))
            self._kv.alloc(slot, horizon)
            table_row = torch.from_numpy(np.asarray(
                self._kv.table_row(slot), np.int32)).to(self.device)
        else:
            budget = None if n_tokens is None else max(1, int(n_tokens))
        self._slot_free.pop(0)
        logits, one = self.prefill(dev_batch, self.slot_len)
        if self.paged:
            _write_slot_paged(self._slot_cache, one, slot, table_row,
                              self.page_size, self.api.paged_keys)
        else:
            _write_slot(self._slot_cache, one, slot)
        self._last_tok[slot] = torch.argmax(logits[0], -1)
        self._slot_active[slot] = True
        self._slot_budget[slot] = budget
        self._slot_generated[slot] = 0
        self._slot_pos[slot] = s
        self._active_mask[slot] = True
        self.stats.inserts += 1
        return slot

    # ------------------------------------------------ packed batch insert
    def _pack_prompts(self, batches: List[Dict[str, Any]],
                      lens: List[int]) -> Dict[str, np.ndarray]:
        """Concatenate prompts into one packed row (host numpy): total
        tokens bucket by ``_packed_bucket``, the segment axis by the next
        power of two of the real count; padding tokens carry segment id S
        and empty segments length 0. An encoder model's frame embeddings
        stack per segment into a host tensor (S, encoder_seq, d_model),
        zero blocks for the padding segments, as the JAX engine pads
        them."""
        s_max = max(1, _pow2_at_least(len(batches)))
        t = max(1, _packed_bucket(sum(lens)))
        tokens = np.zeros((1, t), np.int32)
        seg_ids = np.full((t,), s_max, np.int32)
        starts = np.zeros((s_max,), np.int32)
        seg_lens = np.zeros((s_max,), np.int32)
        off = 0
        for i, (b, ln) in enumerate(zip(batches, lens)):
            tokens[0, off:off + ln] = np.asarray(b["tokens"])[0]
            seg_ids[off:off + ln] = i
            starts[i] = off
            seg_lens[i] = ln
            off += ln
        packed = {"tokens": tokens, "seg_ids": seg_ids,
                  "seg_starts": starts, "seg_lens": seg_lens}
        if self.cfg.has_encoder:
            enc = torch.zeros((s_max, self.cfg.encoder_seq,
                               self.cfg.d_model),
                              dtype=dtype_of(self.cfg.dtype))
            for i, b in enumerate(batches):
                enc[i] = self._frames(b, "cpu")[0]
            packed["enc_embeds"] = enc
        return packed

    def insert_many(self, batches: List[Dict[str, Any]],
                    n_tokens: Optional[List[Optional[int]]] = None,
                    reserve_tokens: Optional[List[Optional[int]]] = None
                    ) -> List[int]:
        """Admit a whole admission batch in ONE packed prefill dispatch and
        scatter every segment's K/V into its slot's pages or ring rows.
        Page allocation is all-or-nothing: on ``OutOfPages`` every page
        already claimed returns and no slot is touched.
        ``reserve_tokens[i]`` (>= prompt i's length) overrides request i's
        page horizon (lazy reservation)."""
        n = len(batches)
        if n == 0:
            return []
        if n > len(self._slot_free):
            raise RuntimeError(
                f"insert_many of {n} requests, {len(self._slot_free)} "
                f"free slots")
        n_tokens = n_tokens or [None] * n
        reserve_tokens = reserve_tokens or [None] * n
        lens = []
        for b in batches:
            assert b["tokens"].shape[0] == 1, \
                "insert_many packs single-request batches"
            lens.append(int(b["tokens"].shape[1]))
        budgets: List[Optional[int]] = []
        for s, nt in zip(lens, n_tokens):
            if not self.paged:
                if s > self.slot_len:
                    raise ValueError(
                        f"prompt of {s} tokens exceeds the {self.slot_len}-"
                        f"token slot (packed prefill cannot ring-wrap)")
                budgets.append(None if nt is None else max(1, int(nt)))
                continue
            if s >= self.slot_len:
                raise ValueError(
                    f"prompt of {s} tokens leaves no decode room in a "
                    f"{self.slot_len}-token paged slot (pages are never "
                    f"evicted; use a longer cache_len)")
            room = self.slot_len - s
            budgets.append(room if nt is None else max(1, min(int(nt), room)))
        slots = self._slot_free[:n]
        if self.paged:
            claimed: List[int] = []
            try:
                for slot, s, budget, rsv in zip(slots, lens, budgets,
                                                reserve_tokens):
                    horizon = s + budget if rsv is None else max(
                        s, min(int(rsv), self.slot_len))
                    self._kv.alloc(slot, horizon)
                    claimed.append(slot)
            except OutOfPages:
                for slot in claimed:
                    self._kv.free(slot)
                raise
        del self._slot_free[:n]

        self._prefill_packed(self._pack_prompts(batches, lens),
                             self._segment_dest(slots, lens), lens)
        for slot, s, budget in zip(slots, lens, budgets):
            self._slot_active[slot] = True
            self._slot_budget[slot] = budget
            self._slot_generated[slot] = 0
            self._slot_pos[slot] = s
            self._active_mask[slot] = True
        self.stats.inserts += n
        return slots

    def _prefill_packed(self, packed, dest, lens: List[int]):
        """One ``packed_prefill`` dispatch of whole prompts of ``lens``
        tokens and their scatter into the slots, charged as the JAX
        engine's ``prefill_packed`` charges it."""
        self._segment_step("packed_prefill", packed, dest, lens)
        self.stats.prefills += 1
        self.stats.packed_prefills += 1
        self.stats.prefill_tokens += sum(lens)

    def segment_key(self, lens: List[int]) -> Tuple[int, int, int]:
        """The executable key ``(T, row_len, S)`` of a packed batch of
        segments of ``lens`` tokens: the packed row's bucketed length,
        the per-segment row length and the segment axis."""
        return (max(1, _packed_bucket(sum(lens))),
                min(self.slot_len, _pow2_at_least(max(lens))),
                max(1, _pow2_at_least(len(lens))))

    def _segment_step(self, kind: str, packed, dest, lens: List[int]):
        """Dispatch the ``kind`` executable (``packed_prefill`` or
        ``chunk_prefill``) of the key ``(T, row_len, S)`` — the JAX
        engine's — on the host arrays of one packed batch of segments of
        ``lens`` new tokens; the segment and token counts ride along so
        the fixed-shape scatter can tell padding from real lanes."""
        key = self.segment_key(lens)
        row_len = key[1]
        arrays = dict(packed, **dest, counts=np.asarray(
            [len(lens), sum(lens)], np.int32))
        self._graphs.entry(
            kind, key, lambda dev: self._segment_body(kind, dev, row_len),
            arrays).run(arrays)

    def _segment_body(self, kind: str, dev, row_len: int):
        """The packed prefill, or the incremental chunk over the resident
        pages, and its scatter, on the step's buffers. Returns the
        segments' last logits and, for a chunk, the per-token argmax (what
        a speculative round scores its drafts against)."""
        amax = None
        if kind == "packed_prefill":
            logits, pcache = self.api.prefill_packed(self.params, dev,
                                                     row_len)
        else:
            logits, amax, pcache = self.api.prefill_chunk(
                self.params, dev, self._slot_cache, row_len)
        _write_segments(self._slot_cache, self._last_tok, pcache, logits,
                        dev, dev["counts"][0], dev["counts"][1],
                        self.api.paged_keys)
        return logits, amax

    def _segment_dest(self, slots: List[int], lens: List[int]):
        """Host destination indices of the packed-segment scatter of whole
        prompts: per token (physical page, in-page offset) from the pages
        just allocated, or (slot row, column) on a ring; per segment the
        slot id (padding: ``n_slots``) and, paged, the slot's table row.
        Padding tokens target the null page (paged) or a column past the
        ring; neither is written."""
        if self.paged:
            return self._segment_dest_at(slots, lens, [0] * len(slots))
        t = max(1, _packed_bucket(sum(lens)))
        s_max = max(1, _pow2_at_least(len(slots)))
        seg_slots = np.full((s_max,), self.n_slots, np.int32)
        seg_slots[:len(slots)] = slots
        dest0 = np.zeros((t,), np.int32)
        dest1 = np.full((t,), self.slot_len, np.int32)
        off = 0
        for slot, ln in zip(slots, lens):
            dest0[off:off + ln] = slot
            dest1[off:off + ln] = np.arange(ln)
            off += ln
        return {"dest0": dest0, "dest1": dest1, "seg_slots": seg_slots}

    def _pack_chunks(self, batches: List[Dict[str, Any]], lens: List[int],
                     hists: List[int]):
        """Pack continuation chunks: the packed-prompt row plus
        ``hist_lens`` (tokens already resident; padding 0). The block-table
        row each segment reads its history through is ``seg_slots`` of
        ``_segment_dest_at`` (padding ``n_slots``, clamped in the model)."""
        packed = self._pack_prompts(batches, lens)
        s_max = packed["seg_starts"].shape[0]
        hist = np.zeros((s_max,), np.int32)
        hist[:len(hists)] = hists
        packed["hist_lens"] = hist
        return packed

    def _segment_dest_at(self, slots: List[int], lens: List[int],
                         offs: List[int]):
        """Destinations for segments whose tokens land at positions
        ``offs[i] .. offs[i] + lens[i]`` of their slot; the destination
        pages were reserved before the dispatch (admission horizon or an
        executed grow). Table rows are the slots' current pages."""
        t = max(1, _packed_bucket(sum(lens)))
        s_max = max(1, _pow2_at_least(len(slots)))
        seg_slots = np.full((s_max,), self.n_slots, np.int32)
        seg_slots[:len(slots)] = slots
        dest0 = np.zeros((t,), np.int32)             # null page
        dest1 = np.zeros((t,), np.int32)
        tables = np.full((s_max, self.max_pages), NULL_PAGE, np.int32)
        off = 0
        for i, (slot, ln, h) in enumerate(zip(slots, lens, offs)):
            pages = np.asarray(self._kv.pages(slot), np.int32)
            p = np.arange(h, h + ln)
            dest0[off:off + ln] = pages[p // self.page_size]
            dest1[off:off + ln] = p % self.page_size
            tables[i, :len(pages)] = pages
            off += ln
        return {"dest0": dest0, "dest1": dest1, "seg_slots": seg_slots,
                "table_rows": tables}

    def free(self, slot: int) -> None:
        """Release a slot: its position pins to 0 and, paged, its pages
        return to the pool and its table row parks on the null page, so
        its dead writes land in the null page and its reads are masked."""
        if not self._slot_active[slot]:
            return
        if slot in self._draft_ready:
            # the draft twin dies with its target
            self._draft.free(slot)
            self._draft_ready.discard(slot)
        self._slot_active[slot] = False
        self._slot_free.append(slot)
        self._slot_pos[slot] = 0
        if self.paged:
            self._kv.free(slot)
            _clear_slot(self._slot_cache, slot)
        else:
            _clear_ring(self._slot_cache, slot)
        self._active_mask[slot] = False

    # ---------------------------------------------------- capabilities
    def prefix_cache_capable(self) -> bool:
        """Pages + ``pos`` are a row's entire sequence state."""
        if not self.paged or self._slot_cache is None:
            return False
        extra = (set(self._slot_cache.keys())
                 - set(self.api.paged_keys) - {"block_tables", "pos"})
        return not extra

    def chunk_capable(self) -> bool:
        """Continuations run incrementally: the family ships
        ``prefill_chunk`` and has no experts."""
        if not self.prefix_cache_capable():
            return False
        if self.api.prefill_chunk is None:
            return False
        return not getattr(self.cfg, "num_experts", 0)

    def spec_capable(self) -> bool:
        """Speculative decoding needs greedy slot steps (draft/verify
        equivalence is an arg-max identity) on a ``chunk_capable``
        engine."""
        return self.chunk_capable() and self._slot_sampling is None

    def host_last_token(self, slot: int) -> int:
        """Host read of the slot's pending token (the next decode input,
        not yet emitted). The planner reads it once per request as the
        speculation seed; a per-slot sync, so only with speculation on."""
        return int(self._last_tok[slot])

    def draft_synced(self, slot: int) -> bool:
        """True when the slot's draft twin exists and sits at the same
        written-token position — the next spec round needs no re-init."""
        return (self._draft is not None and slot in self._draft_ready
                and self._draft._slot_pos[slot] == self._slot_pos[slot])

    # ------------------------------------------------ radix prompt cache
    def enable_prefix_cache(self):
        """Attach a radix prompt cache over this engine's page allocator
        and register the two hit-admission executables (COW page copy,
        table-row + position write). Raises for incapable families —
        callers that want best effort check ``prefix_cache_capable``."""
        if not self.prefix_cache_capable():
            raise ValueError(
                f"{self.cfg.name}: prefix cache needs a paged engine whose "
                "per-row state is exactly pages + pos (families with SSM "
                "state / conv tails / cross K/V cannot alias their prefix)")
        self.prefix_cache = PrefixCache(self._kv.allocator, self.page_size)
        # recovery keeps radix nodes touched within this many cache
        # operations of the fault (``PrefixCache.retain_recent``)
        self.prefix_hot_window = 64
        self._graphs.add_kinds(PREFIX_KINDS)
        return self.prefix_cache

    def warm_prefix_ops(self) -> None:
        """Build (capture, on the card) the hit-admission executables up
        front, on dead state: the COW copy of the null page onto itself,
        and a vacant slot's parked state (null table row, position 0)
        written back unchanged."""
        if self.prefix_cache is None:
            return
        self._copy_page(NULL_PAGE, NULL_PAGE)
        if self._slot_free:
            self._alias_slot(self._slot_free[0],
                             np.full((self.max_pages,), NULL_PAGE, np.int32),
                             0)

    def _copy_page(self, src: int, dst: int) -> None:
        """The ``copy_page`` dispatch: physical page ``src`` of every paged
        leaf copied onto ``dst``."""
        arrays = {"pages": np.asarray([src, dst], np.int32)}
        self._graphs.entry("copy_page", None, self._copy_page_body,
                           arrays).run(arrays)

    def _copy_page_body(self, dev):
        src, dst = dev["pages"][:1].long(), dev["pages"][1:].long()
        for key in self.api.paged_keys:
            leaf = self._slot_cache[key]        # (layers, pages, page, ...)
            leaf.index_copy_(1, dst, leaf.index_select(1, src))

    def _alias_slot(self, slot: int, table_row: np.ndarray, pos: int) -> None:
        """The ``alias_slot`` dispatch: the slot's whole block-table row
        (one static shape for every hit) and its position."""
        arrays = {"slot": np.asarray([slot], np.int32),
                  "row": np.asarray(table_row, np.int32)[None],
                  "pos": np.asarray([pos], np.int32)}
        self._graphs.entry("alias_slot", None, self._alias_slot_body,
                           arrays).run(arrays)

    def _alias_slot_body(self, dev):
        slot = dev["slot"].long()
        tables, pos = self._slot_cache["block_tables"], self._slot_cache["pos"]
        tables.index_copy_(0, slot, dev["row"].to(tables.dtype))
        pos.index_copy_(0, slot, dev["pos"].to(pos.dtype))

    def slot_pages(self, slot: int) -> List[int]:
        """Physical pages backing a slot, in logical order (the prefix
        cache registers a finished prefill's leading pages)."""
        return self._kv.pages(slot) if self.paged else []

    def alias_admit(self, batch: Dict[str, Any], hit,
                    n_tokens: Optional[int] = None,
                    reserve_tokens: Optional[int] = None) -> int:
        """Admit one request whose prompt prefix is a cache hit — no
        prefill for the covered tokens.

        ``hit`` is a pinned ``PrefixHit`` from ``prefix_cache.match``: its
        fully covered pages alias read-only into the new slot's block
        table (the row adopts the match-time pins), a partial-page match
        is copied into the row's first fresh page (one ``copy_page``
        dispatch; the pin on the source releases after the copy), and the
        rest of the horizon allocates fresh pages all-or-nothing. The slot
        starts at ``pos = covered`` with the first uncovered prompt token
        pending, so teacher-forced catch-up steps (the planner's
        ``StepPlan.forced``, or ``catchup_prefill``) replay the prompt
        tail through the decode dispatch, each writing K/V where a
        whole-prompt prefill would; the last leaves the argmax over the
        full prompt pending, as ``insert`` does.

        Raises ``OutOfPages`` with nothing changed (the caller keeps the
        hit's pins and must ``release_hit`` it)."""
        if not self._slot_free:
            raise RuntimeError("no free slots")
        assert self.prefix_cache is not None, "enable_prefix_cache first"
        assert batch["tokens"].shape[0] == 1, "alias_admit admits one request"
        s = int(batch["tokens"].shape[1])
        covered = int(hit.covered)
        assert 0 < covered < s, \
            f"hit covers {covered} of a {s}-token prompt"
        if s >= self.slot_len:
            raise ValueError(
                f"prompt of {s} tokens leaves no decode room in a "
                f"{self.slot_len}-token paged slot (pages are never "
                f"evicted; use a longer cache_len)")
        room = self.slot_len - s
        budget = room if n_tokens is None else max(1, min(int(n_tokens),
                                                          room))
        horizon = s + budget if reserve_tokens is None else max(
            covered + 1, min(int(reserve_tokens), self.slot_len))
        slot = self._slot_free[0]          # claim only after pages are ours
        fresh = self._kv.alloc_alias(slot, hit.pages, horizon)
        self._slot_free.pop(0)
        if hit.cow_src is not None:
            # the partially matched page copies into the row's first page
            # past the aliased prefix; its divergent suffix is stale but
            # never read (attention masks by pos) and is overwritten in
            # order by the forced catch-up writes
            self._copy_page(hit.cow_src, fresh[0])
            self._kv.allocator.release([hit.cow_src])
            self.stats.cow_copies += 1
        self._alias_slot(slot, np.asarray(self._kv.table_row(slot), np.int32),
                         covered)
        self._last_tok[slot] = int(np.asarray(batch["tokens"])[0, covered])
        self._slot_active[slot] = True
        self._slot_budget[slot] = budget
        self._slot_generated[slot] = 0
        self._slot_pos[slot] = covered
        self._active_mask[slot] = True
        self.stats.inserts += 1
        self.stats.prefix_hits += 1
        self.stats.prefix_hit_tokens += covered
        if self.telemetry is not None:
            self.telemetry.instant(
                self.telemetry.engine_track(self), "prefix_hit",
                slot=slot, covered=covered,
                cow=int(hit.cow_src is not None))
        return slot

    def catchup_prefill(self, slot: int, tokens, covered: int) -> None:
        """Teacher-forced completion of an aliased prompt, one decode
        dispatch per remaining token (the pool plane's eager form; the
        tick plane spreads the same steps across ticks through
        ``StepPlan.forced``). After it the slot sits where a whole-prompt
        insert leaves it: ``pos = len(tokens)``, the argmax over the full
        prompt pending."""
        for i in range(int(covered), len(tokens)):
            self.step([slot], forced={slot: int(tokens[i])})

    def dedup_slot_prefix(self, slot: int, tokens, n_full: int) -> int:
        """Cross-request prefix dedup at registration time: when two
        same-prefix prompts prefill in the same tick, both miss and both
        fill their own pages with the same K/V for the shared prefix. The
        first to finish registers its pages as the canonical ones; this
        call — made right after the second registers — repoints every
        one of the slot's leading ``n_full`` pages that differs from the
        tree's canonical walk and releases the row's duplicate. The
        updated table row goes to the device; values never change, so
        streams are untouched. Safe because every later write on a
        registered row lands at ``pos >= prompt_len``. Returns duplicate
        pages actually freed."""
        if not self.paged or self.prefix_cache is None or n_full < 1:
            return 0
        ps = self.page_size
        canonical = self.prefix_cache.canonical_pages(
            list(tokens)[:n_full * ps])
        own = self._kv.pages(slot)
        swaps = [(i, c) for i, (o, c)
                 in enumerate(zip(own[:n_full], canonical)) if o != c]
        if not swaps:
            return 0
        freed = self._kv.repoint(slot, swaps)
        _set_table_row(self._slot_cache, slot,
                       np.asarray(self._kv.table_row(slot), np.int32))
        self.stats.dedup_pages += freed
        if self.telemetry is not None:
            self.telemetry.instant(
                self.telemetry.engine_track(self), "prefix_dedup",
                slot=slot, pages=freed)
        return freed

    # ------------------------------------------------ page-view accessors
    def slot_pos(self, slot: int) -> int:
        """Tokens written to the slot so far (host mirror of pos)."""
        return self._slot_pos[slot]

    def reserved_tokens(self, slot: int) -> int:
        """Token horizon the slot's pages currently cover (slot_len for a
        ring: it is fully backed by construction)."""
        if not self.paged:
            return self.slot_len
        return self._kv.length(slot)

    def slot_page_count(self, slot: int) -> int:
        return len(self._kv.pages(slot)) if self.paged else 0

    def kv_pages_needed(self, tokens: int) -> int:
        if not self.paged:
            return 0
        return self._kv.pages_needed(max(1, int(tokens)))

    def slot_active(self, slot: int) -> bool:
        return self._slot_active[slot]

    # -------------------------------------------- lazy page reservation
    def grow_slot(self, slot: int, upto_tokens: int) -> int:
        """Extend a resident slot's page horizon to ``upto_tokens``. New
        pages push the slot's table row to the device (only when pages
        were added). Raises ``OutOfPages`` with the slot untouched.
        Returns the number of pages added (always 0 on a ring)."""
        if not self.paged:
            return 0
        have = self._kv.length(slot)
        delta = min(int(upto_tokens), self.slot_len) - have
        if delta <= 0:
            return 0
        fresh = self._kv.append(slot, delta)
        if fresh:
            _set_table_row(self._slot_cache, slot,
                           np.asarray(self._kv.table_row(slot), np.int32))
            self.stats.grows += 1
        return len(fresh)

    def ensure_decode_room(self, slots) -> None:
        """Grow every slot to cover its next decode write."""
        for slot in slots:
            self.grow_slot(slot, self._slot_pos[slot] + 1)

    # ------------------------------------------------- chunked prefill
    def chunk_append(self, chunks: List[Tuple[int, Dict[str, Any], bool]]
                     ) -> None:
        """Advance every mid-prefill slot by one chunk in ONE dispatch.
        ``chunks`` is [(slot, prefix batch (1, done + chunk), final)].
        ``final`` segments leave the pending token = argmax of the prompt's
        last logits, exactly what a one-shot admission seeds.

        ``chunk_capable`` (paged) engines run only the NEW tokens: they
        attend the K/V the slot already holds in its pages plus the chunk
        causally, each new position running the attention a decode step
        would. Ring engines recompute: the whole prefixes pack into the
        admission path's packed prefill and ``_write_segments`` rewrites
        each slot's rows from column 0 (the already-written prefix gets
        the values it holds, the chunk lands for the first time)."""
        if not chunks:
            return
        lens = []
        for slot, b, _ in chunks:
            ln = int(b["tokens"].shape[1])
            assert self._slot_active[slot], f"chunk into vacant slot {slot}"
            assert ln <= self.reserved_tokens(slot), \
                f"slot {slot}: chunk outruns its reserved pages"
            assert ln > self._slot_pos[slot], \
                f"slot {slot}: chunk makes no progress"
            lens.append(ln)
        slots = [slot for slot, _, _ in chunks]
        if not self.chunk_capable():
            self._chunk_recompute(chunks, slots, lens)
            return
        offs = [self._slot_pos[slot] for slot in slots]
        new_lens = [ln - off for ln, off in zip(lens, offs)]
        news = [{"tokens": np.asarray(b["tokens"])[:, off:ln]}
                for (_, b, _), off, ln in zip(chunks, offs, lens)]
        self._segment_step("chunk_prefill",
                           self._pack_chunks(news, new_lens, offs),
                           self._segment_dest_at(slots, new_lens, offs),
                           new_lens)
        for slot, ln in zip(slots, lens):
            self._slot_pos[slot] = ln
        self.stats.prefills += 1
        self.stats.packed_prefills += 1
        self.stats.chunk_prefills += 1
        self.stats.incr_chunks += 1
        self.stats.prefill_tokens += sum(new_lens)

    def _chunk_recompute(self, chunks, slots: List[int],
                         lens: List[int]) -> None:
        """Prefix-recompute continuation: the full prefixes run the packed
        prefill admissions use and scatter onto their slots."""
        self._prefill_packed(
            self._pack_prompts([b for _, b, _ in chunks], lens),
            self._segment_dest(slots, lens), lens)
        for slot, ln in zip(slots, lens):
            self._slot_pos[slot] = ln
        self.stats.chunk_prefills += 1

    # --------------------------------------------- speculative decoding
    def attach_draft(self, draft: "InferenceEngine", spec_k: int
                     ) -> "InferenceEngine":
        """Pair a ring-slot draft engine with this (paged, greedy) target
        for speculative decoding: per round the draft proposes up to
        ``spec_k`` tokens in ONE ``draft_scan`` dispatch and the target
        verifies them all in ONE incremental chunk dispatch.

        Identity pairing — target slot i drafts in draft slot i — so the
        draft needs at least as many slots, each at least as long as a
        target slot (a ring wrap would corrupt the mirrored history). The
        ring never pages, so drafting can neither run out of pages nor
        touch the target's pool. Vocabularies must agree: accepted draft
        tokens feed the target's embedding directly. The draft's slots
        and weights are bound here: attach again after changing them."""
        if int(spec_k) < 1:
            raise ValueError("spec_k must be >= 1")
        if not self.spec_capable():
            raise ValueError(
                f"{self.cfg.name}: speculative decoding needs a paged "
                "greedy engine whose per-row state is exactly pages + pos "
                "and whose family ships prefill_chunk")
        if draft.paged:
            raise ValueError("draft must use ring slots (paged=False)")
        if draft.n_slots < self.n_slots or draft.slot_len < self.slot_len:
            raise ValueError(
                f"draft needs >= {self.n_slots} slots of >= "
                f"{self.slot_len} tokens (has {draft.n_slots} x "
                f"{getattr(draft, 'slot_len', 0)})")
        if draft.cfg.vocab_size != self.cfg.vocab_size:
            raise ValueError(
                f"draft/target vocabularies differ "
                f"({draft.cfg.vocab_size} vs {self.cfg.vocab_size})")
        self._draft = draft
        self.spec_k = int(spec_k)
        self._draft_ready = set()
        self._spec_consts: Dict[Any, Dict[str, Any]] = {}
        self._spec_tables: Dict[Any, Tuple[List[np.ndarray], np.ndarray]] = {}
        # the draft's proposals, read on the host after the verify chunk
        # has run: engine state, outside the graph pool, whose blocks a
        # later capture may reuse for its temporaries
        self._spec_props = torch.zeros((self.spec_k + 1, draft.n_slots),
                                       dtype=draft._last_tok.dtype,
                                       device=self.device)
        self._graphs.add_kinds(SPEC_KINDS)
        self._graphs.clear(SPEC_KINDS)
        return draft

    def _draft_scan_body(self, dev):
        """The draft's whole round in one dispatch: each paired row's
        pending token pinned to the target's (teacher forcing), then
        spec_k + 1 masked greedy ring steps (``slot_step``'s body) — step
        i writes the previous token's K/V and proposes the next; the last
        step only writes the last proposal's K/V, so an all-accepted round
        leaves the draft one bonus token behind the target — and the
        verify token row: position 0 of each segment the target's pending
        token, positions 1..k its draft's proposals. The proposals land in
        ``_spec_props`` (spec_k + 1, draft slots); returns the verify row
        (T,) int32, which the round copies on at once."""
        draft = self._draft
        tok = draft._last_tok
        # padding lanes repeat the last real lane: the same value to the
        # same row
        tok.index_copy_(0, dev["idx_d"].long(),
                        self._last_tok.index_select(0, dev["idx_t"].long()))
        masks = dev["masks"] != 0
        props = self._spec_props
        for i in range(masks.shape[0]):
            _slot_decode_step(draft.api, draft._step_skip, draft._ring_keys,
                              draft.params, tok, draft._slot_cache, masks[i])
            props[i].copy_(tok)
        step_idx, slot_idx = dev["step_idx"].long(), dev["slot_idx"].long()
        drafted = props[torch.clamp(step_idx - 1, min=0), slot_idx]
        verify = torch.where(step_idx == 0, self._last_tok[slot_idx], drafted)
        return verify.to(torch.int32)

    def _spec_commit_body(self, dev):
        """The end of a round, both engines at once: the target's
        ``pos`` rewound to the accepted horizon (the verify chunk's
        scatter wrote K/V, and ``pos``, for all k + 1 positions; rejected
        positions sit past the horizon, never attended, and are rewritten
        in order), both pending tokens pinned to the bonus token, and the
        draft ring's ``pos`` rewound to the same horizon."""
        draft = self._draft
        slots = dev["slots"].long()
        for cache in (self._slot_cache, draft._slot_cache):
            cache["pos"].index_copy_(0, slots,
                                     dev["pos"].to(cache["pos"].dtype))
        for tok in (self._last_tok, draft._last_tok):
            tok.index_copy_(0, slots, dev["tok"].to(tok.dtype))

    def _round_consts(self, entries):
        """The host arrays of a round that depend only on its (slots, ks)
        — identical for every steady-state round, built once: the draft
        scan's index vectors and step masks, and the verify chunk's
        segment layout."""
        key = (tuple(s for s, _, _ in entries),
               tuple(k for _, k, _ in entries))
        got = self._spec_consts.get(key)
        if got is not None:
            return got
        slots = list(key[0])
        draft = self._draft
        n_steps = self.spec_k + 1
        masks = np.zeros((n_steps, draft.n_slots), np.int32)
        for slot, k, _ in entries:
            masks[:k + 1, slot] = 1
        vlens = [k + 1 for _, k, _ in entries]
        t = max(1, _packed_bucket(sum(vlens)))
        s_max = max(1, _pow2_at_least(len(slots)))
        # padding lanes repeat the last real one
        idx = np.asarray(slots + [slots[-1]] * (self.n_slots - len(slots)),
                         np.int32)
        seg_ids = np.full((t,), s_max, np.int32)
        seg_starts = np.zeros((s_max,), np.int32)
        seg_lens = np.zeros((s_max,), np.int32)
        step_idx = np.zeros((t,), np.int32)
        slot_idx = np.zeros((t,), np.int32)
        off = 0
        for j, (slot, ln) in enumerate(zip(slots, vlens)):
            seg_ids[off:off + ln] = j
            seg_starts[j] = off
            seg_lens[j] = ln
            step_idx[off:off + ln] = np.arange(ln)
            slot_idx[off:off + ln] = slot
            off += ln
        got = self._spec_consts[key] = {
            "scan": {"idx_t": idx, "idx_d": idx, "masks": masks,
                     "step_idx": step_idx, "slot_idx": slot_idx},
            "packed": {"tokens": np.zeros((1, t), np.int32),
                       "seg_ids": seg_ids, "seg_starts": seg_starts,
                       "seg_lens": seg_lens},
            "slots": slots, "vlens": vlens, "t": t, "s_max": s_max,
            "starts": [int(x) for x in seg_starts[:len(slots)]],
            "row_len": min(self.slot_len, _pow2_at_least(max(vlens)))}
        return got

    def _spec_round(self, entries: List[Tuple[int, int, Optional[List[int]]]],
                    res) -> None:
        """One draft → verify → accept/rollback round for the plan's
        ``spec`` entries [(slot, k, init_tokens-or-None)].

        Protocol (greedy): the target's pending token t sits at position
        P = ``_slot_pos[slot]`` with its K/V unwritten. The draft —
        teacher-forced to the same history — proposes d_1..d_k; the
        verify chunk runs [t, d_1..d_k] through the incremental prefill
        (the ``chunk_prefill`` executable of continuations), whose
        per-token argmax row is the sequence of tokens greedy decode would
        have emitted one step at a time. The longest prefix a of agreeing
        drafts is accepted, and position P+a's argmax is the bonus token —
        a+1 tokens per round. The verify's scatter writes all k+1
        positions' K/V into the slot's reserved pages; ``spec_commit``
        sets ``pos`` to the accepted horizon P+a+1, so rejected K/V sits
        past it, never attended — rollback costs no dispatch and
        conserves pages. The draft ring rewinds the same way, and both
        engines hold the bonus token as their pending input."""
        draft = self._draft
        tel = self.telemetry
        slots = [s for s, _, _ in entries]
        offs = [self._slot_pos[s] for s in slots]

        # (re)admit draft twins that are missing or out of lockstep (the
        # slot decoded plainly while speculation was gated off): one
        # packed prefill on the DRAFT engine re-mirrors the history
        admit = []
        for (slot, _, init), off in zip(entries, offs):
            if self.draft_synced(slot):
                continue
            if slot in self._draft_ready:
                draft.free(slot)
                self._draft_ready.discard(slot)
            assert init is not None and len(init) == off, \
                f"slot {slot}: draft init missing or mismatched"
            admit.append((slot, init))
        if admit:
            order = [s for s, _ in admit]
            chosen = set(order)
            draft._slot_free = order + [s for s in draft._slot_free
                                        if s not in chosen]
            op = tel.t0(draft) if tel is not None else None
            got = draft.insert_many(
                [{"tokens": np.asarray(toks, np.int32)[None, :]}
                 for _, toks in admit], n_tokens=[None] * len(admit))
            assert got == order, "draft twin landed on the wrong slot"
            self._draft_ready.update(order)
            res.dispatches += 1
            if tel is not None:
                tel.dispatch_done(draft, "spec_admit", len(admit), op,
                                  segs=len(admit))

        consts = self._round_consts(entries)
        t, s_max, starts = consts["t"], consts["s_max"], consts["starts"]
        vlens = consts["vlens"]

        # ---- draft: k+1 masked steps, one dispatch, nothing read back
        scan = consts["scan"]
        op = tel.t0(draft) if tel is not None else None
        verify = self._graphs.entry(
            "draft_scan", t, self._draft_scan_body, scan).run(scan)
        res.dispatches += 1
        if tel is not None:
            tel.dispatch_done(draft, "spec_draft", self.spec_k + 1, op,
                              slots=len(slots))

        # ---- verify: [t, d_1..d_k] per slot, one incremental chunk whose
        # token row is the draft scan's output, copied on the device into
        # the chunk's upload (no host sync between the two)
        hist = np.zeros((s_max,), np.int32)
        hist[:len(offs)] = offs
        tkey = (tuple(slots), self._kv.version)
        tables = self._spec_tables.get(tkey)
        if tables is None:
            if len(self._spec_tables) > 64:
                self._spec_tables.clear()
            pages = [np.asarray(self._kv.pages(s), np.int32) for s in slots]
            rows = np.full((s_max, self.max_pages), NULL_PAGE, np.int32)
            for i, p in enumerate(pages):
                rows[i, :len(p)] = p
            tables = self._spec_tables[tkey] = (pages, rows)
        pages, rows = tables
        dest0 = np.zeros((t,), np.int32)             # null page
        dest1 = np.zeros((t,), np.int32)
        for p, st, ln, h in zip(pages, starts, vlens, offs):
            span = np.arange(h, h + ln)
            dest0[st:st + ln] = p[span // self.page_size]
            dest1[st:st + ln] = span % self.page_size
        seg_slots = np.full((s_max,), self.n_slots, np.int32)
        seg_slots[:len(slots)] = slots
        arrays = dict(consts["packed"], hist_lens=hist, dest0=dest0,
                      dest1=dest1, seg_slots=seg_slots, table_rows=rows,
                      counts=np.asarray([len(slots), sum(vlens)], np.int32))
        row_len = consts["row_len"]
        step = self._graphs.entry(
            "chunk_prefill", (t, row_len, s_max),
            lambda dev: self._segment_body("chunk_prefill", dev, row_len),
            arrays)
        op = tel.t0(self) if tel is not None else None
        step.fill(arrays)
        step.views["tokens"][0].copy_(verify)
        _, amax = step.launch()
        res.dispatches += 1
        if tel is not None:
            tel.dispatch_done(self, "spec_verify", t, op, segs=len(slots),
                              tokens=sum(vlens))

        # ---- accept / rollback on the host: the round's only reads
        props_h = self._spec_props.cpu().numpy().T.tolist()  # per slot
        amax = amax.cpu().tolist()
        n = len(slots)
        aux = np.zeros((3, s_max), np.int32)
        emitted_total = accepted_total = drafted_total = n_roll = 0
        for j, (slot, k, _) in enumerate(entries):
            st = starts[j]
            pl = props_h[slot]
            a = 0
            while a < k and pl[a] == amax[st + a]:
                a += 1
            g = amax[st + a]                         # bonus token
            res.spec_tokens[slot] = pl[:a] + [g]
            aux[:, j] = (slot, g, offs[j] + a + 1)
            self._slot_pos[slot] = offs[j] + a + 1
            self._slot_generated[slot] += a + 1
            draft._slot_pos[slot] = offs[j] + a + 1
            emitted_total += a + 1
            accepted_total += a
            drafted_total += k
            if a < k:
                n_roll += 1
        aux[:, n:] = aux[:, n - 1:n]                 # padding: the last lane
        commit = {"slots": aux[0], "tok": aux[1], "pos": aux[2]}
        self._graphs.entry("spec_commit", (t, s_max), self._spec_commit_body,
                           commit).run(commit)

        self.stats.spec_rounds += 1
        self.stats.draft_tokens += drafted_total
        self.stats.accepted_tokens += accepted_total
        self.stats.rollbacks += n_roll
        self.stats.tokens_out += emitted_total
        for slot, active in enumerate(self._slot_active):
            if active:
                budget = self._slot_budget[slot]
                if (budget is not None
                        and self._slot_generated[slot] >= budget
                        and slot not in res.done):
                    res.done.append(slot)
        if tel is not None:
            tel.instant(tel.engine_track(self), "spec_round",
                        slots=len(slots), drafted=drafted_total,
                        accepted=accepted_total, rollbacks=n_roll)

    # ---------------------------------------------------- fault tolerance
    def attach_faults(self, injector, max_retries: Optional[int] = None,
                      backoff_s: Optional[float] = None) -> None:
        """Arm a ``FaultInjector`` at the dispatch site of ``execute`` and
        in the page allocator (``None`` disarms)."""
        self.fault_injector = injector
        if max_retries is not None:
            self.retry_limit = int(max_retries)
        if backoff_s is not None:
            self.retry_backoff_s = float(backoff_s)
        if self._kv is not None:
            self._kv.allocator.fault_injector = injector

    def attach_telemetry(self, tel) -> None:
        """Arm (or with None, disarm) the telemetry plane
        (``repro_torch.serving.telemetry.Telemetry``) on this engine. Like
        ``attach_faults``, attach after warm-up: timing covers only built
        executables. Timing records CUDA events between dispatches and
        waits for none of them: it adds host time, and changes no value,
        dispatch count or capture."""
        self.telemetry = tel

    def recover(self) -> int:
        """Engine reset after an unrecoverable fault: every slot is freed
        and the page-conservation audit runs before serving resumes. The
        radix prompt cache is not flushed: its registered pages hold K/V
        of prompts that finished prefill before the fault, so the hot
        subtree survives (``PrefixCache.retain_recent`` over
        ``prefix_hot_window``) and the audit accounts it: free +
        cache-held == total. Returns how many slots were dropped."""
        dropped = sum(1 for a in self._slot_active if a)
        self.release_all_slots(flush_cache=False)
        if self.prefix_cache is not None:
            self.prefix_cache.retain_recent(self.prefix_hot_window)
        if self.paged:
            held = (self.prefix_cache.held_pages
                    if self.prefix_cache is not None else 0)
            assert (self._kv.free_pages + held
                    == self._kv.allocator.num_pages), \
                "engine recovery leaked pages"
        self.check_page_invariants()
        self.stats.engine_resets += 1
        if self.telemetry is not None:
            self.telemetry.instant(self.telemetry.engine_track(self),
                                   "engine_reset", dropped=dropped)
        return dropped

    def check_page_invariants(self) -> bool:
        """Host-side page audit: allocator conservation (the prefix
        cache's references included) plus slot-level ownership (vacant
        slots own no pages). No-op for ring engines."""
        if not self.paged:
            return True
        extra = (self.prefix_cache.page_refs()
                 if self.prefix_cache is not None else None)
        self._kv.check_invariants(extra_refs=extra)
        if self.prefix_cache is not None:
            self.prefix_cache.check_invariants()
        for slot in self._slot_free:
            assert not self._kv.pages(slot), \
                f"vacant slot {slot} still owns pages"
        return True

    # ------------------------------------------------- plan execution
    def execute(self, plan) -> StepResult:
        """Run one ``StepPlan``: frees → cancels → preemptions → grows →
        alias admissions (prefix-cache hits: a page copy and a row write
        each, no prefill) → first chunks (ONE packed prefill) →
        continuation chunks (ONE incremental chunk dispatch) → decodes and
        teacher-forced catch-up tokens (ONE slot step) → a speculative
        round for the plan's ``spec`` slots. With a
        ``FaultInjector`` attached, injected ``TransientFault``s retry up
        to ``retry_limit`` times before raising ``EngineFault``; the fault
        fires before the plan mutates anything."""
        attempts = 0
        while self.fault_injector is not None:
            try:
                self.fault_injector.maybe_fault("dispatch")
                break
            except TransientFault as e:
                self.stats.engine_retries += 1
                attempts += 1
                if self.telemetry is not None:
                    self.telemetry.instant(
                        self.telemetry.engine_track(self), "retry",
                        attempt=attempts)
                if attempts > self.retry_limit:
                    raise EngineFault(
                        f"dispatch fault persisted past {self.retry_limit} "
                        f"retries") from e
                if self.retry_backoff_s > 0:
                    time.sleep(self.retry_backoff_s * (2 ** (attempts - 1)))
        tel = self.telemetry
        if tel is None or tel.trace is None:
            return self._execute_plan(plan)
        with tel.trace.span(tel.engine_track(self), "execute",
                            admissions=len(plan.admissions),
                            decodes=len(plan.decodes),
                            frees=len(plan.frees), cancels=len(plan.cancels),
                            preemptions=len(plan.preemptions),
                            grows=len(plan.grows)):
            return self._execute_plan(plan)

    def _execute_plan(self, plan) -> StepResult:
        res = StepResult()
        for slot in plan.frees:
            self.free(slot)
        for slot in plan.cancels:
            self.free(slot)
        for slot in plan.preemptions:
            self.free(slot)
        tel = self.telemetry
        failed: set = set()
        if plan.grows:
            op = tel.t0(self) if tel is not None else None
            for slot, upto in plan.grows:
                try:
                    self.grow_slot(slot, upto)
                except OutOfPages:
                    # the slot is untouched but its next write is unbacked
                    # — skip its chunk/decode this tick, report for requeue
                    failed.add(slot)
                    res.failed_grows.append(slot)
            if tel is not None:
                tel.dispatch_done(self, "grow", len(plan.grows), op,
                                  failed=len(res.failed_grows))
        alias = [c for c in plan.admissions
                 if c.slot is None and c.alias is not None]
        first = [c for c in plan.admissions
                 if c.slot is None and c.alias is None]
        cont = [c for c in plan.admissions if c.slot is not None
                and c.slot not in failed]
        for c in alias:
            # each hit consumes its match-time pins; on OutOfPages (fresh
            # tail pages) nothing changed, so the pins return to the cache
            # and the planner requeues the request like any failed
            # admission
            try:
                slot = self.alias_admit(c.batch, c.alias,
                                        n_tokens=c.n_tokens,
                                        reserve_tokens=c.reserve_tokens)
                res.admitted[c.rid] = slot
            except OutOfPages:
                self.prefix_cache.release_hit(c.alias)
                if tel is not None:
                    tel.instant(tel.engine_track(self),
                                "alias_admission_failed", rid=c.rid)
        if first:
            op = tel.t0(self) if tel is not None else None
            try:
                slots = self.insert_many(
                    [c.batch for c in first],
                    n_tokens=[c.n_tokens for c in first],
                    reserve_tokens=[c.reserve_tokens for c in first])
                res.admitted.update(
                    {c.rid: s for c, s in zip(first, slots)})
                res.dispatches += 1
                if tel is not None:
                    ntok = sum(int(c.batch["tokens"].shape[1])
                               for c in first)
                    tel.dispatch_done(self, "admission_prefill",
                                      _packed_bucket(ntok), op,
                                      segs=len(first), tokens=ntok)
            except OutOfPages:
                # all-or-nothing rollback already ran; the planner
                # requeues the whole staged batch
                res.admission_failed = True
                if tel is not None:
                    tel.instant(tel.engine_track(self), "admission_failed",
                                segs=len(first))
        if cont:
            op = tel.t0(self) if tel is not None else None
            self.chunk_append([(c.slot, c.batch, c.final) for c in cont])
            res.dispatches += 1
            if tel is not None:
                ntok = sum(int(c.batch["tokens"].shape[1]) for c in cont)
                tel.dispatch_done(self, "chunk_prefill",
                                  _packed_bucket(ntok), op,
                                  segs=len(cont), tokens=ntok)
        decodes = [s for s in plan.decodes if s not in failed]
        forced = {s: t for s, t in plan.forced if s not in failed}
        if decodes or forced:
            op = tel.t0(self) if tel is not None else None
            # teacher-forced catch-up slots join THE decode dispatch: the
            # step writes each one's prompt token's K/V at pos (what a
            # prefill would write there) and advances pos; forced outputs
            # never reach res.tokens — nothing was generated
            toks, done = self.step(decodes + list(forced), forced=forced)
            t = (toks.cpu().numpy() if tel is None
                 else tel.readback(self, toks, op))
            res.tokens = {int(s): int(t[s]) for s in decodes}
            res.done = list(done)
            res.dispatches += 1
            if tel is not None:
                tel.dispatch_done(self, "decode",
                                  len(decodes) + len(forced), op,
                                  forced=len(forced))
        spec = [e for e in plan.spec if e[0] not in failed]
        if spec:
            self._spec_round(spec, res)
        return res

    def step(self, slots: Optional[List[int]] = None,
             forced: Optional[Dict[int, int]] = None
             ) -> Tuple[torch.Tensor, List[int]]:
        """One decode step in a single dispatch — for all active slots
        (default) or the plan's ``decodes`` subset — greedy or sampled
        with the slots' ``SamplingParams``. Returns
        ``(tokens, done)``: tokens (n_slots,) on the device (unstepped
        slots keep their pending token), and the active slots whose token
        budget is now exhausted (host counters, no device read).

        ``forced`` maps teacher-forced slots (a prefix-cache hit replaying
        its uncovered prompt tail) to their prompt token: the token rides
        the step's upload and becomes the slot's pending token inside the
        dispatch, the step writes its K/V and advances ``pos`` as a
        prefill would, and the slot's generated count and the emitted
        tokens are untouched — nothing was sampled for the stream."""
        if slots is None:
            mask = self._active_mask.copy()
            stepped = [s for s, a in enumerate(self._slot_active) if a]
        else:
            mask = np.zeros((self.n_slots,), bool)
            for s in slots:
                mask[s] = self._slot_active[s]
            stepped = [s for s in slots if self._slot_active[s]]
        forced = forced or {}
        pending = np.full((self.n_slots,), -1, np.int32)
        for s, t in forced.items():
            pending[s] = t
        arrays = {"mask": mask.astype(np.int32), "forced": pending}
        sampling = self._slot_sampling
        self._graphs.entry("slot_step", sampling, self._step_body, arrays,
                           None if sampling is None else self._slot_gen
                           ).run(arrays)
        n_forced = 0
        for slot in stepped:
            self._slot_pos[slot] += 1
            if slot in forced:
                n_forced += 1
            else:
                self._slot_generated[slot] += 1
        done: List[int] = []
        for slot, active in enumerate(self._slot_active):
            if active:
                budget = self._slot_budget[slot]
                if budget is not None and self._slot_generated[slot] >= budget:
                    done.append(slot)
        self.stats.decode_steps += 1
        self.stats.tokens_out += len(stepped) - n_forced
        self.stats.forced_catchup_tokens += n_forced
        return self._last_tok, done

    def _step_body(self, dev):
        """The masked slot step, in place on the slot state, after the
        forced slots' prompt tokens (``forced`` >= 0) become pending."""
        tok, forced = self._last_tok, dev["forced"]
        tok.copy_(torch.where(forced >= 0, forced.to(tok.dtype), tok))
        return _slot_decode_step(self.api, self._step_skip, self._ring_keys,
                                 self.params, tok, self._slot_cache,
                                 dev["mask"] != 0, self._slot_sampling,
                                 self._slot_gen)

    def kv_cache_bytes(self) -> int:
        """Device bytes held by the slot cache (all leaves, the block
        table and the null page included)."""
        if self._slot_cache is None:
            return 0
        return int(sum(t.numel() * t.element_size()
                       for t in self._slot_cache.values()))

    # --------------------------------------------- pool accounting hooks
    def release_all_slots(self, flush_cache: bool = True) -> None:
        """Force-free every slot and restore the canonical free-list order
        of slots and pages (exact replay of seeded runs depends on it).
        ``flush_cache`` (the pool-reset default) also drops the prefix
        cache, so a replayed seeded run starts from a cold cache;
        ``recover`` passes False and keeps the hot working set. A paired
        draft engine is released the same way."""
        for slot, active in enumerate(self._slot_active):
            if active:
                self.free(slot)
        if self.prefix_cache is not None and flush_cache:
            self.prefix_cache.flush()
        self._slot_free.sort()
        if self.paged:
            self._kv.allocator.sort_free()
        if self._draft is not None:
            self._draft.release_all_slots()

    def reset_stats(self) -> None:
        self.stats = EngineStats()


def _pick(logits, sampling: Optional[SamplingParams], generator):
    """The next tokens from (B, V) logits: the arg-max, or drawn with
    ``sampling`` from ``generator`` (the JAX engine's ``pick``)."""
    if sampling is None:
        return torch.argmax(logits, -1)
    return L.sample_logits(generator, logits,
                           temperature=sampling.temperature,
                           top_k=sampling.top_k, top_p=sampling.top_p)


def _merge_rows(new, cache, mask, skip) -> None:
    """Write ``new``'s per-row leaves into ``cache`` IN PLACE, only for
    rows in ``mask``; rows outside it keep theirs. Leaves in ``skip``
    (page pools, the block table, ring K/V) are page-indexed or written in
    place by the step itself and are not touched: masked-off rows' dead
    writes there land at a not-yet-valid position or on the null page (a
    ring step restores them)."""
    for key, leaf in cache.items():
        # the leaf itself: read only (cross K/V) or stepped in place on
        # the masked rows (an SSM state)
        if key in skip or new[key] is leaf:
            continue
        axis = 0 if leaf.dim() == 1 else 1
        shape = [1] * leaf.dim()
        shape[axis] = mask.shape[0]
        leaf.copy_(torch.where(mask.reshape(shape),
                               new[key].to(leaf.dtype), leaf))


def _slot_decode_step(api, skip, ring_keys, params, tok, cache, mask,
                      sampling: Optional[SamplingParams] = None,
                      generator: Optional[torch.Generator] = None):
    """One decode step over every slot row, IN PLACE on ``tok`` and
    ``cache`` (a captured step reads and writes fixed addresses), its
    tokens the arg-max or, with ``sampling``, drawn from ``generator``;
    rows outside ``mask`` (vacant and mid-prefill slots) keep their
    position and pending token and, on a ring, the cache entry the step
    overwrote in place (ring row ``pos % C`` of each ``ring_keys`` leaf),
    so their rows stay bit-identical as the JAX engine's merge keeps
    them. The step gets ``mask``: a family with per-slot recurrent state
    advances it in place on the masked rows and returns the cache's own
    leaf, which the merge then skips. Returns the step's logits (rows
    outside ``mask``: not meaningful)."""
    held = {}
    if ring_keys:
        c = cache[ring_keys[0]].shape[2]
        bidx = torch.arange(mask.shape[0], device=mask.device)
        at = (cache["pos"] % c).long()
        held = {key: cache[key][:, bidx, at] for key in ring_keys}
    logits, new = api.decode_step(params, tok, cache, mask=mask)
    for key, old in held.items():
        leaf = new[key]
        leaf[:, bidx, at] = torch.where(mask[None, :, None, None],
                                        leaf[:, bidx, at], old)
    _merge_rows(new, cache, mask, skip)
    tok.copy_(torch.where(mask, _pick(logits, sampling, generator), tok))
    return logits


def _lanes(n: int, count, device):
    """Lanes 0..n-1 of a fixed-shape scatter whose first ``count`` (an
    int or a 0-d device tensor) are real: a padding lane repeats the last
    real one — the same value to the same place — so no lane needs
    dropping and the shape never depends on the count."""
    return torch.clamp(torch.arange(n, device=device), max=count - 1)


def _write_segments(cache, last_tok, pcache, logits, dev, n_seg, n_tok,
                    paged_keys):
    """The packed-segment scatter, in place, over every lane of the
    bucket: the first ``n_tok`` tokens' per-token leaves (the family's
    paged keys, packed (layers, T, ...) order) land at their (page,
    offset) from ``dev["dest0"/"dest1"]``; every other leaf is per
    segment — (S,) like ``pos``, or stacked (layers, S, ...) like an SSM
    state — and the first ``n_seg`` segments write it at their slot ids,
    with the block-table rows and the pending tokens (the segments'
    argmax). Padding lanes (tokens past ``n_tok``, whose targets are the
    null page or past the ring, and segments past ``n_seg``, whose slot
    is ``n_slots``) repeat the last real lane (``_lanes``), so what lands
    is what the JAX scatter writes, dropping them."""
    seg = _lanes(dev["seg_slots"].shape[0], n_seg, logits.device)
    tok = _lanes(dev["dest0"].shape[0], n_tok, logits.device)
    slots = dev["seg_slots"].long()[seg]
    dest0, dest1 = dev["dest0"].long()[tok], dev["dest1"].long()[tok]
    for key, leaf in cache.items():
        if key == "block_tables":
            leaf[slots] = dev["table_rows"][seg]
        elif key in paged_keys:
            leaf[:, dest0, dest1] = pcache[key][:, tok].to(leaf.dtype)
        elif leaf.dim() == 1:
            leaf[slots] = pcache[key][seg].to(leaf.dtype)
        else:
            leaf[:, slots] = pcache[key][:, seg].to(leaf.dtype)
    last_tok[slots] = torch.argmax(logits[seg], -1)


def _write_row(leaf, o, slot: int) -> None:
    """Write batch-1 leaf ``o`` into row ``slot`` of ``leaf``, in place:
    stacked leaves are (layers, batch, ...), the position vector
    (batch,)."""
    o = o.to(leaf.dtype)
    if leaf.dim() == 1:
        leaf[slot] = o[0]
    else:
        leaf[:, slot] = o[:, 0]


def _write_slot(big, one, slot: int) -> None:
    """Write a batch-1 contiguous cache into row ``slot`` of a ring slot
    cache, in place."""
    for key, leaf in big.items():
        _write_row(leaf, one[key], slot)


def _write_slot_paged(big, one, slot: int, table_row, page_size: int,
                      paged_keys) -> None:
    """The paged insert scatter, in place: the paged leaves of a batch-1
    contiguous cache (layers, 1, slot_len, ...) route through the slot's
    full padded table row into the page pool (padding entries write their
    zeros into the never-read null page); the table row and the per-row
    leaves take a row write."""
    for key, leaf in big.items():
        if key == "block_tables":
            leaf[slot] = table_row
        elif key in paged_keys:
            o = one[key][:, 0]
            o = o.reshape((o.shape[0], table_row.shape[0], page_size)
                          + tuple(o.shape[2:]))
            leaf[:, table_row.long()] = o.to(leaf.dtype)
        else:
            _write_row(leaf, one[key], slot)


def _set_table_row(cache, slot: int, table_row: np.ndarray) -> None:
    """Push a grown slot's block-table row to the device."""
    row = cache["block_tables"][slot]
    row.copy_(torch.from_numpy(table_row))


def _clear_slot(cache, slot: int) -> None:
    """Park a freed slot: position 0 and its whole table row on the null
    page, so its dead writes can never alias a page granted later."""
    cache["pos"][slot] = 0
    cache["block_tables"][slot] = NULL_PAGE


def _clear_ring(cache, slot: int) -> None:
    """Park a freed ring slot: position 0."""
    cache["pos"][slot] = 0


def make_engine(cfg, *, seed: int = 0, cache_len: int = 256,
                dtype=torch.float32, device=None,
                graphs: bool = True) -> InferenceEngine:
    """Engine with random parameters from ``seed``, on ``device`` (default:
    the CUDA device; raises where there is none unless ``device="cpu"``
    is passed). ``dtype`` is the parameters' storage type (float32, as
    the JAX package's ``make_engine``); activations run in ``cfg.dtype``.
    ``graphs``: replay CUDA graphs per bucket on a CUDA device (ignored
    on the CPU, which runs eagerly); off, every step runs eagerly — the
    comparison, as the JAX engine takes ``donate_cache``."""
    api = build_model(cfg, device)
    gen = torch.Generator(device=api.device).manual_seed(seed)
    params = api.init(gen, dtype)
    return InferenceEngine(api, params, cache_len=cache_len, graphs=graphs)
