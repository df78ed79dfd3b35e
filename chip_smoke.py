#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py              # all phases, as the acceptance run
    python3 chip_smoke.py --phases a   # kernels only (a quick first check)
    python3 chip_smoke.py --phases af  # kernels and the Mamba2 family
    python3 chip_smoke.py --phases g   # the D-STACK pool on the card
    python3 chip_smoke.py --phases h   # prefix cache and speculation
    python3 chip_smoke.py --phases i   # sampling, telemetry, the gateway
    python3 chip_smoke.py --phases aj  # kernels and whisper-small
    python3 chip_smoke.py --phases ak  # kernels and the experts
    python3 chip_smoke.py --phases al  # kernels and the hybrid family
    python3 chip_smoke.py --phases am  # kernels and training

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc`` and runs thirteen phases, each printing one JSON line:

  (a) kernels vs plain: each of the seven hand-written kernels against its
      plain PyTorch version on the card, at the serving path's head shapes
      (olmo-1b: 16 heads of 128; qwen2-0.5b: 14 query / 2 KV heads of 64;
      mamba2-1.3b's SSD: 64 heads, P 64, N 128, chunk 128), in float32
      (TF32 off) and bfloat16, with length-0 rows, fresh sequences
      (history 0), padding segments, paged rows at split edges, a 1024-page
      row, pages of 24 tokens, chunks of 5 rows over a history of 2000
      and over histories of 128 to 256 (speculative verify, the second at
      phase (h)'s shape), ragged packed lengths, ragged prompt
      lengths, windows, non-causal attention, L below the chunk and
      packed SSD rows whose dt = 0 tails must leave the state bit for bit
      as their unpadded runs do; #1, #2, #4 and #5 also at yi-9b's heads
      (32 query / 4 KV of 128) and deepseek-7b's (32 of 128), and
      whisper-small's cases (12 heads of 64): #5's cross-attention of 8
      rows of 64 and of 224 queries over 1536 encoder frames and its
      encoder self-attention (8 x 1536, non-causal), #4's cross-attention
      decode (8 rows of 1536); #1, #2, #4 and #5 at zamba2-7b's 32 heads
      of 112 (#1 also at its split edges) and #6 at its SSD heads (112
      heads, P 64, N 64, chunk 128; the dt = 0 tails too); the flash
      backward ``flash_attention_bwd`` (training) from #5's output and
      log-sum-exp against the plain backward (dq, dk, dv) and #5's lse
      against the plain forward's, at qwen2-0.5b's heads (8 x 2048
      causal), olmo-1b's (4 x 2048 causal), a ragged S 1000, a window
      of 512 and whisper's cross shape (8 x 224 queries over 1536
      keys), plus short ragged edges; times every
      case's kernel, plain
      version and, where one PyTorch call computes the same function, that
      call (``scaled_dot_product_attention``, a yardstick the port never
      calls; no single call computes the SSD scan), beside the least time
      the card could take;
  (b) serve: olmo-1b at full width in bfloat16 with seeded random weights
      answers 16 requests through ``StepPlanner``/``serve_ticks`` on one
      paged engine (admissions, chunk continuations and decodes all
      occur), and every kernel of the paged path must have launched;
  (d) generate: the same olmo-1b runs batch ``generate`` (padded prefill
      through the flash kernel, decode through the contiguous decode
      kernel) on four batches of 8 prompts (128 to 2000 tokens, 64 new
      tokens each), then qwen2-0.5b at full width on one;
  (e) ring serve: phase (b)'s requests on 8 ring slots, so admissions and
      prefix-recompute continuations run the packed prefill and decodes
      the contiguous decode kernel (and never the chunk kernel);
  (f) ssm: mamba2-1.3b at full width in bfloat16 (12 of its 48 layers,
      d_model 2048, 64 SSD heads of 64, N 128) serves phase (b)'s requests
      on 8 slots of per-sequence state (packed admissions,
      prefix-recompute continuations, recurrent decodes), then runs batch
      ``generate`` on 8 prompts of 512 and of 2000 tokens; every prefill
      dispatch scans each layer through the SSD kernel;
  (g) pool: the D-STACK control plane drives the quick trio (qwen2-0.5b,
      olmo-1b, mamba2-1.3b) at full width in bfloat16 through
      ``EnginePool``/``Controller``: profiles, knees and efficacy optima on
      the card's ``Hardware`` (units: GPU percent), standby engines of 4
      paged slots of 1024 tokens per allocation, warmed once (every graph
      captured); then ``temporal``, ``fixed_batch_mps``, ``maxmin`` and
      ``dstack`` each serve the same seeded arrivals (128-token prompts,
      4 tokens each), with no capture, every model served, every grant a
      level, the allocated fraction never above 1 but under
      fixed-batch MPS, and exactly #1, #2 and #6 launched; then each
      kind of dispatch the virtual clock charges (admission prefills and
      slot steps at 1, 2 and 4 live slots, at 100%) is timed beside the
      modelled f_L(100, b), with the per-layer overhead the model leaves
      unexplained;
  (h) prefix cache and speculation: olmo-1b at full width in bfloat16 on
      one paged engine of 8 slots x 1024 tokens (pages of 16). (h1) 32
      requests of three shared templates (600, 312 and 150 tokens) plus
      short tails through ``serve_ticks`` (``chunk_tokens=512``), cache
      off and on: the cache must save at least 40% of the admission
      prefill tokens, graphed and eager cache-on turns must agree, and
      #1, #2 and #3 launch; (h2) 8 requests of 128 + 128 tokens, plain
      and speculative with an identical-weights ring draft (8 x 1024, the
      target's weights) at spec_k 4, then a divergent draft (seed 1):
      no capture and no new executable between warm serves, the page
      audit and a canonical free list after the divergent serve, and
      #1-#4 launched; the bf16 streams of different kernels (cache off vs
      on, plain vs speculative) are counted equal, not asserted;
  (i) sampling, telemetry and the gateway: olmo-1b at full width in
      bfloat16 (phase (b)'s weights). (i1) (b)'s requests on 8 sampled
      paged slots (temperature 0.8, top-k 50, top-p 0.95, seed 0): one
      capturing pass, then eager, graphed, graphed, eager turns from the
      same seed — identical streams, no capture, #2, #3 and #1 launched;
      seed 1 draws other streams, temperature 0 gives (b)'s greedy
      streams; (i2) 2^16 draws from each of 8 rows of the model's logits
      lie in the plain filter's support within a total variation of 0.03
      of its renormalised softmax, and sampled ``generate`` 8 x 512 + 64
      gives one seed's tokens graphed twice and eager once (#5, #4);
      (i3) ``bench_gateway --full``'s burst trace through the async
      gateway on 4 paged slots of 32 (pages of 8), every packing captured
      up front: virtual-clock serves under FIFO and tiers (tiers lift
      interactive attainment; streams equal ``serve_ticks``'), then
      wall-clock serves, telemetry off and on (trace validated and saved,
      TTFT/TBT, dispatches against f_L), no capture, #2 and #1; (i4)
      (g)'s pool under ``dstack`` with the telemetry plane attached: (g)'s
      served and violated counts, no capture, the Prometheus text
      round-tripped, #1, #2 and #6;
  (j) whisper-small at full width (12 encoder and 12 decoder layers,
      d_model 768, 1536 stub frames per request) in bfloat16: (j1) 16
      requests (decoder prompts 4-224, 32-128 new tokens, frames of their
      own) on 8 paged slots of 512 (pages of 16), ``chunk_tokens=128``
      (continuations recompute the prefix), and the encoder's share of an
      8-segment admission; (j2) the same on 8 ring slots; (j3)
      ``generate`` 8 x 64 + 64; each graphed and eager in turns,
      identical streams, no capture, the path's kernels exactly (#5 for
      the encoder and the cross-attention of prefills, #2, #1 or #4 for
      self-attention decode, #4 for cross-attention decode); (j4)
      ``bench_pool``'s four models (the trio and whisper-small) at (g)'s
      geometry under ``dstack`` and ``temporal``: every model served, no
      capture after warm-up;
  (k) the experts, bfloat16, seeded weights: granite-moe-3b-a800m at
      full width (32 layers, d_model 1536, 24 query / 8 KV heads of 64,
      40 experts top-8 of d_ff 512). (k1) phase (b)'s 16 requests on 8
      paged slots of 1024 (pages of 16), ``chunk_tokens=512``: the
      engine is not ``chunk_capable``, so continuations recompute the
      prefix — #2 and #1 launch, #3 never; graphed and eager in turns,
      profiled, the tick beside the decode step's weight floor; the
      routing (dropped fraction, load-balance loss, layer 0's tokens per
      expert) of one packed admission and of ``forward`` over 8 x 512;
      each stage of the dispatch timed alone at a decode step's 8 tokens
      and at the admission's, and a decode step of 8 live slots graphed
      and eager. (k2) ``generate`` 8 x 512 + 64: #5, #4. (k3)
      phi3.5-moe-42b-a6.6b at full width cut to 4 of its 32 layers (d_model
      4096, 32 / 8 heads of 128, 16 experts top-2 of d_ff 6400;
      the whole model's 84 GB does not fit one card), ``generate``
      8 x 512 + 32: #5, #4. (k4) the quick trio and granite in one pool
      at (g)'s geometry under ``dstack`` and ``temporal``: every model
      served, every grant a level, no capture after warm-up, #1, #2, #6;
  (l) the hybrid family, bfloat16, seeded weights: zamba2-7b at full
      width (d_model 3584, 32 heads of 112, d_ff 14336, 112 SSD heads of
      64, N 64). (l1) 12 of its 81 layers (two invocations of the shared
      block): phase (b)'s 16 requests on 8 paged slots of 1024 (pages of
      16), ``chunk_tokens=512``, then on 8 ring slots: continuations
      recompute the prefix — #2, #6 and #1 (paged) or #4 (ring) launch,
      #3 never; graphed and eager in turns, profiled, the tick beside the
      decode step's weight floor; (l2) ``generate`` 8 x 512 + 64: #5, #4,
      #6; (l3) all 81 layers, graphed only: one capturing ``generate`` 8
      x 512 + 32, two timed runs, a decode step of 8 live paged slots
      graphed and eager beside its floor, the peak allocation; (l4) the
      quick trio and zamba2 in one pool under ``dstack`` and
      ``temporal``: every model served, no capture after warm-up, #1,
      #2, #6, zamba2's knee and optimum on the card's ``Hardware``;
  (m) training through ``repro_torch.launch.train.main``, bfloat16
      compute over float32 parameters, remat on, seeded weights: (m1)
      qwen2-0.5b whole (24 layers, d_model 896, 14 / 2 heads of 64,
      vocabulary 151,936) on 30 steps of 8 x 2048 of the pipeline's
      stream; every loss finite, the mean of the last 5 at least 1.0 nat
      below the first; s/step, tokens/s, peak allocation, the model-FLOPs
      share of the step; every step launches exactly #5 and the backward,
      each at least once a layer (#5 twice: remat runs the forward again);
      (m3) ``training/checkpoint`` on the card: (m1)'s parameters saved,
      loaded back bit for bit, ``eval_step``'s loss the same before and
      after, then one more step profiled; (m2) olmo-1b whole (16 layers,
      16 heads of 128) on 10 steps of 4 x 2048, the same gates;
  (c) equality: olmo-1b at full width cut to 2 layers, float32 with TF32
      off, runs each path once on the GPU (the kernels, under CUDA
      graphs) and once on the CPU (the plain versions) — a paged serve,
      a shared-prefix serve cache off then on (equal streams), plain then
      speculative serves with an identical-weights draft (equal streams,
      acceptance 1.0), ``generate``, a ring serve with continuations,
      and a sliding-window ring that wraps — and so does mamba2-1.3b at
      full width cut to 2 layers (a serve and ``generate``), and
      whisper-small cut to 2 encoder and 2 decoder layers (paged and ring
      serves, ``generate``); the greedy streams must be identical; and
      ``bench_pool``'s four models (the quick trio and whisper-small) cut
      to 2 layers, float32, serve under ``dstack`` in one pool on each
      device: the same admissions (model, granted units, batch, request
      ids) and the same served and violated counts; a telemetry-attached
      paged serve (its streams and trace keys), sampled slots and sampled ``generate`` at temperature
      0 and at top-k 1 (the greedy streams), and (i3)'s gateway serves at
      2 layers: on the GPU the whole trace, whose scorecards must equal
      (i3)'s, and on both devices its first 0.2 virtual seconds, the same
      streams and scorecards; granite-moe cut to 2 layers: one packed
      prefill's expert indices and drop masks (every layer), a paged
      serve with recomputed continuations, a shared-prefix serve cache
      off then on (hits caught up by forced tokens) and ``generate`` —
      identical routing and greedy streams; zamba2-7b cut to 12 layers:
      one packed prefill's logits, SSM states and packed K/V within 1e-3
      of each leaf's scale, a paged serve with recomputed continuations
      and ``generate`` — identical greedy streams; training: one step's
      loss and gradients (``loss_and_grads``, remat on) of qwen2-0.5b and
      granite-moe (its aux loss included) at full width cut to 2 layers,
      B 2 x S 1536 (the CPU runs the plain flash VJP), the loss within
      1e-5 relative and every gradient leaf within 1e-4 of its max
      |value|.

Every path of (b), (d), (e), (f), (j1)-(j3), (k1)-(k3) and (l1)-(l2)
runs on one engine that
replays CUDA graphs per bucket (``repro_torch.serving.graphs``): a first
graphed run meets the path's buckets and captures them, untimed; then the
path runs timed in turns — eager (``graphs`` off), graphed, graphed,
eager — each with the launch counts at 0 just before it, and must give
the first run's tokens, launch exactly the path's kernels (replays count)
and capture nothing; for (b), (d), (e) and (f) one more run of each mode
goes under ``torch.profiler`` for its device time, whose share of the
mode's mean timed wall is the device's busy share (and so for (k1) and (l1)).

Then it prints the ``kernels`` summary line (each kernel's launches are
its count over the first graphed turn of each main path of (b), (d), (e)
and (f), plus the four serves of (g), the first graphed cache-on and
speculative turns of (h), (i)'s first graphed sampled turn, timed
graphed ``generate``, traced wall-clock gateway serve and traced pool
serve, (j)'s, (k)'s and (l)'s first graphed turns, (l3)'s first timed
``generate`` and their pool serves, and (m1)'s and (m2)'s training steps;
#1, #2, #4, #5 and #6 carry
zamba2's cases, #5 whisper's and the backward its further shapes under
``cases``), the card's name and
power
limit, and, last,
``{"ok": true, "device": {...}}``. Any failure raises
and exits non-zero; so does a machine without a CUDA device, or a
directory without the port's sources. Detailed results go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM data-sheet peaks (dense): HBM bytes/s and FLOP/s per input type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

HEADS = {"olmo-1b": (16, 16, 128), "qwen2-0.5b": (14, 2, 64)}
# the dense configs' heads: #1, #2, #4 and #5 at their main shapes
DENSE_HEADS = {"yi-9b": (32, 4, 128), "deepseek-7b": (32, 32, 128)}
DENSE_KERNELS = ("paged_decode_attention", "segment_flash_attention",
                 "decode_attention", "flash_attention")
# whisper-small: 12 heads of 64 over 1536 encoder frames. #5 takes the
# cross-attention of packed rows of 64 and 224 decoder tokens and the
# encoder's self-attention, #4 the cross-attention decode
WHISPER_HEADS = (12, 12, 64)
WHISPER_CASES = {
    "flash_attention": {
        "cross_64": dict(b=8, s=1536, sq=64, causal=False),
        "cross_224": dict(b=8, s=1536, sq=224, causal=False),
        "encoder": dict(b=8, s=1536, causal=False)},
    "decode_attention": {"cross": dict(c=1536, lengths=(1536,) * 8)}}
KERNEL_NAMES = ("paged_decode_attention", "segment_flash_attention",
                "paged_chunk_attention", "decode_attention",
                "flash_attention", "ssd_scan", "flash_attention_bwd")
TOL = {"float32": (2e-5, 0.0), "bfloat16": (2e-2, 2e-2)}
# the SSD scan in float32: max |kernel - plain| <= this * max(1, max |plain|)
# (its chunk sums reassociate terms as large as the output)
SSD_F32_TOL = 1e-4
# (c)'s packed prefill of zamba2-7b at 12 layers, float32, GPU against
# CPU: the same bound at the scale of each leaf (12 layers of full-width
# matmuls and scans, each summed in another order)
HYBRID_F32_TOL = 1e-3
# the SSD heads (H, P, N, chunk) of mamba2-1.3b and of zamba2-7b
SSD_HEADS = {"mamba2-1.3b": (64, 64, 128, 128),
             "zamba2-7b": (112, 64, 64, 128)}
# zamba2-7b's shared attention: #1, #2, #4 and #5 at 32 heads of 112 (#1
# also at its split edges)
ZAMBA_HEADS = (32, 32, 112)
ZAMBA_SHAPES = {"paged_decode_attention": [
    ("main", {}), ("split edges", dict(lengths="split edges"))]}
# the device functions each of the port's kernels launches
PORT_SYMBOLS = {
    "paged_decode_attention": ("paged_split_kernel", "paged_combine_splits"),
    "segment_flash_attention": ("segment_flash_kernel", "segment_tc_kernel"),
    "paged_chunk_attention": ("paged_chunk_kernel", "chunk_tc_kernel"),
    "decode_attention": ("decode_split_kernel", "combine_splits"),
    "flash_attention": ("flash_kernel", "flash_tc_kernel"),
    "ssd_scan": ("ssd_kernel", "ssd_tc_kernel"),
    "flash_attention_bwd": ("delta_kernel", "dkdv_kernel", "dq_kernel")}
# the bf16 kernels that must run on the tensor cores (wgmma: HGMMA in their
# SASS): library -> (name fragment, instantiations): #2 and #5 at D 64,
# 128 and 112 (#5 with and without its lse store), #3 at D 64 and 128, #6
# at chunk tiles of 64 and 128 rows for N 128 and 64
TENSOR_CORE_KERNELS = {
    "flash_attention": (("flash_tc_kernel", 6), ("segment_tc_kernel", 3)),
    "chunk_attention": (("chunk_tc_kernel", 2),),
    "ssd_scan": (("ssd_tc_kernel", 4),)}
# device cycles of the sleep ahead of a timed run (~10 ms at H100 clocks):
# longer than the host takes to queue its runs
QUEUE_SLEEP_CYCLES = 20_000_000


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _time_ms(fn, torch, iters: int = 20, sleep: bool = True,
             flush=None) -> float:
    """Mean device time of ``fn`` over ``iters`` runs, by CUDA events.

    ``sleep``: a device-side sleep ahead of the first event lets the host
    queue every run before the device reaches them, so a call whose host
    side is slower than its kernels is timed by its kernels. Without it
    the runs go back to back as the host issues them, and a call whose
    host side is the slower one is timed by its host side.
    ``flush``: a tensor larger than the L2 cache, read before every run;
    each run is then timed by its own pair of events and finds its inputs
    in device memory, not in L2, as a layer of a model does after the
    other layers' weights and caches have passed through."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if sleep:
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
             for _ in range(iters if flush is not None else 1)]
    if flush is None:
        pairs[0][0].record()
        for _ in range(iters):
            fn()
        pairs[0][1].record()
    else:
        for start, end in pairs:
            flush.sum()
            start.record()
            fn()
            end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def _timings(fn, torch, flush, key: str = "ms") -> dict:
    """``fn``'s time three ways: ``key`` queued behind a sleep with a warm
    L2 (the headline), ``key``_host_paced back to back without the sleep,
    and ``key``_cold_l2 queued with the L2 flushed before each run."""
    return {key: _time_ms(fn, torch),
            f"{key}_host_paced": _time_ms(fn, torch, sleep=False),
            f"{key}_cold_l2": _time_ms(fn, torch, flush=flush)}


def _release(torch):
    """Free what a finished path dropped: an engine and its captured
    graphs reference each other, so only the cycle collector frees them,
    and their memory then goes back to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def _l2_flush(torch, dev):
    """A float32 buffer of four times the card's L2 cache."""
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    return torch.ones(l2, dtype=torch.float32, device=dev)


def _bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase (a): kernels against their plain versions
# --------------------------------------------------------------------------
def _split_edges(kv, c):
    """8 lengths one below, at and one above the ends of the first two
    splits the decode wrappers cut of 8 rows of capacity c, then c - 1
    and 0."""
    from repro_torch.kernels import decode_attention
    n = decode_attention.decode_splits(8, kv, c,
                                       decode_attention.sm_count(0))[1]
    return (n - 1, n, n + 1, 2 * n - 1, 2 * n, 2 * n + 1, c - 1, 0)


def _decode_case(torch, gen, dev, dtype, h, kv, d, ps=16, max_pages=64,
                 lengths=(0, 1, 17, 100, 500, 1000, 1024, 900)):
    """8 rows of 0 to 1024 tokens in pages of 16, the block tables
    scrambled. ``lengths="split edges"``: ``_split_edges`` of the
    capacity."""
    if lengths == "split edges":
        lengths = _split_edges(kv, ps * max_pages)
    lengths = list(lengths)
    b = len(lengths)
    n_pages = b * max_pages + 1
    q = torch.randn(b, h, d, generator=gen, device=dev).to(dtype)
    kp = torch.randn(n_pages, ps, kv, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(n_pages, ps, kv, d, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    tables = perm[:b * max_pages].reshape(b, max_pages).to(torch.int32)
    # entries past a row's live pages point far outside the pool: the
    # kernel must never read them (the plain version gathers every entry,
    # so it gets them parked on the null page)
    live = torch.tensor([-(-n // ps) for n in lengths], device=dev)
    past = torch.arange(max_pages, device=dev)[None, :] >= live[:, None]
    poisoned = tables.masked_fill(past, 1 << 30).contiguous()
    sane = tables.masked_fill(past, 0).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    elt = q.element_size()
    live_tok = sum(lengths)
    nbytes = (2 * q.numel() * elt + 2 * live_tok * kv * d * elt
              + int(live.sum()) * 4 + b * 4)
    flops = 4.0 * live_tok * h * d
    return dict(args_kernel=(q, kp, vp, poisoned, lens),
                args_plain=(q, kp, vp, sane, lens),
                real=lambda out: out,
                zero_rows=[i for i, n in enumerate(lengths) if n == 0],
                nbytes=nbytes, flops=flops, library=None)


def _segments(t, lens):
    seg = np.full((t,), len(lens), np.int32)
    starts = np.zeros((len(lens),), np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[off:off + n] = i
        starts[i] = off
        off += n
    return seg, starts, off


def _flash_case(torch, gen, dev, dtype, h, kv, d, t=3072,
                lens=(900, 700, 512, 300, 64, 200, 17, 100), window=0):
    from repro_torch.models.layers import packed_positions
    seg_np, starts_np, n_real = _segments(t, lens)
    seg = torch.from_numpy(seg_np).to(dev)
    starts = torch.from_numpy(starts_np).to(dev)
    slens = torch.tensor(lens, dtype=torch.int32, device=dev)
    pos = packed_positions(seg, starts)
    q = torch.randn(1, t, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(1, t, kv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(1, t, kv, d, generator=gen, device=dev).to(dtype)
    row_len = 1 << max(0, max(lens) - 1).bit_length()
    seg_all = np.full((t,), len(lens), np.int64)
    seg_all[:n_real] = seg_np[:n_real]
    # visible pairs, counted from the segment layout (padding tokens
    # attend each other too, and the kernel computes them)
    runs = list(lens) + ([t - n_real] if t > n_real else [])
    if window:
        pairs = sum(sum(min(i + 1, window) for i in range(n)) for n in runs)
    else:
        pairs = sum(n * (n + 1) // 2 for n in runs)
    elt = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * elt + t * 4
    flops = 4.0 * pairs * h * d

    def library():
        import torch.nn.functional as F
        ids = torch.from_numpy(seg_all).to(dev)
        i = torch.arange(t, device=dev)
        mask = (ids[:, None] == ids[None, :]) & (i[None, :] <= i[:, None])
        if window:
            mask &= (i[:, None] - i[None, :]) < window
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kw = {"enable_gqa": True} if kv != h else {}
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask[None, None], **kw)

    return dict(args_kernel=(q, k, v, seg), kernel_kw={"window": window},
                args_plain=(q, k, v, seg, pos, starts, slens),
                plain_kw={"row_len": row_len, "window": window},
                real=lambda out: out[:, :n_real], zero_rows=[],
                nbytes=nbytes, flops=flops, library=library)


def _chunk_case(torch, gen, dev, dtype, h, kv, d, ps=16, max_pages=64,
                r=512, hist=(0, 512, 388, 0), slen=(512, 300, 129, 0),
                window=0):
    s = len(hist)
    n_pages = s * max_pages + 1
    q = torch.randn(s, r, h, d, generator=gen, device=dev).to(dtype)
    kc = torch.randn(s, r, kv, d, generator=gen, device=dev).to(dtype)
    vc = torch.randn(s, r, kv, d, generator=gen, device=dev).to(dtype)
    kp = torch.randn(n_pages, ps, kv, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(n_pages, ps, kv, d, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    tables = perm[:s * max_pages].reshape(s, max_pages).to(torch.int32)
    live = torch.tensor([-(-n // ps) for n in hist], device=dev)
    past = torch.arange(max_pages, device=dev)[None, :] >= live[:, None]
    poisoned = tables.masked_fill(past, 1 << 30).contiguous()
    sane = tables.masked_fill(past, 0).contiguous()
    hl = torch.tensor(hist, dtype=torch.int32, device=dev)
    sl = torch.tensor(slen, dtype=torch.int32, device=dev)
    elt = q.element_size()
    rows = sum(slen)
    # the history keys some real row sees, and the visible (row, key) pairs
    seen = sum(n - (max(0, n - window + 1) if window else 0)
               for n, m in zip(hist, slen) if m)
    pairs = sum(min(n + i + 1, window or n + i + 1)
                for n, m in zip(hist, slen) for i in range(m))
    nbytes = ((2 * rows * h + 2 * rows * kv) * d * elt
              + 2 * max(0, seen) * kv * d * elt
              + int(live.sum()) * 4 + 2 * s * 4)
    flops = 4.0 * pairs * h * d

    def real(out):
        return torch.cat([out[i, :m] for i, m in enumerate(slen)])

    pad_rows = [(i, m) for i, m in enumerate(slen) if m < r]
    return dict(args_kernel=(q, kp, vp, kc, vc, poisoned, hl, sl),
                args_plain=(q, kp, vp, kc, vc, sane, hl, sl),
                kernel_kw={"window": window}, plain_kw={"window": window},
                real=real,
                pad_rows=pad_rows, nbytes=nbytes, flops=flops, library=None)


def _ring_decode_case(torch, gen, dev, dtype, h, kv, d, c=4096,
                      lengths=(0, 1, 256, 512, 1024, 1500, 2048, 4096)):
    """bench_decode --quick's ragged shape: 8 rows of a 4096-row cache,
    lengths from 0 to C. ``lengths="split edges"``: ``_split_edges`` of
    C."""
    if lengths == "split edges":
        lengths = _split_edges(kv, c)
    b = len(lengths)
    q = torch.randn(b, h, d, generator=gen, device=dev).to(dtype)
    kc = torch.randn(b, c, kv, d, generator=gen, device=dev).to(dtype)
    vc = torch.randn(b, c, kv, d, generator=gen, device=dev).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    elt = q.element_size()
    live_tok = sum(lengths)
    nbytes = 2 * q.numel() * elt + 2 * live_tok * kv * d * elt + b * 4

    def library():
        import torch.nn.functional as F
        rows = [i for i, n in enumerate(lengths) if n > 0]
        idx = torch.tensor(rows, device=dev)
        mask = (torch.arange(c, device=dev)[None, :]
                < lens[idx].long()[:, None])[:, None, None, :]
        qt = q[idx][:, :, None, :]                      # (B', H, 1, D)
        kt, vt = kc[idx].transpose(1, 2), vc[idx].transpose(1, 2)
        kw = {"enable_gqa": True} if kv != h else {}
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, **kw)

    return dict(args_kernel=(q, kc, vc, lens), args_plain=(q, kc, vc, lens),
                real=lambda out: out,
                zero_rows=[i for i, n in enumerate(lengths) if n == 0],
                nbytes=nbytes, flops=4.0 * live_tok * h * d,
                library=library)


def _dense_flash_case(torch, gen, dev, dtype, h, kv, d, b=8, s=1000,
                      causal=True, window=0, sq=None):
    """b rows of s keys; ``sq`` queries per row where they differ
    (cross-attention, non-causal), else s."""
    sq = sq or s
    q = torch.randn(b, sq, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, s, kv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, s, kv, d, generator=gen, device=dev).to(dtype)
    i = np.arange(sq)
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    hi = i if causal else np.full_like(i, s - 1)
    pairs = int((hi - lo + 1).sum()) * b            # visible (i, j) per head
    elt = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * elt
    kw = {"causal": causal, "window": window}

    def library():
        import torch.nn.functional as F
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        extra = {"enable_gqa": True} if kv != h else {}
        if window:
            ii = torch.arange(s, device=dev)
            mask = ii[:, None] - ii[None, :] < window
            if causal:
                mask &= ii[None, :] <= ii[:, None]
            extra["attn_mask"] = mask
        else:
            extra["is_causal"] = causal
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, **extra)

    return dict(args_kernel=(q, k, v), kernel_kw=kw, args_plain=(q, k, v),
                plain_kw=kw, real=lambda out: out, nbytes=nbytes,
                flops=4.0 * pairs * h * d, library=library)


def phase_a(torch, timing_model: str = "olmo-1b"):
    from repro_torch.kernels import chunk_attention, decode_attention
    from repro_torch.kernels import flash_attention, paged_attention
    dev = torch.device("cuda")
    kernels = {
        "paged_decode_attention": (
            paged_attention.paged_decode_attention_cuda,
            paged_attention.paged_decode_attention_plain, _decode_case,
            "src/repro_torch/kernels/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention.py:44"),
        "segment_flash_attention": (
            flash_attention.segment_flash_attention_cuda,
            flash_attention.segment_flash_attention_plain, _flash_case,
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:89"),
        "paged_chunk_attention": (
            chunk_attention.paged_chunk_attention_cuda,
            chunk_attention.paged_chunk_attention_plain, _chunk_case,
            "src/repro_torch/kernels/csrc/chunk_attention.cu",
            "src/repro/kernels/chunk_attention.py:38"),
        "decode_attention": (
            decode_attention.decode_attention_cuda,
            decode_attention.decode_attention_plain, _ring_decode_case,
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:43"),
        "flash_attention": (
            flash_attention.flash_attention_cuda,
            flash_attention.flash_attention_plain, _dense_flash_case,
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:30"),
    }
    extra = {  # further shapes checked for correctness only
        "segment_flash_attention": [
            dict(t=48, lens=(20, 13, 9)),                  # ragged T
            dict(t=96, lens=(40, 17, 30), window=16),      # window
            dict(t=1536, lens=(1000, 5, 300)),             # 3·2^9 bucket
            dict(t=1536, lens=(1000, 5, 300), window=200)],  # full tiles
        "paged_chunk_attention": [
            dict(r=8, hist=(13, 0), slen=(8, 3), ps=8, max_pages=4),
            dict(r=129, hist=(388,), slen=(129,)),          # hist 388 alone
            dict(hist=(0, 512, 388), slen=(512, 300, 129),  # window
                 window=256),
            dict(r=5, hist=(2000,) * 8, slen=(5,) * 8,      # spec verify
                 max_pages=128),
            dict(r=5, hist=(128, 146, 165, 183, 201, 219, 238, 256),
                 slen=(5,) * 8, max_pages=32),              # (h2)'s verify
            dict(r=200, hist=(388, 0), slen=(200, 65), ps=24,  # page 24
                 max_pages=32)],
        "paged_decode_attention": [
            dict(ps=8, max_pages=128),
            dict(lengths="split edges"),                   # splits +-1
            dict(max_pages=1024, lengths=(16384,)),        # 1024 pages
            dict(ps=24, max_pages=48,                      # page 24
                 lengths=(0, 1, 23, 24, 25, 500, 1151, 1152))],
        "decode_attention": [
            dict(c=200, lengths=(200, 0, 137, 1)),
            dict(c=16384, lengths=(16384,)),               # B 1, long row
            dict(lengths="split edges"),                   # splits +-1
            dict(lengths=tuple(range(2000, 2065, 9)))],    # generate's
        "flash_attention": [
            dict(s=2048),                                  # causal, 2^11
            dict(s=1000, window=256),                      # window
            dict(s=512, causal=False),                     # non-causal
            dict(s=1000, window=100),                      # mid-tile start
            *[dict(s=n) for n in (1, 63, 64, 65, 127, 128, 129)]],
    }
    # (kernel, model, heads, [(label, shape)]): every kernel at the serving
    # heads with its further shapes, then the dense configs' main shapes
    # and whisper-small's cases
    runs = []
    for name in kernels:
        for model, heads in HEADS.items():
            runs.append((name, model, heads, [("main", {})] + [
                (kw, kw) for kw in extra[name]]))
        if name in DENSE_KERNELS:
            runs += [(name, model, heads, [("main", {})])
                     for model, heads in DENSE_HEADS.items()]
            runs.append((name, "zamba2-7b", ZAMBA_HEADS,
                         ZAMBA_SHAPES.get(name, [("main", {})])))
        if name in WHISPER_CASES:
            runs.append((name, "whisper-small", WHISPER_HEADS,
                         list(WHISPER_CASES[name].items())))
    rows, summary = [], {}
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = _l2_flush(torch, dev)
    for name, model, (h, kv, d), shapes in runs:
        cuda_fn, plain_fn, make, source, replaces = kernels[name]
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            for label, kw in shapes:
                case = make(torch, gen, dev, dtype, h, kv, d, **kw)
                kout = cuda_fn(*case["args_kernel"],
                               **case.get("kernel_kw", {}))
                pout = plain_fn(*case["args_plain"],
                                **case.get("plain_kw", {}))
                torch.cuda.synchronize()
                got = case["real"](kout).float()
                want = case["real"](pout).float()
                assert torch.isfinite(got).all(), (name, model, dname)
                err = float((got - want).abs().max())
                atol, rtol = TOL[dname]
                ok = bool(torch.allclose(got, want, atol=atol,
                                         rtol=rtol))
                for rix in case.get("zero_rows", []):
                    ok &= bool((kout[rix] == 0).all())
                for i, m in case.get("pad_rows", []):
                    ok &= bool((kout[i, m:] == 0).all())
                row = {"kernel": name, "model": model, "dtype": dname,
                       "shape": label, "max_abs_err": err, "ok": ok}
                rows.append(row)
                if dname == "float32" and model not in HEADS:
                    # the further heads' float32 rows check correctness
                    # only: their timings would stretch the phase
                    _log(json.dumps(row))
                    del case, kout, pout
                    continue
                run_k = lambda: cuda_fn(*case["args_kernel"],  # noqa
                                        **case.get("kernel_kw", {}))
                run_p = lambda: plain_fn(*case["args_plain"],  # noqa
                                         **case.get("plain_kw", {}))
                row.update(_timings(run_k, torch, flush))
                row["plain_ms"] = _time_ms(run_p, torch, iters=5)
                row["bound_ms"], row["bound_by"] = _bound_ms(
                    case["nbytes"], case["flops"], dname)
                lib = case["library"]
                row.update(_timings(lib(), torch, flush, "library_ms")
                           if lib is not None else
                           {"library_ms": None})
                timed = {k: row[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}
                if label == "main" and model == timing_model \
                        and dname == "bfloat16":
                    summary[name] = {
                        "name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "max_abs_err": err,
                        **timed}
                elif model == "whisper-small" and dname == "bfloat16":
                    # whisper's cases ride on the kernel's entry
                    summary[name].setdefault("cases", {})[label] = {
                        "shape": kw, "max_abs_err": err, **timed}
                elif model == "zamba2-7b" and dname == "bfloat16":
                    # so do zamba2's, at head_dim 112
                    summary[name].setdefault("cases", {})[
                        f"zamba2-7b {label}"] = {
                        "heads": ZAMBA_HEADS, "shape": kw,
                        "max_abs_err": err, **timed}
                _log(json.dumps(row))
                del case, kout, pout
    for model in SSD_HEADS:
        ssd_rows, timed = _ssd_cases(torch, gen, dev, flush, model)
        rows += ssd_rows
        if model == "mamba2-1.3b":
            summary["ssd_scan"] = {
                "name": "ssd_scan", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
                "replaces": "src/repro/kernels/ssd_scan.py:28", **timed}
        else:
            summary["ssd_scan"].setdefault("cases", {})[f"{model} main"] = {
                "heads": SSD_HEADS[model], **timed}
    bwd_rows, summary["flash_attention_bwd"] = _bwd_cases(torch, gen, dev,
                                                          flush)
    rows += bwd_rows
    bad = [r for r in rows if not r["ok"]]
    _emit({"phase": "a", "cases": len(rows), "failed": len(bad),
           "max_abs_err": {
               f"{r['kernel']}/{r['model']}/{r['dtype']}" + (
                   "" if r["shape"] == "main" else f"/{r['shape']}"):
               r["max_abs_err"] for r in rows
               if r["shape"] == "main" or r["model"] == "whisper-small"}
           | {f"flash_attention_bwd/{r['model']}/{r['dtype']}": r["errs"]
              for r in bwd_rows}})
    assert not bad, f"kernel disagrees with its plain version: {bad}"
    return rows, summary


# --------------------------------------------------------------------------
# phase (a): the flash backward (training) against its plain version
# --------------------------------------------------------------------------
# (label, heads (H, KV, D), B, S, Sk, causal, window): qwen2-0.5b and
# olmo-1b at a training step's shape, a ragged S, a window, whisper's
# cross shape; then correctness-only ragged edges
BWD_CASES = [
    ("qwen2-0.5b main", HEADS["qwen2-0.5b"], 8, 2048, 2048, True, 0),
    ("olmo-1b main", HEADS["olmo-1b"], 4, 2048, 2048, True, 0),
    ("ragged 1000", HEADS["qwen2-0.5b"], 8, 1000, 1000, True, 0),
    ("window 512", HEADS["olmo-1b"], 4, 2048, 2048, True, 512),
    ("whisper cross", WHISPER_HEADS, 8, 224, 1536, False, 0)]
BWD_EDGES = [(f"S {s}", HEADS["qwen2-0.5b"], 2, s, s, True, 0)
             for s in (1, 63, 65, 129)] + [
    ("cross S 70 Sk 130", HEADS["olmo-1b"], 2, 70, 130, False, 0)]
# max |kernel - plain| <= this * max(1, max |plain|), per gradient; the lse
# within a tenth of it (float32: sums of up to S terms in another order;
# bfloat16: both widen the same bf16 inputs, sum in float32 and round each
# gradient once)
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
BWD_TIMED = "olmo-1b main"       # the kernels line's headline case


def _bwd_case(torch, gen, dev, dtype, h, kv, d, b, s, sk, causal, window):
    """Inputs of one backward case, #5's output and lse on them, and the
    case's bytes, operations and SDPA backward."""
    from repro_torch.kernels import flash_attention
    q = torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, sk, kv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, sk, kv, d, generator=gen, device=dev).to(dtype)
    dout = torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
    kw = dict(causal=causal, window=window)
    out, lse = flash_attention.flash_attention_cuda(q, k, v, lse=True, **kw)
    i = np.arange(s)
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    hi = np.minimum(i, sk - 1) if causal else np.full_like(i, sk - 1)
    pairs = int((hi - lo + 1).sum()) * b * h        # visible (i, j, head)
    elt = q.element_size()
    # read q, k, v, out, dout and lse once, write dq, dk and dv once
    nbytes = (4 * q.numel() + 4 * k.numel()) * elt + 4 * lse.numel()
    # 2.5 times the forward's 4 * pairs * D
    flops = 2.5 * 4.0 * pairs * d

    def library():
        import torch.nn.functional as F
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        extra = {"enable_gqa": True} if kv != h else {}
        if window:
            ii = torch.arange(s, device=dev)
            mask = ii[:, None] - ii[None, :] < window
            if causal:
                mask &= ii[None, :] <= ii[:, None]
            extra["attn_mask"] = mask
        else:
            extra["is_causal"] = causal
        o = F.scaled_dot_product_attention(qt, kt, vt, **extra)
        go = dout.transpose(1, 2)
        return lambda: torch.autograd.grad(o, (qt, kt, vt), go,
                                           retain_graph=True)

    return dict(q=q, k=k, v=v, out=out, dout=dout, lse=lse, kw=kw,
                nbytes=nbytes, flops=flops, library=library)


def _bwd_cases(torch, gen, dev, flush):
    """Each backward case in float32 and bf16: #5's lse against the plain
    forward's, the kernel's dq, dk, dv against the plain backward's from
    the same output and lse; the main cases timed beside their bound, the
    plain version and SDPA's backward. Returns (rows, the kernels line's
    entry)."""
    from repro_torch.kernels import flash_vjp
    rows, timed = [], {}
    for label, (h, kv, d), b, s, sk, causal, window in BWD_CASES + BWD_EDGES:
        for dname in ("float32", "bfloat16"):
            c = _bwd_case(torch, gen, dev, getattr(torch, dname), h, kv, d,
                          b, s, sk, causal, window)
            args = (c["q"], c["k"], c["v"], c["out"], c["dout"], c["lse"])
            got = flash_vjp.flash_attention_bwd_cuda(*args, **c["kw"])
            want = flash_vjp.flash_bwd_plain(*args, **c["kw"])
            _, lse_plain = flash_vjp.flash_fwd_plain(
                c["q"], c["k"], c["v"], **c["kw"])
            torch.cuda.synchronize()
            tol = BWD_TOL[dname]
            errs, ok = {}, True
            for name, g, w, t in (("dq", got[0], want[0], tol),
                                  ("dk", got[1], want[1], tol),
                                  ("dv", got[2], want[2], tol),
                                  ("lse", c["lse"], lse_plain, tol / 10)):
                g, w = g.float(), w.float()
                errs[name] = float((g - w).abs().max())
                ok &= bool(torch.isfinite(g).all()) and errs[name] <= t * max(
                    1.0, float(w.abs().max()))
            row = {"kernel": "flash_attention_bwd", "model": label,
                   "dtype": dname, "shape": dict(b=b, s=s, sk=sk, heads=(
                       h, kv, d), causal=causal, window=window),
                   "max_abs_err": max(errs[n] for n in ("dq", "dk", "dv")),
                   "errs": errs, "ok": ok}
            rows.append(row)
            if (label, (h, kv, d)) in [(x[0], x[1]) for x in BWD_CASES]:
                row.update(_timings(lambda: flash_vjp.flash_attention_bwd_cuda(
                    *args, **c["kw"]), torch, flush))
                row["plain_ms"] = _time_ms(lambda: flash_vjp.flash_bwd_plain(
                    *args, **c["kw"]), torch, iters=3)
                row["bound_ms"], row["bound_by"] = _bound_ms(
                    c["nbytes"], c["flops"], dname)
                row.update(_timings(c["library"](), torch, flush,
                                    "library_ms"))
                if dname == "bfloat16":
                    timed[label] = {"shape": row["shape"],
                                    "max_abs_err": row["max_abs_err"],
                                    **{k: row[k] for k in (
                                        "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")}}
            _log(json.dumps(row))
            del c, got, want
    entry = {"name": "flash_attention_bwd", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_backward.cu",
             "replaces": "src/repro/kernels/flash_vjp.py:101 (_bwd_impl, "
                         "plain jnp: no Pallas kernel)",
             **timed.pop(BWD_TIMED), "cases": timed}
    return rows, entry


def _ssd_bound(b, lens, h, p, n, cl, dname):
    """Least time for one scan: each input read and each output written
    once, and the operations the data needs — per chunk of r real rows and
    head, the lower triangle of C·B^T and of its product with x·dt
    (r (r + 1) / 2 pairs, 2 (N + P) flops each) and the two (r, N, P)
    products of the state (4 r N P)."""
    elt = 4 if dname == "float32" else 2
    rows = sum(lens)
    nbytes = (2 * rows * h * p * elt + 2 * rows * n * elt + rows * h * 4
              + h * 4 + b * h * n * p * 4)
    flops = 0.0
    for length in lens:
        for t0 in range(0, length, cl):
            r = min(cl, length - t0)
            flops += h * (r * (r + 1) / 2 * 2 * (n + p) + 4 * r * n * p)
    return _bound_ms(nbytes, flops, dname)


def _ssd_cases(torch, gen, dev, flush, model):
    """The SSD scan against its plain version at ``model``'s heads
    (``SSD_HEADS``), in float32 and bfloat16: the main shape (B 8, L
    2048), a ragged L, L < chunk, and packed rows whose tails carry dt =
    0, whose final states must equal their unpadded runs' bit for bit.
    Returns the rows and the main bfloat16 row's error and times."""
    from repro_torch.kernels import ssd_scan
    h, p, n, chunk = SSD_HEADS[model]
    rows, summary = [], None
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for shape, (b, length) in (("main", (8, 2048)), ("L 1000", (4, 1000)),
                                   ("L 100", (2, 100))):
            x = torch.randn(b, length, h, p, generator=gen,
                            device=dev).to(dtype)
            dt = torch.nn.functional.softplus(
                torch.randn(b, length, h, generator=gen, device=dev) - 1.0)
            a = -torch.exp(0.5 * torch.randn(h, generator=gen, device=dev))
            bb = torch.randn(b, length, n, generator=gen, device=dev).to(dtype)
            cc = torch.randn(b, length, n, generator=gen, device=dev).to(dtype)
            args = (x, dt, a, bb, cc, chunk)
            ky, ks = ssd_scan.ssd_scan_cuda(*args)
            py, ps = ssd_scan.ssd_chunked_plain(*args)
            torch.cuda.synchronize()
            ok = bool(torch.isfinite(ky.float()).all()
                      and torch.isfinite(ks).all())
            errs = []
            for got, want, kind in ((ky, py, dname), (ks, ps, "float32")):
                got, want = got.float(), want.float()
                err = float((got - want).abs().max())
                errs.append(err)
                if kind == "float32":
                    ok &= err <= SSD_F32_TOL * max(
                        1.0, float(want.abs().max()))
                else:
                    ok &= bool(torch.allclose(got, want,
                                              atol=TOL[kind][0],
                                              rtol=TOL[kind][1]))
            row = {"kernel": "ssd_scan", "model": model,
                   "dtype": dname, "shape": shape,
                   "max_abs_err": max(errs),
                   "plain_max_abs": float(py.float().abs().max()), "ok": ok}
            if shape == "main":
                row.update(_timings(
                    lambda: ssd_scan.ssd_scan_cuda(*args), torch, flush))
                row["plain_ms"] = _time_ms(
                    lambda: ssd_scan.ssd_chunked_plain(*args), torch,
                    iters=5)
                row["bound_ms"], row["bound_by"] = _ssd_bound(
                    b, [length] * b, h, p, n, chunk, dname)
                row["library_ms"] = None
                if dname == "bfloat16":
                    summary = {
                        "max_abs_err": row["max_abs_err"],
                        **{k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")}}
            rows.append(row)
            _log(json.dumps(row))
            del x, dt, bb, cc, args, ky, ks, py, ps
        # packed rows: tails of dt = 0 freeze the state exactly
        lens, row_len = (2048, 1000, 1500, 130), 2048
        b = len(lens)
        x = torch.randn(b, row_len, h, p, generator=gen, device=dev).to(dtype)
        dt = torch.nn.functional.softplus(
            torch.randn(b, row_len, h, generator=gen, device=dev) - 1.0)
        for i, length in enumerate(lens):
            dt[i, length:] = 0.0
        a = -torch.exp(0.5 * torch.randn(h, generator=gen, device=dev))
        bb = torch.randn(b, row_len, n, generator=gen, device=dev).to(dtype)
        cc = torch.randn(b, row_len, n, generator=gen, device=dev).to(dtype)
        _, ks = ssd_scan.ssd_scan_cuda(x, dt, a, bb, cc, chunk)
        same = []
        for i, length in enumerate(lens):
            one = [v[i:i + 1, :length].contiguous() for v in (x, dt)] + [a] \
                + [v[i:i + 1, :length].contiguous() for v in (bb, cc)]
            same.append(bool(torch.equal(
                ks[i:i + 1], ssd_scan.ssd_scan_cuda(*one, chunk)[1])))
        torch.cuda.synchronize()
        rows.append({"kernel": "ssd_scan", "model": model,
                     "dtype": dname, "shape": f"packed {lens} dt=0 tails",
                     "max_abs_err": 0.0, "states_bit_identical": same,
                     "ok": all(same)})
        _log(json.dumps(rows[-1]))
    return rows, summary


# --------------------------------------------------------------------------
# phase (b): the paged serving path
# --------------------------------------------------------------------------
def _requests(n, prompt_range, budget_range, vocab, seed, model="olmo-1b"):
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(seed)
    reqs, prompts = [], {}
    for i in range(n):
        p = int(rng.integers(*prompt_range))
        nt = int(rng.integers(*budget_range))
        reqs.append(Request(arrival=0.0, rid=i, model=model, slo=1e9,
                            n_tokens=nt, prompt_len=p))
        prompts[i] = rng.integers(1, vocab, size=(1, p)).astype(np.int32)
    return reqs, prompts


def _prompt_batch(prompt):
    """A prompt's batch: its tokens, or the batch itself where the prompt
    carries more (an encoder model's frames)."""
    return prompt if isinstance(prompt, dict) else {"tokens": prompt}


def _serve(eng, reqs, prompts, chunk_tokens, telemetry=None, **planner_kw):
    import copy
    from repro_torch.serving.plan import (PlannerConfig, StepPlanner,
                                          serve_ticks)
    from repro_torch.serving.request import RequestQueue
    eng.release_all_slots()
    eng.reset_stats()
    planner = StepPlanner(eng, RequestQueue(reqs[0].model, slo=1e9),
                          PlannerConfig(chunk_tokens=chunk_tokens,
                                        **planner_kw))
    planner.telemetry = telemetry
    eng.attach_telemetry(telemetry)
    try:
        srv = serve_ticks(planner, copy.deepcopy(reqs),
                          lambda r: _prompt_batch(prompts[r.rid]))
    finally:
        eng.attach_telemetry(None)
    assert not srv.truncated
    return {r: list(t) for r, t in planner.streams.items()}, srv


def _walls(srv):
    """Tick wall time p50 and p99 of a serve, in ms."""
    walls = sorted(w for w, _ in srv.tick_walls)
    return (1e3 * walls[len(walls) // 2],
            1e3 * walls[min(len(walls) - 1, int(0.99 * len(walls)))])


def _launch_counts():
    from repro_torch.kernels import ops
    return ops.launch_counts()


def _reset_launch_counts():
    from repro_torch.kernels import ops
    ops.reset_launch_counts()


def _check_launches(launches, ran, phase):
    """Every kernel in ``ran`` launched during the path, no other did."""
    want = {n: n in ran for n in KERNEL_NAMES}
    got = {n: launches[n] > 0 for n in KERNEL_NAMES}
    assert got == want, f"phase {phase}: launches {launches}, expected " \
        f"exactly {sorted(ran)} to run"


PAGED_PATH = ("paged_decode_attention", "segment_flash_attention",
              "paged_chunk_attention")
RING_PATH = ("segment_flash_attention", "decode_attention")
GENERATE_PATH = ("flash_attention", "decode_attention")
SSM_PATH = ("ssd_scan",)
POOL_PATH = ("paged_decode_attention", "segment_flash_attention",
             "ssd_scan")
# the timed turns of a path on one engine: graphs off, on, on, off
MODES = ("eager", "graphed", "graphed", "eager")


def _captures(eng):
    return sum(eng.jit_cache_sizes().values())


def _turns(torch, eng, run, n_tokens, ran, phase):
    """``run()`` drives one path on ``eng`` and returns (its tokens, its
    ``TickServer`` or None). One graphed run first meets the path's
    buckets — it captures them and is not timed; then the path runs in
    the turns of ``MODES`` on the same engine, each timed, with the
    launch counts at 0 just before it and the captures counted over it.
    Every turn must give the first run's tokens, launch exactly the
    path's kernels (replays count) and capture nothing. Returns (tokens,
    the first run's captures, the turns)."""
    eng.graphs = True
    c0 = _captures(eng)
    t0 = time.perf_counter()
    want, _ = run()
    torch.cuda.synchronize()
    warm_captures = _captures(eng) - c0
    _log(json.dumps({f"{phase}/first run": {
        "captures": warm_captures, "s": time.perf_counter() - t0}}))
    turns = []
    for mode in MODES:
        eng.graphs = mode == "graphed"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c0 = _captures(eng)
        _reset_launch_counts()
        t0 = time.perf_counter()
        got, srv = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        turn = {"mode": mode, "wall_s": wall,
                "tokens_per_s": n_tokens / wall,
                "captures": _captures(eng) - c0,
                "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                "launches": _launch_counts()}
        if srv is not None:
            turn["tick_ms_p50"], turn["tick_ms_p99"] = _walls(srv)
            turn["ticks"], turn["dispatches"] = srv.ticks, srv.dispatches
        _log(json.dumps({f"{phase}/turn": turn}))
        assert got == want, f"phase {phase}: the {mode} run changed tokens"
        assert turn["captures"] == 0, f"phase {phase}: a timed run captured"
        _check_launches(turn["launches"], ran, f"{phase}/{mode}")
        turns.append(turn)
    eng.graphs = True
    return want, warm_captures, turns


def _by_mode(turns, key):
    """``key`` of the turns, graphed and eager, in turn order."""
    return {m: [t[key] for t in turns if t["mode"] == m]
            for m in ("graphed", "eager")}


def _profiles(torch, eng, run, want):
    """One more run of the path under ``torch.profiler`` graphed and one
    eager; each must give ``want`` and capture nothing."""
    out = {}
    for mode in ("graphed", "eager"):
        eng.graphs = mode == "graphed"
        c0 = _captures(eng)
        got, out[mode] = _profile(torch, run)
        assert got == want and _captures(eng) == c0, mode
    eng.graphs = True
    return out


def _busy(profile, turns):
    """The device's busy share of each mode: the profiled run's device
    time over the mean wall of that mode's timed (unprofiled) turns."""
    walls = _by_mode(turns, "wall_s")
    return {m: p["device_ms"] / (1e3 * sum(walls[m]) / len(walls[m]))
            for m, p in profile.items()}


def _graph_report(eng, warm_captures, turns):
    return {"warm_captures": warm_captures,
            "timed_captures": [t["captures"] for t in turns],
            "jit_cache_sizes": eng.jit_cache_sizes(),
            "pool_bytes": eng.graph_pool_bytes()}


def _serve_phase(torch, phase, eng, reqs, prompts, ran):
    """Phase (b)/(e)/(f)'s serve of ``reqs`` on ``eng`` in turns, then
    profiled in both modes. Returns the phase's report and the streams."""
    cfg = eng.cfg
    n_tok = sum(r.n_tokens for r in reqs)

    def run():
        return _serve(eng, reqs, prompts, chunk_tokens=512)

    streams, warm, turns = _turns(torch, eng, run, n_tok, ran, phase)
    for r in reqs:
        s = streams[r.rid]
        assert len(s) == r.n_tokens, (r.rid, len(s), r.n_tokens)
        assert all(0 <= t < cfg.vocab_size for t in s), r.rid
    profile = _profiles(torch, eng, lambda: run()[0], streams)
    graphed = next(t for t in turns if t["mode"] == "graphed")
    out = {"phase": phase, "model": cfg.name, "dtype": "bfloat16",
           "layers": cfg.num_layers, "params": cfg.param_count(),
           "requests": len(reqs),
           "prompt_tokens": sum(r.prompt_len for r in reqs),
           "tokens_served": n_tok, "ticks": graphed["ticks"],
           "dispatches": graphed["dispatches"],
           **{k: _by_mode(turns, k) for k in (
               "tokens_per_s", "tick_ms_p50", "tick_ms_p99",
               "peak_mem_bytes")},
           "busy_share": _busy(profile, turns),
           "graphs": _graph_report(eng, warm, turns),
           "kv_cache_bytes": eng.kv_cache_bytes(),
           "stats": dataclasses.asdict(eng.stats),
           "launches": graphed["launches"], "turns": turns,
           "profile": profile}
    return out, streams


def phase_b(torch):
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import make_engine
    cfg = get_config("olmo-1b")
    t0 = time.perf_counter()
    eng = make_engine(cfg, seed=0, cache_len=1024, dtype=torch.bfloat16,
                      device="cuda").init_slots(8, page_size=16)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reqs, prompts = _requests(16, (64, 901), (16, 65), cfg.vocab_size, 0)
    out, streams = _serve_phase(torch, "b", eng, reqs, prompts, PAGED_PATH)
    st = eng.stats
    assert st.incr_chunks > 0 and st.packed_prefills > st.incr_chunks
    out["setup_s"] = setup_s
    _emit(out)
    del eng
    torch.cuda.empty_cache()
    return out, streams


def _profile(torch, run, top: int = 12):
    """Run ``run`` once more under ``torch.profiler`` (device activity
    only: the host's is not read, and recording it doubles the time the
    trace takes to read back). Returns its result and the device time by
    kernel (the largest ``top``), the total, and the device's busy share
    of the profiled run's wall time. The kernels' times are summed from
    the profiler's raw events: ``key_averages()`` builds an event object
    for each of them first, ~18x slower (50,000 kernels on an H100 host:
    9.3 s against 0.53 s)."""
    from torch.profiler import ProfilerActivity, profile
    t1 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    totals = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        ms, count = totals.get(e.name(), (0.0, 0))
        totals[e.name()] = (ms + e.duration_ns() / 1e6, count + 1)
    kernels, port = [], {}
    for key, (ms, count) in totals.items():
        kernels.append((ms, count, key[:90]))
        symbol = re.search(r"(\w+)[<(]", key)
        for name, symbols in PORT_SYMBOLS.items():
            if symbol and symbol.group(1) in symbols:
                got = port.setdefault(name, {"ms": 0.0, "by_symbol": {}})
                got["ms"] += ms
                sym = got["by_symbol"].setdefault(
                    symbol.group(1), {"ms": 0.0, "count": 0})
                sym["ms"] += ms
                sym["count"] += count
    kernels.sort(reverse=True)
    device_ms = sum(ms for ms, _, _ in kernels)
    _log(f"profiled in {time.perf_counter() - t1:.1f} s")
    return out, {"wall_ms": 1e3 * wall, "device_ms": device_ms,
                 "device_busy_share": device_ms / (1e3 * wall),
                 "top": [{"kernel": k, "ms": ms, "count": n}
                         for ms, n, k in kernels[:top]],
                 "port_kernels": port}


# --------------------------------------------------------------------------
# phase (d): batch generate; phase (e): ring serve
# --------------------------------------------------------------------------
def _generate_turns(torch, eng, tokens, ran, phase, profile=False,
                    frames=None, n_new=64):
    """Batch ``generate`` of ``tokens`` (and an encoder model's
    ``frames``) with ``n_new`` new tokens each, in turns (``_turns``), and
    the padded prefill alone once more for the split of the wall time.
    Returns the run's report."""
    batch = {"tokens": tokens}
    if frames is not None:
        batch["enc_embeds"] = frames

    def run():
        return eng.generate(batch, n_new).cpu().tolist(), None

    b, s = tokens.shape
    out, warm, turns = _turns(torch, eng, run, b * n_new, ran, phase)
    assert np.shape(out) == (b, n_new), np.shape(out)
    assert all(0 <= t < eng.cfg.vocab_size for row in out for t in row)
    t1 = time.perf_counter()
    eng.prefill(batch, eng.bucket_len(s + n_new))
    torch.cuda.synchronize()
    row = {"model": eng.cfg.name, "batch": b, "prompt_len": s,
           "new_tokens": n_new, "prefill_s": time.perf_counter() - t1,
           "cache_len": eng.bucket_len(s + n_new),
           **{k: _by_mode(turns, k) for k in (
               "wall_s", "tokens_per_s", "peak_mem_bytes")},
           "graphs": _graph_report(eng, warm, turns),
           "launches": next(t for t in turns
                            if t["mode"] == "graphed")["launches"],
           "turns": turns}
    if profile:
        row["profile"] = _profiles(torch, eng, lambda: run()[0], out)
        row["busy_share"] = _busy(row["profile"], turns)
    _log(json.dumps({f"{phase}/generate": {
        k: v for k, v in row.items() if k not in ("turns", "profile")}}))
    return row


def phase_d(torch):
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import make_engine
    runs = [("olmo-1b", (128, 512, 1000, 2000)), ("qwen2-0.5b", (512,))]
    rows, total = [], {n: 0 for n in KERNEL_NAMES}
    rng = np.random.default_rng(3)
    for name, prompt_lens in runs:
        cfg = get_config(name)
        eng = make_engine(cfg, seed=0, cache_len=256, dtype=torch.bfloat16,
                          device="cuda")
        for s in prompt_lens:
            tokens = rng.integers(1, cfg.vocab_size, (8, s)).astype(np.int32)
            row = _generate_turns(torch, eng, tokens, GENERATE_PATH, "d",
                                  profile=(name, s) == ("olmo-1b", 2000))
            for n in KERNEL_NAMES:
                total[n] += row["launches"][n]
            rows.append(row)
        del eng
        torch.cuda.empty_cache()
    out = {"phase": "d", "runs": [
        {k: r[k] for k in ("model", "prompt_len", "wall_s", "tokens_per_s",
                           "prefill_s", "peak_mem_bytes", "graphs")}
        for r in rows],
        "busy_share": next(r["busy_share"] for r in rows if "profile" in r),
        "profile": next(r["profile"] for r in rows if "profile" in r),
        "launches": total}
    _emit(out)
    return dict(out, runs=rows)


def phase_e(torch, paged_streams=None):
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import make_engine
    cfg = get_config("olmo-1b")
    eng = make_engine(cfg, seed=0, cache_len=1024, dtype=torch.bfloat16,
                      device="cuda").init_slots(8, cache_len=1024,
                                                paged=False)
    assert not eng.paged
    reqs, prompts = _requests(16, (64, 901), (16, 65), cfg.vocab_size, 0)
    out, streams = _serve_phase(torch, "e", eng, reqs, prompts, RING_PATH)
    st = eng.stats
    assert st.chunk_prefills > 0 and st.incr_chunks == 0, st
    out["slots"] = "8 ring x 1024"
    out["streams_equal_to_paged"] = (
        None if paged_streams is None else
        sum(streams[r] == paged_streams[r] for r in streams))
    _emit(out)
    del eng
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase (f): the Mamba2 family
# --------------------------------------------------------------------------
# phase (f) runs mamba2-1.3b at full width but a quarter of its depth:
# with the later phases added, the whole script keeps inside its time
# limit that way (every layer is the same shape; it ran 24 before the
# experts' phase came)
SSM_LAYERS = 12


def phase_f(torch):
    """mamba2-1.3b at full width, bfloat16, seeded random weights, at
    ``SSM_LAYERS`` of its 48 layers: (i)
    phase (b)'s 16 requests through ``serve_ticks`` on 8 slots (paged
    slots asked for, per-slot state given), ``chunk_tokens=512``, so
    packed admissions and prefix-recompute continuations both run; (ii)
    batch ``generate`` of 8 prompts of 512 and of 2000 tokens, 64 new
    tokens each. Every prefill dispatch scans each layer through the
    kernel: launches = layers x prefill dispatches. Each runs in turns,
    graphed and eager."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import make_engine
    cfg = dataclasses.replace(get_config("mamba2-1.3b"),
                              num_layers=SSM_LAYERS)
    t0 = time.perf_counter()
    eng = make_engine(cfg, seed=0, cache_len=1024, dtype=torch.bfloat16,
                      device="cuda").init_slots(8)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    assert not eng.paged
    reqs, prompts = _requests(16, (64, 901), (16, 65), cfg.vocab_size, 0,
                              cfg.name)
    serve, _ = _serve_phase(torch, "f", eng, reqs, prompts, SSM_PATH)
    st = eng.stats
    assert serve["launches"]["ssd_scan"] == cfg.num_layers * st.prefills, \
        (serve["launches"], st)
    assert st.chunk_prefills > 0 and st.incr_chunks == 0, st
    serve["setup_s"] = setup_s
    serve["state_bytes"] = serve.pop("kv_cache_bytes")
    _log(json.dumps({"f/serve": {k: v for k, v in serve.items()
                                 if k not in ("turns", "profile")}}))
    total = dict(serve["launches"])
    runs = []
    rng = np.random.default_rng(5)
    for s in (512, 2000):
        tokens = rng.integers(1, cfg.vocab_size, (8, s)).astype(np.int32)
        row = _generate_turns(torch, eng, tokens, SSM_PATH, "f",
                              profile=s == 2000)
        assert all(t["launches"]["ssd_scan"] == cfg.num_layers
                   for t in row["turns"]), row["turns"]
        for name in KERNEL_NAMES:
            total[name] += row["launches"][name]
        runs.append(row)
    out = {"phase": "f", "model": cfg.name, "dtype": "bfloat16",
           "layers": cfg.num_layers, "params": cfg.param_count(),
           "serve": {k: serve[k] for k in (
               "tokens_served", "ticks", "tokens_per_s", "tick_ms_p50",
               "tick_ms_p99", "peak_mem_bytes", "busy_share", "graphs")},
           "generate": [{k: r[k] for k in (
               "prompt_len", "wall_s", "tokens_per_s", "prefill_s",
               "peak_mem_bytes", "graphs")} for r in runs],
           "busy_share": runs[-1]["busy_share"],
           "profile": runs[-1]["profile"], "launches": total}
    _emit(out)
    del eng
    torch.cuda.empty_cache()
    return dict(out, serve=serve, runs=runs)


# --------------------------------------------------------------------------
# phase (g): the D-STACK pool
# --------------------------------------------------------------------------
POOL_MODELS = ("qwen2-0.5b", "olmo-1b", "mamba2-1.3b")
POOL_POLICIES = ("temporal", "fixed_batch_mps", "maxmin", "dstack")
POOL_RATE = 150.0          # requests/s per model
POOL_DURATION = 0.4        # virtual seconds: ~60 requests per model
POOL_GEN = 4               # tokens per request


def _pool_serve(pool, policy):
    """Serve ``policy`` over ``pool`` on seeded arrivals. Returns the
    controller, the result and every admission: (model, asked units,
    granted units, batch, request ids)."""
    from repro_torch.core.scheduler import POLICIES
    from repro_torch.serving.controller import (Controller, ControllerConfig,
                                                make_generators)
    pool.reset()
    log = []
    admit = pool.admit

    def spy(rr, now, gen_len, drop_expired=True):
        run = admit(rr, now, gen_len, drop_expired)
        if run is not None:
            log.append((rr.model, rr.chips, run.chips, run.batch,
                        sorted(r.rid for r in run.slots.values())))
        return run

    pool.admit = spy
    try:
        ctl = Controller(pool, POLICIES[policy](pool.profiles),
                         make_generators(pool, POOL_RATE),
                         ControllerConfig(duration=POOL_DURATION,
                                          gen_len=POOL_GEN))
        res = ctl.run()
    finally:
        del pool.admit
    return ctl, res, log


def _pool_row(ctl, res, log):
    return {"wall_s": res.wall_s, "steps": res.steps,
            "admissions": len(log), "max_alloc": ctl.max_alloc,
            "occupancy": res.occupancy, "jain_runtime": res.fairness(),
            "served": res.total_completed, "violated": res.total_violated,
            "throughput_per_s": res.throughput(),
            "per_model": {n: {
                "served": m.completed, "violated": m.violated,
                "dropped": m.dropped, "runs": m.runs,
                "throughput_per_s": m.throughput(res.duration),
                "runtime_ms": 1e3 * m.runtime,
                "latency_p50_ms": 1e3 * m.p50,
                "latency_p99_ms": 1e3 * m.p99}
                for n, m in res.per_model.items()}}


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _calibrate(torch, pool, reps: int = 5):
    """Each kind of dispatch the pool's virtual clock charges, timed on
    the 100% standby engine of each model (host clock around a
    synchronised dispatch; median of ``reps``): the admission prefill of
    b prompts and the slot step at b live slots, b = 1, 2, 4, beside the
    modelled f_L(100, b) — the prefill f_L the clock charges per run, and
    the decode f_L at the run's context — and a whole run (admission plus
    ``POOL_GEN`` steps) beside what the clock charges for it. The per-layer
    overhead is the 1-slot step's time beyond its modelled roofline (the
    decode f_L without its serial term), per layer."""
    from repro_torch.core.latency_model import LatencyModel
    from repro_torch.serving.plan import PrefillChunk, StepPlan
    rows, per_layer = [], {}
    for name, host in pool.hosts.items():
        eng = host.allocations[max(host.allocations)].engine
        prof, cfg = host.profile, host.profile.cfg
        dec = LatencyModel(cfg, mode="decode",
                           seq=host.prompt_len + POOL_GEN, hw=prof.hw)
        prompt = host.prompt_batch()
        step_1 = None
        for b in (1, 2, 4):
            adm, step = [], []
            for _ in range(reps):
                eng.release_all_slots()
                plan = StepPlan(admissions=[PrefillChunk(
                    rid=i, batch=prompt, start=0, length=host.prompt_len,
                    final=True, n_tokens=64) for i in range(b)])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                slots = sorted(eng.execute(plan).admitted.values())
                torch.cuda.synchronize()
                adm.append(time.perf_counter() - t0)
                for _ in range(POOL_GEN):
                    t0 = time.perf_counter()
                    eng.execute(StepPlan(decodes=slots))
                    torch.cuda.synchronize()
                    step.append(time.perf_counter() - t0)
            eng.release_all_slots()
            a_ms, s_ms = 1e3 * _median(adm), 1e3 * _median(step)
            f_pre = 1e3 * prof.lm.latency(100, b)
            f_dec = 1e3 * dec.latency(100, b)
            charged = 1e3 * prof.latency(100, b)
            run_ms = a_ms + POOL_GEN * s_ms
            rows.append({
                "model": name, "batch": b,
                "admission_ms": a_ms, "f_L_prefill_ms": f_pre,
                "admission_over_f_L": a_ms / f_pre,
                "step_ms": s_ms, "f_L_decode_ms": f_dec,
                "step_over_f_L": s_ms / f_dec,
                "run_ms": run_ms, "charged_run_ms": charged,
                "run_over_charged": run_ms / charged})
            if b == 1:
                step_1 = s_ms / 1e3
        roof = dec.latency(100, 1) - prof.hw.dispatch_overhead \
            * cfg.num_layers
        per_layer[name] = (step_1 - roof) / cfg.num_layers
    return rows, per_layer


def _build_pool(torch):
    """The quick trio at full width in bfloat16, 4 paged slots of 1024
    per standby, not yet warmed."""
    from repro_torch.serving.pool import build_pool
    return build_pool(POOL_MODELS, request_rate=POOL_RATE, base_slots=4,
                      cache_len=1024, prompt_len=128, reduced=False,
                      page_size=16, warm=False, device="cuda",
                      dtype=torch.bfloat16)


def phase_g(torch, keep=None):
    """(g)'s pool; with ``keep``, the pool and its ``dstack`` serve's row
    stay there for phase (i4)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pool = _build_pool(torch)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    hw = pool.profiles[POOL_MODELS[0]].hw       # the card's (local_gpu)
    assert hw.name == torch.cuda.get_device_name(0), hw
    t0 = time.perf_counter()
    pool.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm = pool.jit_cache_sizes()
    engines = [e for h in pool.hosts.values() for e in h.engines()]
    profiles = {n: {"knee_pct": p.knee_chips, "opt_pct": p.opt_chips,
                    "opt_batch": p.opt_batch, "slo_ms": 1e3 * p.slo,
                    "standby_pct": sorted(pool.hosts[n].allocations)}
                for n, p in pool.profiles.items()}
    _log(json.dumps({"g/profiles": profiles, "build_s": build_s,
                     "warm_s": warm_s, "captures": sum(warm.values())}))
    serves, launches = {}, {n: 0 for n in KERNEL_NAMES}
    for policy in POOL_POLICIES:
        _reset_launch_counts()
        ctl, res, log = _pool_serve(pool, policy)
        torch.cuda.synchronize()
        got = _launch_counts()
        row = _pool_row(ctl, res, log)
        row["launches"] = got
        _log(json.dumps({f"g/{policy}": row}))
        _check_launches(got, POOL_PATH, f"g/{policy}")
        assert pool.jit_cache_sizes() == warm, f"g/{policy}: a capture"
        assert not res.truncated and not ctl.oversubscribed, policy
        assert {g for _, _, g, _, _ in log} <= set(hw.levels), log
        if policy != "fixed_batch_mps":
            assert ctl.max_alloc <= 1.0 + 1e-6, (policy, ctl.max_alloc)
        for n, m in res.per_model.items():
            assert m.completed > 0, f"g: {n} starved under {policy}"
        for n in KERNEL_NAMES:
            launches[n] += got[n]
        serves[policy] = row
    calib, per_layer = _calibrate(torch, pool)
    assert pool.jit_cache_sizes() == warm, "g: calibration captured"
    for row in calib:
        _log(json.dumps({"g/f_L": row}))
    out = {"phase": "g", "models": list(POOL_MODELS), "dtype": "bfloat16",
           "hardware": dataclasses.asdict(hw), "rate_per_model": POOL_RATE,
           "duration_virtual_s": POOL_DURATION, "gen_tokens": POOL_GEN,
           "prompt_len": 128, "slots": 4, "profiles": profiles,
           "build_s": build_s, "warm_s": warm_s,
           "captures": sum(warm.values()),
           "graph_pool_bytes": sum(e.graph_pool_bytes() for e in engines),
           "kv_cache_bytes": sum(e.kv_cache_bytes() for e in engines),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "serves": {p: {k: v for k, v in r.items() if k != "per_model"}
                      for p, r in serves.items()},
           "per_model": {p: r["per_model"] for p, r in serves.items()},
           "f_L": calib, "per_layer_overhead_s": per_layer,
           "per_layer_overhead_mean_s": sum(per_layer.values())
           / len(per_layer),
           "dispatch_overhead_modelled_s": hw.dispatch_overhead,
           "launches": launches}
    _emit(out)
    if keep is not None:
        keep.update(pool=pool, dstack=serves["dstack"])
    del pool, engines
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase (h): the radix prompt cache and speculative decoding
# --------------------------------------------------------------------------
SPEC_PATH = ("paged_decode_attention", "segment_flash_attention",
             "paged_chunk_attention", "decode_attention")
# (h1): the reference's bench_shared_prefix at full width — templates of
# 600, 312 and 150 tokens picked 0.6 / 0.3 / 0.1, tails of 2-6. The tree
# registers whole pages only, and each template leaves fewer than 10
# tokens in its last page, so a prompt never fills that page: hits end on
# a page boundary and copy no page (the (c) check's templates do)
H1_TEMPLATES = ((600, 0.6), (312, 0.3), (150, 0.1))
H1_REQUESTS, H1_NEW = 32, 32
H2_REQUESTS, H2_PROMPT, H2_NEW, H2_SPEC_K = 8, 128, 128, 4


def _shared_prefix_requests(vocab, n, new_tokens, templates, seed=0,
                            model="olmo-1b"):
    """``n`` requests to ``model``, each one of ``templates`` [(length,
    probability)] plus a random tail of 2-6 tokens, asking for
    ``new_tokens``."""
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(seed)
    temps = [rng.integers(1, vocab, size=s).astype(np.int32)
             for s, _ in templates]
    probs = [p for _, p in templates]
    reqs, prompts = [], {}
    for i in range(n):
        t = temps[int(rng.choice(len(temps), p=probs))]
        tail = rng.integers(1, vocab, size=int(rng.integers(2, 7))).astype(
            np.int32)
        prompts[i] = np.concatenate([t, tail])[None, :]
        reqs.append(Request(arrival=0.0, rid=i, model=model, slo=1e9,
                            n_tokens=new_tokens,
                            prompt_len=prompts[i].shape[1]))
    return reqs, prompts


def _h_turn(torch, engines, mode, name, run):
    """One timed run of ``run`` on ``engines[0]`` (and its draft) in
    ``mode``, with the launch counts at 0 just before it; the page audit
    after it. Returns (streams, its record, its server)."""
    eng = engines[0]
    eng.graphs = mode == "graphed"
    torch.cuda.synchronize()
    c0 = sum(_captures(e) for e in engines)
    _reset_launch_counts()
    t0 = time.perf_counter()
    streams, srv = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert eng.check_page_invariants()
    tokens = sum(map(len, streams.values()))
    st = eng.stats
    turn = {"turn": name, "mode": mode, "wall_s": wall,
            "tokens_per_s": tokens / wall,
            "captures": sum(_captures(e) for e in engines) - c0,
            "launches": _launch_counts(), "ticks": srv.ticks,
            "dispatches": srv.dispatches,
            "dispatches_per_token": srv.dispatches / tokens,
            "stats": dataclasses.asdict(st)}
    turn["tick_ms_p50"], turn["tick_ms_p99"] = _walls(srv)
    _log(json.dumps({f"h/{name}": turn}))
    assert turn["captures"] == 0, f"h/{name}: a timed run captured"
    eng.graphs = True
    return streams, turn, srv


def _equal_streams(a, b):
    return sum(a[r] == b[r] for r in a)


def _first_difference(a, b):
    """The first token index at which any stream of ``a`` and ``b``
    differs (None when all are equal)."""
    idx = [next((i for i, (x, y) in enumerate(zip(a[r], b[r])) if x != y),
                None) for r in a]
    idx = [i for i in idx if i is not None]
    return min(idx) if idx else None


def _tie_report(torch, eng, prompts):
    """Where the bf16 kernels part: for the (B, S) ``prompts`` admitted
    in one packed prefill (#2) on ``eng``, the next token's logits from a
    paged decode step (#1, plain decoding's) and from a one-row verify
    chunk (#3, speculation's), both bf16, against the same weights in
    float32 (a padded prefill and a decode step, TF32 off). Per request:
    the float32 top-2 margin of the first token after the prompt and of
    the one after it, whether each bf16 argmax is float32's, and the
    largest logit differences."""
    from repro_torch.models.registry import build_model
    dev = eng.device
    eng.release_all_slots()
    slots = eng.insert_many([{"tokens": p[None]} for p in prompts],
                            n_tokens=[4] * len(prompts))
    idx = torch.tensor(slots, device=dev)
    t0 = eng._last_tok[idx]
    cache = {k: v.clone() for k, v in eng._slot_cache.items()}
    logits1 = eng.api.decode_step(eng.params, eng._last_tok, cache)[0][idx]
    n, s = prompts.shape
    ar = torch.arange(n, dtype=torch.int32, device=dev)
    packed = {"tokens": t0.to(torch.int32)[None], "seg_ids": ar,
              "seg_starts": ar, "seg_lens": torch.ones_like(ar),
              "seg_slots": idx.to(torch.int32),
              "hist_lens": torch.full_like(ar, s)}
    logits3 = eng.api.prefill_chunk(eng.params, packed, eng._slot_cache,
                                    1)[0]
    eng.release_all_slots()
    cfg32 = dataclasses.replace(eng.cfg, dtype="float32")
    api32 = build_model(cfg32, dev)
    p32 = _tree_map(eng.params, lambda t: t.float())
    tokens = torch.from_numpy(prompts).to(dev)
    first32, cache32 = api32.prefill(p32, {"tokens": tokens}, s + 8)
    logits32 = api32.decode_step(p32, t0, cache32)[0]

    def margin(lg):
        top = torch.topk(lg.float(), 2, dim=-1).values
        return (top[:, 0] - top[:, 1]).tolist()

    def agree(lg):
        return (lg.argmax(-1) == logits32.argmax(-1)).tolist()

    out = {
        "first_token_margin_f32": margin(first32),
        "first_token_is_f32s": (first32.argmax(-1) == t0).tolist(),
        "next_margin_f32": margin(logits32),
        "next_decode_is_f32s": agree(logits1),
        "next_verify_is_f32s": agree(logits3),
        "decode_equals_verify": (logits1.argmax(-1)
                                 == logits3.argmax(-1)).tolist(),
        "decode_vs_verify_max_abs": float(
            (logits1.float() - logits3.float()).abs().max()),
        "decode_vs_f32_max_abs": float(
            (logits1.float() - logits32).abs().max()),
        "verify_vs_f32_max_abs": float(
            (logits3.float() - logits32).abs().max()),
        "logit_scale_f32": float(logits32.abs().max())}
    del cache, cache32, p32
    torch.cuda.empty_cache()
    return out


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    return fn(tree)


def phase_h(torch):
    """olmo-1b at full width, bfloat16, seed 0, on one paged engine of 8
    slots x 1024 tokens in pages of 16. (h1) shared prefixes: 32
    requests of three templates through ``serve_ticks`` with
    ``chunk_tokens=512``, cache off and on; (h2) speculative decoding:
    8 requests of 128 + 128 tokens with an identical-weights ring draft
    (8 x 1024, the target's weights) at spec_k 4, plain and speculative,
    then a divergent draft (seed 1). One untimed graphed pass of each
    serve captures its buckets; then the timed turns."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import InferenceEngine, make_engine
    cfg = get_config("olmo-1b")
    eng = make_engine(cfg, seed=0, cache_len=1024, dtype=torch.bfloat16,
                      device="cuda").init_slots(8, page_size=16)
    eng.enable_prefix_cache()
    eng.warm_prefix_ops()

    # ---- (h1): the radix prompt cache
    reqs, prompts = _shared_prefix_requests(
        cfg.vocab_size, H1_REQUESTS, H1_NEW, H1_TEMPLATES)

    def h1(cache):
        return lambda: _serve(eng, reqs, prompts, chunk_tokens=512,
                              prefix_cache=cache)

    t0 = time.perf_counter()
    c0 = _captures(eng)
    warm = {c: h1(c)()[0] for c in (False, True)}
    _log(json.dumps({"h1/first runs": {"captures": _captures(eng) - c0,
                                       "s": time.perf_counter() - t0}}))
    turns, streams = [], {}
    for name, mode, cache in (("off", "graphed", False),
                              ("on", "graphed", True),
                              ("on", "graphed", True),
                              ("off", "graphed", False),
                              ("on", "eager", True)):
        got, turn, _ = _h_turn(torch, [eng], mode, f"h1 cache {name}",
                               h1(cache))
        assert got == warm[cache], f"h1 cache {name} {mode}: tokens changed"
        _check_launches(turn["launches"], PAGED_PATH, f"h1/{name}/{mode}")
        streams[(name, mode)] = got
        turns.append(turn)
    on, off = turns[1]["stats"], turns[0]["stats"]
    assert streams[("on", "eager")] == streams[("on", "graphed")], \
        "h1: graphed and eager cache-on streams differ"
    saved = 1 - on["prefill_tokens"] / off["prefill_tokens"]
    assert saved >= 0.4, f"h1: the cache saved {saved:.1%} of prefill"
    assert on["prefix_hits"], on
    h1_out = {
        "requests": len(reqs), "new_tokens": H1_NEW,
        "templates": [s for s, _ in H1_TEMPLATES],
        "prompt_tokens": sum(r.prompt_len for r in reqs),
        "prefill_tokens_off": off["prefill_tokens"],
        "prefill_tokens_on": on["prefill_tokens"],
        "prefill_saved": saved,
        **{k: on[k] for k in ("prefix_hits", "prefix_hit_tokens",
                              "cow_copies", "forced_catchup_tokens",
                              "dedup_pages")},
        "streams_equal_off_on": _equal_streams(warm[False], warm[True]),
        "first_difference_off_on": _first_difference(warm[False],
                                                     warm[True]),
        "turns": [{k: t[k] for k in ("turn", "mode", "tokens_per_s",
                                     "tick_ms_p50", "tick_ms_p99", "ticks",
                                     "dispatches")} for t in turns]}
    _log(json.dumps({"h1": h1_out}))
    launches = dict(turns[1]["launches"])

    # ---- (h2): speculative decoding
    reqs, prompts = _requests(H2_REQUESTS, (H2_PROMPT, H2_PROMPT + 1),
                              (H2_NEW, H2_NEW + 1), cfg.vocab_size, 2)
    same = InferenceEngine(eng.api, eng.params, cache_len=1024).init_slots(
        8, paged=False)
    other = make_engine(cfg, seed=1, cache_len=1024, dtype=torch.bfloat16,
                        device="cuda").init_slots(8, paged=False)
    h2_out, spec_turns = {}, []
    for draft_name, draft in (("identical", same), ("divergent", other)):
        eng.attach_draft(draft, spec_k=H2_SPEC_K)

        def h2(k):
            return lambda: _serve(eng, reqs, prompts, chunk_tokens=0,
                                  spec_k=k)

        t0 = time.perf_counter()
        c0 = _captures(eng) + _captures(draft)
        warm = {k: h2(k)()[0] for k in (0, H2_SPEC_K)}
        sizes = (eng.jit_cache_sizes(), draft.jit_cache_sizes())
        _log(json.dumps({f"h2/{draft_name} first runs": {
            "captures": _captures(eng) + _captures(draft) - c0,
            "s": time.perf_counter() - t0}}))
        order = ((0, H2_SPEC_K, H2_SPEC_K, 0) if draft_name == "identical"
                 else (H2_SPEC_K,))
        turns = []
        for k in order:
            name = f"h2 {draft_name} {'spec' if k else 'plain'}"
            got, turn, srv = _h_turn(torch, [eng, draft], "graphed", name,
                                     h2(k))
            assert got == warm[k], f"{name}: tokens changed"
            ran = {n for n, c in turn["launches"].items() if c}
            if k:
                assert turn["stats"]["spec_rounds"] > 0, name
                assert {"segment_flash_attention", "paged_chunk_attention",
                        "decode_attention"} <= ran <= set(SPEC_PATH), ran
                spec_turns.append(turn)
            else:
                _check_launches(turn["launches"],
                                ("paged_decode_attention",
                                 "segment_flash_attention"), name)
            turns.append(turn)
        assert (eng.jit_cache_sizes(), draft.jit_cache_sizes()) == sizes, \
            f"h2/{draft_name}: a warm serve added an executable"
        st = next(t for t in turns if t["stats"]["spec_rounds"])["stats"]
        h2_out[draft_name] = {
            "acceptance": st["accepted_tokens"] / st["draft_tokens"],
            "spec_rounds": st["spec_rounds"], "rollbacks": st["rollbacks"],
            "streams_equal_to_plain": _equal_streams(warm[0],
                                                     warm[H2_SPEC_K]),
            "first_difference": _first_difference(warm[0], warm[H2_SPEC_K]),
            "turns": [{k: t[k] for k in (
                "turn", "tokens_per_s", "tick_ms_p50", "tick_ms_p99",
                "ticks", "dispatches", "dispatches_per_token")}
                for t in turns],
            "paged_chunk_attention_launches": [
                t["launches"]["paged_chunk_attention"] for t in turns]}
        _log(json.dumps({f"h2/{draft_name}": h2_out[draft_name]}))
    assert h2_out["divergent"]["rollbacks"] > 0, "h2: no draft rejected"
    eng.release_all_slots()
    free = eng._kv.allocator._free
    assert free == sorted(free, reverse=True), "h2: free list not canonical"
    assert eng.check_page_invariants()
    # the identical draft's speculative serve once more, profiled (after
    # a serve that captures its graphs again): #3's device time on the
    # verify path
    eng.attach_draft(same, spec_k=H2_SPEC_K)
    _serve(eng, reqs, prompts, chunk_tokens=0, spec_k=H2_SPEC_K)
    _, profile = _profile(torch, lambda: _serve(
        eng, reqs, prompts, chunk_tokens=0, spec_k=H2_SPEC_K)[0])
    h2_out["profile"] = profile
    h2_out["verify_chunk_ms"] = profile["port_kernels"].get(
        "paged_chunk_attention", {}).get("ms")
    h2_out["ties"] = _tie_report(
        torch, eng, np.concatenate([prompts[r.rid] for r in reqs]))
    _log(json.dumps({"h2/ties": h2_out["ties"]}))
    for n, c in spec_turns[0]["launches"].items():
        launches[n] += c
    out = {"phase": "h", "model": cfg.name, "dtype": "bfloat16",
           "layers": cfg.num_layers, "slots": "8 paged x 1024, pages of 16",
           "h1": h1_out, "h2": h2_out, "launches": launches}
    _emit({k: v for k, v in out.items() if k != "h2"}
          | {"h2": {k: v for k, v in h2_out.items() if k != "profile"}})
    del eng, same, other
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase (i): sampled decoding, the telemetry plane and the async gateway
# --------------------------------------------------------------------------
I_SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95)
I2_ROWS, I2_DRAWS, I2_BATCH = 8, 1 << 16, 1024
I2_GEN = (8, 512, 64)              # generate: batch, prompt, new tokens
# (i3): bench_gateway --full's burst trace, tiers, planner and slots
GW_TRAFFIC = dict(model="olmo-1b", duration=0.6, rate=240.0, seed=12,
                  slo_unit=1e-3, prompt_tokens=(4, 12), gen_tokens=(3, 8))
GW_BURST = 16.0
GW_SLOTS, GW_CACHE, GW_PAGE = 4, 32, 8
GW_POLICIES = ("temporal", "dstack")     # FIFO admission, weighted tiers
GW_QUICK = 0.2         # bench_gateway's quick duration: (c)'s CPU slice
# the gateway's planner does not chunk: admissions (#2) and decodes (#1)
GW_PATH = ("paged_decode_attention", "segment_flash_attention")


def _sampling(**kw):
    from repro_torch.serving.engine import SamplingParams
    return SamplingParams(**kw)


def _i1(torch, eng, reqs, prompts, greedy_streams):
    """(i1): (b)'s 16 requests on 8 sampled paged slots (``I_SAMPLING``,
    seed 0): one capturing pass, then eager, graphed, graphed, eager turns
    from the same seed (identical streams, 0 captures); seed 1 gives
    another stream; temperature 0 gives (b)'s greedy streams."""
    n_tok = sum(r.n_tokens for r in reqs)

    def run(seed=0):
        eng.seed_slots(seed)
        return _serve(eng, reqs, prompts, chunk_tokens=512)

    streams, warm, turns = _turns(torch, eng, run, n_tok, PAGED_PATH, "i1")
    vocab = eng.cfg.vocab_size
    assert all(0 <= t < vocab for s in streams.values() for t in s), \
        "i1: a sampled token outside the vocabulary"
    other = run(1)[0]
    assert other != streams, "i1: seed 1 drew seed 0's streams"
    # temperature 0: the greedy streams of (b) (eager, so nothing new is
    # captured for a config served once)
    eng.init_slots(8, page_size=16, sampling=_sampling(temperature=0.0))
    eng.graphs = False
    cold = _serve(eng, reqs, prompts, chunk_tokens=512)[0]
    eng.graphs = True
    if greedy_streams is None:
        eng.init_slots(8, page_size=16)
        greedy_streams = _serve(eng, reqs, prompts, chunk_tokens=512)[0]
    assert cold == greedy_streams, "i1: temperature 0 is not greedy"
    graphed = next(t for t in turns if t["mode"] == "graphed")
    out = {"requests": len(reqs), "tokens_served": n_tok,
           "sampling": I_SAMPLING,
           **{k: _by_mode(turns, k) for k in (
               "tokens_per_s", "tick_ms_p50", "tick_ms_p99")},
           "ticks": graphed["ticks"], "dispatches": graphed["dispatches"],
           "streams_equal_seed_1": _equal_streams(streams, other),
           "graphs": _graph_report(eng, warm, turns),
           "launches": graphed["launches"]}
    _log(json.dumps({"i1": {k: v for k, v in out.items()
                            if k != "graphs"}}))
    return out


def _i2(torch, eng):
    """(i2): the sampler on the card — 2^16 draws from each of 8 rows of
    the model's own last-token logits (64-token prompts), against the
    plain filter's support and its renormalised softmax; then sampled
    ``generate`` 8 x 512 + 64 graphed (capturing, untimed), graphed and
    eager from one seed, identical tokens."""
    from repro_torch.models import layers as L
    cfg = eng.cfg
    rng = np.random.default_rng(21)
    tokens = rng.integers(1, cfg.vocab_size, (I2_ROWS, 64)).astype(np.int32)
    logits = eng.prefill({"tokens": tokens}, 128)[0].float()
    filt = L.top_k_top_p_filter(logits / I_SAMPLING["temperature"],
                                top_k=I_SAMPLING["top_k"],
                                top_p=I_SAMPLING["top_p"])
    support = filt > -1e29
    p = torch.softmax(filt.double(), -1)
    gen = torch.Generator(device=logits.device).manual_seed(0)
    counts = torch.zeros_like(p)
    outside = 0
    for _ in range(I2_DRAWS // I2_BATCH):
        draws = L.sample_logits(gen, logits.repeat_interleave(I2_BATCH, 0),
                                **I_SAMPLING).view(I2_ROWS, I2_BATCH)
        outside += int((~support.gather(1, draws)).sum())
        counts.scatter_add_(1, draws, torch.ones_like(draws,
                                                      dtype=counts.dtype))
    tv = (0.5 * (counts / I2_DRAWS - p).abs().sum(-1)).tolist()
    _log(json.dumps({"i2/sampler": {"tv": tv, "outside": outside}}))
    assert outside == 0, f"i2: {outside} draws outside the filter's support"
    assert max(tv) <= 0.03, f"i2: total variation {tv}"
    step_ms = _time_ms(lambda: L.sample_logits(gen, logits, **I_SAMPLING),
                       torch, sleep=False)
    # sampled generate: graphed (captures), graphed, eager — one seed
    b, s, new = I2_GEN
    prompt = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    sp = _sampling(**I_SAMPLING)
    runs = []
    for mode in ("graphed", "graphed", "eager"):
        eng.graphs = mode == "graphed"
        torch.cuda.synchronize()
        c0 = _captures(eng)
        _reset_launch_counts()
        t0 = time.perf_counter()
        got = eng.generate({"tokens": prompt}, new, rng=0, sampling=sp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append({"mode": mode, "tokens": got.cpu().tolist(),
                     "wall_s": wall, "tokens_per_s": b * new / wall,
                     "captures": _captures(eng) - c0,
                     "launches": _launch_counts()})
    eng.graphs = True
    assert runs[0]["tokens"] == runs[1]["tokens"] == runs[2]["tokens"], \
        "i2: sampled generate differs between runs of one seed"
    for r in runs[1:]:
        assert r["captures"] == 0, f"i2: a timed {r['mode']} run captured"
        _check_launches(r["launches"], GENERATE_PATH, f"i2/{r['mode']}")
    out = {"rows": I2_ROWS, "draws_per_row": I2_DRAWS,
           "vocab": cfg.vocab_size, "support_sizes":
           support.sum(-1).tolist(), "tv": tv, "tv_max": max(tv),
           "sample_logits_ms_8_rows": step_ms,
           "generate": [{k: v for k, v in r.items() if k != "tokens"}
                        for r in runs],
           "launches": runs[1]["launches"]}
    _log(json.dumps({"i2": {k: v for k, v in out.items()
                            if k != "generate"}}))
    return out


def _warm_packings(eng, lo, hi):
    """Capture every packed-prefill executable an admission of 1..n_slots
    prompts of ``lo``..``hi`` tokens can meet (one admission per
    ``segment_key``), and the slot step; then free everything."""
    import itertools
    keys = {}
    for n in range(1, eng.n_slots + 1):
        for lens in itertools.combinations_with_replacement(
                range(lo, hi + 1), n):
            keys.setdefault(eng.segment_key(lens), lens)
    for lens in keys.values():
        eng.insert_many([{"tokens": np.ones((1, ln), np.int32)}
                         for ln in lens], n_tokens=[1] * len(lens))
        eng.step()
        eng.release_all_slots()
    return len(keys)


def _gw_trace(vocab, duration=GW_TRAFFIC["duration"]):
    """The burst trace over its first ``duration`` virtual seconds, and
    its prompts."""
    from repro_torch.serving import traffic
    reqs = traffic.burst_trace(traffic.TrafficConfig(
        **dict(GW_TRAFFIC, duration=duration)), burst_mult=GW_BURST)
    return reqs, traffic.synth_prompts(reqs, vocab=vocab, seed=0)


def _gw_serve(eng, reqs, prompts, policy, *, wall=False, telemetry=None,
              ticks=False):
    """One serve of the burst trace under ``policy`` — through the async
    gateway (virtual or wall clock) or, with ``ticks``, ``serve_ticks`` —
    as ``bench_gateway`` serves it. Returns (streams, scorecard, planner,
    seconds)."""
    import torch
    from repro_torch.serving import traffic
    from repro_torch.serving.gateway import AsyncGateway
    from repro_torch.serving.plan import (PlannerConfig, StepPlanner,
                                          serve_ticks)
    from repro_torch.serving.request import RequestQueue
    for r in reqs:
        r.state, r.finish, r.first_token, r.tokens_out = \
            "pending", -1.0, -1.0, 0
    eng.release_all_slots()
    eng.reset_stats()
    tiers = dict(traffic.TIER_WEIGHTS) if policy == "dstack" else None
    planner = StepPlanner(eng, RequestQueue(eng.cfg.name, slo=1e9),
                          PlannerConfig(gen_len=4, tiers=tiers))
    planner.telemetry = telemetry
    t0 = time.perf_counter()
    if ticks:
        srv = serve_ticks(planner, reqs, lambda r: prompts[r.rid],
                          stall_limit=100)
        assert not srv.truncated
        n_ticks = srv.ticks
    else:
        gw = AsyncGateway(planner, wall_clock=wall, stall_limit=100)
        gw.serve_trace(reqs, prompts)
        assert not gw.truncated, "gateway serve hit its max_ticks"
        n_ticks = gw.server.ticks
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    planner.telemetry = None
    assert eng.free_pages == eng.total_pages, "gateway serve leaked pages"
    q = planner.queue
    card = {"attainment_by_tier": traffic.attainment_by(reqs, "tier"),
            "attainment_by_tenant": traffic.attainment_by(reqs, "tenant"),
            "tenant_jain": planner.metrics.tenant_fairness(),
            "completed": q.completed, "shed": q.shed, "dropped": q.dropped,
            "deadline_aborted": q.deadline_aborted, "late": q.late,
            "ticks": n_ticks}
    streams = {r: list(t) for r, t in planner.streams.items()}
    return streams, card, planner, seconds


def _gw_virtual(eng, duration=GW_TRAFFIC["duration"]):
    """The burst trace's virtual-clock gateway serves under both policies
    on ``eng``: {policy: (streams, scorecard)}."""
    reqs, prompts = _gw_trace(eng.cfg.vocab_size, duration)
    return {p: _gw_serve(eng, reqs, prompts, p)[:2] for p in GW_POLICIES}


def _i3(torch, eng):
    """(i3): ``bench_gateway --full``'s burst trace on one engine of 4 paged
    slots of 32 tokens (pages of 8) sharing (i1)'s weights: every packing
    captured up front; virtual-clock serves under FIFO and tiers (their
    counts are host decisions, held against the 2-layer float32 GPU serve
    in phase (c), itself held against the CPU) and ``serve_ticks`` under
    tiers (the gateway's streams);
    then wall-clock serves under tiers with SLOs relaxed (a tick here is
    slower than the trace's 1 ms virtual tick), telemetry off and on —
    the traced one saved, validated and joined against f_L."""
    from repro_torch.core.hardware import local_gpu
    from repro_torch.core.profiles import build_profile
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.metrics import percentile
    from repro_torch.serving.telemetry import (Telemetry, TraceRecorder,
                                               format_roofline,
                                               roofline_report,
                                               validate_chrome_trace)
    geng = InferenceEngine(eng.api, eng.params, cache_len=GW_CACHE,
                           alloc_chips=100).init_slots(
        GW_SLOTS, page_size=GW_PAGE)
    t0 = time.perf_counter()
    n_keys = _warm_packings(geng, *GW_TRAFFIC["prompt_tokens"])
    torch.cuda.synchronize()
    warm = geng.jit_cache_sizes()
    _log(json.dumps({"i3/warm": {"packings": n_keys, "captures":
                                 sum(warm.values()),
                                 "s": time.perf_counter() - t0}}))
    reqs, prompts = _gw_trace(eng.cfg.vocab_size)
    virtual = {}
    for policy in GW_POLICIES:
        streams, card, _, secs = _gw_serve(geng, reqs, prompts, policy)
        virtual[policy] = {"card": card, "wall_s": secs,
                           "streams": streams}
    ticks_streams = _gw_serve(geng, reqs, prompts, "dstack", ticks=True)[0]
    assert ticks_streams == virtual["dstack"]["streams"], \
        "i3: gateway streams differ from serve_ticks"
    fifo, tiered = (virtual[p]["card"] for p in GW_POLICIES)
    assert tiered["attainment_by_tier"]["interactive"] > \
        fifo["attainment_by_tier"]["interactive"], (fifo, tiered)
    # wall clock, SLOs relaxed: telemetry off, then on
    slos = [r.slo for r in reqs]
    walls = {}
    for r in reqs:
        r.slo = 1e9
    try:
        for traced in (False, True):
            tel = Telemetry(trace=TraceRecorder()) if traced else None
            geng.attach_telemetry(tel)
            _reset_launch_counts()
            try:
                streams, card, planner, secs = _gw_serve(
                    geng, reqs, prompts, "dstack", wall=True, telemetry=tel)
            finally:
                geng.attach_telemetry(None)
            q = planner.queue
            walls[traced] = {
                "wall_s": secs, "ticks": card["ticks"],
                "tokens_per_s": sum(map(len, streams.values())) / secs,
                "ttft_ms_p50": 1e3 * percentile(q.ttfts, 0.5),
                "ttft_ms_p99": 1e3 * percentile(q.ttfts, 0.99),
                "tbt_ms_p50": 1e3 * percentile(q.tbts, 0.5),
                "tbt_ms_p99": 1e3 * percentile(q.tbts, 0.99),
                "completed": q.completed,
                "streams_equal_virtual": _equal_streams(
                    streams, virtual["dstack"]["streams"]),
                "launches": _launch_counts()}
            _check_launches(walls[traced]["launches"], GW_PATH,
                            f"i3/wall/{'traced' if traced else 'plain'}")
    finally:
        for r, slo in zip(reqs, slos):
            r.slo = slo
    # on-time attainment of the traced wall pass against the real SLOs
    from repro_torch.serving import traffic
    walls[True]["attainment_by_tier_real_slo"] = traffic.attainment_by(
        reqs, "tier")
    assert geng.jit_cache_sizes() == warm, "i3: a serve captured"
    obj = tel.trace.to_chrome_trace()
    n_spans = validate_chrome_trace(obj)
    OUT_DIR.mkdir(exist_ok=True)
    tel.trace.save(str(OUT_DIR / "i3_gateway_trace.json"))
    prof = build_profile(eng.cfg.name, request_rate=1000.0, hw=local_gpu())
    rows = roofline_report(tel.timers, {eng.cfg.name: prof})
    for line in format_roofline(rows):
        _log(line)
    out = {"model": eng.cfg.name, "dtype": "bfloat16",
           "slots": f"{GW_SLOTS} paged x {GW_CACHE}, pages of {GW_PAGE}",
           "trace": dict(GW_TRAFFIC, burst_mult=GW_BURST,
                         requests=len(reqs)),
           "packings_warmed": n_keys, "captures_after_warm_up": 0,
           "virtual": {p: {"card": v["card"], "wall_s": v["wall_s"]}
                       for p, v in virtual.items()},
           "wall": {("traced" if k else "plain"): v
                    for k, v in walls.items()},
           "trace_spans": n_spans, "trace_events": len(tel.trace.events),
           "timer_samples": tel.timers.total_samples,
           "roofline": [r.as_dict() for r in rows],
           "launches": walls[True]["launches"]}
    _log(json.dumps({"i3": {k: v for k, v in out.items()
                            if k != "roofline"}}))
    return out


def _i4(torch, keep):
    """(i4): (g)'s pool under ``dstack`` once more with the telemetry plane
    attached (trace and timers) — the same served and violated counts as
    the untraced ``dstack`` serve, no capture, #1, #2 and #6 launched —
    and its Prometheus exposition round-tripped."""
    from repro_torch.serving.telemetry import (MetricsRegistry, Telemetry,
                                               TraceRecorder,
                                               export_pool_result,
                                               parse_prometheus,
                                               roofline_report,
                                               validate_chrome_trace)
    pool = keep.get("pool")
    if pool is None:
        pool = keep["pool"] = _build_pool(torch)
        pool.warmup()
        keep["dstack"] = _pool_row(*_pool_serve(pool, "dstack"))
    base = keep["dstack"]
    warm = pool.jit_cache_sizes()
    tel = Telemetry(trace=TraceRecorder())
    pool.attach_telemetry(tel)
    _reset_launch_counts()
    try:
        ctl, res, log = _pool_serve(pool, "dstack")
        torch.cuda.synchronize()
    finally:
        pool.attach_telemetry(None)
    got = _launch_counts()
    _check_launches(got, POOL_PATH, "i4")
    assert pool.jit_cache_sizes() == warm, "i4: the traced serve captured"
    counts = {n: (m.completed, m.violated) for n, m in res.per_model.items()}
    want = {n: (m["served"], m["violated"])
            for n, m in base["per_model"].items()}
    assert counts == want, f"i4: traced {counts}, untraced {want}"
    reg = MetricsRegistry()
    export_pool_result(reg, res)
    text = reg.render()
    parsed = parse_prometheus(text)
    for n, (served, violated) in counts.items():
        assert parsed[("dstack_requests_total",
                       (("cause", "completed"), ("model", n)))] == served
        assert parsed[("dstack_slo_violations_total",
                       (("model", n),))] == violated
    assert parse_prometheus(reg.render()) == parsed
    n_spans = validate_chrome_trace(tel.trace.to_chrome_trace())
    rows = roofline_report(tel.timers, pool.profiles)
    out = {"served": res.total_completed, "violated": res.total_violated,
           "wall_s": res.wall_s,
           "untraced_wall_s": base["wall_s"],
           "metric_lines": len(text.splitlines()),
           "trace_spans": n_spans, "timer_samples":
           tel.timers.total_samples,
           "roofline": [r.as_dict() for r in rows], "launches": got}
    _log(json.dumps({"i4": {k: v for k, v in out.items()
                            if k != "roofline"}}))
    return out


def phase_i(torch, greedy_streams=None, keep=None):
    """olmo-1b at full width, bfloat16, seed 0 (phase (b)'s weights):
    (i1) a sampled serve, (i2) the sampler and sampled ``generate``, (i3)
    the async gateway on the burst trace, (i4) telemetry on (g)'s pool."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import make_engine
    cfg = get_config("olmo-1b")
    eng = make_engine(cfg, seed=0, cache_len=1024, dtype=torch.bfloat16,
                      device="cuda").init_slots(
        8, page_size=16, sampling=_sampling(**I_SAMPLING), rng_seed=0)
    reqs, prompts = _requests(16, (64, 901), (16, 65), cfg.vocab_size, 0)
    out = {"phase": "i", "model": cfg.name, "dtype": "bfloat16"}
    parts = {}
    for name, fn, args in (
            ("i1", _i1, (eng, reqs, prompts, greedy_streams)),
            ("i2", _i2, (eng,)), ("i3", _i3, (eng,)),
            ("i4", _i4, (keep if keep is not None else {},))):
        t0 = time.perf_counter()
        parts[name] = fn(torch, *args)
        parts[name]["s"] = time.perf_counter() - t0
    launches = {n: sum(p["launches"][n] for p in parts.values())
                for n in KERNEL_NAMES}
    out.update(parts, launches=launches)
    _emit({"phase": "i", "i1": {k: parts["i1"][k] for k in (
        "tokens_per_s", "streams_equal_seed_1", "s")},
        "i2": {k: parts["i2"][k] for k in ("tv_max", "s")},
        "i3": {"virtual": parts["i3"]["virtual"], "s": parts["i3"]["s"]},
        "i4": {k: parts["i4"][k] for k in ("served", "violated", "s")}})
    del eng
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase (j): the encoder-decoder family, whisper-small
# --------------------------------------------------------------------------
# whisper's paths: the encoder and the cross-attention of prefills run #5,
# packed self-attention #2, decode self-attention #1 (paged) or #4 (ring)
# and the cross-attention decode #4
WHISPER_PAGED_PATH = ("paged_decode_attention", "segment_flash_attention",
                      "decode_attention", "flash_attention")
WHISPER_RING_PATH = ("segment_flash_attention", "decode_attention",
                     "flash_attention")
POOL_FULL_PATH = POOL_PATH + ("decode_attention", "flash_attention")
# bench_pool's MODELS_FULL: the quick trio and whisper-small
POOL_FULL_MODELS = POOL_MODELS + ("whisper-small",)
POOL_FULL_POLICIES = ("dstack", "temporal")
WHISPER_SLOTS, WHISPER_SLOT_LEN, WHISPER_CHUNK = 8, 512, 128


def _whisper_requests(torch, cfg, n, prompt_range, budget_range, seed):
    """``_requests`` whose prompts carry their own stub frames
    (encoder_seq x d_model in the config's dtype, host memory), drawn
    from a generator seeded with ``seed``."""
    from repro_torch.serving import modality
    reqs, prompts = _requests(n, prompt_range, budget_range, cfg.vocab_size,
                              seed, cfg.name)
    gen = torch.Generator().manual_seed(seed)
    return reqs, {rid: {"tokens": p, "enc_embeds": modality.audio_frames(
        cfg, 1, generator=gen)} for rid, p in prompts.items()}


def _whisper_serve_turns(torch, phase, eng, reqs, prompts, ran):
    """A serve of ``reqs`` on ``eng`` in turns (``_turns``, no profile):
    every stream of the asked length. Returns the report and streams."""
    n_tok = sum(r.n_tokens for r in reqs)

    def run():
        return _serve(eng, reqs, prompts, chunk_tokens=WHISPER_CHUNK)

    streams, warm, turns = _turns(torch, eng, run, n_tok, ran, phase)
    for r in reqs:
        s = streams[r.rid]
        assert len(s) == r.n_tokens, (r.rid, len(s), r.n_tokens)
        assert all(0 <= t < eng.cfg.vocab_size for t in s), r.rid
    graphed = next(t for t in turns if t["mode"] == "graphed")
    out = {"tokens_served": n_tok, "ticks": graphed["ticks"],
           "dispatches": graphed["dispatches"],
           **{k: _by_mode(turns, k) for k in (
               "tokens_per_s", "tick_ms_p50", "tick_ms_p99",
               "peak_mem_bytes")},
           "graphs": _graph_report(eng, warm, turns),
           "kv_cache_bytes": eng.kv_cache_bytes(),
           "stats": dataclasses.asdict(eng.stats),
           "launches": graphed["launches"], "turns": turns}
    _log(json.dumps({f"{phase}/serve": {
        k: v for k, v in out.items() if k != "turns"}}))
    return out, streams


def _encoder_share(torch, eng, batches, reps: int = 3):
    """The encoder's share of an admission: one packed admission of
    ``batches`` (``insert_many``, eager) against the encoder alone over
    their frames, each the median of ``reps`` synchronised host-clock
    runs after one warm run."""
    from repro_torch.models import encdec
    frames = torch.cat([b["enc_embeds"] for b in batches]).to(eng.device)
    graphs, eng.graphs = eng.graphs, False
    adm, enc = [], []
    for i in range(reps + 1):
        eng.release_all_slots()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.insert_many(batches, n_tokens=[1] * len(batches))
        torch.cuda.synchronize()
        adm.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        encdec.encode(eng.params, eng.cfg, frames)
        torch.cuda.synchronize()
        enc.append(time.perf_counter() - t0)
    eng.release_all_slots()
    eng.graphs = graphs
    a, e = _median(adm[1:]), _median(enc[1:])
    return {"segments": len(batches),
            "tokens": sum(int(b["tokens"].shape[1]) for b in batches),
            "admission_ms": 1e3 * a, "encoder_ms": 1e3 * e,
            "encoder_share": e / a}


def _build_full_pool(torch, models=POOL_FULL_MODELS):
    """``models`` (bench_pool's four by default) at full width in
    bfloat16, (g)'s geometry: 4 paged slots of 1024 per standby,
    128-token prompts."""
    from repro_torch.serving.pool import build_pool
    return build_pool(models, request_rate=POOL_RATE, base_slots=4,
                      cache_len=1024, prompt_len=128, reduced=False,
                      page_size=16, warm=False, device="cuda",
                      dtype=torch.bfloat16)


def _pool_phase(torch, phase, models, ran):
    """``models``' pool built and warmed, then served under each of
    ``POOL_FULL_POLICIES``: no capture after warm-up, exactly the kernels
    of ``ran``, every model served, every grant a level. Returns the
    report (the launches summed over the serves)."""
    t0 = time.perf_counter()
    pool = _build_full_pool(torch, models)
    pool.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm = pool.jit_cache_sizes()
    hw = next(iter(pool.profiles.values())).hw
    serves, launches = {}, {n: 0 for n in KERNEL_NAMES}
    for policy in POOL_FULL_POLICIES:
        _reset_launch_counts()
        ctl, res, log = _pool_serve(pool, policy)
        torch.cuda.synchronize()
        got = _launch_counts()
        row = _pool_row(ctl, res, log)
        row["launches"] = got
        _log(json.dumps({f"{phase}/{policy}": row}))
        _check_launches(got, ran, f"{phase}/{policy}")
        assert pool.jit_cache_sizes() == warm, f"{phase}/{policy}: a capture"
        assert not res.truncated and not ctl.oversubscribed, policy
        assert {g for _, _, g, _, _ in log} <= set(hw.levels), log
        for n, m in res.per_model.items():
            assert m.completed > 0, f"{phase}: {n} starved under {policy}"
        for n in KERNEL_NAMES:
            launches[n] += got[n]
        serves[policy] = row
    engines = [e for h in pool.hosts.values() for e in h.engines()]
    out = {"models": list(models), "hardware": hw.name,
           "build_warm_s": warm_s, "captures": sum(warm.values()),
           "graph_pool_bytes": sum(e.graph_pool_bytes() for e in engines),
           "profiles": {n: {"knee_pct": p.knee_chips, "opt_pct": p.opt_chips,
                            "opt_batch": p.opt_batch, "slo_ms": 1e3 * p.slo}
                        for n, p in pool.profiles.items()},
           "serves": serves, "launches": launches}
    del pool, engines
    torch.cuda.empty_cache()
    return out


def phase_j(torch):
    """whisper-small at full width (12 encoder and 12 decoder layers,
    d_model 768, 12 heads of 64, 1536 frames), bfloat16, seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import InferenceEngine, make_engine
    cfg = get_config("whisper-small")
    t0 = time.perf_counter()
    eng = make_engine(cfg, seed=0, cache_len=WHISPER_SLOT_LEN,
                      dtype=torch.bfloat16, device="cuda").init_slots(
        WHISPER_SLOTS, page_size=16)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reqs, prompts = _whisper_requests(torch, cfg, 16, (4, 225), (32, 129), 0)
    out = {"phase": "j", "model": cfg.name, "dtype": "bfloat16",
           "encoder_layers": cfg.encoder_layers, "layers": cfg.num_layers,
           "encoder_seq": cfg.encoder_seq, "params": cfg.param_count(),
           "requests": len(reqs),
           "prompt_tokens": sum(r.prompt_len for r in reqs),
           "setup_s": setup_s}
    launches = {n: 0 for n in KERNEL_NAMES}

    def add(got):
        for n in KERNEL_NAMES:
            launches[n] += got[n]

    # (j1) paged serve: packed admissions, recomputed continuations
    j1, streams = _whisper_serve_turns(torch, "j1", eng, reqs, prompts,
                                       WHISPER_PAGED_PATH)
    st = eng.stats
    assert st.chunk_prefills > 0 and st.incr_chunks == 0, st
    j1["encoder_share"] = _encoder_share(
        torch, eng, [prompts[r.rid] for r in reqs[:WHISPER_SLOTS]])
    _log(json.dumps({"j1/encoder_share": j1["encoder_share"]}))
    add(j1["launches"])
    out["j1"] = j1
    # (j2) the same requests on ring slots, the same weights
    ring = InferenceEngine(eng.api, eng.params,
                           cache_len=WHISPER_SLOT_LEN).init_slots(
        WHISPER_SLOTS, paged=False)
    j2, ring_streams = _whisper_serve_turns(torch, "j2", ring, reqs, prompts,
                                            WHISPER_RING_PATH)
    j2["streams_equal_to_paged"] = sum(
        ring_streams[r] == streams[r] for r in streams)
    add(j2["launches"])
    out["j2"] = j2
    del ring
    # (j3) batch generate: 8 prompts of 64 tokens, 64 new tokens each
    rng = np.random.default_rng(9)
    tokens = rng.integers(1, cfg.vocab_size, (8, 64)).astype(np.int32)
    from repro_torch.serving import modality
    frames = modality.audio_frames(
        cfg, 8, generator=torch.Generator().manual_seed(9))
    j3 = _generate_turns(torch, eng, tokens, GENERATE_PATH, "j3",
                         frames=frames)
    add(j3["launches"])
    out["j3"] = {k: v for k, v in j3.items() if k != "turns"}
    del eng
    torch.cuda.empty_cache()
    # (j4) the four-model pool under dstack and temporal
    j4 = _pool_phase(torch, "j4", POOL_FULL_MODELS, POOL_FULL_PATH)
    add(j4.pop("launches"))
    out["j4"] = j4
    serves = j4["serves"]
    out["launches"] = launches
    _emit({k: v for k, v in out.items() if k not in ("j1", "j2", "j4")}
          | {"j1": {k: j1[k] for k in ("tokens_per_s", "encoder_share",
                                       "ticks", "dispatches")},
             "j2": {k: j2[k] for k in ("tokens_per_s",
                                       "streams_equal_to_paged")},
             "j4": {p: {k: r[k] for k in ("served", "violated",
                                          "admissions")}
                    for p, r in serves.items()}})
    return out


# --------------------------------------------------------------------------
# phase (k): the mixture-of-experts family
# --------------------------------------------------------------------------
MOE = "granite-moe-3b-a800m"
PHI_MOE = "phi3.5-moe-42b-a6.6b"
# phi3.5-moe at full width, 4 of its 32 layers: the whole model's 84 GB of
# bfloat16 weights do not fit one card (4 layers: ~11 GB)
PHI_LAYERS = 4
# the experts' continuations recompute the prefix (not chunk_capable): #2
# for admissions and continuations, #1 for decodes, never #3
MOE_PAGED_PATH = ("paged_decode_attention", "segment_flash_attention")
POOL_MOE_MODELS = POOL_MODELS + (MOE,)
# the dispatch's stages, as ``repro_torch.models.moe`` splits them
MOE_STAGES = ("route", "slots", "scatter", "experts", "combine")


def _decode_floor_ms(cfg):
    """The least time of a bfloat16 decode step: the weights it reads
    (every parameter but the embedding table, of which it reads one row a
    sequence — every expert's capacity rows run each step) over the card's
    memory rate."""
    return 2 * (cfg.param_count() - cfg.vocab_size * cfg.d_model) \
        / PEAK_BYTES * 1e3


def _record_routes(run):
    """``run()`` with ``transformer.apply_moe`` wrapped: returns its
    result and, per call (one per layer), the aux and the routing —
    expert indices ``gate_i`` and drop mask, on the host."""
    from repro_torch.models import moe, transformer
    calls, plain = [], transformer.apply_moe

    def recorded(p, cfg, x, **kw):
        _, aux = plain(p, cfg, x, aux=True)
        _, _, gate_i, dropped = moe.dispatch(p, cfg, x)
        calls.append({"aux": {k: float(v) for k, v in aux.items()},
                      "gate_i": gate_i.cpu(), "dropped": dropped.cpu(),
                      "experts": cfg.num_experts})
        return plain(p, cfg, x, **kw)

    transformer.apply_moe = recorded
    try:
        out = run()
    finally:
        transformer.apply_moe = plain
    return out, calls


def _routing_row(calls):
    """Layer 0's dropped fraction, load-balance loss and kept choices per
    expert, and both aux keys' mean over the layers."""
    first = calls[0]
    kept = first["gate_i"].reshape(-1)[~first["dropped"].reshape(-1)]
    return {"layer0": dict(first["aux"], tokens_per_expert=np.bincount(
                kept.numpy(), minlength=first["experts"]).tolist()),
            "mean_over_layers": {k: sum(c["aux"][k] for c in calls)
                                 / len(calls) for k in first["aux"]}}


def _packed_admission(eng, prompts, lens):
    """The packed batch of ``prompts`` cut to ``lens`` on ``eng``'s
    device, and its row length."""
    import torch
    packed = eng._pack_prompts(
        [{"tokens": p[:, :n]} for p, n in zip(prompts, lens)], lens)
    return ({k: torch.from_numpy(np.asarray(v)).to(eng.device)
             for k, v in packed.items()},
            1 << max(0, max(lens) - 1).bit_length())


def _moe_stages(torch, eng, tokens):
    """Each stage of layer 0's dispatch over ``tokens`` tokens in one
    group, timed alone (``_timings``) on seeded inputs at the model's
    width: the ms of a layer, by stage."""
    from repro_torch.models import moe
    from repro_torch.models.layers import layer_params
    cfg = eng.cfg
    p = layer_params(eng.params["layers"], 0)["moe"]
    e, k = cfg.num_experts, cfg.experts_per_token
    gen = torch.Generator(device=eng.device).manual_seed(5)
    x3 = torch.randn((1, tokens, cfg.d_model), generator=gen,
                     device=eng.device).to(torch.bfloat16)
    cap = moe.capacity_for(tokens, cfg)
    probs, gate_w, gate_i = moe._route(p, x3, k)
    slot, dest, dropped = moe._slots(gate_i, e, cap)
    buf = moe._scatter(x3, k, dest, e * cap).view(e, cap, cfg.d_model)
    out = moe._experts(p, buf)
    flush = _l2_flush(torch, eng.device)
    fns = {"route": lambda: moe._route(p, x3, k),
           "slots": lambda: moe._slots(gate_i, e, cap),
           "scatter": lambda: moe._scatter(x3, k, dest, e * cap),
           "experts": lambda: moe._experts(p, buf),
           "combine": lambda: moe._combine(out, slot, dropped, gate_w)}
    rows = {name: _timings(fns[name], torch, flush) for name in MOE_STAGES}
    del flush
    layer = {key: sum(r[key] for r in rows.values())
             for key in ("ms", "ms_cold_l2")}
    # the expert matmuls' least time: their weights, the buffer in and
    # the outputs out once, or their products at the bf16 peak
    weights = 3 * e * cfg.d_model * cfg.d_ff
    bound, by = _bound_ms(2 * (weights + 2 * e * cap * cfg.d_model),
                          2 * cap * weights, "bfloat16")
    return {"tokens": tokens, "capacity": cap, "stages": rows,
            "layer_ms": layer["ms"], "layer_ms_cold_l2": layer["ms_cold_l2"],
            "model_ms_cold_l2": cfg.num_layers * layer["ms_cold_l2"],
            "experts_bound_ms": bound, "experts_bound_by": by}


def _decode_step_ms(torch, eng, prompt, reps: int = 20):
    """A decode step of 8 live slots, graphed and eager (host clock
    around a synchronised step, median of ``reps``)."""
    from repro_torch.serving.plan import PrefillChunk, StepPlan
    out = {}
    for mode in ("graphed", "eager"):
        eng.graphs = mode == "graphed"
        eng.release_all_slots()
        n = int(prompt["tokens"].shape[1])
        plan = StepPlan(admissions=[PrefillChunk(
            rid=i, batch=prompt, start=0, length=n, final=True,
            n_tokens=reps + 8) for i in range(eng.n_slots)])
        slots = sorted(eng.execute(plan).admitted.values())
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.execute(StepPlan(decodes=slots))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[mode] = 1e3 * _median(walls)
    eng.release_all_slots()
    eng.graphs = True
    return out


def phase_k(torch):
    """granite-moe-3b-a800m at full width (32 layers, d_model 1536, 24
    query / 8 KV heads of 64, 40 experts top-8 of d_ff 512) and
    phi3.5-moe-42b-a6.6b at full width cut to ``PHI_LAYERS`` layers, in
    bfloat16 with seeded weights; then the quick trio and granite in one
    pool."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import make_engine
    cfg = get_config(MOE)
    t0 = time.perf_counter()
    eng = make_engine(cfg, seed=0, cache_len=1024, dtype=torch.bfloat16,
                      device="cuda").init_slots(8, page_size=16)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    assert not eng.chunk_capable() and not eng.spec_capable()
    out = {"phase": "k", "model": cfg.name, "dtype": "bfloat16",
           "setup_s": setup_s}
    launches = {n: 0 for n in KERNEL_NAMES}

    def add(got):
        for n in KERNEL_NAMES:
            launches[n] += got[n]

    # (k1) phase (b)'s 16 requests on 8 paged slots of 1024
    reqs, prompts = _requests(16, (64, 901), (16, 65), cfg.vocab_size, 0,
                              cfg.name)
    k1, _ = _serve_phase(torch, "k1", eng, reqs, prompts, MOE_PAGED_PATH)
    st = eng.stats
    assert st.incr_chunks == 0 and st.chunk_prefills > 0, st
    floor = _decode_floor_ms(cfg)
    k1.update(incr_chunks=st.incr_chunks,
              recomputed_continuations=st.chunk_prefills,
              decode_floor_ms=floor,
              tick_p50_over_floor=_by_mode(k1["turns"], "tick_ms_p50")[
                  "graphed"][0] / floor)
    # routing of one packed admission (the first 8 requests' first
    # chunks) and of forward over 8 x 512
    lens = [min(r.prompt_len, 512) for r in reqs[:8]]
    packed, row_len = _packed_admission(
        eng, [prompts[r.rid] for r in reqs[:8]], lens)
    _, calls = _record_routes(
        lambda: eng.api.prefill_packed(eng.params, packed, row_len))
    fwd_tokens = torch.from_numpy(np.random.default_rng(12).integers(
        1, cfg.vocab_size, (8, 512)).astype(np.int32)).to(eng.device)
    (_, fwd_aux), fcalls = _record_routes(
        lambda: eng.api.forward(eng.params, {"tokens": fwd_tokens}))
    routing = {"packed_admission": dict(_routing_row(calls),
                                        tokens=int(packed["tokens"].shape[1]),
                                        real_tokens=sum(lens)),
               "forward_8x512": dict(_routing_row(fcalls), aux={
                   k: float(v) for k, v in fwd_aux.items()})}
    _log(json.dumps({"k/routing": routing}))
    # the dispatch's stages at a decode step's 8 tokens and at the packed
    # admission's tokens; a decode step of 8 live slots
    stages = {"decode_8": _moe_stages(torch, eng, 8),
              "admission": _moe_stages(
                  torch, eng, int(packed["tokens"].shape[1]))}
    step = _decode_step_ms(torch, eng, {"tokens": prompts[0][:, :128]})
    stages["decode_step_ms"] = step
    stages["dispatch_share_of_graphed_step"] = \
        stages["decode_8"]["model_ms_cold_l2"] / step["graphed"]
    _log(json.dumps({"k/stages": stages}))
    k1.update(routing=routing, dispatch_stages=stages)
    add(k1["launches"])
    out["k1"] = k1
    # (k2) batch generate 8 x 512 + 64
    tokens = np.random.default_rng(13).integers(
        1, cfg.vocab_size, (8, 512)).astype(np.int32)
    k2 = _generate_turns(torch, eng, tokens, GENERATE_PATH, "k2")
    add(k2["launches"])
    out["k2"] = {k: v for k, v in k2.items() if k != "turns"}
    del eng
    torch.cuda.empty_cache()
    # (k3) phi3.5-moe, PHI_LAYERS layers: batch generate 8 x 512 + 32
    pcfg = dataclasses.replace(get_config(PHI_MOE), num_layers=PHI_LAYERS)
    t0 = time.perf_counter()
    peng = make_engine(pcfg, seed=0, cache_len=1024, dtype=torch.bfloat16,
                       device="cuda")
    torch.cuda.synchronize()
    tokens = np.random.default_rng(14).integers(
        1, pcfg.vocab_size, (8, 512)).astype(np.int32)
    k3 = _generate_turns(torch, peng, tokens, GENERATE_PATH, "k3",
                         n_new=32)
    k3.update(layers=PHI_LAYERS, setup_s=time.perf_counter() - t0,
              params=pcfg.param_count(),
              decode_floor_ms=_decode_floor_ms(pcfg))
    add(k3["launches"])
    out["k3"] = {k: v for k, v in k3.items() if k != "turns"}
    del peng
    torch.cuda.empty_cache()
    # (k4) the quick trio and granite in one pool, dstack and temporal
    k4 = _pool_phase(torch, "k4", POOL_MOE_MODELS, POOL_PATH)
    add(k4.pop("launches"))
    out["k4"] = k4
    out["launches"] = launches
    _emit({k: v for k, v in out.items() if k not in ("k1", "k2", "k3", "k4")}
          | {"k1": {k: k1[k] for k in (
              "tokens_per_s", "tick_ms_p50", "tick_ms_p99",
              "decode_floor_ms", "busy_share", "ticks", "dispatches",
              "recomputed_continuations", "incr_chunks")}
             | {"dispatch_share_of_graphed_step": k1["dispatch_stages"][
                 "dispatch_share_of_graphed_step"]},
             "k2": {k: k2[k] for k in ("tokens_per_s", "prefill_s")},
             "k3": {k: k3[k] for k in ("tokens_per_s", "prefill_s",
                                       "decode_floor_ms")},
             "k4": {p: {k: r[k] for k in ("served", "violated",
                                          "admissions")}
                    for p, r in k4["serves"].items()}
             | {"granite_profile": k4["profiles"][MOE]}})
    return out


# --------------------------------------------------------------------------
# phase (l): the hybrid family
# --------------------------------------------------------------------------
HYBRID = "zamba2-7b"
# (l1), (l2) and (c) run zamba2-7b at full width cut to 12 of its 81
# layers: two invocations of the shared block, and turns that fit the
# script's time; (l3) runs all 81 layers, graphed only
HYBRID_LAYERS = 12
# continuations recompute the prefix (not chunk_capable): #2 for
# admissions and continuations, #1 or #4 for decodes, #6 for every mamba
# layer of every prefill, never #3
HYBRID_PAGED_PATH = ("paged_decode_attention", "segment_flash_attention",
                     "ssd_scan")
HYBRID_RING_PATH = ("segment_flash_attention", "decode_attention",
                    "ssd_scan")
HYBRID_GENERATE_PATH = ("flash_attention", "decode_attention", "ssd_scan")
POOL_HYBRID_MODELS = POOL_MODELS + (HYBRID,)


def _hybrid_floor_ms(cfg):
    """The least time of a bfloat16 decode step of the hybrid family: the
    weights it reads over the card's memory rate — every mamba layer,
    the shared block once per invocation (its 411 MB at full width do
    not stay in the 50 MB L2 between invocations), the final norm and
    the LM head (one embedding row a sequence is not counted)."""
    from repro_torch.models import hybrid

    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        return float(np.prod(tree.shape))

    plan = hybrid.plan(cfg)
    head = plan["embed"].get("lm_head", plan["embed"]["embedding"])
    n = (count(plan["layers"]) + count(plan["final_norm"]) + count(head)
         + hybrid.n_attn_blocks(cfg) * count(plan["shared_attn"]))
    return 2 * n / PEAK_BYTES * 1e3


def _hybrid_serves(torch, eng, reqs, prompts, floor):
    """(l1): ``reqs`` on ``eng``'s 8 paged slots, then on 8 ring slots of
    the same weights, each in turns and profiled; every prefill dispatch
    scans each mamba layer through #6."""
    from repro_torch.serving.engine import InferenceEngine
    cfg = eng.cfg
    out, streams = {}, {}
    ring = InferenceEngine(eng.api, eng.params,
                           cache_len=eng.slot_len).init_slots(8, paged=False)
    for name, e, ran in (("paged", eng, HYBRID_PAGED_PATH),
                         ("ring", ring, HYBRID_RING_PATH)):
        row, streams[name] = _serve_phase(torch, f"l1/{name}", e, reqs,
                                          prompts, ran)
        st = e.stats
        assert st.incr_chunks == 0 and st.chunk_prefills > 0, st
        assert row["launches"]["ssd_scan"] == cfg.num_layers * st.prefills, \
            (row["launches"], st)
        row.update(recomputed_continuations=st.chunk_prefills,
                   decode_floor_ms=floor,
                   tick_p50_over_floor=_by_mode(row["turns"], "tick_ms_p50")[
                       "graphed"][0] / floor)
        out[name] = row
    out["ring"]["streams_equal_to_paged"] = sum(
        streams["ring"][r] == streams["paged"][r] for r in streams["paged"])
    del ring
    return out


def _hybrid_full_depth(torch, rng):
    """(l3): zamba2-7b with all 81 layers, graphed only: one capturing
    ``generate`` 8 x 512 + 32, then two timed runs that must give its
    tokens, capture nothing and launch exactly #5, #4 and #6; then a
    decode step of 8 live paged slots, graphed and eager, beside the
    step's weight floor; the peak allocation over it all."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import make_engine
    cfg = get_config(HYBRID)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = make_engine(cfg, seed=0, cache_len=1024, dtype=torch.bfloat16,
                      device="cuda")
    torch.cuda.synchronize()
    out = {"layers": cfg.num_layers, "params": cfg.param_count(),
           "setup_s": time.perf_counter() - t0}
    tokens = rng.integers(1, cfg.vocab_size, (8, 512)).astype(np.int32)
    batch, n_new = {"tokens": tokens}, 32
    t0 = time.perf_counter()
    want = eng.generate(batch, n_new).cpu().tolist()
    torch.cuda.synchronize()
    out["first_run"] = {"s": time.perf_counter() - t0,
                        "captures": _captures(eng)}
    runs = []
    for _ in range(2):
        c0 = _captures(eng)
        _reset_launch_counts()
        t0 = time.perf_counter()
        got = eng.generate(batch, n_new).cpu().tolist()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launch_counts()
        assert got == want, "l3: a graphed generate changed tokens"
        assert _captures(eng) == c0, "l3: a timed generate captured"
        _check_launches(launches, HYBRID_GENERATE_PATH, "l3")
        assert launches["ssd_scan"] == cfg.num_layers, launches
        runs.append({"wall_s": wall, "tokens_per_s": 8 * n_new / wall,
                     "launches": launches})
    assert all(0 <= t < cfg.vocab_size for row in want for t in row)
    out["generate"] = runs
    out["launches"] = runs[0]["launches"]
    eng.init_slots(8, page_size=16)
    floor = _hybrid_floor_ms(cfg)
    out["decode_step_ms"] = _decode_step_ms(
        torch, eng, {"tokens": tokens[:1, :128]})
    out.update(decode_floor_ms=floor,
               graphed_step_over_floor=out["decode_step_ms"]["graphed"]
               / floor,
               graph_pool_bytes=eng.graph_pool_bytes(),
               kv_cache_bytes=eng.kv_cache_bytes(),
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    _log(json.dumps({"l3": {k: v for k, v in out.items()
                            if k != "generate"}}))
    del eng
    _release(torch)
    return out


def phase_l(torch):
    """zamba2-7b at full width (d_model 3584, 32 heads of 112, d_ff
    14336, 112 SSD heads of 64, N 64), bfloat16, seeded weights: (l1) and
    (l2) at ``HYBRID_LAYERS`` of its 81 layers, (l3) at all 81, (l4) the
    quick trio and zamba2 in one pool."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import make_engine
    cfg = dataclasses.replace(get_config(HYBRID), num_layers=HYBRID_LAYERS)
    t0 = time.perf_counter()
    eng = make_engine(cfg, seed=0, cache_len=1024, dtype=torch.bfloat16,
                      device="cuda").init_slots(8, page_size=16)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    assert eng.paged and not eng.chunk_capable()
    assert not eng.spec_capable() and not eng.prefix_cache_capable()
    out = {"phase": "l", "model": cfg.name, "dtype": "bfloat16",
           "layers": cfg.num_layers, "setup_s": setup_s}
    launches = {n: 0 for n in KERNEL_NAMES}

    def add(got):
        for n in KERNEL_NAMES:
            launches[n] += got[n]

    # (l1) phase (b)'s 16 requests on 8 paged slots of 1024, then on 8
    # ring slots
    reqs, prompts = _requests(16, (64, 901), (16, 65), cfg.vocab_size, 0,
                              cfg.name)
    l1 = _hybrid_serves(torch, eng, reqs, prompts, _hybrid_floor_ms(cfg))
    for row in l1.values():
        add(row["launches"])
    out["l1"] = l1
    # (l2) batch generate 8 x 512 + 64
    rng = np.random.default_rng(15)
    tokens = rng.integers(1, cfg.vocab_size, (8, 512)).astype(np.int32)
    l2 = _generate_turns(torch, eng, tokens, HYBRID_GENERATE_PATH, "l2")
    assert all(t["launches"]["ssd_scan"] == cfg.num_layers
               for t in l2["turns"]), l2["turns"]
    add(l2["launches"])
    out["l2"] = {k: v for k, v in l2.items() if k != "turns"}
    del eng
    _release(torch)
    # (l3) all 81 layers, graphed
    l3 = _hybrid_full_depth(torch, rng)
    add(l3["launches"])
    out["l3"] = l3
    # (l4) the quick trio and zamba2 in one pool, dstack and temporal
    torch.cuda.reset_peak_memory_stats()
    l4 = _pool_phase(torch, "l4", POOL_HYBRID_MODELS, POOL_PATH)
    l4["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    add(l4.pop("launches"))
    out["l4"] = l4
    out["launches"] = launches
    serve_keys = ("tokens_per_s", "tick_ms_p50", "tick_ms_p99",
                  "decode_floor_ms", "tick_p50_over_floor", "busy_share",
                  "ticks", "dispatches", "recomputed_continuations",
                  "peak_mem_bytes")
    _emit({k: v for k, v in out.items() if k not in ("l1", "l2", "l3",
                                                      "l4")}
          | {"l1": {n: {k: r[k] for k in serve_keys}
                    for n, r in l1.items()}
             | {"ring_streams_equal_to_paged":
                l1["ring"]["streams_equal_to_paged"]},
             "l2": {k: l2[k] for k in ("tokens_per_s", "prefill_s",
                                       "peak_mem_bytes")},
             "l3": {k: l3[k] for k in (
                 "layers", "decode_step_ms", "decode_floor_ms",
                 "graphed_step_over_floor", "peak_mem_bytes",
                 "graph_pool_bytes")}
             | {"tokens_per_s": [r["tokens_per_s"]
                                 for r in l3["generate"]]},
             "l4": {p: {k: r[k] for k in ("served", "violated",
                                          "admissions")}
                    for p, r in l4["serves"].items()}
             | {"captures": l4["captures"],
                "graph_pool_bytes": l4["graph_pool_bytes"],
                "peak_mem_bytes": l4["peak_mem_bytes"],
                "zamba2_profile": l4["profiles"][HYBRID]}})
    return out


# --------------------------------------------------------------------------
# phase (m): training through the normal entry point
# --------------------------------------------------------------------------
# (m1) and (m2): model, batch, sequence, steps, at full width and depth
TRAIN_RUNS = {"m1": ("qwen2-0.5b", 8, 2048, 30),
              "m2": ("olmo-1b", 4, 2048, 10)}
TRAIN_PATH = ("flash_attention", "flash_attention_bwd")
TRAIN_DROP = 1.0     # nats the mean of the last 5 losses must fall by


def _model_flops(cfg, n_params, b, s):
    """Model FLOPs of one training step: 6 * N * tokens for the matmuls,
    plus 3 times the causal attention's forward (4 * pairs * D per head
    and layer); the forward that remat runs again is not counted."""
    pairs = s * (s + 1) // 2
    attn = 4.0 * pairs * cfg.resolved_head_dim * cfg.num_heads * b
    return 6.0 * n_params * b * s + 3.0 * attn * cfg.num_layers


def _train_run(torch, phase, model, b, s, steps):
    """``launch.train.main`` at full width in bf16 with remat: the losses,
    each step's wall and launches, and the last parameters."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.training.optimizer import tree_leaves
    cfg = get_config(model)
    steps_s, launches, kept = [], [], {}

    def on_step(i, params, metrics, step_s):
        steps_s.append(step_s)
        launches.append(_launch_counts())
        _reset_launch_counts()
        kept["params"] = params

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.perf_counter()
    losses = train.main(
        ["--arch", model, "--full-size", "--steps", str(steps),
         "--batch", str(b), "--seq", str(s), "--dtype", "bfloat16",
         "--log-every", str(max(1, steps // 3))], on_step=on_step)
    wall = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(kept["params"]))
    step_s = float(np.median(steps_s[1:]))
    flops = _model_flops(cfg, n_params, b, s)
    total = {n: sum(c[n] for c in launches) for n in KERNEL_NAMES}
    first, last5 = losses[0], float(np.mean(losses[-5:]))
    out = {"model": model, "layers": cfg.num_layers, "batch": b, "seq": s,
           "steps": steps, "params": n_params, "losses": losses,
           "first_loss": first, "last5_mean": last5,
           "first_step_s": steps_s[0], "s_per_step": step_s,
           "tokens_per_s": b * s / step_s,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "model_flops_per_step": flops,
           "model_flops_share": flops / step_s / PEAK_FLOPS["bfloat16"],
           "launches_per_step": launches[-1], "launches": total,
           "wall_s": wall}
    _log(json.dumps({phase: {k: v for k, v in out.items()
                             if k != "losses"}}))
    assert all(np.isfinite(losses)), f"{phase}: a loss is not finite"
    assert last5 <= first - TRAIN_DROP, \
        f"{phase}: loss {first} -> {last5} (mean of the last 5)"
    for i, c in enumerate(launches):
        _check_launches(c, TRAIN_PATH, f"{phase}/step {i}")
        assert c["flash_attention"] >= cfg.num_layers \
            and c["flash_attention_bwd"] >= cfg.num_layers, (phase, i, c)
    return out, kept["params"], cfg


def _checkpoint_round_trip(torch, cfg, params):
    """(m3): ``training/checkpoint`` on the card: save (m1)'s parameters,
    load them back bit for bit, and ``eval_step``'s loss before and after
    on one eval batch."""
    import tempfile
    from repro_torch.data.pipeline import eval_batch
    from repro_torch.models.registry import build_model
    from repro_torch.training import checkpoint
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_step import make_eval_step
    api = build_model(cfg, "cuda")
    eval_step = make_eval_step(api)
    batch = eval_batch(cfg, 4, 2048, device="cuda")
    before = float(eval_step(params, batch)["loss"])
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "m1.msgpack")
        t0 = time.perf_counter()
        checkpoint.save(path, params)
        save_s = time.perf_counter() - t0
        nbytes = Path(path).stat().st_size
        t0 = time.perf_counter()
        loaded = checkpoint.load(path, params)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    equal = all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                  tree_leaves(loaded)))
    after = float(eval_step(loaded, batch)["loss"])
    out = {"file_bytes": nbytes, "save_s": save_s, "load_s": load_s,
           "bit_equal": equal, "eval_loss_before": before,
           "eval_loss_after": after}
    _log(json.dumps({"m3": out}))
    assert equal, "m3: the loaded parameters differ"
    assert after == before, f"m3: eval loss {before} -> {after}"
    return out


def _profile_step(torch, cfg, params, b, s):
    """One more training step of (m1)'s model under the profiler: the
    device time by kernel and the device's busy share of the step."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.registry import build_model
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import make_train_step
    api = build_model(dataclasses.replace(cfg, dtype="bfloat16"), "cuda")
    opt = AdamW(lr=1e-4)
    step = make_train_step(api, opt)
    state = opt.init(params)
    batch = next(iter(TokenPipeline(api.cfg, DataConfig(b, s, seed=5),
                                    "cuda")))
    step(params, state, batch)                   # warm
    _, prof = _profile(torch, lambda: step(params, state, batch))
    return prof


def phase_m(torch):
    """Training: (m1) qwen2-0.5b whole, (m3) its parameters' checkpoint
    round trip and one profiled step, (m2) olmo-1b whole (head_dim 128)."""
    out = {"phase": "m"}
    out["m1"], params, cfg = _train_run(torch, "m1", *TRAIN_RUNS["m1"])
    out["m3"] = _checkpoint_round_trip(torch, cfg, params)
    prof = _profile_step(torch, cfg, params, *TRAIN_RUNS["m1"][1:3])
    out["m1"]["profile"] = prof
    out["m1"]["device_busy_share"] = prof["device_busy_share"]
    del params
    _release(torch)
    out["m2"], params, _ = _train_run(torch, "m2", *TRAIN_RUNS["m2"])
    del params
    out["launches"] = {n: out["m1"]["launches"][n] + out["m2"]["launches"][n]
                       for n in KERNEL_NAMES}
    keys = ("s_per_step", "tokens_per_s", "peak_mem_bytes",
            "model_flops_share", "first_loss", "last5_mean",
            "launches_per_step")
    _emit({"phase": "m", **{r: {k: out[r][k] for k in keys}
                            for r in ("m1", "m2")},
           "m1_busy_share": out["m1"]["device_busy_share"],
           "m1_profiled_step_ms": {
               "device": prof["device_ms"], "wall": prof["wall_ms"],
               **{n: k["ms"] for n, k in prof["port_kernels"].items()}},
           "m3": {k: out["m3"][k] for k in ("bit_equal", "eval_loss_before",
                                            "eval_loss_after")}})
    return out


# (c)'s training check: full width cut to 2 layers, float32, B 2 x S 1536
# (past 1024: the CPU takes the plain flash VJP, chunks of 512); the loss
# within this relative error, every gradient leaf within GRAD_TOL of its
# max |value|
TRAIN_C = dict(layers=2, batch=2, seq=1536)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4


def _train_pair(torch, name):
    """One training step's loss and gradients (``loss_and_grads``, remat
    on, the experts' aux loss included) on the GPU (the kernels) and on
    the CPU (the plain versions) from the same weights and batch."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.registry import build_model
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_step import loss_and_grads
    cfg = dataclasses.replace(get_config(name), num_layers=TRAIN_C["layers"],
                              dtype="float32")
    weights = build_model(cfg, "cuda").init(
        torch.Generator(device="cuda").manual_seed(3))
    res, launches, secs = {}, None, {}
    for dev in ("cuda", "cpu"):
        api = build_model(cfg, dev)
        params = {"cuda": weights, "cpu": _to_cpu(weights)}[dev]
        params = _tree_map(params, lambda t: t.detach().requires_grad_(True))
        batch = next(iter(TokenPipeline(cfg, DataConfig(
            TRAIN_C["batch"], TRAIN_C["seq"], seed=4), dev)))
        _reset_launch_counts()
        t0 = time.perf_counter()
        res[dev] = loss_and_grads(api, params, batch, remat=True)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = _launch_counts()
        secs[dev] = time.perf_counter() - t0
    (mg, gg), (mc, gc_) = res["cuda"], res["cpu"]
    loss_err = abs(float(mg["loss"]) - float(mc["loss"])) / abs(
        float(mc["loss"]))
    worst = 0.0
    for a, b in zip(tree_leaves(gg), tree_leaves(gc_)):
        scale = float(b.abs().max())
        worst = max(worst, float((a.cpu() - b).abs().max())
                    / max(scale, 1e-30))
    out = dict(loss_gpu=float(mg["loss"]), loss_cpu=float(mc["loss"]),
               loss_rel_err=loss_err, aux_loss=float(mg["aux_loss"]),
               grad_worst_rel_err=worst, launches=launches,
               gpu_s=secs["cuda"], cpu_s=secs["cpu"],
               close=loss_err <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_TOL)
    _log(json.dumps({f"train {name}": out}))
    assert out["close"], f"train {name}: GPU and CPU differ: {out}"
    _check_launches(launches, TRAIN_PATH, f"c/train {name}")
    return out


def _insert_step_serve(eng, prompts, budgets):
    """Continuous batching through ``insert``/``step``/``free``: requests
    enter free slots in order, every active slot steps, done slots free.
    Returns each request's greedy tokens."""
    streams = {i: [] for i in range(len(prompts))}
    owner, nxt = {}, 0
    while nxt < len(prompts) or owner:
        while nxt < len(prompts) and eng.can_admit(prompts[nxt].shape[1],
                                                   budgets[nxt]):
            owner[eng.insert({"tokens": prompts[nxt]},
                             n_tokens=budgets[nxt])] = nxt
            nxt += 1
        tok, done = eng.step()
        t = tok.cpu().numpy()
        for slot, rid in owner.items():
            streams[rid].append(int(t[slot]))
        for slot in done:
            eng.free(slot)
            del owner[slot]
    return streams


def _both(engines, run):
    """``run`` on the GPU engine, then on the CPU one. Returns the two
    results, the GPU run's launches and the CPU run's seconds."""
    _reset_launch_counts()
    gpu = run(engines[0])
    launches = _launch_counts()
    t0 = time.perf_counter()
    cpu = run(engines[1])
    return (gpu, cpu), launches, time.perf_counter() - t0


def phase_c(torch, i3=None):
    """GPU against CPU at full width cut to 2 layers, float32. ``i3``:
    phase (i3)'s report, whose virtual-clock scorecards the GPU gateway
    serves must equal."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import InferenceEngine, make_engine
    from repro_torch.serving.telemetry import Telemetry, TraceRecorder
    cfg = dataclasses.replace(get_config("olmo-1b"), num_layers=2,
                              dtype="float32")
    gpu_params = make_engine(cfg, seed=1, device="cuda").params
    params = {"cuda": gpu_params, "cpu": _to_cpu(gpu_params)}

    def pair(c, cache_len, weights=params):
        """(GPU engine, CPU engine) of config ``c`` on the same weights."""
        return tuple(InferenceEngine(build_model(c, device=d), weights[d],
                                     cache_len=cache_len)
                     for d in ("cuda", "cpu"))

    checks = {}

    def check(name, engines, run, ran, first_logits, **extra):
        """Run a path on both devices: identical streams, exactly the
        path's kernels launched on the GPU; records the first-token
        logits' max difference."""
        streams, launches, cpu_s = _both(engines, run)
        lg = [first_logits(e).float().cpu() for e in engines]
        same = streams[0] == streams[1]
        checks[name] = dict(
            streams_identical=same,
            first_token_logits_max_abs_diff=float(
                (lg[0] - lg[1]).abs().max()),
            launches=launches, cpu_s=cpu_s, **extra)
        _log(json.dumps({name: checks[name]}))
        assert same, f"{name}: GPU and CPU greedy streams differ: {streams}"
        _check_launches(launches, ran, f"c/{name}")
        return streams[0]

    reqs, prompts = _requests(6, (20, 301), (8, 33), cfg.vocab_size, 1)
    lens = [r.prompt_len for r in reqs]
    engines = [e.init_slots(4, page_size=16) for e in pair(cfg, 512)]
    packed = {k: torch.from_numpy(v) for k, v in engines[1]._pack_prompts(
        [{"tokens": prompts[r.rid]} for r in reqs], lens).items()}
    row_len = 1 << max(0, max(lens) - 1).bit_length()

    def packed_logits(eng):
        dev = {k: v.to(eng.device) for k, v in packed.items()}
        return eng.api.prefill_packed(eng.params, dev, row_len)[0][:len(reqs)]

    def serve(eng):
        return _serve(eng, reqs, prompts, chunk_tokens=128)[0]

    # 1. paged serve with incremental continuations
    got = check("paged_serve", engines, serve, PAGED_PATH, packed_logits,
                requests=len(reqs),
                packed_tokens=engines[0].segment_key(lens)[0])
    assert engines[0].stats.incr_chunks > 0, "no continuation ran"
    checks["paged_serve"]["tokens"] = sum(map(len, got.values()))

    # 1b. the same serve with the telemetry plane attached: the untraced
    # streams, and one trace key sequence (every field but wall-clock)
    # on both devices
    def traced_serve(eng):
        tel = Telemetry(trace=TraceRecorder())
        streams = _serve(eng, reqs, prompts, chunk_tokens=128,
                         telemetry=tel)[0]
        return streams, tel.trace.key_sequence()

    traced, keys = check("traced_serve", engines, traced_serve, PAGED_PATH,
                         packed_logits, events=None)
    assert traced == got, "the traced serve changed the streams"
    checks["traced_serve"]["events"] = len(keys)

    # 2. the radix prompt cache: a shared-prefix serve cache off, then on
    # — the streams must be the same, on each device. Templates of 203 and
    # 76 tokens leave 11 and 12 in their last page of 16, which a tail of
    # 5 or 6 fills: later hits end inside that page and copy it
    preqs, pprompts = _shared_prefix_requests(
        cfg.vocab_size, 10, 16, ((203, 0.5), (76, 0.5)), seed=1)
    engines = [e.init_slots(4, page_size=16) for e in pair(cfg, 512)]
    for e in engines:
        e.enable_prefix_cache()
        e.warm_prefix_ops()

    def prefix_serves(eng):
        off = _serve(eng, preqs, pprompts, chunk_tokens=128)[0]
        on = _serve(eng, preqs, pprompts, chunk_tokens=128,
                    prefix_cache=True)[0]
        assert on == off, "prefix cache: cache-on streams differ"
        st = eng.stats
        assert st.prefix_hits and st.cow_copies, st
        return on, dataclasses.asdict(st)

    check("prefix_cache", engines, prefix_serves, PAGED_PATH, packed_logits,
          requests=len(preqs))

    # 3. speculative decoding with an identical-weights ring draft at
    # spec_k 4: the streams of plain decoding, acceptance 1.0
    engines = [e.init_slots(4, page_size=16) for e in pair(cfg, 512)]
    for e in engines:
        e.attach_draft(InferenceEngine(e.api, e.params, cache_len=512)
                       .init_slots(4, paged=False), spec_k=4)

    def spec_serves(eng):
        plain = _serve(eng, reqs, prompts, chunk_tokens=128)[0]
        spec = _serve(eng, reqs, prompts, chunk_tokens=128, spec_k=4)[0]
        assert spec == plain, "speculative streams differ from plain"
        st = eng.stats
        assert st.spec_rounds and st.accepted_tokens == st.draft_tokens, st
        return spec, dataclasses.asdict(st)

    check("speculative", engines, spec_serves, SPEC_PATH, packed_logits,
          spec_k=4, acceptance=1.0)

    # 4. batch generate: 4 prompts of 300 tokens, 24 new tokens each
    tokens = np.random.default_rng(2).integers(
        1, cfg.vocab_size, (4, 300)).astype(np.int32)
    greedy_gen = check(
        "generate", pair(cfg, 256),
        lambda e: e.generate({"tokens": tokens}, 24).cpu().tolist(),
        GENERATE_PATH,
        lambda e: e.prefill({"tokens": tokens}, e.bucket_len(300 + 32))[0],
        batch=4, prompt_len=300, new_tokens=24)

    # 4b. sampling configs that leave one choice (temperature 0; top-k 1)
    # on sampled slots and in sampled generate: the greedy streams
    def degenerate(eng):
        out = {}
        for name, sp in (("temperature_0", _sampling(temperature=0.0)),
                         ("top_k_1", _sampling(temperature=0.8, top_k=1))):
            eng.init_slots(4, page_size=16, sampling=sp, rng_seed=1)
            out[name] = _serve(eng, reqs, prompts, chunk_tokens=128)[0]
            out[f"{name}/generate"] = eng.generate(
                {"tokens": tokens}, 24, rng=1, sampling=sp).cpu().tolist()
        return out

    got_s = check("sampled_greedy", pair(cfg, 512), degenerate,
                  PAGED_PATH + GENERATE_PATH, packed_logits)
    for name, streams in got_s.items():
        assert streams == (greedy_gen if name.endswith("generate")
                           else got), f"sampled {name} is not greedy"

    # 5. ring serve: continuations recompute the prefix
    engines = [e.init_slots(4, paged=False) for e in pair(cfg, 512)]
    check("ring_serve", engines, serve, RING_PATH, packed_logits)
    assert engines[0].stats.chunk_prefills > 0, "no continuation ran"

    # 6. sliding window 128 on 128-row rings. serve_ticks caps a ring
    # slot's budget at slot_len - prompt, so to wrap the rings the
    # requests go through insert/step, whose ring budgets are uncapped:
    # prompt + budget > 128 for every request
    wcfg = dataclasses.replace(cfg, sliding_window=128)
    engines = [e.init_slots(4) for e in pair(wcfg, 128)]
    assert not engines[0].paged, "a windowed config must take ring slots"
    rng = np.random.default_rng(4)
    wprompts = [rng.integers(1, cfg.vocab_size, (1, int(n))).astype(
        np.int32) for n in rng.integers(60, 129, size=5)]
    wbudgets = [int(n) for n in rng.integers(40, 90, size=5)]
    assert all(p.shape[1] + b > 128 for p, b in zip(wprompts, wbudgets))
    got = check("window_ring", engines,
                lambda e: _insert_step_serve(e, wprompts, wbudgets),
                GENERATE_PATH,
                lambda e: e.prefill({"tokens": wprompts[0]}, 128)[0],
                window=128, requests=len(wprompts))
    checks["window_ring"]["tokens"] = sum(map(len, got.values()))

    # 7. mamba2-1.3b at full width cut to 2 layers: a serve with
    # recomputed continuations, then batch generate
    mcfg = dataclasses.replace(get_config("mamba2-1.3b"), num_layers=2,
                               dtype="float32")
    mgpu = make_engine(mcfg, seed=1, device="cuda").params
    mparams = {"cuda": mgpu, "cpu": _to_cpu(mgpu)}
    mreqs, mprompts = _requests(6, (20, 301), (8, 33), mcfg.vocab_size, 6,
                                mcfg.name)
    engines = [e.init_slots(4) for e in pair(mcfg, 512, mparams)]
    assert not engines[0].paged
    got = check("ssm_serve", engines,
                lambda e: _serve(e, mreqs, mprompts, chunk_tokens=128)[0],
                SSM_PATH,
                lambda e: e.prefill({"tokens": mprompts[0]})[0],
                requests=len(mreqs))
    assert engines[0].stats.chunk_prefills > 0, "no continuation ran"
    checks["ssm_serve"]["tokens"] = sum(map(len, got.values()))
    mtokens = np.random.default_rng(7).integers(
        1, mcfg.vocab_size, (4, 300)).astype(np.int32)
    check("ssm_generate", pair(mcfg, 256, mparams),
          lambda e: e.generate({"tokens": mtokens}, 24).cpu().tolist(),
          SSM_PATH, lambda e: e.prefill({"tokens": mtokens})[0],
          batch=4, prompt_len=300, new_tokens=24)

    # 7b. whisper-small at full width cut to 2 encoder and 2 decoder
    # layers: a paged serve and a ring serve with recomputed
    # continuations, then batch generate
    wcfg = dataclasses.replace(get_config("whisper-small"), num_layers=2,
                               encoder_layers=2, dtype="float32")
    wgpu = make_engine(wcfg, seed=1, device="cuda").params
    wparams = {"cuda": wgpu, "cpu": _to_cpu(wgpu)}
    wreqs, wprompts = _whisper_requests(torch, wcfg, 6, (4, 225), (8, 33), 8)

    def wserve(eng):
        return _serve(eng, wreqs, wprompts, chunk_tokens=WHISPER_CHUNK)[0]

    def wlogits(eng):
        return eng.prefill(wprompts[0], WHISPER_SLOT_LEN)[0]

    for name, paged, ran in (("whisper_paged_serve", True,
                              WHISPER_PAGED_PATH),
                             ("whisper_ring_serve", False,
                              WHISPER_RING_PATH)):
        engines = [e.init_slots(4, page_size=16, paged=paged)
                   for e in pair(wcfg, WHISPER_SLOT_LEN, wparams)]
        got = check(name, engines, wserve, ran, wlogits,
                    requests=len(wreqs))
        assert engines[0].stats.chunk_prefills > 0, "no continuation ran"
        checks[name]["tokens"] = sum(map(len, got.values()))
    wtokens = np.random.default_rng(10).integers(
        1, wcfg.vocab_size, (4, 64)).astype(np.int32)
    from repro_torch.serving import modality
    wbatch = {"tokens": wtokens, "enc_embeds": modality.audio_frames(
        wcfg, 4, generator=torch.Generator().manual_seed(10))}
    check("whisper_generate", pair(wcfg, 256, wparams),
          lambda e: e.generate(wbatch, 24).cpu().tolist(), GENERATE_PATH,
          lambda e: e.prefill(wbatch)[0], batch=4, prompt_len=64,
          new_tokens=24)

    # 7c. granite-moe at full width cut to 2 layers: a paged serve whose
    # continuations recompute the prefix, a shared-prefix serve cache off
    # then on (a hit caught up by forced tokens; the experts' streams of
    # the two may differ, since the cache changes who shares a dispatch),
    # batch generate; and one packed prefill's expert indices and drop
    # masks, every layer, equal on both devices
    gcfg = dataclasses.replace(get_config(MOE), num_layers=2,
                               dtype="float32")
    ggpu = make_engine(gcfg, seed=1, device="cuda").params
    gparams = {"cuda": ggpu, "cpu": _to_cpu(ggpu)}
    greqs, gprompts = _requests(8, (64, 301), (8, 17), gcfg.vocab_size, 11,
                                gcfg.name)
    glens = [r.prompt_len for r in greqs]
    engines = [e.init_slots(4, page_size=16)
               for e in pair(gcfg, 512, gparams)]

    def groutes(eng):
        batch, row_len = _packed_admission(
            eng, [gprompts[r.rid] for r in greqs], glens)
        return _record_routes(lambda: eng.api.prefill_packed(
            eng.params, batch, row_len))

    (glogits, gcalls), (clogits, ccalls) = (groutes(e) for e in engines)
    # the real tokens' routes: the padding tokens after them hold what
    # each device's packed attention leaves there (the kernel attends
    # them as one more segment, the plain version copies a real row), and
    # coming last they take no slot a real token could have had
    n, k = sum(glens), gcfg.experts_per_token

    def real(c):
        return c["gate_i"][:, :n], c["dropped"][:, :n * k]

    same_routes = len(gcalls) == len(ccalls) and all(
        all(torch.equal(x, y) for x, y in zip(real(a), real(b)))
        for a, b in zip(gcalls, ccalls))
    checks["moe_routing"] = dict(
        layers=len(gcalls), tokens=int(gcalls[0]["gate_i"].shape[1]),
        real_tokens=n, routes_identical=same_routes,
        dropped=[int(real(c)[1].sum()) for c in gcalls],
        padding_routes_identical=all(
            torch.equal(a["gate_i"], b["gate_i"])
            for a, b in zip(gcalls, ccalls)),
        logits_max_abs_diff=float((glogits[0].cpu() - clogits[0])
                                  .abs().max()))
    _log(json.dumps({"moe_routing": checks["moe_routing"]}))
    assert same_routes, "moe: GPU and CPU expert indices or drops differ"

    def gpacked_logits(eng):
        batch, row_len = _packed_admission(
            eng, [gprompts[r.rid] for r in greqs], glens)
        return eng.api.prefill_packed(eng.params, batch, row_len)[0][
            :len(greqs)]

    got = check("moe_paged_serve", engines,
                lambda e: _serve(e, greqs, gprompts, chunk_tokens=128)[0],
                MOE_PAGED_PATH, gpacked_logits, requests=len(greqs))
    assert engines[0].stats.chunk_prefills > 0, "no continuation ran"
    assert engines[0].stats.incr_chunks == 0, engines[0].stats
    checks["moe_paged_serve"]["tokens"] = sum(map(len, got.values()))
    mpreqs, mpprompts = _shared_prefix_requests(
        gcfg.vocab_size, 8, 12, ((203, 0.5), (76, 0.5)), seed=2,
        model=gcfg.name)
    for e in engines:
        e.enable_prefix_cache()
        e.warm_prefix_ops()

    def moe_prefix_serves(eng):
        off = _serve(eng, mpreqs, mpprompts, chunk_tokens=128)[0]
        on = _serve(eng, mpreqs, mpprompts, chunk_tokens=128,
                    prefix_cache=True)[0]
        st = eng.stats
        assert st.prefix_hits and st.forced_catchup_tokens, st
        return off, on, dataclasses.asdict(st)

    _, gon, gst = check("moe_prefix_cache", engines, moe_prefix_serves,
                        MOE_PAGED_PATH, gpacked_logits,
                        requests=len(mpreqs))
    checks["moe_prefix_cache"]["prefix_hits"] = gst["prefix_hits"]
    gtokens = np.random.default_rng(12).integers(
        1, gcfg.vocab_size, (4, 300)).astype(np.int32)
    check("moe_generate", pair(gcfg, 256, gparams),
          lambda e: e.generate({"tokens": gtokens}, 24).cpu().tolist(),
          GENERATE_PATH,
          lambda e: e.prefill({"tokens": gtokens}, e.bucket_len(300 + 32))[0],
          batch=4, prompt_len=300, new_tokens=24)

    # 7d. zamba2-7b at full width cut to HYBRID_LAYERS (two invocations
    # of the shared block, head_dim 112, SSD N 64): one packed prefill's
    # logits, SSM states and packed K/V close on both devices, then a
    # short paged serve (continuations recompute the prefix) and
    # generate with identical streams
    hcfg = dataclasses.replace(get_config(HYBRID), num_layers=HYBRID_LAYERS,
                               dtype="float32")
    hgpu = make_engine(hcfg, seed=1, device="cuda").params
    hparams = {"cuda": hgpu, "cpu": _to_cpu(hgpu)}
    hreqs, hprompts = _requests(4, (20, 161), (6, 13), hcfg.vocab_size, 13,
                                hcfg.name)
    hlens = [r.prompt_len for r in hreqs]
    engines = [e.init_slots(4, page_size=16)
               for e in pair(hcfg, 256, hparams)]

    def hpacked(eng):
        batch, row_len = _packed_admission(
            eng, [hprompts[r.rid] for r in hreqs], hlens)
        return eng.api.prefill_packed(eng.params, batch, row_len)

    (glog, gcache), (clog, ccache) = (hpacked(e) for e in engines)
    n_seg, n_tok = len(hreqs), sum(hlens)
    cuts = {"logits": (glog[:n_seg], clog[:n_seg]),
            "ssm": (gcache["ssm"][:, :n_seg], ccache["ssm"][:, :n_seg]),
            "attn_k": (gcache["attn_k"][:, :n_tok],
                       ccache["attn_k"][:, :n_tok]),
            "attn_v": (gcache["attn_v"][:, :n_tok],
                       ccache["attn_v"][:, :n_tok])}
    errs = {k: (float((g.cpu() - c).abs().max()),
                float(c.abs().max())) for k, (g, c) in cuts.items()}
    checks["hybrid_packed_prefill"] = dict(
        segments=n_seg, tokens=n_tok, max_abs_diff={
            k: e for k, (e, _) in errs.items()},
        close=all(e <= HYBRID_F32_TOL * max(1.0, m)
                  for e, m in errs.values()))
    _log(json.dumps({"hybrid_packed_prefill":
                     checks["hybrid_packed_prefill"]}))
    assert checks["hybrid_packed_prefill"]["close"], errs
    del glog, gcache, clog, ccache, cuts

    def hlogits(eng):
        return hpacked(eng)[0][:len(hreqs)]

    got = check("hybrid_paged_serve", engines,
                lambda e: _serve(e, hreqs, hprompts, chunk_tokens=64)[0],
                HYBRID_PAGED_PATH, hlogits, requests=len(hreqs))
    assert engines[0].stats.chunk_prefills > 0, "no continuation ran"
    checks["hybrid_paged_serve"]["tokens"] = sum(map(len, got.values()))
    htokens = np.random.default_rng(16).integers(
        1, hcfg.vocab_size, (2, 160)).astype(np.int32)
    check("hybrid_generate", pair(hcfg, 256, hparams),
          lambda e: e.generate({"tokens": htokens}, 12).cpu().tolist(),
          HYBRID_GENERATE_PATH,
          lambda e: e.prefill({"tokens": htokens})[0],
          batch=2, prompt_len=160, new_tokens=12)
    del engines, hparams, hgpu

    # 8. the pool: bench_pool's four models (the quick trio and
    # whisper-small) at full width cut to 2 layers, under dstack on each
    # device — the same admissions and counts
    pools = _pool_pair(torch)
    logs, results = [], []
    _reset_launch_counts()
    for i, pool in enumerate(pools):
        t0 = time.perf_counter()
        _, res, log = _pool_serve(pool, "dstack")
        if i == 0:
            launches = _launch_counts()
        logs.append(log)
        results.append({n: (m.completed, m.violated, m.dropped)
                        for n, m in res.per_model.items()})
    cpu_s = time.perf_counter() - t0
    same = logs[0] == logs[1] and results[0] == results[1]
    checks["pool_dstack"] = dict(
        models=list(POOL_FULL_MODELS),
        admissions_identical=logs[0] == logs[1],
        counts_identical=results[0] == results[1],
        admissions=len(logs[0]), counts=results[0], launches=launches,
        cpu_s=cpu_s)
    _log(json.dumps({"pool_dstack": checks["pool_dstack"]}))
    assert same, f"pool: GPU and CPU differ: {results}"
    assert all(c > 0 for c, _, _ in results[0].values()), results
    _check_launches(launches, POOL_FULL_PATH, "c/pool_dstack")
    del pools

    # 9. the async gateway on the virtual clock, FIFO and tiers, on 4
    # paged slots of 32 (pages of 8): bench_gateway --full's burst trace
    # on the GPU, whose scorecards (host decisions) must equal phase
    # (i3)'s at full depth in bf16; and its quick slice on both devices,
    # identical streams and scorecards
    engines = [e.init_slots(GW_SLOTS, page_size=GW_PAGE)
               for e in pair(cfg, GW_CACHE)]
    t0 = time.perf_counter()
    _warm_packings(engines[0], *GW_TRAFFIC["prompt_tokens"])
    cards = {p: v[1] for p, v in _gw_virtual(engines[0]).items()}
    full_s = time.perf_counter() - t0
    check("gateway", engines, lambda e: _gw_virtual(e, GW_QUICK), GW_PATH,
          packed_logits, duration=GW_QUICK, cards=cards, full_trace_s=full_s,
          cards_equal_i3=None if i3 is None else all(
              cards[p] == i3["virtual"][p]["card"] for p in GW_POLICIES))
    assert checks["gateway"]["cards_equal_i3"] in (None, True), \
        "gateway: (i3)'s bf16 scorecards differ from the float32 ones"

    # 10. training: one step's loss and gradients, GPU against CPU, for
    # the dense family and the experts
    for name in ("qwen2-0.5b", MOE):
        checks[f"train_{name}"] = _train_pair(torch, name)

    out = {"phase": "c",
           "model": "olmo-1b, mamba2-1.3b, qwen2-0.5b, whisper-small, "
                    "granite-moe-3b-a800m (2 layers), zamba2-7b "
                    f"({HYBRID_LAYERS} layers)",
           "dtype": "float32",
           "checks": {k: {kk: v[kk] for kk in (
               "streams_identical", "first_token_logits_max_abs_diff",
               "admissions_identical", "counts_identical",
               "cards_equal_i3", "routes_identical", "close",
               "loss_rel_err", "grad_worst_rel_err") if kk in v}
               for k, v in checks.items()}}
    _emit(out)
    return dict(out, checks=checks)


def _pool_pair(torch):
    """(GPU pool, CPU pool) of ``bench_pool``'s four models (the quick
    trio and whisper-small) at full width cut to 2 layers
    (whisper: 2 encoder and 2 decoder layers), float32, on the same
    weights: 4 paged slots of 256 tokens per standby, 32-token prompts
    (whisper's with the same stub frames), profiles on the card's
    ``Hardware``."""
    from repro_torch.configs import get_config
    from repro_torch.core.hardware import local_gpu
    from repro_torch.core.profiles import build_profile
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.pool import (EnginePool, ModelHost,
                                          StandbyAllocation,
                                          default_allocations)
    hw = local_gpu()
    hosts = {"cuda": {}, "cpu": {}}
    for i, name in enumerate(POOL_FULL_MODELS):
        cfg = dataclasses.replace(get_config(name), num_layers=2,
                                  dtype="float32")
        if cfg.has_encoder:
            cfg = dataclasses.replace(cfg, encoder_layers=2)
        prof = build_profile(name, request_rate=POOL_RATE, hw=hw)
        api = build_model(cfg, "cuda")
        params = {"cuda": api.init(
            torch.Generator(device="cuda").manual_seed(i))}
        params["cpu"] = _to_cpu(params["cuda"])
        for dev in ("cuda", "cpu"):
            api = build_model(cfg, dev)
            standby = {c: StandbyAllocation(c, 4, InferenceEngine(
                api, params[dev], cache_len=256, alloc_chips=c).init_slots(
                    4, page_size=16)) for c in default_allocations(prof)}
            hosts[dev][name] = ModelHost(cfg, api, params[dev], prof,
                                         standby, prompt_len=32)
    pools = [EnginePool(hosts[d]) for d in ("cuda", "cpu")]
    for pool in pools:
        pool.warmup()
    return pools


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="abdefghijklmc",
                    help="which phases to run, of a, b, d, e, f, g, h, i, "
                         "j, k, l, m, c (default: all)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        _log("chip_smoke: no CUDA device")
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        _log(f"chip_smoke: the port's sources are not under {src}")
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(exist_ok=True)
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    logs = build.build_logs()
    (OUT_DIR / "ptxas.log").write_text(
        "\n".join(f"== {n}\n{t}" for n, t in logs.items()))
    for n, t in logs.items():
        for line in t.splitlines():
            if "registers" in line or "spill" in line:
                _log(f"{n}: {line.strip()}")
    _log(f"kernels built in {build_s:.1f} s")
    # the bf16 kernels must run on the tensor cores (wgmma: HGMMA)
    hgmma = {lib: build.sass_count(lib, "HGMMA")
             for lib in TENSOR_CORE_KERNELS}
    _log(f"HGMMA instructions per kernel: {hgmma}")
    for lib, wanted in TENSOR_CORE_KERNELS.items():
        for name, count in wanted:
            tc = {k: n for k, n in hgmma[lib].items() if name in k}
            assert len(tc) == count and all(tc.values()), (name, hgmma)
    report = {"build_s": build_s, "sass_hgmma": hgmma}
    summary, paged_streams = {}, None
    main_launches = {n: 0 for n in KERNEL_NAMES}
    report["phase_s"] = seconds = {}

    def timed(phase, fn, *a):
        t = time.perf_counter()
        out = fn(torch, *a)
        _release(torch)
        seconds[phase] = time.perf_counter() - t
        _log(f"phase {phase} took {seconds[phase]:.1f} s")
        return out

    if "a" in args.phases:
        report["a"], summary = timed("a", phase_a)
    if "b" in args.phases:
        report["b"], paged_streams = timed("b", phase_b)
    if "d" in args.phases:
        report["d"] = timed("d", phase_d)
    if "e" in args.phases:
        report["e"] = timed("e", phase_e, paged_streams)
    if "f" in args.phases:
        report["f"] = timed("f", phase_f)
    keep = {}          # (g)'s pool, kept for (i4)
    if "g" in args.phases:
        report["g"] = timed("g", phase_g, keep if "i" in args.phases
                            else None)
    if "h" in args.phases:
        report["h"] = timed("h", phase_h)
    if "i" in args.phases:
        report["i"] = timed("i", phase_i, paged_streams, keep)
        keep.clear()
        torch.cuda.empty_cache()
    if "j" in args.phases:
        report["j"] = timed("j", phase_j)
    if "k" in args.phases:
        report["k"] = timed("k", phase_k)
    if "l" in args.phases:
        report["l"] = timed("l", phase_l)
    if "m" in args.phases:
        report["m"] = timed("m", phase_m)
    for phase in "bdefghijklm":
        for name, n in report.get(phase, {}).get("launches", {}).items():
            main_launches[name] += n
    if "c" in args.phases:
        report["c"] = timed("c", phase_c, report.get("i", {}).get("i3"))
    if summary:
        if all(p in args.phases for p in "bdefghijklm"):
            assert all(main_launches.values()), main_launches
            for name, row in summary.items():
                row["launches"] = main_launches[name]
        _emit({"kernels": list(summary.values())})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    report["card"] = card
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    _emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
