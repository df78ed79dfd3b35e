"""The chip's peaks and the work a tick does, counted from its plan.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): 989 TFLOP/s in bfloat16, 3.35 TB/s of HBM.

Model FLOPs of a token: twice every weight it multiplies (the
projections, the feed-forward block, the unembedding over the real
vocabulary; the embedding lookup is free), attention's 4 * heads *
head_dim per key it attends (scores and values, causal: a token attends
itself and what precedes it), and for Mamba2 the conv's taps and the SSD
recurrence's 4 * heads * head_dim * state (state update and read-out).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

PEAK_FLOPS = 989e12          # bf16 dense, H100 SXM
PEAK_BYTES = 3.35e12         # HBM3


@dataclasses.dataclass
class Tick:
    """What one executed tick did, read from its plan before it ran."""
    t0: float                                 # perf_counter at execute
    t1: float
    decode_ctx: List[int]                     # keys each decode attends
    first: List[int]                          # first chunks' lengths
    cont: List[Tuple[int, int]]               # (history, new) per chunk


def weight_flops(cfg: Dict) -> float:
    """2 * the weights one token multiplies."""
    d, nl = cfg["d_model"], cfg["num_layers"]
    unembed = d * cfg["vocab_size"]
    if cfg["family"] == "ssm":
        di, n = cfg["ssm_expand"] * d, cfg["ssm_state"]
        h = di // cfg["ssm_head_dim"]
        per = d * (2 * di + 2 * n + h) + di * d
        per += cfg["ssm_conv_width"] * (di + 2 * n)
    else:
        hd, h, kv = cfg["head_dim"], cfg["num_heads"], cfg["num_kv_heads"]
        per = d * (h + 2 * kv) * hd + h * hd * d + 3 * d * cfg["d_ff"]
    return 2.0 * (nl * per + unembed)


def mixing_flops(cfg: Dict, keys: float) -> float:
    """Sequence mixing of one token: attention over ``keys`` keys, or
    the SSD recurrence (``keys`` unused)."""
    nl = cfg["num_layers"]
    if cfg["family"] == "ssm":
        di = cfg["ssm_expand"] * cfg["d_model"]
        return 4.0 * nl * di * cfg["ssm_state"]
    return 4.0 * nl * cfg["num_heads"] * cfg["head_dim"] * keys


def segment_keys(hist: int, n: int) -> float:
    """Keys attended in all by n tokens after ``hist``: sum of
    hist + 1 .. hist + n."""
    return n * hist + n * (n + 1) / 2.0


def tick_flops(cfg: Dict, tick: Tick) -> float:
    """Model FLOPs of every token the tick processed."""
    wf = weight_flops(cfg)
    total = 0.0
    for c in tick.decode_ctx:
        total += wf + mixing_flops(cfg, c)
    segs = [(0, n) for n in tick.first] + list(tick.cont)
    for hist, n in segs:
        if cfg["family"] == "ssm":
            total += n * (wf + mixing_flops(cfg, 0))
        else:
            total += n * wf + mixing_flops(cfg, segment_keys(hist, n))
    return total


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of its two
    bounds."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
