"""Warm up every step shape a cell's traffic can reach, before the window.

The engine keeps one executable (on the card a captured CUDA graph) per
step key: ``(T, row_len, S)`` of a packed prefill or a chunk continuation
(the packed row's bucketed length, the per-segment row length and the
segment axis, ``InferenceEngine.segment_key``), and one slot step. A cell
names, per kind, the admissions its traffic can make in one tick: up to
``n_max`` segments of ``lo``..``hi`` tokens each, at most ``sum_max`` in
all. ``witnesses`` gives one list of lengths for each key that such a
batch can reach; ``warm`` drives the engine through each once and frees
everything, so the window captures nothing.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def packed_bucket(n: int) -> int:
    """Smallest of {2^k, 3 * 2^(k-1)} >= n: the packed row's buckets."""
    p = pow2_at_least(n)
    half = 3 * p // 4
    return half if half >= n else p


def _fill(n: int, s: int, m: int, lo: int) -> List[int]:
    """n lengths in [lo, m], the first m, summing to s."""
    lens = [m]
    rest = s - m
    for j in range(n - 1, 0, -1):
        take = min(m, rest - lo * (j - 1))
        lens.append(take)
        rest -= take
    return lens


def witnesses(n_max: int, lo: int, hi: int,
              sum_max: Optional[int] = None) -> List[List[int]]:
    """Lists of segment lengths, one per (packed bucket, row bucket,
    segment bucket) that ``n_max`` segments of ``lo``..``hi`` tokens (at
    most ``sum_max`` in all) can reach."""
    seen: Dict[Tuple[int, int, int], List[int]] = {}
    for n in range(1, n_max + 1):
        # the lengths whose row bucket is r: (r/2, r] within [lo, hi]
        r = pow2_at_least(lo)
        while r // 2 < hi:
            m_lo, m_hi = max(lo, r // 2 + 1), min(hi, r)
            if m_lo <= m_hi:
                s_lo = m_lo + (n - 1) * lo
                s_hi = n * m_hi if sum_max is None else min(n * m_hi,
                                                            sum_max)
                s = s_lo
                while s <= s_hi:
                    b = packed_bucket(s)
                    top = min(b, s_hi)
                    m = max(m_lo, -(-top // n))
                    if m <= min(m_hi, top - (n - 1) * lo):
                        key = (b, r, pow2_at_least(n))
                        seen.setdefault(key, _fill(n, top, m, lo))
                    s = b + 1
            r *= 2
    return list(seen.values())


def _ones(n: int):
    return {"tokens": np.ones((1, n), np.int32)}


def warm(eng, spec: Dict[str, Dict[str, int]]) -> Dict[str, int]:
    """Capture the cell's packed-prefill and chunk keys and the slot step
    on ``eng``; free every slot. Returns the keys warmed per kind."""
    done = {"packed": 0, "chunk": 0}
    packed = spec.get("packed")
    keys = set()
    if packed:
        for lens in witnesses(packed["n_max"], packed["lo"], packed["hi"],
                              packed.get("sum_max")):
            key = eng.segment_key(lens)
            if key in keys:
                continue
            keys.add(key)
            eng.insert_many([_ones(n) for n in lens],
                            n_tokens=[1] * len(lens))
            eng.release_all_slots()
            done["packed"] += 1
    chunk = spec.get("chunk")
    keys = set()
    if chunk:
        for lens in witnesses(chunk["n_max"], chunk["lo"], chunk["hi"],
                              chunk.get("sum_max")):
            key = eng.segment_key(lens)
            if key in keys:
                continue
            keys.add(key)
            slots = eng.insert_many([_ones(1) for _ in lens],
                                    n_tokens=[n + 1 for n in lens])
            eng.chunk_append([(s, _ones(1 + n), True)
                              for s, n in zip(slots, lens)])
            eng.release_all_slots()
            done["chunk"] += 1
    # the slot step: one executable over every slot
    eng.insert_many([_ones(1)], n_tokens=[1])
    eng.step()
    eng.release_all_slots()
    eng.reset_stats()
    return done
