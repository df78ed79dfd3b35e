"""Window arithmetic for the end-to-end metrics, over every sample.

A request is stamped by its client: when it was due (its scheduled send
time, or the moment a closed-loop client sent it) and when each token
reached the client. The nearest-rank percentile is the one
``repro_torch.serving.metrics.percentile`` computes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 1]) of ``xs``; nan when empty."""
    if not xs:
        return float("nan")
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))]


@dataclasses.dataclass
class Record:
    """One request as its client saw it."""
    rid: int
    due: float                        # perf_counter seconds
    prompt: object                    # (prompt_len,) int32 array
    n_tokens: int
    stamps: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    state: Optional[str] = None       # the stream's terminal state
    refused: bool = False


def tokens_in(records: Sequence[Record], t0: float, t1: float) -> int:
    """Tokens that reached clients in [t0, t1)."""
    return sum(1 for r in records for s in r.stamps if t0 <= s < t1)


def gaps_in(records: Sequence[Record], t0: float, t1: float) -> List[float]:
    """Every gap between consecutive tokens of a request, both in
    [t0, t1)."""
    out = []
    for r in records:
        st = r.stamps
        for a, b in zip(st, st[1:]):
            if t0 <= a and b < t1:
                out.append(b - a)
    return out


def due_in(records: Sequence[Record], t0: float, t1: float) -> List[Record]:
    return [r for r in records if t0 <= r.due < t1]


def ttfts(records: Sequence[Record]) -> List[float]:
    """Time from due to first token; a request refused or without a token
    counts as missing (infinite)."""
    return [r.stamps[0] - r.due if r.stamps and not r.refused else math.inf
            for r in records]
