"""The program's own spans in a traced run (``serving.telemetry``'s
``TraceRecorder``): the host's path between two ticks, the device time of
a tick's dispatches, and each request's wait for admission and for its
first token.

Every function takes the recorder's events and its ``t0`` (the absolute
``perf_counter`` seconds of ``ts`` 0), with the window [w0, w1] where it
needs one, and returns None where the events hold nothing to read: a
program without these spans.

* A tick: a ``tick`` span on a ``tick/<model>`` track inside the window;
  its dispatches (``cat`` ``dispatch``) and ``readback`` spans lie
  inside it on the engine's track.
* The host gap after tick n: from the end of tick n's last ``readback``
  (the host has the tokens) to the start of tick n + 1's first dispatch
  span, for consecutive ticks that have both.
* A request's waits, from the planner's instants on ``queue/<model>``:
  ``queued`` to ``admitted`` (its first chunk has run) and ``admitted``
  to ``first_token``, the first of each per ``rid``.
"""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from harness.stats import percentile

# the host spans a gap is split into; ``execute`` splits into the end of
# tick n's (after its readback) and the start of tick n + 1's
SPLIT = ("wait", "deliver", "plan", "execute.pre", "execute.post",
         "observe", "pump", "yield")

Interval = Tuple[float, float]


def _start(ev, t0: float) -> float:
    return t0 + ev["ts"] / 1e6


def _end(ev, t0: float) -> float:
    return t0 + (ev["ts"] + ev["dur"]) / 1e6


def ticks(events, t0: float, w0: float, w1: float) -> List[Dict]:
    """The window's ticks in order: ``{"tick", "start", "end",
    "dispatches", "readbacks"}``, the last two the spans inside it."""
    spans = [e for e in events if e.get("ph") == "X"]
    inner = sorted((e for e in spans if e.get("cat") == "dispatch"
                    or e["name"] == "readback"), key=lambda e: e["ts"])
    starts = [e["ts"] for e in inner]
    out = []
    for e in sorted((e for e in spans if e["name"] == "tick"),
                    key=lambda e: e["ts"]):
        a, b = _start(e, t0), _end(e, t0)
        if a < w0 or b > w1:
            continue
        lo = bisect.bisect_left(starts, e["ts"])
        hi = bisect.bisect_right(starts, e["ts"] + e["dur"])
        kids = [k for k in inner[lo:hi]
                if k["ts"] + k["dur"] <= e["ts"] + e["dur"] + 1e-3]
        out.append({"tick": e["args"].get("tick"), "start": a, "end": b,
                    "dispatches": [k for k in kids
                                   if k.get("cat") == "dispatch"],
                    "readbacks": [k for k in kids
                                  if k["name"] == "readback"]})
    return out


def host_gaps(events, t0: float, w0: float, w1: float) -> List[Interval]:
    """(start, end) in absolute seconds of each host gap in the window."""
    ts = ticks(events, t0, w0, w1)
    out = []
    for a, b in zip(ts, ts[1:]):
        if (a["tick"] is None or b["tick"] != a["tick"] + 1
                or not a["readbacks"] or not b["dispatches"]):
            continue
        out.append((max(_end(r, t0) for r in a["readbacks"]),
                    min(_start(d, t0) for d in b["dispatches"])))
    return out


def host_gap_ms(events, t0: float, w0: float, w1: float
                ) -> Optional[float]:
    """Mean host gap between consecutive ticks, ms."""
    gaps = host_gaps(events, t0, w0, w1)
    if not gaps:
        return None
    return 1e3 * sum(b - a for a, b in gaps) / len(gaps)


def dispatch_device_ms(events, t0: float, w0: float, w1: float
                       ) -> Optional[float]:
    """Mean over the window's ticks of the summed ``device_dur`` of the
    tick's dispatch spans, ms (ticks with a dispatch not yet resolved
    are left out)."""
    per = [sum(d["device_dur"] for d in t["dispatches"]) / 1e3
           for t in ticks(events, t0, w0, w1)
           if t["dispatches"]
           and all("device_dur" in d for d in t["dispatches"])]
    return sum(per) / len(per) if per else None


def host_split(events, t0: float, gaps: Sequence[Interval]
               ) -> Optional[Dict[str, float]]:
    """Mean ms per gap that each host span of ``SPLIT`` covers inside the
    gaps, and ``other`` for the rest of them."""
    if not gaps:
        return None
    spans = [(_start(e, t0), _end(e, t0), e["name"]) for e in events
             if e.get("ph") == "X" and e["name"] in SPLIT + ("execute",)]
    spans.sort()
    starts = [s[0] for s in spans]
    # no span of SPLIT is longer than a tick, so those that overlap a gap
    # start within a tick's length before it
    reach = max((b - a for a, b, _ in spans), default=0.0)
    total = {k: 0.0 for k in SPLIT}
    for ga, gb in gaps:
        lo = bisect.bisect_left(starts, ga - reach)
        hi = bisect.bisect_right(starts, gb)
        for a, b, name in spans[lo:hi]:
            cover = min(b, gb) - max(a, ga)
            if cover <= 0:
                continue
            if name == "execute":
                name = "execute.post" if a < ga else "execute.pre"
            total[name] += cover
    span_s = sum(b - a for a, b in gaps)
    out = {k: 1e3 * v / len(gaps) for k, v in total.items()}
    out["other"] = 1e3 * (span_s - sum(total.values())) / len(gaps)
    return out


def request_waits(events, t0: float, rids: Iterable[int]
                  ) -> Tuple[List[float], List[float]]:
    """Seconds from ``queued`` to ``admitted`` and from ``admitted`` to
    ``first_token`` of each of ``rids`` that has both instants."""
    firsts: Dict[Tuple[int, str], float] = {}
    for e in events:
        if e.get("cat") != "request" or e["name"] not in (
                "queued", "admitted", "first_token"):
            continue
        rid = e.get("args", {}).get("rid")
        if rid is not None:
            firsts.setdefault((int(rid), e["name"]), _start(e, t0))
    queue, prefill = [], []
    for rid in rids:
        q = firsts.get((rid, "queued"))
        a = firsts.get((rid, "admitted"))
        f = firsts.get((rid, "first_token"))
        if q is not None and a is not None:
            queue.append(a - q)
        if a is not None and f is not None:
            prefill.append(f - a)
    return queue, prefill


def queue_wait_p95_ms(events, t0: float, rids: Iterable[int]
                      ) -> Optional[float]:
    """p95 of ``queued`` → ``admitted`` over ``rids``, ms."""
    queue, _ = request_waits(events, t0, rids)
    return 1e3 * percentile(queue, 0.95) if queue else None


def prefill_wait_p95_ms(events, t0: float, rids: Iterable[int]
                        ) -> Optional[float]:
    """p95 of ``admitted`` → ``first_token`` over ``rids``, ms."""
    _, prefill = request_waits(events, t0, rids)
    return 1e3 * percentile(prefill, 0.95) if prefill else None


def overlap(a: Sequence[Interval], b: Sequence[Interval]) -> float:
    """Total length of the intersection of two unions of intervals, each
    sorted and disjoint within itself."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
