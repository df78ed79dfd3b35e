"""The device's side of a traced run, from ``torch.profiler``.

The profiler runs from the end of set-up to the end of the window; the
window itself is a host range (``chipbench.window``) in the same trace, so
device activity is cut to it on the profiler's own clock. The harness
marks the host's planner and executor calls (``chipbench.plan``,
``chipbench.execute``); an idle gap on the device is named by the host
range that covers its middle, and ``gateway`` where none does (the
gateway's loop, the clients, the event loop).
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

WINDOW = "chipbench.window"
HOST_RANGES = ("chipbench.plan", "chipbench.execute")
_SYMBOL = re.compile(r"(\w+)[<(]")


def symbol(name: str) -> str:
    """A device function's short name: the identifier before its
    template or argument list (``paged_split_kernel``), else the name."""
    m = _SYMBOL.search(name)
    return m.group(1) if m else name[:64]


@dataclasses.dataclass
class DeviceSummary:
    window_s: float
    busy_s: float
    by_symbol: Dict[str, float]            # seconds of device time
    gaps: List[Tuple[str, float]]  # (host range, seconds), longest first

    def seconds_of(self, symbols) -> float:
        return sum(self.by_symbol.get(s, 0.0) for s in symbols)

    def top_ops(self, k: int = 10) -> List[List]:
        ops = sorted(self.by_symbol.items(), key=lambda kv: -kv[1])
        return [[n, s] for n, s in ops[:k]]


class DeviceTrace:
    """Profiler over the traced run (``start`` .. ``stop``) with the
    window marked inside it."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._window = None

    def start(self) -> None:
        self._prof.start()

    def window_start(self) -> None:
        from torch.autograd.profiler import record_function
        self._window = record_function(WINDOW)
        self._window.__enter__()

    def window_end(self) -> None:
        self._window.__exit__(None, None, None)

    def stop(self) -> None:
        self._prof.stop()

    def summary(self) -> Optional[DeviceSummary]:
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        win = None
        host: List[Tuple[int, int, str]] = []
        dev: List[Tuple[int, int, str]] = []
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == cuda:
                if e.is_user_annotation() or name.startswith("chipbench."):
                    continue       # a host range drawn on the device track
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            name))
            elif name == WINDOW:
                win = (e.start_ns(), e.start_ns() + e.duration_ns())
            elif name in HOST_RANGES:
                host.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                             name.split(".", 1)[1]))
        if win is None:
            return None
        w0, w1 = win
        by_symbol: Dict[str, float] = {}
        spans = []
        for a, b, name in dev:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            key = symbol(name)
            by_symbol[key] = by_symbol.get(key, 0.0) + (b - a) / 1e9
            spans.append((a, b))
        spans.sort()
        busy, gaps, edge = 0, [], w0
        for a, b in spans:
            if a > edge:
                gaps.append((edge, a))
            if b > edge:
                busy += b - max(a, edge)
                edge = b
        if w1 > edge:
            gaps.append((edge, w1))
        host.sort()
        starts = [h[0] for h in host]
        named = []
        for a, b in gaps:
            mid = (a + b) // 2
            i = bisect.bisect_right(starts, mid) - 1
            label = host[i][2] if i >= 0 and mid < host[i][1] else "gateway"
            named.append((label, (b - a) / 1e9))
        named.sort(key=lambda g: -g[1])
        return DeviceSummary(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
                             by_symbol=by_symbol, gaps=named)
