"""Arithmetic that several per-layer readers share: the whole step's
share of the peak, the device's idle share, a kernel's roofline share."""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

from harness import work


def mfu(run) -> Optional[float]:
    """Model FLOPs of every token the window's ticks processed over the
    window's seconds at the bf16 peak, in %."""
    if run.device is None or not run.ticks:
        return None
    flops = sum(work.tick_flops(run.cell.config, t) for t in run.ticks)
    return 100.0 * flops / (run.device.window_s * work.PEAK_FLOPS)


def idle_share(run) -> Optional[float]:
    """Share of the traced window in which no device operation ran, %."""
    if run.device is None:
        return None
    return 100.0 * (1.0 - run.device.busy_s / run.device.window_s)


def roofline(run, symbols: Iterable[str],
             per_tick: Callable[[dict, work.Tick], Tuple[float, float]]
             ) -> Optional[float]:
    """The kernel's least time over its device time, in %. ``per_tick``
    gives the (operations, bytes) one layer's launch needs in a tick; the
    kernel runs once per layer. None where the kernel did not run."""
    if run.device is None:
        return None
    spent = run.device.seconds_of(symbols)
    if spent <= 0:
        return None
    cfg = run.cell.config
    least = 0.0
    for t in run.ticks:
        flops, nbytes = per_tick(cfg, t)
        if flops or nbytes:
            least += cfg["num_layers"] * work.least_seconds(flops, nbytes)
    return 100.0 * least / spent


def elem_bytes(cfg) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[cfg["dtype"]]
