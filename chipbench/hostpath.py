"""Readings of the program's host path and device timing in a cell, many
seeds in one process.

    python3 chipbench/hostpath.py --workload <cell> --seeds 1 2 3 \
        --seconds 30 [--modes off tel prof both]

For each seed, one run of the cell as ``run.py`` makes it in each mode
(every other seed in reverse order):
``off`` (``--trace 0``), ``tel`` (the program's telemetry attached for the
window, no profiler), ``prof`` (the profiler, no telemetry) and ``both``
(``--trace 1``). Each run gives the cell's end-to-end metrics, so the
modes' costs compare on one seed. With the telemetry attached it reads
the program's spans (``harness/spans.py``): the mean host gap between
ticks and what covers it, the device time of a tick's dispatches, and
chat's queue and prefill waits. With both, it places the recorder's spans
on the profiler's clock through the recorder's clock anchor: the share
of the device's idle time that lies in the host gaps; the share of the
host's waits in ``readback`` that the profiler calls idle (the device is
busy then, so this is device activity the profiler lost); how far the
end of each tick's ``readback`` lies after the end of its device-to-host
token copy (matched by CUDA correlation id) and after the runtime's
return from it; and the idle share in the host gaps again, over the
ticks where the profiler's device clock keeps in step with its host
clock (``_in_step``). One JSON line a run, on standard output
and in ``chiprun_out/hostpath-<cell>.jsonl``; with the profiler, one line
a readback in ``chiprun_out/hostpath-align-<cell>.jsonl``, which splits
its lateness by the CUDA correlation id of its copy (``_align_row``).
The output check is not run.

``serve.run_cell`` drops its telemetry and profiler at its end; this
script hands it subclasses that keep a reference. The benchmark's runs
never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

import run as bench_run  # noqa: E402

MODES = ("off", "tel", "prof", "both")
ALIGN_LIMIT_NS = 250_000       # a readback ends within 0.25 ms of its copy


class _NoProfiler:
    """``DeviceTrace``'s surface, recording nothing."""

    def start(self):
        pass

    def window_start(self):
        pass

    def window_end(self):
        pass

    def stop(self):
        pass

    def summary(self):
        return None


@contextlib.contextmanager
def _patched(obj, name, value):
    had = name in vars(obj)
    old = vars(obj).get(name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        if had:
            setattr(obj, name, old)
        else:
            delattr(obj, name)


@contextlib.contextmanager
def _mode(mode, kept):
    """Run ``run_cell`` in ``mode``, keeping its telemetry and profiler in
    ``kept``."""
    from harness import devtrace
    from repro_torch.serving import engine, plan, telemetry

    class KeptTelemetry(telemetry.Telemetry):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            kept["tel"] = self

    class KeptTrace(devtrace.DeviceTrace):
        def __init__(self):
            super().__init__()
            kept["dev"] = self

    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(telemetry, "Telemetry", KeptTelemetry))
        stack.enter_context(_patched(
            devtrace, "DeviceTrace",
            _NoProfiler if mode == "tel" else KeptTrace))
        if mode == "prof":
            # the harness attaches its telemetry; nothing takes it
            stack.enter_context(_patched(
                plan.StepPlanner, "telemetry",
                property(lambda self: None, lambda self, v: None)))
            stack.enter_context(_patched(
                engine.InferenceEngine, "attach_telemetry",
                lambda self, tel: None))
        yield


def _profiler_side(dev, rec, gaps, window_ticks, gc_passes):
    """Idle share in the host gaps and the readback alignment, on the
    profiler's clock."""
    import torch
    from harness import spans
    from repro_torch.serving.telemetry import TraceRecorder
    cuda = torch.autograd.DeviceType.CUDA
    clock = win = None
    device = []
    events = list(dev._prof.profiler.kineto_results.events())
    for e in events:
        name = e.name()
        iv = (e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() == cuda:
            if e.is_user_annotation() or name.startswith("chipbench."):
                continue
            device.append(iv)
        elif name == TraceRecorder.CLOCK_RANGE:
            clock = iv[0] if clock is None else max(clock, iv[0])
        elif name == "chipbench.window":
            win = iv
    if clock is None or win is None or rec.anchor is None:
        return {"anchor": False}, []

    def ns(t_abs):
        return rec.profiler_ns((t_abs - rec.t0) * 1e6, clock)

    w0, w1 = win
    busy, edge = [], w0
    for a, b in sorted(device):
        a, b = max(a, edge), min(b, w1)
        if b > a:
            busy.append((a, b))
            edge = b
    idle, edge = [], w0
    for a, b in busy:
        if a > edge:
            idle.append((edge, a))
        edge = b
    if w1 > edge:
        idle.append((edge, w1))
    idle_ns = sum(b - a for a, b in idle)
    gaps_ns = [(ns(a), ns(b)) for a, b in gaps]
    runtime, by_corr = _runtime_calls(events)
    gc_ns = [(ns(a), ns(b), g) for a, b, g in gc_passes]
    waits, rows = [], []
    for t in window_ticks:
        if not t["readbacks"]:
            continue
        r = t["readbacks"][-1]
        r0 = rec.profiler_ns(r["ts"], clock)
        r1 = rec.profiler_ns(r["ts"] + r["dur"], clock)
        # the host waits here for the step it just launched: the device
        # is busy, bar the gaps between kernels, until the copy
        if r1 - ALIGN_LIMIT_NS > r0:
            waits.append((r0, r1 - ALIGN_LIMIT_NS))
        rows.append(_align_row(r0, r1, runtime, by_corr, gc_ns))
    wait_ns = sum(b - a for a, b in waits)
    out = {"anchor": True, "idle_s": idle_ns / 1e9,
           "window_s": (w1 - w0) / 1e9,
           "idle_in_host_gaps": (spans.overlap(idle, gaps_ns) / idle_ns
                                 if idle_ns else None),
           "idle_in_readback_waits": (spans.overlap(idle, waits) / wait_ns
                                      if wait_ns else None),
           "in_step": _in_step(idle, gaps_ns, rows)}
    out.update(_align_summary(rows, w0, w1))
    return out, rows


# -- the readback's alignment, matched by CUDA correlation id --------------
# Inside a ``readback`` span the host calls the runtime to copy the tokens
# (``cudaMemcpy*``) and to wait for them; the profiler records both calls on
# the host's clock and the copy on the device, the copy under the copy
# call's correlation id. So a readback's lateness after its copy splits
# into ``host_us`` (the span's end after the runtime's last call returned:
# Python, the op's exit, anything that held the thread) and ``runtime_us``
# (that return after the device's copy ended: the runtime's wake-up, and
# the profiler's mapping of device time onto the host's clock).

def _runtime_calls(events):
    """The host's runtime copy and wait calls, ``(start, end, name, corr)``
    sorted by start, and the device's copies by correlation id."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    runtime, by_corr = [], {}
    for e in events:
        name = e.name()
        corr = getattr(e, "correlation_id", lambda: 0)()
        if e.device_type() == cuda:
            if "Memcpy" in name and corr:
                by_corr[corr] = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif name.startswith("cuda") and ("Memcpy" in name
                                          or "Synchronize" in name):
            runtime.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            name, corr))
    runtime.sort()
    return runtime, by_corr


def _align_row(r0, r1, runtime, by_corr, gc_ns):
    """One readback: its span, the runtime calls inside it, the copy that
    the last copy call made (by correlation id), and the collections of
    the cycle collector that overlap it."""
    lo = bisect.bisect_left(runtime, (r0,))
    calls = [c for c in runtime[lo:] if c[0] <= r1][:8]
    row = {"r0": r0, "r1": r1, "dur_us": (r1 - r0) / 1e3,
           "calls": [c[2] for c in calls]}
    copy_calls = [c for c in calls if "Memcpy" in c[2]]
    if calls:
        row["host_us"] = (r1 - max(c[1] for c in calls)) / 1e3
    if copy_calls and copy_calls[-1][3] in by_corr:
        c0, c1 = by_corr[copy_calls[-1][3]]
        row["delta_us"] = (r1 - c1) / 1e3
        row["runtime_us"] = (max(c[1] for c in calls) - c1) / 1e3
        row["copy_us"] = (c1 - c0) / 1e3
        row["copy_start_after_r0_us"] = (c0 - r0) / 1e3
    gc = [g for g in gc_ns if g[0] < r1 and g[1] > r0]
    if gc:
        row["gc_us"] = sum(min(b, r1) - max(a, r0) for a, b, _ in gc) / 1e3
        row["gc_gen"] = max(g[2] for g in gc)
    return row


def _align_summary(rows, w0, w1):
    from harness.stats import percentile
    got = [r for r in rows if "delta_us" in r]
    if not got:
        return {"matched": 0, "readbacks": len(rows)}
    d = [r["delta_us"] for r in got]
    late = [r for r in got if r["delta_us"] > ALIGN_LIMIT_NS / 1e3]

    def med(xs, key):
        v = [x[key] for x in xs if key in x]
        return percentile(v, 0.5) if v else None

    tenths = [0] * 10
    for r in late:
        tenths[min(9, int(10 * (r["r0"] - w0) / (w1 - w0)))] += 1
    return {
        "readbacks": len(rows), "matched": len(got),
        "delta_p50_us": percentile(d, 0.5), "delta_p95_us":
        percentile(d, 0.95), "delta_min_us": min(d),
        "within_share": sum(1 for x in d if 0 <= x <= ALIGN_LIMIT_NS / 1e3)
        / len(rows),
        "late": len(late), "late_by_tenth": tenths,
        "median": {k: med(got, k) for k in ("host_us", "runtime_us",
                                            "copy_us", "dur_us")},
        "late_median": {k: med(late, k) for k in (
            "host_us", "runtime_us", "copy_us", "dur_us",
            "copy_start_after_r0_us")},
        "late_host_over_limit": sum(1 for r in late if r.get(
            "host_us", 0) > ALIGN_LIMIT_NS / 1e3),
        "late_runtime_over_limit": sum(1 for r in late if r.get(
            "runtime_us", 0) > ALIGN_LIMIT_NS / 1e3),
        "late_with_gc": sum(1 for r in late if "gc_us" in r),
        "with_gc": sum(1 for r in got if "gc_us" in r),
        "unmatched_calls": sorted({" ".join(r["calls"]) for r in rows
                                   if "delta_us" not in r})[:5],
    }


def _in_step(idle, gaps_ns, rows):
    """The share of the device's idle time that lies in the host gaps,
    over the tick cycles (one readback's end to the next's) whose two
    readbacks both find the profiler's device clock in step with its host
    clock: ``runtime_us`` within ``ALIGN_LIMIT_NS`` of its median. Where
    the two clocks drift apart the profiler's kernels land on the wrong
    host spans."""
    from harness import spans
    from harness.stats import percentile
    rt = [r["runtime_us"] for r in rows if "runtime_us" in r]
    if not rt:
        return None
    med = percentile(rt, 0.5)
    ok = [abs(r.get("runtime_us", math.inf) - med) <= ALIGN_LIMIT_NS / 1e3
          for r in rows]
    cycles = [(a["r1"], b["r1"]) for a, b, oa, ob
              in zip(rows, rows[1:], ok, ok[1:]) if oa and ob]
    if not cycles:
        return None
    starts = [c[0] for c in cycles]
    inside = []
    for g in gaps_ns:
        # a gap starts where its tick's readback ends (to rounding)
        i = bisect.bisect_right(starts, g[0] + 1000) - 1
        if i >= 0 and starts[i] - 1000 <= g[0] and g[1] <= cycles[i][1]:
            inside.append(g)
    cyc_idle = spans.overlap(idle, cycles)
    return {"cycles": len(cycles), "of": len(rows) - 1,
            "idle_in_host_gaps": (spans.overlap(idle, inside) / cyc_idle
                                  if cyc_idle else None)}


class _GcLog:
    """The cycle collector's passes during a run, ``(start, end, gen)`` in
    absolute ``perf_counter`` seconds."""

    def __init__(self):
        self.passes, self._open = [], None

    def __call__(self, phase, info):
        if phase == "start":
            self._open = time.perf_counter()
        elif self._open is not None:
            self.passes.append((self._open, time.perf_counter(),
                                info["generation"]))
            self._open = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def readings(run, mode, kept, gc_passes=()):
    """The run's line, and with the profiler one alignment row a
    readback."""
    from harness import endtoend, spans, stats
    line = {"seed": run.seed, "mode": mode,
            "end_to_end": {m.name: endtoend.METRICS[m.name](run)
                           for m in run.cell.end_to_end},
            "tokens_in_window": stats.tokens_in(run.records, run.w0,
                                                run.w1)}
    if run.spans.get("execute"):
        ex = run.spans["execute"]
        line["execute_ms"] = 1e3 * sum(ex) / len(ex)
    rows = []
    tel = kept.get("tel") if mode in ("tel", "both") else None
    if tel is not None:
        tel.flush()
        rec = tel.trace
        evs = list(rec.events)
        w0, w1 = run.w0, run.w1
        window_ticks = spans.ticks(evs, rec.t0, w0, w1)
        gaps = spans.host_gaps(evs, rec.t0, w0, w1)
        due = [r.rid for r in run.in_window]
        line.update(
            ticks=len(window_ticks), host_gaps=len(gaps),
            host_gap_ms=spans.host_gap_ms(evs, rec.t0, w0, w1),
            dispatch_device_ms=spans.dispatch_device_ms(evs, rec.t0, w0,
                                                        w1),
            queue_wait_p95_ms=spans.queue_wait_p95_ms(evs, rec.t0, due),
            prefill_wait_p95_ms=spans.prefill_wait_p95_ms(evs, rec.t0,
                                                          due),
            host_split_ms=spans.host_split(evs, rec.t0, gaps),
            dropped_events=rec.dropped)
        dev = kept.get("dev")
        if dev is not None:
            line["profiler"], rows = _profiler_side(dev, rec, gaps,
                                                    window_ticks, gc_passes)
    if run.device is not None:
        line["busy_s"] = run.device.busy_s
        line["window_s"] = run.device.window_s
        line["idle_share"] = 1.0 - run.device.busy_s / run.device.window_s
    return line, rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--modes", nargs="+", choices=MODES, default=MODES)
    args = ap.parse_args()
    bench_run.setup_paths()
    import torch
    from harness.manifest import load_cell
    from harness.serve import run_cell
    out_dir = BENCH.parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    sink = open(out_dir / f"hostpath-{args.workload}.jsonl", "a")
    align = open(out_dir / f"hostpath-align-{args.workload}.jsonl", "a")
    card = bench_run.power_limit()
    t_start = T_START
    for i, seed in enumerate(args.seeds):
        # every other seed runs the modes in reverse, so drift through
        # the call falls on each mode alike
        for mode in args.modes[::-1] if i % 2 else args.modes:
            cell = load_cell(args.workload)
            kept = {}
            with _mode(mode, kept), _GcLog() as gcs:
                run = run_cell(cell, seed, args.seconds, mode != "off",
                               "cuda", t_start)
            line, rows = readings(run, mode, kept, gcs.passes)
            line.update(card=card, cell=args.workload)
            print(json.dumps(line), flush=True)
            sink.write(json.dumps(line) + "\n")
            sink.flush()
            for row in rows:
                align.write(json.dumps(dict(row, seed=seed)) + "\n")
            align.flush()
            del run, kept
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
