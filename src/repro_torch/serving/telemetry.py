"""Serving-wide telemetry plane of the port: tracing, step timers,
metrics, roofline — a copy of the JAX package's
``repro.serving.telemetry``, with the port's own host and device timing.

Four cooperating pieces, all optional and all zero-cost when detached
(every instrumentation site in the serving stack guards on
``telemetry is None`` — no context managers, no clock reads, no CUDA
events on the disabled path; ``tests/test_torch_telemetry.py`` proves
disabled runs bit-identical):

* :class:`TraceRecorder` — a bounded ring buffer of structured spans and
  instants, exported as Chrome-trace-event JSON (``to_chrome_trace`` /
  ``save``) loadable in Perfetto or ``chrome://tracing``. One track per
  engine (``engine/<model>@<alloc>ch``, the allocation in GPU percent,
  named as the JAX package names it), one per model queue
  (``queue/<model>``), one per tick server (``tick/<model>``). The
  deterministic projection ``key_sequence()`` (everything except
  wall-clock ``ts``/``dur``, and except the port-only ``host`` spans
  unless asked for) is what the seeded-chaos determinism test compares.
  Under an active ``torch.profiler`` the recorder takes a clock anchor
  (:attr:`TraceRecorder.anchor`), which places its spans on the
  profiler's timeline (:meth:`TraceRecorder.profiler_ns`).
* :class:`StepTimers` — dispatch samples keyed ``(model, chips, kind,
  bucket)``: device seconds between two CUDA events around the dispatch
  on the card, host seconds on the CPU. Feeds :func:`roofline_report`,
  which joins measured dispatch latency against the port's
  ``core/latency_model`` predictions (the profiles' hardware: the H100)
  and flags deviations (on the CPU the flags are the point: the
  rooflines model the card).
* :class:`MetricsRegistry` — labelled counters/gauges/histograms with
  Prometheus text exposition (``render``) and a matching parser for
  tests/CI. The ``export_*`` bridges register the existing ad-hoc
  counters (engine ``stats``, ``RequestQueue`` per-cause terminals,
  ``FaultInjector.injected``, pool occupancy/Jain) so
  ``PoolMetrics``/``ModelPoolMetrics`` become snapshot views over one
  coherent exposition.
* :class:`Telemetry` — the umbrella object the serving layers hold. The
  engine opens each dispatch with :meth:`Telemetry.t0`, which returns
  its :class:`Dispatch` handle, and closes it with
  :meth:`Telemetry.dispatch_done` once it returns (never inside a
  capture); neither waits for the device: the dispatch's pair of CUDA
  events is resolved later, when the device has passed it
  (:meth:`Telemetry.flush` waits for the rest). Planners/pools emit
  lifecycle instants (:meth:`request_event`); the event loop emits
  arrivals; the gateway, the tick server and the decode's token read
  emit ``host`` spans.

Request timelines (queued → admitted → chunk ticks → first token →
terminal) are reconstructible from the instants via
:func:`request_timelines`; TTFT/TBT themselves are recorded always-on in
``RequestQueue`` (they are cheap scalars, not telemetry).

``docs/observability_torch.md`` documents what is the port's own: the
event-timed dispatches, the ``host`` spans and the clock anchor.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "TraceRecorder", "StepTimers", "Dispatch", "Telemetry", "MetricsRegistry",
    "Counter", "Gauge", "Histogram", "validate_chrome_trace",
    "parse_prometheus", "roofline_report", "format_roofline",
    "export_queue", "export_fault_injector", "export_engine_stats",
    "export_pool_result", "request_timelines",
]


# --------------------------------------------------------------------------
# Trace recorder (Chrome trace event format)
# --------------------------------------------------------------------------

class TraceRecorder:
    """Bounded ring buffer of trace events with Chrome-trace JSON export.

    Events carry ``ts``/``dur`` in microseconds relative to :attr:`t0`,
    the ``perf_counter`` time of the recorder's construction or last
    :meth:`clear`. The ring (``capacity`` events) bounds memory on long
    serves; the validator is subset-closed, so dropping the oldest events
    never produces an invalid trace. A dispatch span's device time, once
    known, is the event's ``device_dur`` (microseconds), beside ``args``.

    Clock anchor: where a ``torch.profiler`` is active at construction or
    at :meth:`clear`, the recorder reads ``perf_counter`` inside a
    ``record_function("repro_torch.clock")`` range (:attr:`anchor`; None
    without a profiler). The profiler stamps that range's start on its
    own clock, so :meth:`profiler_ns` places any span on the profiler's
    timeline.
    """

    CLOCK_RANGE = "repro_torch.clock"

    def __init__(self, capacity: int = 65536):
        self.capacity = int(capacity)
        self.events: collections.deque = collections.deque(maxlen=self.capacity)
        self._seq = 0
        self.dropped = 0
        self._start_clock()

    # -- clocks ------------------------------------------------------------
    def _start_clock(self) -> None:
        self.anchor: Optional[float] = None
        if torch._C._autograd._profiler_enabled():
            from torch.autograd.profiler import record_function
            with record_function(self.CLOCK_RANGE):
                self.anchor = time.perf_counter()
        self.t0 = time.perf_counter()

    def now(self) -> float:
        """Absolute ``perf_counter`` time (pairs with :meth:`complete`)."""
        return time.perf_counter()

    def _us(self, t_abs: float) -> float:
        return (t_abs - self.t0) * 1e6

    def profiler_ns(self, ts_us: float, clock_start_ns: int) -> int:
        """The recorder time ``ts_us`` (an event's ``ts`` or ``ts + dur``)
        on the profiler's clock, given the profiler's start of this
        recorder's ``repro_torch.clock`` range (``start_ns()`` of its
        kineto event): that start minus :attr:`anchor` is the offset."""
        if self.anchor is None:
            raise ValueError("no clock anchor: the recorder was not "
                             "started or cleared under a profiler")
        return clock_start_ns + round(
            (self.t0 - self.anchor + ts_us * 1e-6) * 1e9)

    # -- emission ----------------------------------------------------------
    def _push(self, ev: Dict[str, Any]) -> None:
        if len(self.events) == self.events.maxlen:
            self.dropped += 1
        ev["seq"] = self._seq
        self._seq += 1
        self.events.append(ev)

    @contextmanager
    def span(self, track: str, name: str, cat: str = "serving", **args):
        """Record a complete (``ph='X'``) span around the body."""
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            t1 = time.perf_counter()
            self._push({"track": track, "ph": "X", "name": name,
                        "cat": cat, "ts": self._us(t0),
                        "dur": (t1 - t0) * 1e6, "args": dict(args)})

    def complete(self, track: str, name: str, start: float, dur_s: float,
                 cat: str = "serving", **args) -> Dict[str, Any]:
        """Record an already-measured span (``start`` is perf_counter);
        returns the event."""
        ev = {"track": track, "ph": "X", "name": name, "cat": cat,
              "ts": self._us(start), "dur": dur_s * 1e6, "args": dict(args)}
        self._push(ev)
        return ev

    def instant(self, track: str, name: str, cat: str = "serving",
                **args) -> None:
        self._push({"track": track, "ph": "i", "name": name, "cat": cat,
                    "ts": self._us(time.perf_counter()), "args": dict(args)})

    def counter(self, track: str, name: str, **values) -> None:
        """Chrome counter sample (rendered as a stacked area in Perfetto)."""
        self._push({"track": track, "ph": "C", "name": name, "cat": "counter",
                    "ts": self._us(time.perf_counter()),
                    "args": {k: float(v) for k, v in values.items()}})

    # -- export ------------------------------------------------------------
    def tracks(self) -> List[str]:
        """Track names in first-appearance order (stable tids)."""
        seen: Dict[str, None] = {}
        for ev in self.events:
            seen.setdefault(ev["track"], None)
        return list(seen)

    def to_chrome_trace(self) -> Dict[str, Any]:
        pid = 1
        tids = {t: i + 1 for i, t in enumerate(self.tracks())}
        out: List[Dict[str, Any]] = [{
            "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": "dstack-serving"},
        }]
        for track, tid in tids.items():
            out.append({"ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_name", "args": {"name": track}})
        for ev in self.events:
            e = {"ph": ev["ph"], "pid": pid, "tid": tids[ev["track"]],
                 "name": ev["name"], "cat": ev.get("cat", "serving"),
                 "ts": round(ev["ts"], 3), "args": ev.get("args", {})}
            if "device_dur" in ev:
                e["args"] = dict(e["args"],
                                 device_dur=round(ev["device_dur"], 3))
            if ev["ph"] == "X":
                e["dur"] = round(ev["dur"], 3)
            elif ev["ph"] == "i":
                e["s"] = "t"          # thread-scoped instant
            out.append(e)
        return {"traceEvents": out,
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped,
                              "t0": self.t0, "clock_anchor": self.anchor}}

    def save(self, path: str) -> Dict[str, Any]:
        obj = self.to_chrome_trace()
        with open(path, "w") as f:
            json.dump(obj, f)
        return obj

    def key_sequence(self, host: bool = False) -> List[Tuple]:
        """Deterministic projection: everything but wall-clock fields.

        Two seeded runs of the same workload must produce identical
        key sequences even though ``ts``/``dur`` differ. The port-only
        ``host`` spans (the gateway's turn, ``observe``, ``readback``)
        are left out unless ``host``, so the projection stays the JAX
        package's; their args hold no wall-clock value either.
        """
        out = []
        for ev in self.events:
            if not host and ev.get("cat") == "host":
                continue
            args = tuple(sorted(ev.get("args", {}).items()))
            out.append((ev["track"], ev["ph"], ev["name"],
                        ev.get("cat", "serving"), args))
        return out

    def clear(self) -> None:
        self.events.clear()
        self.dropped = 0
        self._seq = 0
        self._start_clock()


def validate_chrome_trace(obj: Any) -> int:
    """Validate a Chrome trace object; return the number of span events.

    Checks Perfetto-loadability essentials: a ``traceEvents`` list, each
    event with a known phase, numeric non-negative ``ts`` (and ``dur``
    for spans), names everywhere, and — per (pid, tid) track — spans
    pairwise *nested or disjoint* (a small tolerance absorbs float
    rounding). Raises ``ValueError`` on the first violation.
    """
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace: missing traceEvents")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("trace: traceEvents is not a list")
    spans_by_track: Dict[Tuple, List[Tuple[float, float, str]]] = {}
    n_spans = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"trace[{i}]: not an object")
        ph = ev.get("ph")
        if ph not in ("X", "i", "I", "C", "M", "B", "E"):
            raise ValueError(f"trace[{i}]: unknown phase {ph!r}")
        if not ev.get("name"):
            raise ValueError(f"trace[{i}]: missing name")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0 or not math.isfinite(ts):
            raise ValueError(f"trace[{i}]: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if (not isinstance(dur, (int, float)) or dur < 0
                    or not math.isfinite(dur)):
                raise ValueError(f"trace[{i}]: bad dur {dur!r}")
            key = (ev.get("pid", 0), ev.get("tid", 0))
            spans_by_track.setdefault(key, []).append(
                (float(ts), float(dur), ev["name"]))
            n_spans += 1
    eps = 1e-3  # us; absorbs ts rounding in the exporter
    for key, spans in spans_by_track.items():
        # sort by start, longest first at equal start (parents first)
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: List[Tuple[float, float, str]] = []
        for ts, dur, name in spans:
            while stack and ts >= stack[-1][0] + stack[-1][1] - eps:
                stack.pop()
            if stack and ts + dur > stack[-1][0] + stack[-1][1] + eps:
                p_ts, p_dur, p_name = stack[-1]
                raise ValueError(
                    f"trace: span {name!r} [{ts:.1f},{ts + dur:.1f}] "
                    f"overlaps {p_name!r} [{p_ts:.1f},{p_ts + p_dur:.1f}] "
                    f"on track {key}")
            stack.append((ts, dur, name))
    return n_spans


# --------------------------------------------------------------------------
# Dispatch timers
# --------------------------------------------------------------------------

class StepTimers:
    """Dispatch samples keyed ``(model, chips, kind, bucket)``: device
    seconds on the card (between the dispatch's two CUDA events), host
    seconds on the CPU.

    ``kind`` is the dispatch family (``admission_prefill``,
    ``chunk_prefill``, ``decode``, ``grow``); ``bucket`` is the graph
    bucket the dispatch ran at (packed token bucket for prefills, batch
    size for decode). These are the per-(model, allocation, bucket)
    latency histograms the roofline report joins against predictions.
    """

    def __init__(self):
        self.samples: Dict[Tuple[str, int, str, int], List[float]] = {}

    def record(self, model: str, chips: int, kind: str, bucket: int,
               seconds: float) -> None:
        self.samples.setdefault((str(model), int(chips), str(kind),
                                 int(bucket)), []).append(float(seconds))

    @property
    def total_samples(self) -> int:
        return sum(len(v) for v in self.samples.values())

    def summary(self) -> List[Dict[str, Any]]:
        from repro_torch.serving.metrics import percentile
        rows = []
        for (model, chips, kind, bucket), xs in sorted(self.samples.items()):
            rows.append({"model": model, "chips": chips, "kind": kind,
                         "bucket": bucket, "n": len(xs),
                         "p50_s": percentile(xs, 0.5),
                         "p99_s": percentile(xs, 0.99),
                         "mean_s": sum(xs) / len(xs)})
        return rows


# --------------------------------------------------------------------------
# Telemetry umbrella
# --------------------------------------------------------------------------

class Dispatch:
    """An open dispatch (:meth:`Telemetry.t0`): its host start ``t``
    (``perf_counter``) and, on the card, its start and end CUDA events."""

    __slots__ = ("t", "start", "end")

    def __init__(self, t: float, start=None):
        self.t = t
        self.start = start
        self.end = None


class Telemetry:
    """What the serving layers hold: a trace (optional) plus timers.

    Attach with ``EnginePool.attach_telemetry`` /
    ``InferenceEngine.attach_telemetry`` / ``StepPlanner.telemetry``.
    When ``trace`` is None only the timers run (used by ``bench_pool``
    for the roofline report without trace export).

    Device timing without a synchronise: :meth:`t0` opens a dispatch and
    returns its :class:`Dispatch` handle, which holds the host start and,
    on the card, a start event recorded on the engine's stream;
    :meth:`dispatch_done` takes the handle back and records the end event.
    The pair waits in ``_pending`` until the device has passed its end
    event (``Event.query``, at every later ``dispatch_done``; all of them
    after the decode's :meth:`readback`, which waits for the stream
    anyway), then gives the span its ``device_dur`` and the timers their
    sample. :meth:`flush` waits for what is left. Events come from a
    reused pool, so a dispatch allocates none; a dispatch that raises
    drops its handle, and its start event with it.
    """

    def __init__(self, trace: Optional[TraceRecorder] = None,
                 timers: Optional[StepTimers] = None):
        self.trace = trace
        self.timers = timers if timers is not None else StepTimers()
        self._free: List[Any] = []         # recorded-and-read CUDA events
        # (span or None, start event, end event, timer key), oldest first
        self._pending: collections.deque = collections.deque()

    # -- track names -------------------------------------------------------
    @staticmethod
    def engine_track(engine) -> str:
        chips = getattr(engine, "alloc_chips", 0) or 0
        return f"engine/{engine.cfg.name}@{chips}ch"

    @staticmethod
    def queue_track(model: str) -> str:
        return f"queue/{model}"

    # -- dispatch timing ---------------------------------------------------
    def _record(self, engine):
        ev = (self._free.pop() if self._free
              else torch.cuda.Event(enable_timing=True))
        ev.record(torch.cuda.current_stream(engine.device))
        return ev

    def t0(self, engine) -> "Dispatch":
        """Open a dispatch on ``engine``: its host start (``perf_counter``)
        and, on the card, a start event on the engine's stream. Call it
        before the dispatch, outside any capture."""
        t = time.perf_counter()
        return Dispatch(t, self._record(engine)
                        if engine.device.type == "cuda" else None)

    def readback(self, engine, x: torch.Tensor, d: "Dispatch") -> np.ndarray:
        """The decode's read of its tokens ``x``, as a ``host`` span
        (``readback``: the host blocked on the device). The end event of
        the dispatch ``d`` goes in first, so its device time ends with the
        step, not with the copy."""
        if d.start is not None:
            d.end = self._record(engine)
        s = time.perf_counter()
        out = x.cpu().numpy()
        if self.trace is not None:
            self.trace.complete(self.engine_track(engine), "readback", s,
                                time.perf_counter() - s, cat="host")
        return out

    def dispatch_done(self, engine, kind: str, bucket: int, d: "Dispatch",
                      **args) -> None:
        """Close the dispatch ``d`` (from :meth:`t0`) once it has returned:
        push its span (the host's duration, launch and any read included)
        and, on the card, its end event (unless :meth:`readback` put it
        in), then resolve whatever pairs the device has passed. Never
        waits; never called inside a capture."""
        if d.start is not None and d.end is None:
            d.end = self._record(engine)
        dt = time.perf_counter() - d.t
        chips = getattr(engine, "alloc_chips", 0) or 0
        key = (engine.cfg.name, chips, kind, bucket)
        ev = None
        if self.trace is not None:
            ev = self.trace.complete(self.engine_track(engine), kind, d.t, dt,
                                     cat="dispatch", bucket=int(bucket),
                                     **args)
        if d.start is None:                # the CPU: the host ran it
            self.timers.record(*key, dt)
            if ev is not None:
                ev["device_dur"] = ev["dur"]
            return
        self._pending.append((ev, d.start, d.end, key))
        self._resolve()

    def _resolve(self) -> None:
        """Resolve pending pairs, oldest first, while the device has
        passed their end events (one stream: they complete in order)."""
        while self._pending and self._pending[0][2].query():
            ev, start, end, key = self._pending.popleft()
            sec = start.elapsed_time(end) / 1e3
            self._free += (start, end)
            self.timers.record(*key, sec)
            if ev is not None:
                ev["device_dur"] = sec * 1e6

    def flush(self) -> None:
        """Wait for every pending dispatch's end event and resolve it."""
        for _, _, end, _ in self._pending:
            end.synchronize()
        self._resolve()

    # -- emission helpers --------------------------------------------------

    def instant(self, track: str, name: str, **args) -> None:
        if self.trace is not None:
            self.trace.instant(track, name, **args)

    def request_event(self, model: str, name: str, **args) -> None:
        """Lifecycle instant on the model's queue track."""
        if self.trace is not None:
            self.trace.instant(self.queue_track(model), name,
                               cat="request", **args)


# --------------------------------------------------------------------------
# Metrics registry (Prometheus text exposition)
# --------------------------------------------------------------------------

def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_labels(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + body + "}"


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class Counter:
    def __init__(self, name: str, help: str = ""):
        self.name, self.help, self.kind = name, help, "counter"
        self.values: Dict[Tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = _label_key(labels)
        self.values[k] = self.values.get(k, 0.0) + float(amount)

    def render(self) -> List[str]:
        return [f"{self.name}{_render_labels(k)} {_fmt(v)}"
                for k, v in sorted(self.values.items())]


class Gauge:
    def __init__(self, name: str, help: str = ""):
        self.name, self.help, self.kind = name, help, "gauge"
        self.values: Dict[Tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        self.values[_label_key(labels)] = float(value)

    def render(self) -> List[str]:
        return [f"{self.name}{_render_labels(k)} {_fmt(v)}"
                for k, v in sorted(self.values.items())]


DEFAULT_BUCKETS = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2,
                   5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, math.inf)


class Histogram:
    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name, self.help, self.kind = name, help, "histogram"
        bs = sorted(float(b) for b in buckets)
        if not bs or bs[-1] != math.inf:
            bs.append(math.inf)
        self.buckets = tuple(bs)
        # labelset -> (bucket counts, sum, count)
        self.values: Dict[Tuple, Tuple[List[int], float, int]] = {}

    def observe(self, value: float, **labels) -> None:
        k = _label_key(labels)
        counts, total, n = self.values.get(
            k, ([0] * len(self.buckets), 0.0, 0))
        for i, le in enumerate(self.buckets):
            if value <= le:
                counts[i] += 1
        self.values[k] = (counts, total + float(value), n + 1)

    def render(self) -> List[str]:
        lines = []
        for k, (counts, total, n) in sorted(self.values.items()):
            for le, c in zip(self.buckets, counts):
                lk = k + (("le", _fmt(le)),)
                lines.append(f"{self.name}_bucket{_render_labels(lk)} {c}")
            lines.append(f"{self.name}_sum{_render_labels(k)} {_fmt(total)}")
            lines.append(f"{self.name}_count{_render_labels(k)} {n}")
        return lines


class MetricsRegistry:
    """Named metric family registry with Prometheus text exposition."""

    def __init__(self):
        self.metrics: Dict[str, Any] = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self.metrics.get(name)
        if m is None:
            m = cls(name, help, **kw)
            self.metrics[name] = m
        elif not isinstance(m, cls):
            raise ValueError(f"metric {name!r} already registered as "
                             f"{type(m).__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def render(self) -> str:
        lines = []
        for name in sorted(self.metrics):
            m = self.metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> Dict[Tuple[str, Tuple], float]:
    """Parse exposition text back to ``{(name, labelkey): value}``.

    Covers the subset :meth:`MetricsRegistry.render` emits — enough for
    the round-trip assertions in tests and CI.
    """
    out: Dict[Tuple[str, Tuple], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        head, _, val = line.rpartition(" ")
        if "{" in head:
            name, _, rest = head.partition("{")
            body = rest.rstrip("}")
            labels = []
            for part in _split_labels(body):
                k, _, v = part.partition("=")
                labels.append((k, v.strip('"')))
            key = tuple(sorted(labels))
        else:
            name, key = head, ()
        out[(name, key)] = float(val.replace("+Inf", "inf"))
    return out


def _split_labels(body: str) -> List[str]:
    parts, cur, inq = [], "", False
    for ch in body:
        if ch == '"':
            inq = not inq
            cur += ch
        elif ch == "," and not inq:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    if cur:
        parts.append(cur)
    return parts


# --------------------------------------------------------------------------
# Registry bridges for the existing ad-hoc counters
# --------------------------------------------------------------------------

def export_queue(reg: MetricsRegistry, queue, model: Optional[str] = None
                 ) -> None:
    """Register a ``RequestQueue``'s per-cause terminals and TTFT/TBT."""
    model = model if model is not None else queue.model
    term = reg.counter("dstack_requests_total",
                       "requests by terminal cause")
    for cause in ("completed", "cancelled", "deadline_aborted", "shed",
                  "dropped"):
        term.inc(getattr(queue, cause), model=model, cause=cause)
    reg.counter("dstack_slo_violations_total",
                "completions past their SLO").inc(queue.violated, model=model)
    lat = reg.histogram("dstack_latency_seconds",
                        "end-to-end completion latency")
    for v in queue.latencies:
        lat.observe(v, model=model)
    ttft = reg.histogram("dstack_ttft_seconds", "time to first token")
    for cause, xs in sorted(queue.ttft_by_cause.items()):
        for v in xs:
            ttft.observe(v, model=model, cause=cause)
    tbt = reg.histogram("dstack_tbt_seconds",
                        "mean time between tokens (completed requests)")
    for v in queue.tbts:
        tbt.observe(v, model=model)


def export_fault_injector(reg: MetricsRegistry, injector) -> None:
    c = reg.counter("dstack_faults_injected_total",
                    "injected faults by site")
    for site, n in sorted(injector.injected.items()):
        c.inc(n, site=site)


def export_engine_stats(reg: MetricsRegistry, stats, model: str,
                        chips: int = 0) -> None:
    labels = {"model": model, "chips": str(chips)}
    for field, name in (
            ("prefills", "dstack_prefills_total"),
            ("packed_prefills", "dstack_packed_prefills_total"),
            ("chunk_prefills", "dstack_chunk_prefills_total"),
            ("prefill_tokens", "dstack_prefill_tokens_total"),
            ("decode_steps", "dstack_decode_steps_total"),
            ("tokens_out", "dstack_tokens_out_total"),
            ("grows", "dstack_page_grows_total"),
            ("engine_retries", "dstack_engine_retries_total"),
            ("engine_resets", "dstack_engine_resets_total"),
            ("prefix_hits", "dstack_prefix_hits_total"),
            ("prefix_hit_tokens", "dstack_prefix_hit_tokens_total"),
            ("cow_copies", "dstack_cow_copies_total"),
            ("forced_catchup_tokens", "dstack_prefix_catchup_tokens_total"),
            ("incr_chunks", "dstack_incr_chunks_total"),
            ("draft_tokens", "dstack_draft_tokens_total"),
            ("accepted_tokens", "dstack_accepted_tokens_total"),
            ("spec_rounds", "dstack_spec_rounds_total"),
            ("rollbacks", "dstack_spec_rollbacks_total")):
        reg.counter(name).inc(getattr(stats, field, 0), **labels)


def export_pool_result(reg: MetricsRegistry, result,
                       injector=None) -> None:
    """Register a ``PoolResult`` snapshot (the ``ModelPoolMetrics`` view).

    ``PoolMetrics``/``ModelPoolMetrics`` stay the in-process snapshot
    structs; this bridge is what turns one into the exposition format.
    """
    reg.gauge("dstack_pool_throughput_rps",
              "completed requests per virtual second").set(
        result.throughput(), policy=result.policy)
    reg.gauge("dstack_pool_fairness_jain", "Jain index over model shares"
              ).set(result.fairness(), policy=result.policy)
    reg.gauge("dstack_pool_occupancy", "mean chip occupancy").set(
        result.occupancy, policy=result.policy)
    reg.gauge("dstack_pool_page_occupancy",
              "time-averaged KV page occupancy").set(
        result.page_occupancy, policy=result.policy)
    term = reg.counter("dstack_requests_total",
                       "requests by terminal cause")
    thr = reg.gauge("dstack_model_throughput_rps",
                    "per-model completed requests per virtual second")
    lat = reg.histogram("dstack_latency_seconds",
                        "end-to-end completion latency")
    ttft = reg.histogram("dstack_ttft_seconds", "time to first token")
    tbt = reg.histogram("dstack_tbt_seconds",
                        "mean time between tokens (completed requests)")
    dur = max(result.duration, 1e-12)
    for name, m in sorted(result.per_model.items()):
        for cause in ("completed", "cancelled", "deadline_aborted", "shed",
                      "dropped"):
            term.inc(getattr(m, cause, 0), model=name, cause=cause)
        thr.set(m.completed / dur, model=name)
        reg.counter("dstack_slo_violations_total",
                    "completions past their SLO").inc(m.violated, model=name)
        for c, n in (("preemptions", m.preemptions),
                     ("requeues", m.requeues), ("topups", m.topups)):
            reg.counter(f"dstack_{c}_total").inc(n, model=name)
        reg.counter("dstack_engine_retries_total").inc(
            m.engine_retries, model=name)
        reg.counter("dstack_engine_resets_total").inc(
            m.engine_resets, model=name)
        reg.counter("dstack_prefix_hits_total").inc(
            getattr(m, "prefix_hits", 0), model=name)
        reg.counter("dstack_prefix_hit_tokens_total").inc(
            getattr(m, "prefix_hit_tokens", 0), model=name)
        reg.counter("dstack_cow_copies_total").inc(
            getattr(m, "cow_copies", 0), model=name)
        for v in m.latencies:
            lat.observe(v, model=name)
        for v in getattr(m, "ttfts", ()):
            ttft.observe(v, model=name, cause="completed")
        for v in getattr(m, "tbts", ()):
            tbt.observe(v, model=name)
    if injector is not None:
        export_fault_injector(reg, injector)


# --------------------------------------------------------------------------
# Roofline validation
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RooflineRow:
    model: str
    chips: int
    kind: str
    bucket: int
    n: int
    measured_p50_s: float
    predicted_s: Optional[float]
    ratio: Optional[float]
    flagged: bool

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def roofline_report(timers: StepTimers, profiles: Dict[str, Any],
                    tol: float = 4.0) -> List[RooflineRow]:
    """Join measured dispatch time against latency-model predictions.

    ``profiles`` maps model name → ``ModelProfile`` (as on
    ``EnginePool.profiles``). Decode dispatches are predicted by a
    decode-mode ``LatencyModel`` at ``batch=bucket``; prefill dispatches
    by a prefill-mode model at ``seq=bucket`` (the packed token bucket),
    batch 1, on the profile's hardware (the port's: the H100, units of GPU
    percent). ``grow`` dispatches (block-table updates) have no analytic
    model and get no prediction. A row is flagged when measured/predicted
    falls outside ``[1/tol, tol]`` — on the CPU essentially every row
    flags, which is exactly the signal: the rooflines model the card, the
    host is not one.
    """
    from repro_torch.core.latency_model import LatencyModel
    from repro_torch.serving.metrics import percentile

    lm_cache: Dict[Tuple, Any] = {}
    rows: List[RooflineRow] = []
    for (model, chips, kind, bucket), xs in sorted(timers.samples.items()):
        prof = profiles.get(model)
        predicted = None
        if prof is not None and chips >= 1:
            if kind == "decode":
                key = (model, "decode")
                lm = lm_cache.get(key)
                if lm is None:
                    lm = LatencyModel(prof.cfg, mode="decode", seq=1,
                                      hw=prof.hw)
                    lm_cache[key] = lm
                predicted = lm.latency(chips, max(1, bucket))
            elif kind in ("admission_prefill", "chunk_prefill"):
                key = (model, "prefill", bucket)
                lm = lm_cache.get(key)
                if lm is None:
                    lm = LatencyModel(prof.cfg, mode="prefill",
                                      seq=max(1, bucket), hw=prof.hw)
                    lm_cache[key] = lm
                predicted = lm.latency(chips, 1)
        p50 = percentile(xs, 0.5)
        ratio = (p50 / predicted) if predicted else None
        flagged = ratio is not None and not (1.0 / tol <= ratio <= tol)
        rows.append(RooflineRow(model=model, chips=chips, kind=kind,
                                bucket=int(bucket), n=len(xs),
                                measured_p50_s=p50, predicted_s=predicted,
                                ratio=ratio, flagged=flagged))
    return rows


def format_roofline(rows: Iterable[RooflineRow]) -> List[str]:
    out = ["model         chips kind              bucket    n "
           "measured_p50 predicted    ratio flag"]
    for r in rows:
        pred = f"{r.predicted_s * 1e6:9.1f}us" if r.predicted_s else \
            "        --"
        ratio = f"{r.ratio:8.1f}" if r.ratio is not None else "      --"
        out.append(f"{r.model:<13} {r.chips:>5} {r.kind:<17} "
                   f"{r.bucket:>6} {r.n:>4} "
                   f"{r.measured_p50_s * 1e6:9.1f}us {pred} {ratio}"
                   f" {'DEV' if r.flagged else 'ok'}")
    return out


# --------------------------------------------------------------------------
# Per-request timelines from trace instants
# --------------------------------------------------------------------------

def request_timelines(rec: TraceRecorder) -> Dict[Tuple[str, int],
                                                  List[Tuple[float, str]]]:
    """Reconstruct per-request event timelines from queue-track instants.

    Returns ``{(model, rid): [(ts_us, event), ...]}`` in emission order —
    the queued → admitted → chunk ticks → first token → terminal view.
    """
    out: Dict[Tuple[str, int], List[Tuple[float, str]]] = {}
    for ev in rec.events:
        if ev.get("cat") != "request":
            continue
        rid = ev.get("args", {}).get("rid")
        if rid is None:
            continue
        model = ev["track"].split("/", 1)[-1]
        out.setdefault((model, int(rid)), []).append(
            (ev["ts"], ev["name"]))
    return out
