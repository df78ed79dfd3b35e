"""The port's telemetry plane (``repro_torch.serving.telemetry`` and its
hooks in the engine, planner and pool) on the CPU, against the JAX
package's ``tests/test_telemetry.py`` and against the JAX package itself.

* A detached run is bit-identical to one that never saw telemetry, and an
  attached trace is a pure observer: the same streams, the same dispatch
  counts, no new ``jit_cache_sizes()`` entry.
* Seeded runs give the same ``key_sequence()`` (everything but wall-clock
  fields) as **the JAX package's** on the same weights and workload: the
  chaos run (dispatch and allocator faults, retries and resets), a
  shared-prefix serve with the radix cache (hits, COW copies, evictions)
  and a speculative serve (draft admissions, scans, verifies, rounds);
  the Prometheus exposition of the run equals the JAX one's.
* The validator, the Prometheus round trip and the roofline report (on
  the H100's latency model) behave as the reference's tests require.
* The pool: ``EnginePool.attach_telemetry`` arms every standby engine and
  planner; a traced ``dstack`` serve equals the untraced one, and its
  exposition round-trips through ``parse_prometheus``.
* The port's own timing: seeded gateway serves give one
  ``key_sequence(host=True)`` with the ``host`` spans in it; on the CPU
  every dispatch span carries a ``device_dur``; a dispatch's CUDA events
  resolve only once the device has passed them, with no wait (fake
  events on the CPU); the clock anchor places a span on
  ``torch.profiler``'s timeline.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.serving import faults as jax_faults  # noqa: E402
from repro.serving import plan as jax_plan  # noqa: E402
from repro.serving import request as jax_request  # noqa: E402
from repro.serving import telemetry as jax_tel  # noqa: E402
from repro.serving.engine import InferenceEngine as JaxEngine  # noqa
from repro.serving.engine import make_engine as jax_make_engine  # noqa
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.latency_model import LatencyModel  # noqa: E402
from repro_torch.core.profiles import build_profile  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402
from repro_torch.serving import faults as port_faults  # noqa: E402
from repro_torch.serving import plan as port_plan  # noqa: E402
from repro_torch.serving import request as port_request  # noqa: E402
from repro_torch.serving import telemetry as port_tel  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402
from repro_torch.serving.gateway import AsyncGateway  # noqa: E402
from repro_torch.serving.pool import build_pool  # noqa: E402
from repro_torch.serving.telemetry import (MetricsRegistry,  # noqa: E402
                                           StepTimers, Telemetry,
                                           TraceRecorder, parse_prometheus,
                                           request_timelines,
                                           roofline_report,
                                           validate_chrome_trace)

CACHE_LEN = 32
N_SLOTS = 4
PAGE = 8
MODEL = "olmo-1b"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """The JAX package's reduced olmo-1b engine (slots of the tests'
    geometry) and the port's weights converted from it."""
    jeng = jax_make_engine(jax_config(MODEL).reduced(),
                           cache_len=CACHE_LEN).init_slots(
        N_SLOTS, paged=True, page_size=PAGE)
    cfg = get_config(MODEL).reduced()
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jeng.params),
                               device="cpu")
    return cfg, jeng, params


@pytest.fixture(scope="module")
def engine(weights):
    cfg, _, params = weights
    eng = InferenceEngine(build_model(cfg, device="cpu"), params,
                          cache_len=CACHE_LEN).init_slots(
        N_SLOTS, paged=True, page_size=PAGE)
    return cfg, eng


def _workload(cfg, seed: int, n: int):
    rng = np.random.default_rng(seed)
    spec, prompts = [], {}
    for i in range(n):
        p = int(rng.integers(3, 12))
        nt = int(rng.integers(3, 8))
        spec.append((i, p, nt))
        prompts[i] = rng.integers(1, cfg.vocab_size,
                                  size=(1, p)).astype(np.int32)
    return spec, prompts


def _shared_workload(cfg, seed: int, n: int):
    """Two templates (20 and 8 tokens) with short random tails, as the
    reference's chaos-with-prefix-cache workload."""
    rng = np.random.default_rng(seed)
    temps = [rng.integers(1, cfg.vocab_size, size=s).astype(np.int32)
             for s in (20, 8)]
    spec, prompts = [], {}
    for i in range(n):
        t = temps[int(rng.integers(0, 2))]
        tail = rng.integers(1, cfg.vocab_size,
                            size=int(rng.integers(2, 6))).astype(np.int32)
        toks = np.concatenate([t, tail])[None, :]
        spec.append((i, toks.shape[1], int(rng.integers(3, 7))))
        prompts[i] = toks
    return spec, prompts


def _serve(side, cfg, eng, spec, prompts, *, tel=None, fault_kw=None,
           chunk_tokens=3, **planner_kw):
    """One traced (or detached) serve to drain; returns (streams, planner,
    server, injector)."""
    plan, request, faults = ((jax_plan, jax_request, jax_faults)
                             if side == "jax"
                             else (port_plan, port_request, port_faults))
    wrap = jnp.asarray if side == "jax" else (lambda a: a)
    eng.release_all_slots()
    eng.reset_stats()
    reqs = [request.Request(arrival=0.0, rid=i, model=cfg.name, slo=1e9,
                            n_tokens=nt, prompt_len=p) for i, p, nt in spec]
    planner = plan.StepPlanner(eng, request.RequestQueue(cfg.name, slo=1e9),
                               plan.PlannerConfig(chunk_tokens=chunk_tokens,
                                                  lazy=True, gen_len=4,
                                                  **planner_kw))
    planner.telemetry = tel
    eng.attach_telemetry(tel)
    inj = faults.FaultInjector(**fault_kw) if fault_kw else None
    if inj is not None:
        eng.attach_faults(inj, max_retries=1)
    try:
        srv = plan.serve_ticks(planner, reqs,
                               lambda r: {"tokens": wrap(prompts[r.rid])},
                               faults=inj, stall_limit=50)
    finally:
        eng.attach_faults(None, max_retries=2)
        eng.attach_telemetry(None)
        planner.telemetry = None
    assert not srv.truncated
    held = eng.prefix_cache.held_pages if eng.prefix_cache else 0
    assert eng.free_pages + held == eng.total_pages
    streams = {r: tuple(t) for r, t in planner.streams.items()}
    return streams, planner, srv, inj


def _dispatch_counts(eng):
    s = eng.stats
    return (s.prefills, s.packed_prefills, s.chunk_prefills,
            s.prefill_tokens, s.decode_steps, s.tokens_out, s.grows)


# ---------------------------------------------------------------------------
# detached runs are bit-identical; an attached trace is a pure observer
# ---------------------------------------------------------------------------
def test_disabled_runs_bit_identical_and_tracing_pure_observer(engine):
    cfg, eng = engine
    spec, prompts = _workload(cfg, seed=11, n=6)

    base, _, _, _ = _serve("port", cfg, eng, spec, prompts)
    base_counts = _dispatch_counts(eng)
    jit_before = eng.jit_cache_sizes()

    tel = Telemetry(trace=TraceRecorder())
    traced, planner, _, _ = _serve("port", cfg, eng, spec, prompts, tel=tel)
    assert traced == base, "tracing changed emitted streams"
    assert _dispatch_counts(eng) == base_counts, \
        "tracing changed what was dispatched"
    assert eng.jit_cache_sizes() == jit_before, "tracing built something"

    assert tel.timers.total_samples > 0
    obj = tel.trace.to_chrome_trace()
    assert validate_chrome_trace(obj) > 0
    tracks = tel.trace.tracks()
    assert f"queue/{cfg.name}" in tracks
    assert f"tick/{cfg.name}" in tracks
    assert f"engine/{cfg.name}@0ch" in tracks
    kinds = {ev["name"] for ev in tel.trace.events
             if ev.get("cat") == "dispatch"}
    assert {"admission_prefill", "chunk_prefill", "decode"} <= kinds
    assert any(ev["name"] == "execute" for ev in tel.trace.events)

    tl = request_timelines(tel.trace)
    names = [n for _, n in tl[(cfg.name, 0)]]
    for a, b in (("queued", "admitted"), ("admitted", "first_token"),
                 ("first_token", "complete")):
        assert names.index(a) < names.index(b), names
    q = planner.queue
    assert len(q.ttfts) == q.completed and all(t >= 0 for t in q.ttfts)
    assert q.tbts and all(t > 0 for t in q.tbts)

    again, _, _, _ = _serve("port", cfg, eng, spec, prompts)
    assert again == base
    assert _dispatch_counts(eng) == base_counts
    assert eng.jit_cache_sizes() == jit_before


# ---------------------------------------------------------------------------
# the seeded traces' key sequences equal the JAX package's
# ---------------------------------------------------------------------------
CHAOS = dict(seed=13, dispatch_rate=0.1, alloc_rate=0.05, max_faults=8)


def test_chaos_trace_key_sequence_equals_jax(weights, engine):
    """The seeded chaos trace: two port runs give one key sequence, and it
    is the JAX package's on the same run; so is the Prometheus exposition
    of the run's queue, engine counters and injected faults."""
    cfg, jeng, _ = weights
    _, eng = engine
    spec, prompts = _workload(cfg, seed=23, n=8)
    runs = {}
    for side, e in (("jax", jeng), ("port", eng), ("port2", eng)):
        mod = jax_tel if side == "jax" else port_tel
        tel = mod.Telemetry(trace=mod.TraceRecorder())
        streams, planner, _, inj = _serve(
            side[:4], cfg, e, spec, prompts, tel=tel, fault_kw=CHAOS)
        assert inj.total > 0, "chaos did not fire"
        mod.validate_chrome_trace(tel.trace.to_chrome_trace())
        reg = mod.MetricsRegistry()
        mod.export_queue(reg, planner.queue)
        mod.export_engine_stats(reg, e.stats, cfg.name)
        mod.export_fault_injector(reg, inj)
        runs[side] = (tel.trace.key_sequence(), streams, reg.render(),
                      dict(inj.injected))
    assert runs["port"][0] == runs["port2"][0]
    names = {k[2] for k in runs["port"][0]}
    assert {"retry", "execute", "grow", "decode"} <= names
    for got, want in zip(runs["port"], runs["jax"]):
        assert got == want


@pytest.mark.parametrize("feature", ["prefix_cache", "speculative"])
def test_feature_trace_key_sequence_equals_jax(weights, feature):
    """The radix cache's instants (prefix_hit with its COW flag,
    prefix_evict under a tight pool) and speculation's dispatches
    (spec_admit, spec_draft, spec_verify) and rounds, event for event as
    the JAX package traces them."""
    cfg, jref, params = weights
    pages = 8 if feature == "prefix_cache" else None
    jeng = JaxEngine(jref.api, jref.params, cache_len=CACHE_LEN).init_slots(
        N_SLOTS, paged=True, page_size=PAGE, total_pages=pages)
    api = build_model(cfg, device="cpu")
    peng = InferenceEngine(api, params, cache_len=CACHE_LEN).init_slots(
        N_SLOTS, paged=True, page_size=PAGE, total_pages=pages)
    if feature == "prefix_cache":
        for e in (jeng, peng):
            e.enable_prefix_cache()
            e.warm_prefix_ops()
        spec, prompts = _shared_workload(cfg, seed=23, n=10)
        kw = dict(prefix_cache=True)
        want = {"prefix_hit", "prefix_evict"}
    else:
        jeng.attach_draft(JaxEngine(jref.api, jref.params,
                                    cache_len=CACHE_LEN).init_slots(
            N_SLOTS, paged=False), spec_k=3)
        peng.attach_draft(InferenceEngine(api, params,
                                          cache_len=CACHE_LEN).init_slots(
            N_SLOTS, paged=False), spec_k=3)
        spec, prompts = _workload(cfg, seed=31, n=6)
        kw = dict(spec_k=3)
        want = {"spec_admit", "spec_draft", "spec_verify", "spec_round"}
    seqs = {}
    for side, e, mod in (("jax", jeng, jax_tel), ("port", peng, port_tel)):
        tel = mod.Telemetry(trace=mod.TraceRecorder())
        streams, _, _, _ = _serve(side, cfg, e, spec, prompts, tel=tel, **kw)
        seqs[side] = (tel.trace.key_sequence(), streams)
    assert want <= {k[2] for k in seqs["port"][0]}
    assert seqs["port"] == seqs["jax"]


# ---------------------------------------------------------------------------
# the validator, the Prometheus round trip, the roofline report
# ---------------------------------------------------------------------------
def test_trace_recorder_and_validator():
    rec = TraceRecorder(capacity=16)
    with rec.span("tick/m", "tick", tick=0):
        with rec.span("tick/m", "plan"):
            pass
    rec.instant("queue/m", "queued", rid=1)
    rec.counter("queue/m", "depth", queued=3)
    obj = rec.to_chrome_trace()
    assert validate_chrome_trace(obj) == 2
    assert validate_chrome_trace(json.loads(json.dumps(obj))) == 2
    names = {e["args"]["name"] for e in obj["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert names == {"tick/m", "queue/m"}
    for i in range(40):
        rec.instant("queue/m", "queued", rid=i)
    assert len(rec.events) == 16 and rec.dropped > 0
    assert validate_chrome_trace(rec.to_chrome_trace()) >= 0
    bad = [{"events": []},
           {"traceEvents": [{"ph": "Z", "name": "x"}]},
           {"traceEvents": [{"ph": "X", "name": "x", "ts": -1.0,
                             "dur": 1.0}]},
           {"traceEvents": [{"ph": "X", "name": "x", "ts": 0.0,
                             "dur": float("nan")}]},
           {"traceEvents": [
               {"ph": "X", "name": "a", "ts": 0.0, "dur": 10.0,
                "pid": 1, "tid": 1},
               {"ph": "X", "name": "b", "ts": 5.0, "dur": 10.0,
                "pid": 1, "tid": 1}]}]
    for obj in bad:
        with pytest.raises(ValueError):
            validate_chrome_trace(obj)
        # the JAX package's validator refuses the same objects
        with pytest.raises(ValueError):
            jax_tel.validate_chrome_trace(obj)
    assert validate_chrome_trace({"traceEvents": [
        {"ph": "X", "name": "a", "ts": 0.0, "dur": 10.0,
         "pid": 1, "tid": 1},
        {"ph": "X", "name": "b", "ts": 5.0, "dur": 10.0,
         "pid": 1, "tid": 2}]}) == 2


def test_prometheus_roundtrip():
    regs = []
    for mod in (port_tel, jax_tel):
        reg = mod.MetricsRegistry()
        reg.counter("dstack_requests_total", "by cause").inc(
            3, model="m", cause="completed")
        reg.counter("dstack_requests_total").inc(1, model="m", cause="shed")
        reg.gauge("dstack_pool_occupancy", "mean occupancy").set(
            0.75, policy="dstack")
        h = reg.histogram("dstack_latency_seconds", "e2e latency",
                          buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05, 0.5, 5.0):
            h.observe(v, model="m")
        regs.append(reg)
    text = regs[0].render()
    assert text == regs[1].render()
    assert "# TYPE dstack_requests_total counter" in text
    assert "# HELP dstack_latency_seconds e2e latency" in text
    parsed = parse_prometheus(text)
    assert parsed == jax_tel.parse_prometheus(text)
    assert parsed[("dstack_requests_total",
                   (("cause", "completed"), ("model", "m")))] == 3
    assert parsed[("dstack_requests_total",
                   (("cause", "shed"), ("model", "m")))] == 1
    assert parsed[("dstack_pool_occupancy", (("policy", "dstack"),))] == 0.75
    key = (("le", "1"), ("model", "m"))
    assert parsed[("dstack_latency_seconds_bucket", key)] == 3
    assert parsed[("dstack_latency_seconds_bucket",
                   (("le", "+Inf"), ("model", "m")))] == 4
    assert parsed[("dstack_latency_seconds_count", (("model", "m"),))] == 4
    assert parsed[("dstack_latency_seconds_sum",
                   (("model", "m"),))] == pytest.approx(5.555)
    with pytest.raises(ValueError):
        regs[0].gauge("dstack_requests_total")


def test_roofline_report_flags_deviations():
    """Rows join the H100's latency model (GPU percent): decode at batch
    = bucket, prefill at seq = bucket; samples at the prediction pass,
    wildly slow ones flag, ``grow`` and unknown models get none."""
    prof = build_profile(MODEL, request_rate=2000)
    assert prof.hw.name == "h100-sxm"
    lm_pred = LatencyModel(prof.cfg, mode="decode", seq=1,
                           hw=prof.hw).latency(50, 4)
    timers = StepTimers()
    for _ in range(5):
        timers.record(MODEL, 50, "decode", 4, lm_pred)
    for _ in range(5):
        timers.record(MODEL, 50, "admission_prefill", 64, 10.0)
    timers.record(MODEL, 50, "grow", 1, 0.001)
    timers.record("nope", 50, "decode", 4, 0.001)
    rows = {(r.kind, r.model): r
            for r in roofline_report(timers, {MODEL: prof}, tol=4.0)}
    ok = rows[("decode", MODEL)]
    assert ok.predicted_s == pytest.approx(lm_pred)
    assert ok.ratio == pytest.approx(1.0) and not ok.flagged
    dev = rows[("admission_prefill", MODEL)]
    assert dev.predicted_s and dev.ratio > 4.0 and dev.flagged
    assert dev.predicted_s == pytest.approx(LatencyModel(
        prof.cfg, mode="prefill", seq=64, hw=prof.hw).latency(50, 1))
    assert rows[("grow", MODEL)].predicted_s is None
    assert not rows[("grow", MODEL)].flagged
    assert rows[("decode", "nope")].predicted_s is None
    lines = port_tel.format_roofline(rows.values())
    assert len(lines) == 5 and "DEV" in lines[2] and "ok" in lines[1]


# ---------------------------------------------------------------------------
# the pool plane
# ---------------------------------------------------------------------------
def test_pool_telemetry_traced_serve_equals_untraced():
    """``EnginePool.attach_telemetry`` arms every standby engine and the
    per-model planners (and ``reset`` carries it to the new planners); a
    traced ``dstack`` serve admits, serves and violates exactly as the
    untraced one, adds no executable, traces the request lifecycle and
    the dispatches on ``engine/<model>@<GPU%>ch`` tracks, and its
    exposition round-trips through ``parse_prometheus``."""
    from repro_torch.serving.controller import run_policy
    pool = build_pool(["olmo-1b", "mamba2-1.3b"], request_rate=1500.0,
                      base_slots=2, cache_len=32, device="cpu")
    warm = pool.jit_cache_sizes()

    def serve():
        res = run_policy(pool, "dstack", rate=1500.0, duration=0.02,
                         gen_len=3)
        return res, {n: (m.completed, m.violated, m.dropped, m.runs)
                     for n, m in res.per_model.items()}

    _, base = serve()
    tel = Telemetry(trace=TraceRecorder())
    pool.attach_telemetry(tel)
    try:
        res, traced = serve()
        for host in pool.hosts.values():
            assert all(e.telemetry is tel for e in host.engines())
        assert all(p.telemetry is tel for p in pool._planners.values())
    finally:
        pool.attach_telemetry(None)
    assert traced == base and all(c for c, _, _, _ in traced.values())
    assert pool.jit_cache_sizes() == warm
    assert all(e.telemetry is None for h in pool.hosts.values()
               for e in h.engines())
    validate_chrome_trace(tel.trace.to_chrome_trace())
    names = [ev["name"] for ev in tel.trace.events]
    for n in ("queued", "admitted", "first_token", "complete",
              "admission_prefill", "decode"):
        assert n in names, n
    chips = {a for h in pool.hosts.values() for a in h.allocations}
    engine_tracks = {t for t in tel.trace.tracks()
                     if t.startswith("engine/")}
    assert engine_tracks and all(
        int(t.rsplit("@", 1)[1][:-2]) in chips for t in engine_tracks)
    assert tel.timers.total_samples > 0
    reg = MetricsRegistry()
    port_tel.export_pool_result(reg, res)
    parsed = parse_prometheus(reg.render())
    for n, (completed, violated, _, _) in traced.items():
        assert parsed[("dstack_requests_total",
                       (("cause", "completed"), ("model", n)))] == completed
        assert parsed[("dstack_slo_violations_total",
                       (("model", n),))] == violated
    rows = roofline_report(tel.timers, pool.profiles)
    assert any(r.predicted_s for r in rows if r.kind == "decode")


# ---------------------------------------------------------------------------
# the port's own timing: host spans, device time, the profiler's clock
# ---------------------------------------------------------------------------
def _gateway_serve(cfg, eng, seed):
    """A seeded trace served through the gateway (virtual clock) with a
    trace attached; returns the telemetry."""
    spec, prompts = _workload(cfg, seed=seed, n=6)
    eng.release_all_slots()
    eng.reset_stats()
    planner = port_plan.StepPlanner(
        eng, port_request.RequestQueue(cfg.name, slo=1e9),
        port_plan.PlannerConfig(chunk_tokens=3, lazy=True, gen_len=4))
    tel = Telemetry(trace=TraceRecorder())
    planner.telemetry = tel
    eng.attach_telemetry(tel)
    reqs = [port_request.Request(arrival=0.002 * i, rid=i, model=cfg.name,
                                 slo=1e9, n_tokens=nt, prompt_len=p)
            for i, p, nt in spec]
    try:
        AsyncGateway(planner, stall_limit=50).serve_trace(
            reqs, {r: {"tokens": t} for r, t in prompts.items()})
    finally:
        eng.attach_telemetry(None)
        planner.telemetry = None
    return tel


def test_host_spans_key_sequence_deterministic(engine):
    """Two seeded gateway serves give one ``key_sequence(host=True)``,
    with the gateway's, the tick server's and the engine's ``host`` spans
    in it; the default projection leaves exactly those out; every span
    nests or is disjoint on its track."""
    cfg, eng = engine
    tels = [_gateway_serve(cfg, eng, seed=5) for _ in range(2)]
    full = [t.trace.key_sequence(host=True) for t in tels]
    assert full[0] == full[1]
    host = [k for k in full[0] if k[3] == "host"]
    assert {"deliver", "pump", "yield", "observe", "readback"} == {
        k[2] for k in host}
    assert {k[0] for k in host} == {f"tick/{cfg.name}",
                                    f"engine/{cfg.name}@0ch"}
    assert tels[0].trace.key_sequence() == [k for k in full[0]
                                           if k[3] != "host"]
    assert validate_chrome_trace(tels[0].trace.to_chrome_trace()) > 0
    # each decode holds its readback; each tick its observe
    evs = list(tels[0].trace.events)
    spans = [e for e in evs if e["ph"] == "X"]

    def inside(child, parents):
        return any(p["ts"] <= child["ts"] and child["ts"] + child["dur"]
                   <= p["ts"] + p["dur"] + 1e-3 for p in parents)
    decodes = [e for e in spans if e["name"] == "decode"]
    ticks = [e for e in spans if e["name"] == "tick"]
    for name, parents in (("readback", decodes), ("observe", ticks)):
        kids = [e for e in spans if e["name"] == name]
        assert kids and all(inside(k, parents) for k in kids), name
    assert sum(e["name"] == "readback" for e in spans) == len(decodes)


def test_dispatch_spans_carry_device_dur_on_the_cpu(engine):
    """On the CPU the host runs each dispatch: every dispatch span has a
    ``device_dur`` equal to its ``dur``, the Chrome export shows it as an
    arg (and ``key_sequence`` does not), and every dispatch gave the
    timers one sample."""
    cfg, eng = engine
    tel = _gateway_serve(cfg, eng, seed=7)
    disp = [e for e in tel.trace.events if e.get("cat") == "dispatch"]
    assert disp and all(e["device_dur"] == e["dur"] for e in disp)
    assert tel.timers.total_samples == len(disp)
    exported = [e for e in tel.trace.to_chrome_trace()["traceEvents"]
                if e.get("cat") == "dispatch"]
    assert all(e["args"]["device_dur"] == round(e["dur"], 3)
               for e in exported)
    assert not any("device_dur" in dict(k[4])
                   for k in tel.trace.key_sequence(host=True))


class _FakeDevice:
    """A card's stream as fake events see it: the host's clock records,
    the device has passed every event stamped at or before ``passed``."""

    def __init__(self):
        self.clock = 0.0          # ms
        self.passed = -1.0
        self.made = 0
        self.waits = 0


def test_dispatch_events_resolve_without_waiting(monkeypatch):
    """The card's path with fake events: a dispatch's pair stays pending
    until the device has passed its end event (no wait), pairs resolve
    oldest first into ``device_dur`` and the timers, the decode's
    readback resolves everything before it, ``flush`` waits for the rest,
    and the events are reused (none allocated per dispatch; a dispatch
    that raised drops its handle and its start event)."""
    dev = _FakeDevice()

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            dev.made += 1

        def record(self, stream=None):
            self.t = dev.clock

        def query(self):
            return self.t <= dev.passed

        def synchronize(self):
            dev.waits += 1
            dev.passed = max(dev.passed, self.t)

        def elapsed_time(self, end):
            assert self.query() and end.query()
            return end.t - self.t

    class Tokens:
        """The decode's tokens: the copy waits for the stream."""

        def cpu(self):
            dev.passed = dev.clock
            return torch.zeros(4, dtype=torch.int32)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    from types import SimpleNamespace
    eng = SimpleNamespace(device=torch.device("cuda"), alloc_chips=0,
                          cfg=SimpleNamespace(name="m"))
    tel = Telemetry(trace=TraceRecorder())

    def dispatch(kind, ms, read=False):
        op = tel.t0(eng)
        dev.clock += ms
        if read:
            tel.readback(eng, Tokens(), op)
        tel.dispatch_done(eng, kind, 1, op)
        dev.clock += 0.5                 # the host between dispatches

    def device_durs():
        return [e.get("device_dur") for e in tel.trace.events
                if e.get("cat") == "dispatch"]

    dispatch("grow", 1.0)
    dispatch("admission_prefill", 2.0)
    assert device_durs() == [None, None] and len(tel._pending) == 2
    dev.passed = 1.0                      # past the grow only
    dispatch("chunk_prefill", 3.0)
    assert device_durs() == [1e3, None, None]
    dispatch("decode", 4.0, read=True)
    assert device_durs() == [1e3, 2e3, 3e3, 4e3] and not tel._pending
    assert tel.timers.samples[("m", 0, "decode", 1)] == [4e-3]
    made = dev.made
    for _ in range(3):
        dispatch("decode", 1.0, read=True)
    assert dev.made == made, "a dispatch allocated events"
    free = len(tel._free)
    tel.t0(eng)                           # a dispatch that raised: its
    assert len(tel._free) == free - 1     # start event goes with it
    dispatch("chunk_prefill", 2.0)
    assert dev.made == made and tel._pending
    assert device_durs()[-1] is None
    assert dev.waits == 0
    tel.flush()
    assert not tel._pending and dev.waits == 1
    assert device_durs()[-1] == 2e3
    rb = [e for e in tel.trace.events if e["name"] == "readback"]
    assert len(rb) == 4 and all(e["cat"] == "host" for e in rb)


def test_clock_anchor_maps_spans_onto_the_profiler():
    """Under ``torch.profiler`` (CPU) the recorder's anchor maps a span
    onto the profiler's clock within 0.5 ms of a ``record_function``
    range around the same code; without a profiler there is no anchor."""
    import time
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile
    assert TraceRecorder().anchor is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rec = TraceRecorder()
        with record_function("probe"):
            with rec.span("tick/m", "probe"):
                time.sleep(0.003)
        rec.clear()                       # a new clock, a new anchor
        with record_function("probe2"):
            with rec.span("tick/m", "probe2"):
                time.sleep(0.002)
    assert rec.anchor is not None
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        ranges.setdefault(e.name(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    clocks = sorted(ranges[TraceRecorder.CLOCK_RANGE])
    assert len(clocks) == 2
    (ev,) = rec.events
    a, b = ranges["probe2"][0]
    start = rec.profiler_ns(ev["ts"], clocks[1][0])
    end = rec.profiler_ns(ev["ts"] + ev["dur"], clocks[1][0])
    assert abs(start - a) < 5e5 and abs(end - b) < 5e5, (start - a, end - b)
    other = rec.to_chrome_trace()["otherData"]
    assert other["t0"] == rec.t0 and other["clock_anchor"] == rec.anchor
