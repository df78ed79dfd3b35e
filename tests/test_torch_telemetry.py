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
