"""The port's async gateway, traffic scenarios and chaos plane on the CPU:
``tests/test_gateway.py`` case for case, ``tests/test_chaos.py``'s chaos
acceptance and its pool-plane and prefix-cache cases, on the port's
engine (reduced olmo-1b on the JAX package's weights, 4 paged slots of
32 tokens, pages of 8), and the port against the JAX package:

* gateway streams equal ``serve_ticks`` on the same port engine, tick for
  tick, under every lifecycle edge the reference checks (disconnects mid
  chunked prefill and mid speculative round, deadlines at submit and in
  queue, shedding, live submits, chaos, telemetry instants);
* ``bench_gateway``'s burst trace (its quick duration) served through the
  port's gateway and the JAX package's under FIFO and under tiers gives
  the same streams, per-tier and per-tenant attainment, Jain index and
  shed, drop and abort counts — and tiers lift interactive attainment
  above FIFO's;
* the seeded chaos run's terminal counters and surviving streams equal
  the JAX engine's on the same schedule.
"""
import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.serving import faults as jax_faults  # noqa: E402
from repro.serving import gateway as jax_gateway  # noqa: E402
from repro.serving import plan as jax_plan  # noqa: E402
from repro.serving import request as jax_request  # noqa: E402
from repro.serving import traffic as jax_traffic  # noqa: E402
from repro.serving.engine import make_engine as jax_make_engine  # noqa
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402
from repro_torch.serving import gateway as port_gateway  # noqa: E402
from repro_torch.serving import plan as port_plan  # noqa: E402
from repro_torch.serving import request as port_request  # noqa: E402
from repro_torch.serving import traffic  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402
from repro_torch.serving.faults import FaultInjector  # noqa: E402
from repro_torch.serving.gateway import (AsyncGateway,  # noqa: E402
                                         DeadlineRejection, ShedRejection)
from repro_torch.serving.plan import (PlannerConfig, StepPlanner,  # noqa
                                      TieredAdmission, serve_ticks)
from repro_torch.serving.request import Request, RequestQueue  # noqa: E402
from repro_torch.serving.telemetry import Telemetry, TraceRecorder  # noqa

CACHE_LEN = 32
N_SLOTS = 4
PAGE = 8
MODEL = "olmo-1b"
CHAOS = dict(seed=13, dispatch_rate=0.08, alloc_rate=0.05, stuck_rate=0.04,
             max_faults=12)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(config, JAX engine, port engine) on the same weights, both with
    the reference's slot geometry."""
    jeng = jax_make_engine(jax_config(MODEL).reduced(),
                           cache_len=CACHE_LEN).init_slots(
        N_SLOTS, paged=True, page_size=PAGE)
    cfg = get_config(MODEL).reduced()
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jeng.params),
                               device="cpu")
    peng = InferenceEngine(build_model(cfg, device="cpu"), params,
                           cache_len=CACHE_LEN).init_slots(
        N_SLOTS, paged=True, page_size=PAGE)
    return cfg, jeng, peng


@pytest.fixture(scope="module")
def engine(pair):
    return pair[0], pair[2]


@pytest.fixture(scope="module")
def spec_engine(engine):
    """The module engine paired with an identical-weights draft, so
    spec rounds accept everything and streams stay plain-greedy."""
    cfg, eng = engine
    draft = InferenceEngine(eng.api, eng.params,
                            cache_len=CACHE_LEN).init_slots(
        N_SLOTS, paged=False)
    eng.attach_draft(draft, spec_k=3)
    yield cfg, eng
    eng._draft = None                     # later tests run draft-free


def _make_prompt(cfg, rid: int, length: int):
    rng = np.random.default_rng(1000 + rid)
    return {"tokens": rng.integers(1, cfg.vocab_size,
                                   size=(1, length)).astype(np.int32)}


def _workload(cfg, seed: int, n: int, *, spread=0.0, prompt_range=(3, 12),
              budget_range=(3, 8), slo=1e9):
    rng = np.random.default_rng(seed)
    reqs, prompts = [], {}
    for i in range(n):
        p = int(rng.integers(*prompt_range))
        nt = int(rng.integers(*budget_range))
        t = float(rng.uniform(0.0, spread)) if spread else 0.0
        reqs.append(Request(arrival=t, rid=i, model=cfg.name, slo=slo,
                            n_tokens=nt, prompt_len=p))
        prompts[i] = _make_prompt(cfg, i, p)
    reqs.sort(key=lambda r: r.arrival)
    return reqs, prompts


def _reset(cfg, eng, reqs, **planner_kw):
    eng.release_all_slots()
    eng.reset_stats()
    for r in reqs:
        r.state = "pending"
        r.finish = -1.0
    return StepPlanner(eng, RequestQueue(cfg.name, slo=1e9),
                       PlannerConfig(gen_len=4, **planner_kw))


def _tick_serve(cfg, eng, reqs, prompts, **planner_kw):
    planner = _reset(cfg, eng, reqs, **planner_kw)
    srv = serve_ticks(planner, reqs, lambda r: prompts[r.rid],
                      stall_limit=50)
    assert not srv.truncated
    return {r: tuple(t) for r, t in planner.streams.items()}, planner, srv


def _gw_serve(cfg, eng, reqs, prompts, *, wall_clock=False, faults=None,
              on_tick=None, max_retries=None, telemetry=None, **planner_kw):
    """Serve a trace through the gateway; always audit page conservation
    on the way out."""
    planner = _reset(cfg, eng, reqs, **planner_kw)
    planner.telemetry = telemetry
    if faults is not None:
        eng.attach_faults(faults, max_retries=max_retries)
    gw = AsyncGateway(planner, wall_clock=wall_clock, faults=faults,
                      on_tick=on_tick, stall_limit=50)
    try:
        streams = gw.serve_trace(reqs, prompts)
    finally:
        if faults is not None:
            eng.attach_faults(None, max_retries=2)
    assert not gw.truncated
    held = eng.prefix_cache.held_pages if eng.prefix_cache else 0
    assert eng.free_pages + held == eng.total_pages, "leaked pages"
    assert eng.check_page_invariants()
    return streams, planner, gw


# ---------------------------------------------------------------------------
# bit-exactness: gateway == serve_ticks, telemetry detached, 0 new entries
# ---------------------------------------------------------------------------
def test_gateway_trace_bit_exact_vs_serve_ticks(engine):
    cfg, eng = engine
    reqs, prompts = _workload(cfg, seed=11, n=10, spread=0.01)
    base, _, srv = _tick_serve(cfg, eng, reqs, prompts,
                               chunk_tokens=3, lazy=True)
    assert base and any(len(t) for t in base.values())
    jit_before = eng.jit_cache_sizes()
    streams, planner, gw = _gw_serve(cfg, eng, reqs, prompts,
                                     chunk_tokens=3, lazy=True)
    assert planner.telemetry is None
    got = {rid: tuple(st.tokens) for rid, st in streams.items()}
    assert got == base
    assert all(st.state == "completed" for st in streams.values())
    assert gw.server.ticks == srv.ticks
    assert eng.jit_cache_sizes() == jit_before
    for rid, st in streams.items():
        assert st.tokens == list(planner.streams[rid])


def test_gateway_concurrent_consumers_and_wall_clock(engine):
    cfg, eng = engine
    reqs, prompts = _workload(cfg, seed=11, n=10, spread=0.01)
    base, _, _ = _tick_serve(cfg, eng, reqs, prompts,
                             chunk_tokens=3, lazy=True)
    planner = _reset(cfg, eng, reqs, chunk_tokens=3, lazy=True)
    gw = AsyncGateway(planner, wall_clock=True, stall_limit=50)

    async def main():
        gw.schedule(reqs, prompts)
        consumers = [asyncio.create_task(st.collect())
                     for st in gw.streams.values()]
        await gw.run()
        return await asyncio.gather(*consumers)

    collected = asyncio.run(main())
    assert not gw.truncated
    got = {st.rid: tuple(st.tokens) for st in gw.streams.values()}
    assert got == base
    assert [tuple(t) for t in collected] \
        == [tuple(gw.streams[st.rid].tokens) for st in gw.streams.values()]
    assert gw.now >= max(r.arrival for r in reqs)
    assert eng.free_pages == eng.total_pages


# ---------------------------------------------------------------------------
# lifecycle edges: disconnects, deadlines, shedding
# ---------------------------------------------------------------------------
def test_disconnect_mid_chunked_prefill_through_gateway(engine):
    cfg, eng = engine
    long_req = Request(arrival=0.0, rid=0, model=cfg.name, slo=1e9,
                       n_tokens=4, prompt_len=24)
    side = Request(arrival=0.0, rid=1, model=cfg.name, slo=1e9,
                   n_tokens=6, prompt_len=4)
    prompts = {0: _make_prompt(cfg, 0, 24), 1: _make_prompt(cfg, 1, 4)}
    base, _, _ = _tick_serve(cfg, eng, [side], {1: prompts[1]})
    hold = {}

    def disconnect_mid_prefill(server, now):
        if "pages" in hold:
            return
        for slot, r in server.planner._resident.items():
            if r.req.rid == 0 and r.prefilling and r.done > 0:
                hold["pages"] = eng.slot_page_count(slot)
                assert hold["gw"].cancel(0)
                return

    planner = _reset(cfg, eng, [long_req, side], chunk_tokens=3)
    gw = AsyncGateway(planner, on_tick=disconnect_mid_prefill,
                      stall_limit=50)
    hold["gw"] = gw
    streams = gw.serve_trace([long_req, side], prompts)
    assert hold.get("pages", 0) > 0, "never caught it mid-prefill"
    assert streams[0].state == "cancelled" and streams[0].tokens == []
    assert streams[1].state == "completed"
    assert tuple(streams[1].tokens) == base[1]
    q = planner.queue
    assert q.cancelled == 1 and q.completed == 1 and q.violated == 0
    assert eng.free_pages == eng.total_pages


def test_disconnect_mid_spec_round_through_gateway(spec_engine):
    cfg, eng = spec_engine
    reqs, prompts = _workload(cfg, seed=23, n=5, budget_range=(6, 10))
    base, _, _ = _gw_serve(cfg, eng, reqs, prompts, spec_k=3)
    assert eng.stats.spec_rounds > 0
    hold = {}

    def disconnect_mid_spec(server, now):
        if hold.get("done"):
            return
        pl = server.planner
        if eng.stats.spec_rounds == 0:
            return
        for slot, r in pl._resident.items():
            if r.req.rid == 2 and not r.prefilling:
                hold["done"] = now
                assert hold["gw"].cancel(2)
                return

    planner = _reset(cfg, eng, reqs, spec_k=3)
    gw = AsyncGateway(planner, on_tick=disconnect_mid_spec, stall_limit=50)
    hold["gw"] = gw
    streams = gw.serve_trace(reqs, prompts)
    assert hold.get("done") is not None, "cancel never fired"
    assert eng.stats.spec_rounds > 0
    assert streams[2].state == "cancelled"
    assert len(streams[2].tokens) < len(base[2].tokens)
    for rid, st in streams.items():
        if rid != 2:
            assert st.state == "completed"
            assert st.tokens == base[rid].tokens, f"survivor {rid} diverged"
    assert planner.queue.cancelled == 1
    assert eng.free_pages == eng.total_pages


def test_deadline_at_submit_vs_deadline_in_queue(engine):
    cfg, eng = engine
    planner = _reset(cfg, eng, [])
    gw = AsyncGateway(planner)
    stale = Request(arrival=-1.0, rid=90, model=cfg.name, slo=0.5,
                    n_tokens=2, prompt_len=4)

    async def live():
        task = asyncio.create_task(gw.run(hold_open=True))
        await asyncio.sleep(0)
        with pytest.raises(DeadlineRejection):
            gw.submit(stale, _make_prompt(cfg, 90, 4))
        gw.close()
        await task

    asyncio.run(live())
    q = planner.queue
    assert stale.state == "deadline_aborted"
    assert (q.dropped, q.violated) == (1, 1)
    assert 90 not in gw.streams
    assert eng.free_pages == eng.total_pages
    hogs = [Request(arrival=0.0, rid=i, model=cfg.name, slo=1e9,
                    n_tokens=8, prompt_len=24) for i in range(5)]
    tight = Request(arrival=5e-4, rid=5, model=cfg.name, slo=2e-3,
                    n_tokens=2, prompt_len=24)
    prompts = {i: _make_prompt(cfg, i, 24) for i in range(6)}
    streams, planner, _ = _gw_serve(cfg, eng, hogs + [tight], prompts)
    q = planner.queue
    assert streams[5].state == "deadline_aborted"
    assert streams[5].tokens == []
    assert (q.dropped, q.completed) == (1, 5)
    assert q.completed + q.dropped == 6


def test_shed_request_never_holds_pages(engine):
    cfg, eng = engine
    reqs, prompts = _workload(cfg, seed=5, n=8)
    streams, planner, _ = _gw_serve(cfg, eng, reqs, prompts,
                                    shed_queue_depth=2)
    q = planner.queue
    assert q.shed > 0
    shed = [st for st in streams.values() if st.state == "shed"]
    assert len(shed) == q.shed
    assert all(st.tokens == [] for st in shed)
    assert q.completed + q.shed == len(reqs)
    planner = _reset(cfg, eng, [], shed_queue_depth=0)
    gw = AsyncGateway(planner)
    free0 = eng.free_pages
    req = Request(arrival=0.0, rid=50, model=cfg.name, slo=1e9,
                  n_tokens=2, prompt_len=4)

    async def live():
        task = asyncio.create_task(gw.run(hold_open=True))
        await asyncio.sleep(0)
        with pytest.raises(ShedRejection):
            gw.submit(req, _make_prompt(cfg, 50, 4))
        gw.close()
        await task

    asyncio.run(live())
    assert req.state == "shed"
    assert eng.free_pages == free0
    assert 50 not in gw.streams


def test_live_submit_cancel_and_drain(engine):
    cfg, eng = engine
    planner = _reset(cfg, eng, [])
    gw = AsyncGateway(planner)
    prompts = {i: _make_prompt(cfg, i, 5) for i in range(3)}

    async def live():
        task = asyncio.create_task(gw.run(hold_open=True))
        await asyncio.sleep(0)
        sts = [gw.submit(Request(arrival=gw.now, rid=i, model=cfg.name,
                                 slo=1e9, n_tokens=10, prompt_len=5),
                         prompts[i]) for i in range(3)]
        for _ in range(4):
            await asyncio.sleep(0)
        sts[1].cancel()
        gw.close()
        await task
        return sts

    sts = asyncio.run(live())
    assert sts[1].state == "cancelled"
    assert len(sts[1].tokens) < 10
    for st in (sts[0], sts[2]):
        assert st.state == "completed" and len(st.tokens) == 10
    assert planner.queue.cancelled == 1 and planner.queue.completed == 2
    assert eng.free_pages == eng.total_pages


# ---------------------------------------------------------------------------
# chaos through the gateway: seeded faults + disconnects, survivors exact
# ---------------------------------------------------------------------------
def _chaos_reqs(cfg):
    reqs, prompts = _workload(cfg, seed=31, n=10, budget_range=(4, 10))
    reqs = [Request(arrival=r.arrival, rid=r.rid, model=r.model,
                    slo=(8e-3 if r.rid in (4, 7) else 1e9),
                    n_tokens=r.n_tokens, prompt_len=r.prompt_len)
            for r in reqs]
    return reqs, prompts


def test_chaos_through_gateway_survivors_bit_exact(engine):
    cfg, eng = engine
    reqs, prompts = _chaos_reqs(cfg)
    base, _, _ = _gw_serve(cfg, eng, reqs, prompts)
    jit_before = eng.jit_cache_sizes()
    hold = {"cancelled": []}

    def chaos_script(server, now):
        for tick, rid in ((2, 3), (6, 8)):
            if server.ticks == tick and rid not in hold["cancelled"]:
                if hold["gw"].cancel(rid):
                    hold["cancelled"].append(rid)

    def run_chaos():
        inj = FaultInjector(**CHAOS)
        planner = _reset(cfg, eng, reqs, chunk_tokens=3, lazy=True,
                         deadline_aborts=True, shed_queue_depth=8)
        eng.attach_faults(inj, max_retries=1)
        gw = AsyncGateway(planner, faults=inj, on_tick=chaos_script,
                          stall_limit=50)
        hold["gw"] = gw
        try:
            streams = gw.serve_trace(reqs, prompts)
        finally:
            eng.attach_faults(None, max_retries=2)
        assert not gw.truncated
        return streams, planner, inj

    streams, planner, inj = run_chaos()
    q = planner.queue
    assert inj.total > 0 and hold["cancelled"]
    terminal = (q.completed + q.cancelled + q.deadline_aborted + q.shed
                + q.dropped)
    assert terminal == len(reqs)
    assert q.cancelled == len(hold["cancelled"])
    for rid, st in streams.items():
        assert st.state == st.req.state and st.state != "pending"
        if st.state == "completed":
            assert st.tokens == base[rid].tokens, f"survivor {rid} diverged"
    assert eng.free_pages == eng.total_pages
    assert eng.jit_cache_sizes() == jit_before
    counters = (q.completed, q.cancelled, q.deadline_aborted, q.shed,
                q.dropped)
    hold["cancelled"] = []
    streams2, planner2, inj2 = run_chaos()
    q2 = planner2.queue
    assert inj2.injected == inj.injected
    assert (q2.completed, q2.cancelled, q2.deadline_aborted, q2.shed,
            q2.dropped) == counters
    assert {r: tuple(s.tokens) for r, s in streams2.items()} \
        == {r: tuple(s.tokens) for r, s in streams.items()}


def test_gateway_lifecycle_edges_land_as_telemetry_instants(engine):
    cfg, eng = engine
    reqs, prompts = _workload(cfg, seed=3, n=3)
    tel = Telemetry(trace=TraceRecorder(capacity=4096))
    hold = {}

    def cancel_once(server, now):
        if server.ticks == 1 and not hold.get("done"):
            hold["done"] = hold["gw"].cancel(2)

    planner = _reset(cfg, eng, reqs)
    planner.telemetry = tel
    gw = AsyncGateway(planner, on_tick=cancel_once, stall_limit=50)
    hold["gw"] = gw
    gw.serve_trace(reqs, prompts)
    assert hold.get("done")
    names = [e["name"] for e in tel.trace.events]
    assert names.count("arrival") == len(reqs)
    assert "gw_disconnect" in names
    closes = [e for e in tel.trace.events if e["name"] == "gw_stream_close"]
    assert len(closes) == len(reqs)
    assert {e["args"]["cause"] for e in closes} == {"completed", "cancelled"}


# ---------------------------------------------------------------------------
# tiered, tenant-fair admission (unit: no engine)
# ---------------------------------------------------------------------------
def _mk(rid, arrival, tier, tenant="t"):
    return Request(arrival=arrival, rid=rid, model="m", slo=1e9,
                   n_tokens=4, prompt_len=4, tier=tier, tenant=tenant)


def _drain_picks(q, adm, now=0.0, cost=10.0):
    order = []
    while True:
        req = q.pop_pick(now, key=adm.key())
        if req is None:
            return order
        order.append(req.rid)
        adm.admitted(req, cost, list(q))


def test_lowest_tier_starvation_bound():
    adm = TieredAdmission(dict(traffic.TIER_WEIGHTS), bypass_limit=2)
    q = RequestQueue("m", slo=1e9)
    q.push(_mk(0, 0.0, "batch"))
    for i in range(1, 6):
        q.push(_mk(i, 0.1 * i, "interactive"))
    order = _drain_picks(q, adm)
    assert order[:3] == [1, 2, 0]
    assert order[3:] == [3, 4, 5]


def test_tier_weights_order_admissions():
    adm = TieredAdmission(dict(traffic.TIER_WEIGHTS), bypass_limit=100)
    q = RequestQueue("m", slo=1e9)
    q.push(_mk(0, 0.0, "batch"))
    q.push(_mk(1, 0.1, "standard"))
    q.push(_mk(2, 0.2, "interactive"))
    q.push(_mk(3, 0.3, "interactive"))
    q.push(_mk(4, 0.4, "standard"))
    assert _drain_picks(q, adm) == [2, 3, 1, 4, 0]


def test_tenant_deficit_round_robins_within_tier():
    adm = TieredAdmission(dict(traffic.TIER_WEIGHTS))
    q = RequestQueue("m", slo=1e9)
    for i in range(3):
        q.push(_mk(i, 0.01 * i, "standard", "acme"))
    for i in range(3, 5):
        q.push(_mk(i, 0.1 + 0.01 * i, "standard", "globex"))
    assert _drain_picks(q, adm) == [0, 3, 1, 4, 2]


def test_unknown_tier_maps_to_default_and_fifo_degenerates():
    adm = TieredAdmission({"interactive": 4.0, "standard": 2.0},
                          default_tier="standard")
    assert adm.weight(_mk(0, 0.0, "no-such-tier")) == 2.0
    adm2 = TieredAdmission({"standard": 1.0})
    q = RequestQueue("m", slo=1e9)
    for i in range(4):
        q.push(_mk(i, 0.1 * i, "standard"))
    assert _drain_picks(q, adm2) == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        TieredAdmission({})


def test_tiered_serve_end_to_end_with_tenant_metrics(engine):
    cfg, eng = engine
    rng = np.random.default_rng(41)
    reqs, prompts = [], {}
    tiers = ["interactive", "batch"] * 4
    for i, tier in enumerate(tiers):
        p = int(rng.integers(3, 8))
        reqs.append(Request(arrival=0.0, rid=i, model=cfg.name, slo=1e9,
                            n_tokens=4, prompt_len=p, tier=tier,
                            tenant=("acme", "globex")[i % 2]))
        prompts[i] = _make_prompt(cfg, i, p)
    streams, planner, _ = _gw_serve(cfg, eng, reqs, prompts,
                                    tiers=dict(traffic.TIER_WEIGHTS))
    assert all(st.state == "completed" for st in streams.values())
    m = planner.metrics
    assert set(m.tenant_tokens) == {"acme", "globex"}
    assert sum(m.tenant_tokens.values()) == 4 * len(reqs)
    assert 0.0 < m.tenant_fairness() <= 1.0
    first = {r.rid: r.first_token for r in reqs}
    worst_interactive = max(first[r.rid] for r in reqs
                            if r.tier == "interactive")
    best_batch = min(first[r.rid] for r in reqs if r.tier == "batch")
    assert worst_interactive <= best_batch
    assert eng.free_pages == eng.total_pages


# ---------------------------------------------------------------------------
# traffic scenarios: seeded determinism + shapes, equal to the JAX traces
# ---------------------------------------------------------------------------
def _sig(reqs):
    return [(round(r.arrival, 12), r.rid, r.tier, r.tenant, r.prompt_len,
             r.n_tokens, r.slo) for r in reqs]


def test_traffic_scenarios_deterministic_and_well_formed():
    cfg = traffic.TrafficConfig(model="m", duration=1.0, rate=80.0, seed=9)
    jcfg = jax_traffic.TrafficConfig(model="m", duration=1.0, rate=80.0,
                                     seed=9)
    assert sorted(traffic.SCENARIOS) == sorted(jax_traffic.SCENARIOS)
    for name in traffic.SCENARIOS:
        a = traffic.make_scenario(name, cfg)
        b = traffic.make_scenario(name, cfg)
        assert a and _sig(a) == _sig(b), f"{name} not seed-deterministic"
        assert _sig(a) == _sig(jax_traffic.make_scenario(name, jcfg)), name
        assert [r.rid for r in a] == list(range(len(a)))
        assert all(0.0 <= r.arrival < cfg.duration for r in a)
        assert all(r.tier in traffic.TIER_SLO_UNITS for r in a)
        assert all(r.slo == traffic.TIER_SLO_UNITS[r.tier] * cfg.slo_unit
                   for r in a)
        c = traffic.make_scenario(
            name, traffic.TrafficConfig(model="m", duration=1.0,
                                        rate=80.0, seed=10))
        assert _sig(a) != _sig(c), f"{name} ignores its seed"
    with pytest.raises(ValueError):
        traffic.make_scenario("nope", cfg)


def test_burst_trace_floods_one_tenant_one_tier():
    cfg = traffic.TrafficConfig(model="m", duration=1.0, rate=60.0, seed=4)
    reqs = traffic.burst_trace(cfg, burst_mult=6.0)
    start, end = 0.25, 0.5
    inside = [r for r in reqs if start <= r.arrival < end]
    outside = [r for r in reqs if not start <= r.arrival < end]
    assert len(inside) / 0.25 > 3 * len(outside) / 0.75
    flood = [r for r in inside if r.tenant == "globex" and r.tier == "batch"]
    assert len(flood) > len(inside) / 2
    by_tier = traffic.offered_by(reqs, "tier")
    assert by_tier["batch"] > by_tier["interactive"]


def test_synth_prompts_and_attainment_helpers():
    cfg = traffic.TrafficConfig(model="m", duration=0.5, rate=40.0, seed=1)
    reqs = traffic.poisson_trace(cfg)
    p1 = traffic.synth_prompts(reqs, vocab=128, seed=0)
    p2 = traffic.synth_prompts(reqs, vocab=128, seed=0)
    assert all(np.array_equal(p1[r]["tokens"], p2[r]["tokens"]) for r in p1)
    assert all(p1[r.rid]["tokens"].shape == (1, r.prompt_len) for r in reqs)
    jp = jax_traffic.synth_prompts(reqs, vocab=128, seed=0)
    assert all(np.array_equal(p1[r]["tokens"], jp[r]["tokens"]) for r in p1)
    for i, r in enumerate(reqs):
        if i % 3 == 0:
            r.state, r.finish = "completed", r.deadline - 1e-6
        elif i % 3 == 1:
            r.state, r.finish = "completed", r.deadline + 1.0
        else:
            r.state = "shed"
    att = traffic.attainment_by(reqs, "tier")
    offered = traffic.offered_by(reqs, "tier")
    assert set(att) <= set(offered)
    ontime = sum(1 for r in reqs
                 if r.state == "completed" and r.finish <= r.deadline)
    assert sum(att[k] * offered[k] for k in att) == pytest.approx(ontime)
    assert att == jax_traffic.attainment_by(reqs, "tier")


# ---------------------------------------------------------------------------
# against the JAX package: the burst trace's scorecards, the chaos run
# ---------------------------------------------------------------------------
def _burst(mod):
    """``bench_gateway``'s burst trace at its quick duration."""
    return mod.burst_trace(mod.TrafficConfig(
        model=MODEL, duration=0.2, rate=240.0, seed=12, slo_unit=1e-3,
        prompt_tokens=(4, 12), gen_tokens=(3, 8)), burst_mult=16.0)


def _scorecard(mod, reqs, planner, gw):
    q = planner.queue
    return {"attainment_by_tier": mod.attainment_by(reqs, "tier"),
            "attainment_by_tenant": mod.attainment_by(reqs, "tenant"),
            "offered_by_tier": mod.offered_by(reqs, "tier"),
            "tenant_jain": planner.metrics.tenant_fairness(),
            "completed": q.completed, "shed": q.shed, "dropped": q.dropped,
            "deadline_aborted": q.deadline_aborted, "late": q.late,
            "ticks": gw.server.ticks, "now": gw.now}


def test_burst_trace_scorecards_equal_jax(pair):
    """``bench_gateway``'s virtual passes on both packages: FIFO and tiered
    admission give the JAX gateway's streams and scorecards, and tiers
    lift interactive attainment strictly above FIFO's."""
    cfg, jeng, peng = pair
    cards = {}
    for policy, tiers in (("temporal", None),
                          ("dstack", dict(traffic.TIER_WEIGHTS))):
        for side, eng, mods in (
                ("jax", jeng, (jax_traffic, jax_plan, jax_request,
                               jax_gateway)),
                ("port", peng, (traffic, port_plan, port_request,
                                port_gateway))):
            tr, plan, request, gateway = mods
            reqs = _burst(tr)
            prompts = tr.synth_prompts(reqs, vocab=cfg.vocab_size, seed=0)
            eng.release_all_slots()
            eng.reset_stats()
            planner = plan.StepPlanner(
                eng, request.RequestQueue(cfg.name, slo=1e9),
                plan.PlannerConfig(gen_len=4, tiers=tiers))
            gw = gateway.AsyncGateway(planner, stall_limit=100)
            streams = gw.serve_trace(reqs, prompts)
            assert not gw.truncated
            assert eng.free_pages == eng.total_pages
            cards[policy, side] = (
                {r: tuple(st.tokens) for r, st in streams.items()},
                {r: st.state for r, st in streams.items()},
                _scorecard(tr, reqs, planner, gw))
        assert cards[policy, "port"] == cards[policy, "jax"], policy
    fifo = cards["temporal", "port"][2]
    tiered = cards["dstack", "port"][2]
    assert tiered["attainment_by_tier"]["interactive"] > \
        fifo["attainment_by_tier"]["interactive"]
    assert tiered["tenant_jain"] >= fifo["tenant_jain"] - 1e-9
    assert fifo["completed"] > 0 and fifo["offered_by_tier"]["batch"] > 0


def _chaos_serve(side, cfg, eng, reqs_spec, prompts, inj, cancelled):
    plan, request = ((jax_plan, jax_request) if side == "jax"
                     else (port_plan, port_request))
    wrap = jax.numpy.asarray if side == "jax" else (lambda a: a)
    eng.release_all_slots()
    eng.reset_stats()
    reqs = [request.Request(arrival=r.arrival, rid=r.rid, model=r.model,
                            slo=r.slo, n_tokens=r.n_tokens,
                            prompt_len=r.prompt_len) for r in reqs_spec]

    def chaos_script(server, now):
        for tick, rid in ((2, 3), (6, 8)):
            if server.ticks == tick and rid not in cancelled:
                if server.planner.cancel(rid):
                    cancelled.append(rid)

    planner = plan.StepPlanner(eng, request.RequestQueue(cfg.name, slo=1e9),
                               plan.PlannerConfig(
                                   chunk_tokens=3, lazy=True, gen_len=4,
                                   deadline_aborts=True,
                                   shed_queue_depth=8))
    eng.attach_faults(inj, max_retries=1)
    try:
        srv = plan.serve_ticks(planner, reqs,
                               lambda r: {"tokens": wrap(
                                   prompts[r.rid]["tokens"])},
                               faults=inj, on_tick=chaos_script,
                               stall_limit=50)
    finally:
        eng.attach_faults(None, max_retries=2)
    assert not srv.truncated
    return reqs, planner, srv


def test_chaos_acceptance(pair):
    """``tests/test_chaos.py``'s acceptance run on the port — dispatch
    faults, allocator failures, stuck ticks, client cancels, deadline
    aborts and shedding together drain with every offered request in one
    terminal state, survivors bit-exact with the fault-free run, no
    leaked page, no new executable, a seeded replay and a Prometheus
    exposition that conserves the offered load — and every outcome equal
    to the JAX engine's under the same schedule."""
    from repro_torch.serving.telemetry import (MetricsRegistry,
                                               export_engine_stats,
                                               export_fault_injector,
                                               export_queue,
                                               parse_prometheus)
    cfg, jeng, eng = pair
    reqs, prompts = _chaos_reqs(cfg)
    base, _, _ = _tick_serve(cfg, eng, reqs, prompts)
    jit_before = eng.jit_cache_sizes()
    out = {}
    for side, e, faults in (("port", eng, FaultInjector),
                            ("jax", jeng, jax_faults.FaultInjector),
                            ("port2", eng, FaultInjector)):
        cancelled = []
        inj = faults(**CHAOS)
        got, planner, srv = _chaos_serve(side[:4], cfg, e, reqs, prompts,
                                         inj, cancelled)
        assert e.free_pages == e.total_pages
        assert e.check_page_invariants()
        q = planner.queue
        out[side] = ({r.rid: r.state for r in got},
                     {r: tuple(t) for r, t in planner.streams.items()},
                     (q.completed, q.cancelled, q.deadline_aborted, q.shed,
                      q.dropped), dict(inj.injected), tuple(cancelled),
                     srv.stuck_ticks)
        if side == "port":
            port_run = (inj, planner, srv)
    assert out["port"] == out["jax"] == out["port2"]
    inj, planner, srv = port_run
    states, streams, counters, _, cancelled, _ = out["port"]
    q = planner.queue
    assert inj.total > 0 and cancelled
    assert sum(counters) == len(reqs)
    assert q.cancelled == len(cancelled)
    m = planner.metrics
    assert (m.cancelled, m.deadline_aborted, m.shed) \
        == (q.cancelled, q.deadline_aborted, q.shed)
    assert m.engine_retries + m.engine_resets + srv.stuck_ticks > 0
    for rid, state in states.items():
        if state == "completed":
            assert streams[rid] == base[rid], f"survivor rid={rid} diverged"
    assert eng.jit_cache_sizes() == jit_before
    reg = MetricsRegistry()
    export_queue(reg, q)
    export_fault_injector(reg, inj)
    parsed = parse_prometheus(reg.render())
    assert sum(v for (name, _), v in parsed.items()
               if name == "dstack_requests_total") == len(reqs)
    for site, n in inj.injected.items():
        assert parsed[("dstack_faults_injected_total",
                       (("site", site),))] == n
    reg = MetricsRegistry()
    export_engine_stats(reg, eng.stats, cfg.name)
    parsed = parse_prometheus(reg.render())
    assert sum(v for (name, _), v in parsed.items()
               if name == "dstack_engine_resets_total") \
        == eng.stats.engine_resets


# ---------------------------------------------------------------------------
# the pool plane: cancel, engine reset, shed watermark
# ---------------------------------------------------------------------------
def test_pool_plane_cancel_and_engine_reset():
    from repro_torch.core.simulator import RunRequest
    from repro_torch.serving.controller import run_policy
    from repro_torch.serving.pool import build_pool

    pool = build_pool([MODEL], base_slots=4, cache_len=32,
                      allocations={MODEL: [100]}, device="cpu")
    name = sorted(pool.hosts)[0]
    pool.reset()
    q = pool.queues[name]
    for i in range(3):
        pool.push(Request(arrival=0.0, rid=i, model=name, slo=1e9,
                          n_tokens=8))
    assert pool.cancel(name, 2)
    run = pool.admit(RunRequest(name, chips=100, batch=4), 0.0, 4)
    assert run is not None and run.batch == 2
    eng = run.engine
    pages_before = eng.free_pages
    assert pool.cancel(name, 0)
    assert eng.free_pages > pages_before
    assert not pool.cancel(name, 0)
    while not pool.step_run(run, 0.0):
        pass
    assert q.cancelled == 2 and q.completed == 1
    eng.check_page_invariants()

    inj = FaultInjector(seed=2, dispatch_rate=0.2, max_faults=6)
    for alloc in pool.hosts[name].allocations.values():
        alloc.engine.attach_faults(inj, max_retries=0)
    try:
        res = run_policy(pool, "temporal", rate=800.0, duration=0.05,
                         drain=True)
    finally:
        for alloc in pool.hosts[name].allocations.values():
            alloc.engine.attach_faults(None)
    m = res.per_model[name]
    assert m.engine_resets > 0 and m.requeues > 0
    assert m.completed > 0
    for alloc in pool.hosts[name].allocations.values():
        assert alloc.engine.free_pages == alloc.engine.total_pages
        alloc.engine.check_page_invariants()


def test_pool_shed_watermark():
    from repro_torch.serving.pool import build_pool

    pool = build_pool([MODEL], base_slots=2, cache_len=32,
                      allocations={MODEL: [100]}, device="cpu", warm=False,
                      planner_config=PlannerConfig(shed_queue_depth=2))
    name = sorted(pool.hosts)[0]
    pool.reset()
    for i in range(5):
        pool.push(Request(arrival=0.0, rid=i, model=name, slo=1e9))
    q = pool.queues[name]
    assert len(q) == 2 and q.shed == 3
    res = pool.snapshot("none", 1.0, 1.0, 0)
    assert res.per_model[name].shed == 3


def _shared_workload(cfg, seed: int, n: int, template_lens=(20, 8)):
    rng = np.random.default_rng(seed)
    temps = [rng.integers(1, cfg.vocab_size, size=s).astype(np.int32)
             for s in template_lens]
    reqs, prompts = [], {}
    for i in range(n):
        t = temps[int(rng.integers(0, len(temps)))]
        tail = rng.integers(1, cfg.vocab_size,
                            size=int(rng.integers(2, 6))).astype(np.int32)
        toks = np.concatenate([t, tail])
        reqs.append(Request(arrival=0.0, rid=i, model=cfg.name, slo=1e9,
                            n_tokens=int(rng.integers(3, 7)),
                            prompt_len=len(toks)))
        prompts[i] = {"tokens": toks[None, :]}
    return reqs, prompts


def test_chaos_with_prefix_cache(engine):
    """The seeded chaos schedule over a shared-prefix stream with the
    cache on (an engine of its own on the module's weights): zero leaked
    pages, survivors bit-exact with the fault-free cache-on and cache-off
    runs, a seeded replay, and no new executable once the chaos shapes
    are warm."""
    cfg, base_eng = engine
    eng = InferenceEngine(base_eng.api, base_eng.params,
                          cache_len=CACHE_LEN).init_slots(
        N_SLOTS, paged=True, page_size=PAGE)
    eng.enable_prefix_cache()
    eng.warm_prefix_ops()
    reqs, prompts = _shared_workload(cfg, seed=23, n=10)

    def serve(**kw):
        planner = _reset(cfg, eng, reqs, lazy=True, **kw)
        srv = serve_ticks(planner, reqs, lambda r: prompts[r.rid],
                          stall_limit=50)
        assert not srv.truncated
        held = eng.prefix_cache.held_pages
        assert eng.free_pages + held == eng.total_pages, "leaked pages"
        assert eng.check_page_invariants()
        eng.prefix_cache.check_invariants()
        return {r: tuple(t) for r, t in planner.streams.items()}, planner

    def serve_faults(**kw):
        inj = FaultInjector(seed=29, dispatch_rate=0.08, alloc_rate=0.05,
                            stuck_rate=0.04, max_faults=10)
        eng.attach_faults(inj, max_retries=1)
        try:
            planner = _reset(cfg, eng, reqs, lazy=True, chunk_tokens=3,
                             prefix_cache=True)
            srv = serve_ticks(planner, reqs, lambda r: prompts[r.rid],
                              faults=inj, stall_limit=50)
        finally:
            eng.attach_faults(None, max_retries=2)
        assert not srv.truncated
        assert eng.free_pages + eng.prefix_cache.held_pages \
            == eng.total_pages
        eng.check_page_invariants()
        return {r: tuple(t) for r, t in planner.streams.items()}, \
            planner, inj

    base_off, _ = serve()
    base_on, _ = serve(prefix_cache=True)
    assert base_on == base_off
    assert eng.stats.prefix_hits > 0 and eng.stats.cow_copies > 0
    serve(chunk_tokens=3, prefix_cache=True)
    serve_faults()
    jit_before = eng.jit_cache_sizes()
    got, planner, inj = serve_faults()
    assert inj.total > 0, "fault schedule never fired"
    q = planner.queue
    assert q.completed + q.dropped == len(reqs)
    for r in reqs:
        if r.state == "completed":
            assert got[r.rid] == base_on[r.rid], f"rid={r.rid} diverged"
    eng.prefix_cache.flush()
    assert eng.free_pages == eng.total_pages
    eng.check_page_invariants()
    assert eng.jit_cache_sizes() == jit_before
    got2, _, inj2 = serve_faults()
    assert got2 == got
    assert inj2.injected == inj.injected
