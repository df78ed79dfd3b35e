"""The port's serving control plane (``repro_torch.serving.pool`` and
``controller``) on the CPU.

One module-scoped pair of warmed pools: the JAX package's, as
``tests/test_pool.py`` builds it (the reduced quick trio, two slots of 32
tokens), and the port's with the same weights (carried across), planning
on a ``Hardware`` with the v5e's field values — the profiles the JAX
tests' invariants are stated for.

* The port's pool runs ``tests/test_pool.py``'s cases, case for case:
  each policy family over a seeded arrival trace, with the §6 invariants
  — no oversubscription, no starved model, monotone served counts, no new
  executable while serving — plus admission, starvation and metric
  cases.
* Against the JAX pool, under ``temporal``, ``fixed_batch_mps``,
  ``maxmin`` and ``dstack`` with the same generators: the same sequence
  of admissions (model, requested and granted units, batch, request ids),
  equal per-model served, violated and dropped counts, and unchanged
  ``jit_cache_sizes()``.
* On the port's default hardware, the H100 (units are GPU percent): every
  standby and every grant is a level, 100% is always standing by, and the
  four quick policies serve every model without a new executable. There
  every knee is 90% or 100% (a 16 x 128-token prefill fills all 132
  SMs), so no two of the trio's runs fit beside each other at their
  knees: max-min runs one model at a time and, at the JAX tests' 1500
  requests/s per model, starves all but the first.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.hardware import V5E  # noqa: E402
from repro.core.latency_model import CHIP_LEVELS  # noqa: E402
from repro.serving.controller import run_policy as jax_run_policy  # noqa
from repro.serving.pool import build_pool as jax_build_pool  # noqa: E402
from repro_torch.core.hardware import H100, Hardware  # noqa: E402
from repro_torch.core.profiles import build_profile  # noqa: E402
from repro_torch.core.scheduler import (POLICIES, SchedView,  # noqa: E402
                                        chips_for_frac)
from repro_torch.core.simulator import RunRequest  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402
from repro_torch.serving.controller import (Controller,  # noqa: E402
                                            ControllerConfig,
                                            make_generators, run_policy)
from repro_torch.serving.metrics import jain_index, percentile  # noqa
from repro_torch.serving.pool import (EnginePool, build_host,  # noqa: E402
                                      build_pool)
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.telemetry import Telemetry  # noqa: E402

MODELS = ["qwen2-0.5b", "olmo-1b", "mamba2-1.3b"]
RATE = 1500.0
DURATION = 0.03
GEN_LEN = 3
QUICK = ["temporal", "fixed_batch_mps", "maxmin", "dstack"]
H100_RATE = 150.0
V5E_FIELDS = Hardware(**dataclasses.asdict(V5E), levels=CHIP_LEVELS,
                      tp_cap=32, tp_shard_width=512, hop_latency=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced engines' ops are tiny: one intra-op thread serves them
    as fast, and keeps this module from oversubscribing the cores that
    parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pool_pair(models):
    """(JAX pool, port pool) of ``models``: the JAX pool as
    ``tests/test_pool.py`` builds it; the port's hosts carry its weights
    and plan on a ``Hardware`` with the v5e's field values."""
    jpool = jax_build_pool(models, request_rate=RATE, base_slots=2,
                           cache_len=32)
    hosts = {}
    for i, name in enumerate(models):
        jhost = jpool.hosts[name]
        params = params_from_numpy(
            jhost.cfg, jax.tree.map(np.asarray, jhost.params), "cpu")
        profile = build_profile(name, request_rate=RATE, hw=V5E_FIELDS)
        hosts[name] = build_host(name, profile=profile, base_slots=2,
                                 cache_len=32, seed=i, device="cpu",
                                 params=params)
        assert sorted(hosts[name].allocations) == sorted(jhost.allocations)
    ppool = EnginePool(hosts)
    ppool.warmup()
    return jpool, ppool


@pytest.fixture(scope="module")
def pools():
    return _pool_pair(MODELS)


@pytest.fixture(scope="module")
def pool(pools):
    return pools[1]


def _serve(pool, policy_name, *, rate=RATE, duration=DURATION, seed0=0):
    pool.reset()
    policy = POLICIES[policy_name](pool.profiles)
    gens = make_generators(pool, rate, seed0=seed0)
    ctl = Controller(pool, policy, gens,
                     ControllerConfig(duration=duration, gen_len=GEN_LEN))
    return ctl, ctl.run()


# ------------------------------------------------------- policy conformance
@pytest.mark.parametrize("policy", ["temporal", "gslice", "maxmin", "dstack"])
def test_policy_conformance_on_real_engines(pool, policy):
    ctl, res = _serve(pool, policy)
    assert not ctl.oversubscribed, f"{policy} oversubscribed the GPU"
    assert ctl.max_alloc <= 1.0 + 1e-6
    for n, m in res.per_model.items():
        assert m.completed > 0, f"{n} starved under {policy}"
        assert m.runs > 0
    counts = [c for _, c in ctl.served_timeline]
    assert counts == sorted(counts)
    assert counts and counts[-1] == res.total_completed
    assert res.total_completed == sum(
        q.completed for q in pool.queues.values())
    assert 0.0 <= res.occupancy <= 1.0 + 1e-6
    assert res.steps > 0 and res.wall_s > 0
    assert not res.truncated


def test_fixed_batch_mps_may_oversubscribe_but_serves(pool):
    ctl, res = _serve(pool, "fixed_batch_mps")
    assert not ctl.oversubscribed
    assert all(m.completed > 0 for m in res.per_model.values())


def test_pool_run_is_deterministic(pool):
    _, r1 = _serve(pool, "dstack")
    _, r2 = _serve(pool, "dstack")
    assert {n: m.completed for n, m in r1.per_model.items()} \
        == {n: m.completed for n, m in r2.per_model.items()}
    assert r1.total_violated == r2.total_violated
    assert r1.duration == r2.duration


def test_no_recompilation_while_serving(pool):
    """Standby allocations are warmed once, up front; serving any policy
    afterwards must not add an executable."""
    _serve(pool, "temporal")
    before = pool.jit_cache_sizes()
    assert sum(before.values()) > 0
    for policy in ("maxmin", "dstack"):
        _serve(pool, policy)
    assert pool.jit_cache_sizes() == before


def test_spatial_policies_beat_temporal_on_pool(pool):
    """The paper's core claim, end to end on real engines: spatial packing
    (D-STACK) outperforms pure temporal sharing on the same workload."""
    _, r_t = _serve(pool, "temporal")
    _, r_d = _serve(pool, "dstack")
    assert r_d.throughput() > r_t.throughput()
    assert r_d.total_violated <= r_t.total_violated


def test_drain_mode_backstop_terminates(pool):
    pool.reset()

    class Stubborn:
        name = "stubborn"

        def plan(self, now, view):
            return [RunRequest("no-such-model", chips=8, batch=1)]

        def next_wakeup(self, now):
            return now + 0.01

    pool.push(Request(arrival=0.0, rid=0, model=sorted(pool.hosts)[0],
                      slo=1.0))
    ctl = Controller(pool, Stubborn(), [],
                     ControllerConfig(drain=True, duration=0.0,
                                      arrival_horizon=0.01, max_time=0.25))
    res = ctl.run()
    assert res.total_completed == 0
    assert res.steps == 0
    assert res.truncated
    pool.reset()


# ---------------------------------------------------- admission starvation
def test_pop_admissible_bypass_is_bounded_by_slo_expiry():
    pool = build_pool(["olmo-1b"], base_slots=4, cache_len=32,
                      pages={"olmo-1b": 5}, device="cpu")
    pool.reset()
    name = sorted(pool.hosts)[0]
    pool.push(Request(arrival=0.0, rid=0, model=name, slo=10.0, n_tokens=8))
    pool.push(Request(arrival=1e-5, rid=1, model=name, slo=0.4, n_tokens=24))
    pool.push(Request(arrival=2e-5, rid=2, model=name, slo=10.0, n_tokens=8))
    run = pool.admit(RunRequest(name, chips=4096, batch=3), 0.0, GEN_LEN)
    assert run is not None and run.batch == 2
    assert len(pool.queues[name]) == 1
    assert pool._metrics[name].blocked_on_memory == 1
    while not pool.step_run(run, 0.1):
        pass
    run2 = pool.admit(RunRequest(name, chips=4096, batch=1), 0.2, GEN_LEN)
    assert run2 is not None
    assert [r.rid for r in run2.slots.values()] == [1]
    while not pool.step_run(run2, 0.3):
        pass
    pool.push(Request(arrival=0.3, rid=4, model=name, slo=0.05, n_tokens=24))
    pool.push(Request(arrival=0.31, rid=5, model=name, slo=10.0, n_tokens=8))
    q = pool.queues[name]
    run3 = pool.admit(RunRequest(name, chips=4096, batch=1), 1.0, GEN_LEN)
    assert run3 is not None
    assert [r.rid for r in run3.slots.values()] == [5]
    assert q.dropped == 1 and q.violated == 1
    while not pool.step_run(run3, 1.1):
        pass
    pool.reset()


def test_head_reservation_ages_for_page_blocked_fifo_head():
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import make_engine
    from repro_torch.serving.plan import (PlannerConfig, StepPlanner,
                                          serve_ticks)
    from repro_torch.serving.request import RequestQueue

    cfg = get_config("olmo-1b").reduced()
    name = cfg.name

    def serve(head_reservation: bool):
        eng = make_engine(cfg, cache_len=32, device="cpu").init_slots(
            4, paged=True, page_size=8, total_pages=5)
        q = RequestQueue(name, slo=1e9)
        completion_order = []

        class Rec(StepPlanner):
            def observe(self, res, now):
                for req in super().observe(res, now):
                    completion_order.append(req.rid)
                return []

        planner = Rec(eng, q, PlannerConfig(
            gen_len=4, head_reservation=head_reservation))
        reqs = [Request(arrival=0.0, rid=0, model=name, slo=1e9,
                        n_tokens=8, prompt_len=2),
                Request(arrival=1e-5, rid=1, model=name, slo=1e9,
                        n_tokens=30, prompt_len=2)]
        reqs += [Request(arrival=2e-5 + i * 1e-5, rid=2 + i, model=name,
                         slo=1e9, n_tokens=8, prompt_len=2)
                 for i in range(6)]
        prompts = {r.rid: {"tokens": torch.ones((1, 2), dtype=torch.int32)}
                   for r in reqs}
        srv = serve_ticks(planner, reqs, lambda r: prompts[r.rid])
        assert not srv.truncated
        assert sorted(completion_order) == [r.rid for r in reqs]
        return completion_order.index(1)

    with_resv = serve(True)
    without = serve(False)
    assert without == len(range(8)) - 1
    assert with_resv < without


# --------------------------------------------------------- SchedView adapter
def test_pool_implements_schedview(pool):
    assert isinstance(pool, SchedView)
    from repro_torch.core.simulator import Simulator
    profiles = {"qwen2-0.5b": build_profile("qwen2-0.5b")}
    sim = Simulator(profiles, POLICIES["temporal"](profiles), [])
    assert isinstance(sim, SchedView)
    assert sim.sim.total_chips == H100.chips_per_pod
    assert pool.sim.total_chips == V5E_FIELDS.chips_per_pod


def test_admit_selects_standby_allocation(pool):
    pool.reset()
    name = sorted(pool.hosts)[0]
    host = pool.hosts[name]
    chips_opts = sorted(host.allocations)
    pool.push(Request(arrival=0.0, rid=0, model=name, slo=1.0))
    run = pool.admit(RunRequest(name, chips=4096, batch=1), 0.0, GEN_LEN)
    assert run is not None and run.chips == chips_opts[-1]
    assert run.engine.alloc_chips == run.chips
    pool.push(Request(arrival=0.0, rid=1, model=name, slo=1.0))
    assert pool.admit(RunRequest(name, chips=4096, batch=1), 0.0,
                      GEN_LEN) is None
    while not pool.step_run(run, 0.0):
        pass
    # ask below the smallest -> falls back to the smallest standby engine,
    # and the quantization upgrade is counted (not silent)
    pool.push(Request(arrival=0.0, rid=2, model=name, slo=1.0))
    run = pool.admit(RunRequest(name, chips=1, batch=1), 0.0, GEN_LEN)
    assert run is not None and run.chips == chips_opts[0]
    assert pool._metrics[name].alloc_upgrades == 1
    while not pool.step_run(run, 0.0):
        pass
    pool.reset()


def test_admit_caps_batch_to_free_slots(pool):
    pool.reset()
    name = sorted(pool.hosts)[0]
    n_slots = max(a.n_slots for a in pool.hosts[name].allocations.values())
    for i in range(n_slots + 3):
        pool.push(Request(arrival=0.0, rid=i, model=name, slo=1.0))
    run = pool.admit(RunRequest(name, chips=4096, batch=n_slots + 3), 0.0,
                     GEN_LEN)
    assert run is not None and run.batch == n_slots
    assert len(pool.queues[name]) == 3
    while not pool.step_run(run, 0.0):
        pass
    pool.reset()


# ------------------------------------------------------------ fairness metric
def test_jain_index():
    assert jain_index([1.0, 1.0, 1.0, 1.0]) == pytest.approx(1.0)
    assert jain_index([5.0, 5.0]) == pytest.approx(1.0)
    assert jain_index([1.0, 0.0, 0.0, 0.0]) == pytest.approx(0.25)
    assert jain_index([3.0, 1.0]) < jain_index([2.0, 1.0]) < 1.0
    assert jain_index([]) == 1.0
    assert jain_index([0.0, 0.0]) == 1.0


def test_percentile_nearest_rank():
    xs = [1.0, 2.0, 3.0, 4.0]
    assert percentile(xs, 0.5) == 2.0
    assert percentile(xs, 0.99) == 4.0
    assert percentile(xs, 0.0) == 1.0
    assert math.isnan(percentile([], 0.5))


# ----------------------------------------------------------- chips_for_frac
def test_chips_for_frac_parametrized_by_pod_size():
    def pod(total):
        return dataclasses.replace(
            V5E_FIELDS, chips_per_pod=total,
            levels=tuple(c for c in CHIP_LEVELS if c <= total))

    assert chips_for_frac(0.5, pod(256)) == 128
    assert chips_for_frac(0.5, pod(64)) == 32
    assert chips_for_frac(0.3, pod(16)) == 4
    assert chips_for_frac(1.0, pod(8)) == 8
    assert chips_for_frac(0.001, pod(256)) == 0
    # the H100: the largest multiple of 10% below the fraction
    assert chips_for_frac(0.5, H100) == 50
    assert chips_for_frac(0.39, H100) == 30
    assert chips_for_frac(0.09, H100) == 0


# -------------------------------------------------- the port's own surface
def test_unported_pool_features_raise():
    """Every pool feature is ported: on a pool of its own (the module's
    pools stay as built) the prefix cache attaches to every capable
    standby and skips the SSM family, cross-model speculation pairs a
    draft with every olmo-1b standby, and ``attach_telemetry`` arms every
    standby engine, every draft and every planner — and disarms them."""
    pool = build_pool(["olmo-1b", "mamba2-1.3b"], request_rate=RATE,
                      base_slots=2, cache_len=32, device="cpu", warm=False,
                      prefix_cache=True)
    for name, host in pool.hosts.items():
        for eng in host.engines():
            assert (eng.prefix_cache is not None) == (name == "olmo-1b")
    assert pool.enable_speculation("olmo-1b", "olmo-1b", spec_k=2) == len(
        pool.hosts["olmo-1b"].allocations)
    assert pool.enable_speculation("mamba2-1.3b", "olmo-1b") == 0
    tel = Telemetry()
    pool.attach_telemetry(tel)
    engines = [e for h in pool.hosts.values() for e in h.engines()]
    drafts = [e._draft for e in engines if e._draft is not None]
    assert len(drafts) == len(pool.hosts["olmo-1b"].allocations)
    assert all(e.telemetry is tel for e in engines + drafts)
    pool.reset()
    assert pool.telemetry is tel
    assert all(p.telemetry is tel for p in pool._planners.values())
    pool.attach_telemetry(None)
    assert all(e.telemetry is None for e in engines + drafts)
    assert all(p.telemetry is None for p in pool._planners.values())


@pytest.fixture(scope="module")
def h100_pool():
    """The quick trio on the port's defaults (H100 profiles) at a load
    every model's standbys can carry."""
    return build_pool(MODELS, request_rate=H100_RATE, base_slots=2,
                      cache_len=32, device="cpu")


@pytest.mark.parametrize("policy", QUICK)
def test_h100_pool_grants_levels_and_serves_every_model(h100_pool,
                                                        policy):
    pool = h100_pool
    for host in pool.hosts.values():
        allocs = sorted(host.allocations)
        assert set(allocs) <= set(H100.levels) and allocs[-1] == 100
        assert host.profile.knee_chips >= 90
    before = pool.jit_cache_sizes()
    log = _recorded(pool)
    try:
        pool.reset()
        ctl = Controller(pool, POLICIES[policy](pool.profiles),
                         make_generators(pool, H100_RATE),
                         ControllerConfig(duration=0.3, gen_len=GEN_LEN))
        res = ctl.run()
    finally:
        del pool.admit
    assert log and {granted for _, _, granted, _, _ in log} <= \
        set(H100.levels)
    assert not ctl.oversubscribed
    if policy != "fixed_batch_mps":
        assert ctl.max_alloc <= 1.0 + 1e-6
    for n, m in res.per_model.items():
        assert m.completed > 0, f"{n} starved under {policy}"
    assert pool.jit_cache_sizes() == before


def test_h100_maxmin_runs_one_model_at_a_time(h100_pool):
    """Every knee is 90% or more, so max-min never places two runs
    together; at 1500 requests/s per model the first model's queue never
    empties and the others starve."""
    pool = h100_pool
    pool.reset()
    conc = []
    plan = pool.admit

    def spy(rr, now, gen_len, drop_expired=True):
        run = plan(rr, now, gen_len, drop_expired)
        conc.append(len(pool.running))
        return run

    pool.admit = spy
    try:
        ctl = Controller(pool, POLICIES["maxmin"](pool.profiles),
                         make_generators(pool, RATE),
                         ControllerConfig(duration=DURATION,
                                          gen_len=GEN_LEN))
        res = ctl.run()
    finally:
        del pool.admit
    assert max(conc) == 1
    served = [n for n, m in res.per_model.items() if m.completed]
    assert served == [MODELS[0]]


def test_h100_ask_below_the_smallest_level(h100_pool):
    pool = h100_pool
    pool.reset()
    name = MODELS[1]
    pool.push(Request(arrival=0.0, rid=0, model=name, slo=1.0))
    run = pool.admit(RunRequest(name, chips=1, batch=1), 0.0, GEN_LEN)
    assert run is not None
    assert run.chips == min(pool.hosts[name].allocations)
    assert run.frac == run.chips / 100
    assert pool._metrics[name].alloc_upgrades == 1
    while not pool.step_run(run, 0.0):
        pass
    pool.reset()


def test_pool_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_pool(["olmo-1b"], base_slots=1, warm=False)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run_real(["olmo-1b"], 0.01, "dstack", 100.0)


# ------------------------------------------------- against the JAX package
def _recorded(pool):
    """Every admission ``pool`` makes: (model, requested units, granted
    units, batch, request ids)."""
    log = []
    admit = pool.admit

    def spy(rr, now, gen_len, drop_expired=True):
        run = admit(rr, now, gen_len, drop_expired)
        if run is not None:
            log.append((rr.model, rr.chips, run.chips, run.batch,
                        sorted(r.rid for r in run.slots.values())))
        return run

    pool.admit = spy
    return log


def _assert_admissions_equal(pools, policy):
    jpool, ppool = pools
    logs = [_recorded(p) for p in pools]
    caches = [p.jit_cache_sizes() for p in pools]
    try:
        ja = jax_run_policy(jpool, policy, rate=RATE, duration=DURATION,
                            gen_len=GEN_LEN)
        pb = run_policy(ppool, policy, rate=RATE, duration=DURATION,
                        gen_len=GEN_LEN)
    finally:
        for p in pools:
            del p.admit
    assert logs[0] and logs[1] == logs[0]
    for n, m in ja.per_model.items():
        got = pb.per_model[n]
        assert (got.completed, got.violated, got.dropped) == \
            (m.completed, m.violated, m.dropped), n
        assert got.completed > 0
    assert (pb.duration, pb.steps) == (ja.duration, ja.steps)
    assert [p.jit_cache_sizes() for p in pools] == caches


@pytest.mark.parametrize("policy", QUICK)
def test_pool_admissions_equal_jax(pools, policy):
    _assert_admissions_equal(pools, policy)


def test_hybrid_pool_admissions_equal_jax():
    """The quick trio plus zamba2-7b reduced under ``dstack``: the same
    admissions and per-model counts as the JAX pool, every model served,
    and no new executable; zamba2's engines recompute their
    continuations."""
    pair = _pool_pair(MODELS + ["zamba2-7b"])
    host = pair[1].hosts["zamba2-7b"]
    assert not any(e.chunk_capable() for e in host.engines())
    _assert_admissions_equal(pair, "dstack")


def test_moe_pool_admissions_equal_jax():
    """The quick trio plus granite-moe reduced under ``dstack``: the same
    admissions and per-model counts as the JAX pool, every model served,
    and no new executable."""
    pair = _pool_pair(MODELS + ["granite-moe-3b-a800m"])
    host = pair[1].hosts["granite-moe-3b-a800m"]
    assert not any(e.chunk_capable() for e in host.engines())
    _assert_admissions_equal(pair, "dstack")
