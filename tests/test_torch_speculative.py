"""The port's speculative decoding (``InferenceEngine.attach_draft``, the
draft scan, the verify chunk and the commit, the planner's spec phase and
the pool's ``enable_speculation``) against the JAX package's, on the CPU.

* Every test of ``tests/test_speculative.py``, case for case, on the
  port, at the reference's sizes (reduced olmo-1b target, 4 paged slots
  of 32 tokens, pages of 8, a ring-slot draft, spec_k 3): an
  identical-weights draft gives the plain streams with acceptance 1.0; a
  divergent draft rolls back to the same streams; pages are conserved and
  the free list canonical after rejection-heavy serves; a tight lazy pool
  degrades k instead of preempting; the knee and acceptance gates; no new
  executable between warm serves; the refusals (incapable families, a
  paged or short draft, mismatched vocabularies); the counters in
  ``EngineStats`` and the pool's result; and the pool plane's
  cross-model pairing.
* Against the JAX package, on the same weights: the reference's
  speculative workload with the identical and with the divergent draft
  gives the JAX engine's greedy streams, ``EngineStats`` (draft and
  accepted tokens, rounds and rollbacks included), dispatches, page
  placement after ``release_all_slots`` and ``jit_cache_sizes()`` counts
  (``chunk_prefill``, ``draft_scan`` and ``spec_commit`` included).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa
from repro.serving import plan as jax_plan  # noqa: E402
from repro.serving import request as jax_request  # noqa: E402
from repro.serving.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.serving.engine import make_engine as jax_make_engine  # noqa
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import (InferenceEngine,  # noqa: E402
                                        _packed_bucket, _pow2_at_least,
                                        make_engine)
from repro_torch.serving import plan as port_plan  # noqa: E402
from repro_torch.serving import request as port_request  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

CACHE_LEN = 32
N_SLOTS = 4
PAGE = 8
TARGET = "olmo-1b"
DRAFT = "qwen2-0.5b"

INCAPABLE = {
    "ssm": "mamba2-1.3b",         # no KV pages to verify against
    "hybrid": "zamba2-7b",        # per-row conv/ssm state beyond pages+pos
    "encdec": "whisper-small",    # per-row cross-attention K/V
    "moe": "phi3.5-moe-42b-a6.6b",  # capacity dropping is batch-shape dep.
}
# the executables both packages count, by the JAX engine's names
SHARED_KINDS = ("packed_prefill", "chunk_prefill", "slot_step",
                "draft_scan", "spec_commit")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced engines' ops are tiny: one intra-op thread serves them
    as fast, and keeps this module from oversubscribing the cores that
    parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_prompt(cfg, rid: int, length: int):
    rng = np.random.default_rng(1000 + rid)
    return rng.integers(1, cfg.vocab_size, size=(1, length)).astype(np.int32)


def _workload(cfg, seed: int, n: int, prompt_range=(3, 20),
              budget_range=(2, 10)):
    """The reference's speculative workload (host prompt arrays)."""
    rng = np.random.default_rng(seed)
    reqs, prompts = [], {}
    for i in range(n):
        p = int(rng.integers(*prompt_range))
        nt = int(rng.integers(*budget_range))
        reqs.append(Request(arrival=0.0, rid=i, model=cfg.name, slo=1e9,
                            n_tokens=nt, prompt_len=p))
        prompts[i] = _make_prompt(cfg, i, p)
    return reqs, prompts


def _serve(cfg, eng, reqs, prompts, side="port", **planner_kw):
    """Serve to drain on one package's engine (the reference test's
    ``_serve``). Returns (streams, planner, server)."""
    eng.release_all_slots()
    eng.reset_stats()
    if eng._draft is not None:
        eng._draft.reset_stats()
    plan, request = ((jax_plan, jax_request) if side == "jax"
                     else (port_plan, port_request))
    wrap = jnp.asarray if side == "jax" else (lambda a: a)
    reqs = [request.Request(**{f.name: getattr(r, f.name)
                               for f in dataclasses.fields(r) if f.init})
            for r in reqs]
    planner = plan.StepPlanner(eng, request.RequestQueue(cfg.name, slo=1e9),
                               plan.PlannerConfig(gen_len=4, **planner_kw))
    srv = plan.serve_ticks(planner, reqs,
                           lambda r: {"tokens": wrap(prompts[r.rid])})
    assert not srv.truncated
    return {r: tuple(t) for r, t in planner.streams.items()}, planner, srv


def _jax_weights(seed):
    """The JAX package's reduced olmo-1b weights of ``seed``: (JAX
    params, port params)."""
    cfg = jax_config(TARGET).reduced()
    jparams = jax_build_model(cfg).init(jax.random.PRNGKey(seed))
    pparams = params_from_numpy(get_config(TARGET).reduced(),
                                jax.tree.map(np.asarray, jparams), "cpu")
    return jparams, pparams


def _port_pair(draft_seed=None, total_pages=None):
    """A port target on the JAX package's seed-0 weights with a ring
    draft of the same weights (``draft_seed`` None) or of another seed."""
    cfg = get_config(TARGET).reduced()
    api = build_model(cfg, device="cpu")
    _, params = _jax_weights(0)
    eng = InferenceEngine(api, params, cache_len=CACHE_LEN).init_slots(
        N_SLOTS, paged=True, page_size=PAGE, total_pages=total_pages)
    dparams = eng.params if draft_seed is None else _jax_weights(
        draft_seed)[1]
    draft = InferenceEngine(api, dparams, cache_len=CACHE_LEN).init_slots(
        N_SLOTS, paged=False)
    eng.attach_draft(draft, spec_k=3)
    return cfg, eng


@pytest.fixture(scope="module")
def target():
    """One warm (target, identical-weights draft) pair for the module."""
    return _port_pair()


@pytest.fixture(scope="module")
def divergent_target():
    """Target paired with a same-shape draft whose weights diverge (the
    reference's other init seed): drafts are often wrong, so every serve
    exercises rejection and rollback."""
    return _port_pair(draft_seed=99)


# ---------------------------------------------------------------------------
# draft/verify equivalence: speculative greedy == plain greedy
# ---------------------------------------------------------------------------
def test_speculative_streams_bit_exact(target):
    """Identical-weights draft: every proposal verifies (acceptance 1.0)
    and the streams are the plain-greedy streams, token for token."""
    cfg, eng = target
    reqs, prompts = _workload(cfg, seed=7, n=6)
    base, _, _ = _serve(cfg, eng, reqs, prompts)
    assert base and all(len(t) for t in base.values())
    got, _, _ = _serve(cfg, eng, reqs, prompts, spec_k=3)
    assert got == base
    assert eng.stats.spec_rounds > 0
    assert eng.stats.accepted_tokens == eng.stats.draft_tokens
    assert eng.stats.rollbacks == 0
    # speculation replaced most per-token decode dispatches
    assert eng.stats.decode_steps < sum(len(t) for t in base.values()) / 2


def test_divergent_draft_rolls_back_bit_exact(divergent_target):
    """A frequently wrong draft: rejections roll back to the exact plain
    decode state, so the streams are still the plain ones."""
    cfg, eng = divergent_target
    reqs, prompts = _workload(cfg, seed=11, n=6)
    base, _, _ = _serve(cfg, eng, reqs, prompts)
    got, _, _ = _serve(cfg, eng, reqs, prompts, spec_k=3)
    assert got == base
    assert eng.stats.rollbacks > 0, "divergent draft never rejected"
    assert eng.stats.accepted_tokens < eng.stats.draft_tokens


def test_rollback_conserves_pages_and_free_list_canonical(divergent_target):
    """Rejection-heavy serving: every page is conserved (allocator audit)
    and after recovery the free list is back in canonical order."""
    cfg, eng = divergent_target
    reqs, prompts = _workload(cfg, seed=13, n=8, budget_range=(4, 12))
    _serve(cfg, eng, reqs, prompts, spec_k=3)
    assert eng.stats.rollbacks > 0
    assert eng.check_page_invariants()
    eng.release_all_slots()
    assert eng.free_pages == eng.total_pages
    eng.recover()
    free = eng._kv.allocator._free
    assert free == sorted(free, reverse=True), "free list not canonical"


def test_lazy_page_pressure_degrades_never_preempts(target):
    """Tight lazy pool: speculation degrades k (down to plain decode)
    rather than preempting a resident, and the streams stay the plain
    ones."""
    cfg, eng_base = target
    reqs, prompts = _workload(cfg, seed=3, n=8, budget_range=(10, 20),
                              prompt_range=(4, 12))
    base, _, _ = _serve(cfg, eng_base, reqs, prompts)
    _, eng = _port_pair(total_pages=10)
    got, planner, _ = _serve(cfg, eng, reqs, prompts, spec_k=3, lazy=True)
    assert got == base
    assert eng.check_page_invariants()


def test_gating_desync_and_reinit_bit_exact(target):
    """The knee gate flips speculation off whenever the decode batch is
    at or over the knee, so slots alternate plain and speculative ticks —
    every plain tick desyncs the draft twin, every later round re-inits
    it from the recorded history. The streams stay the plain ones."""
    cfg, eng = target
    reqs, prompts = _workload(cfg, seed=5, n=6, budget_range=(4, 10))
    base, _, _ = _serve(cfg, eng, reqs, prompts)
    got, _, _ = _serve(cfg, eng, reqs, prompts, spec_k=3, spec_knee_batch=3)
    assert got == base
    assert 0 < eng.stats.spec_rounds
    assert eng.stats.decode_steps > 0      # both modes actually ran


def test_knee_gate_disables_speculation(target):
    """Batch always >= knee -> compute-bound -> never speculate."""
    cfg, eng = target
    reqs, prompts = _workload(cfg, seed=7, n=6)
    base, _, _ = _serve(cfg, eng, reqs, prompts)
    got, _, _ = _serve(cfg, eng, reqs, prompts, spec_k=3, spec_knee_batch=1)
    assert got == base
    assert eng.stats.spec_rounds == 0


def test_acceptance_ema_gate_with_probes(divergent_target):
    """A draft below the acceptance floor disables itself through the
    trailing EMA; periodic probe rounds keep measuring it."""
    cfg, eng = divergent_target
    reqs, prompts = _workload(cfg, seed=17, n=8, budget_range=(6, 14))
    base, _, _ = _serve(cfg, eng, reqs, prompts)
    got, planner, srv = _serve(cfg, eng, reqs, prompts, spec_k=3,
                               spec_min_accept=0.95, spec_probe_every=5)
    assert got == base
    # the gate engaged: fewer spec rounds than eligible decode ticks
    assert eng.stats.spec_rounds < srv.ticks
    assert planner._spec_accept_ema < 1.0


def test_speculation_worthwhile_knee_gate():
    from repro_torch.core.scheduler import speculation_worthwhile
    assert speculation_worthwhile(4, None)          # no knee: CPU tests
    assert speculation_worthwhile(3, 4)             # memory-bound
    assert not speculation_worthwhile(4, 4)         # at the knee
    assert not speculation_worthwhile(9, 4)         # compute-bound


# ---------------------------------------------------------------------------
# compile gate: verification rides executables already built
# ---------------------------------------------------------------------------
def test_speculative_compile_gate(target):
    """No new executable while serving: a second speculative serve adds
    nothing — the draft scan keys on the verify bucket and every verify
    chunk lands on the packed-bucket lattice the first serve met."""
    cfg, eng = target
    reqs, prompts = _workload(cfg, seed=23, n=6)
    _serve(cfg, eng, reqs, prompts, spec_k=3)       # warm
    warm = dict(eng.jit_cache_sizes())
    assert warm.get("draft_scan", 0) >= 1
    assert warm.get("chunk_prefill", 0) >= 1        # verify path live
    _serve(cfg, eng, reqs, prompts, spec_k=3)       # measured re-serve
    assert eng.jit_cache_sizes() == warm, "speculative serving recompiled"
    for t, r, s in eng._graphs.entries["chunk_prefill"]:
        assert t == _packed_bucket(t) and s == _pow2_at_least(s)
        assert r == _pow2_at_least(r) or r == eng.slot_len
    for t in eng._graphs.entries["draft_scan"]:
        assert t == _packed_bucket(t)


# ---------------------------------------------------------------------------
# capability boundaries
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", sorted(INCAPABLE))
def test_incapable_family_refuses_draft(family):
    """The SSM, hybrid, encoder-decoder and MoE families build and refuse
    a draft, as the reference test has them do."""
    cfg = get_config(INCAPABLE[family]).reduced()
    eng = make_engine(cfg, cache_len=CACHE_LEN, device="cpu").init_slots(
        2, paged=bool(build_model(cfg, device="cpu").paged_keys),
        page_size=PAGE)
    assert not eng.spec_capable()
    draft = InferenceEngine(eng.api, eng.params,
                            cache_len=CACHE_LEN).init_slots(2, paged=False)
    with pytest.raises(ValueError):
        eng.attach_draft(draft, spec_k=3)


def test_vocab_mismatch_refused():
    """Cross-model pairing demands one shared vocabulary — token ids must
    mean the same thing to drafter and verifier; and the draft must be a
    ring of at least the target's slots and length, with spec_k >= 1."""
    cfg = get_config(TARGET).reduced()
    eng = make_engine(cfg, cache_len=CACHE_LEN, device="cpu").init_slots(
        2, paged=True, page_size=PAGE)
    small = dataclasses.replace(cfg, vocab_size=256)
    draft = make_engine(small, cache_len=CACHE_LEN,
                        device="cpu").init_slots(2, paged=False)
    with pytest.raises(ValueError, match="vocabularies"):
        eng.attach_draft(draft, spec_k=3)
    ring = InferenceEngine(eng.api, eng.params, cache_len=CACHE_LEN)
    with pytest.raises(ValueError, match="ring"):
        eng.attach_draft(ring.init_slots(2, paged=True, page_size=PAGE), 3)
    with pytest.raises(ValueError, match="slots"):
        eng.attach_draft(ring.init_slots(1, paged=False), 3)
    with pytest.raises(ValueError, match="slots"):
        eng.attach_draft(ring.init_slots(2, CACHE_LEN // 2, paged=False), 3)
    with pytest.raises(ValueError, match="spec_k"):
        eng.attach_draft(ring.init_slots(2, paged=False), 0)
    assert eng._draft is None


# ---------------------------------------------------------------------------
# observability: the counters surface through EngineStats and the pool
# ---------------------------------------------------------------------------
def test_spec_counters_surface_everywhere(target):
    """The port has no telemetry plane yet: the spec counters surface in
    ``EngineStats`` (consistent with the streams) and in the pool's
    per-model summary line."""
    from repro_torch.serving.metrics import ModelPoolMetrics, PoolResult
    cfg, eng = target
    reqs, prompts = _workload(cfg, seed=31, n=4)
    streams, _, _ = _serve(cfg, eng, reqs, prompts, spec_k=3)
    st = eng.stats
    assert st.spec_rounds > 0 and st.draft_tokens > 0
    assert st.incr_chunks == 0 and st.accepted_tokens == st.draft_tokens
    assert st.tokens_out == sum(map(len, streams.values()))
    m = ModelPoolMetrics(spec_rounds=st.spec_rounds,
                         draft_tokens=st.draft_tokens,
                         accepted_tokens=st.accepted_tokens,
                         rollbacks=st.rollbacks)
    res = PoolResult(policy="test", duration=1.0, wall_s=0.0,
                     per_model={cfg.name: m}, occupancy=0.0)
    assert (f"spec={st.accepted_tokens}/{st.draft_tokens}"
            f"({st.spec_rounds}r,{st.rollbacks}rb)") in res.table_rows()[-1]


# ---------------------------------------------------------------------------
# pool plane: cross-model wiring
# ---------------------------------------------------------------------------
def test_pool_cross_model_speculation():
    """``EnginePool.enable_speculation`` pairs a small hosted model as the
    drafter for a large target; pool serving completes with spec rounds
    on the books and the counters mirrored into the pool's result."""
    from repro_torch.core.simulator import RunRequest
    from repro_torch.serving.pool import build_pool
    pool = build_pool([TARGET, DRAFT], base_slots=2, cache_len=CACHE_LEN,
                      prompt_len=8, page_size=PAGE, device="cpu")
    paired = pool.enable_speculation(TARGET, DRAFT, spec_k=3)
    assert paired >= 1
    for i in range(4):
        pool.push(Request(arrival=0.0, rid=i, model=TARGET, slo=1e9,
                          n_tokens=6, prompt_len=8))
    chips = max(pool.hosts[TARGET].allocations)
    run = pool.admit(RunRequest(model=TARGET, chips=chips, batch=2),
                     now=0.0, gen_len=6)
    assert run is not None
    steps = 0
    while not pool.step_run(run, now=float(steps)) and steps < 64:
        steps += 1
    assert steps < 64
    eng = run.engine
    assert eng.stats.spec_rounds > 0
    assert eng.stats.accepted_tokens <= eng.stats.draft_tokens
    res = pool.snapshot("test", duration=1.0, wall_s=0.0, steps=steps)
    m = res.per_model[TARGET]
    assert m.spec_rounds == eng.stats.spec_rounds
    assert m.draft_tokens == eng.stats.draft_tokens
    # the vocabulary refusal: a hosted model of another vocabulary
    # cannot draft for the target
    from repro_torch.serving.pool import ModelHost
    host = pool.hosts[DRAFT]
    small = dataclasses.replace(host.cfg, vocab_size=256)
    api = build_model(small, device="cpu")
    pool.hosts["small"] = ModelHost(
        small, api, api.init(torch.Generator().manual_seed(0)),
        host.profile, {}, prompt_len=8)
    with pytest.raises(ValueError, match="vocabularies"):
        pool.enable_speculation(TARGET, "small", spec_k=3)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def parity():
    """(JAX target, port target, {kind: (JAX draft, port draft)}) on the
    same weights: the identical draft shares the target's, the divergent
    one has the reference's seed 99."""
    jcfg = jax_config(TARGET).reduced()
    jeng = jax_make_engine(jcfg, cache_len=CACHE_LEN).init_slots(
        N_SLOTS, paged=True, page_size=PAGE)
    cfg = get_config(TARGET).reduced()
    api = build_model(cfg, device="cpu")
    peng = InferenceEngine(api, params_from_numpy(
        cfg, jax.tree.map(np.asarray, jeng.params), "cpu"),
        cache_len=CACHE_LEN).init_slots(N_SLOTS, paged=True, page_size=PAGE)
    jp99, pp99 = _jax_weights(99)
    drafts = {}
    for kind, (jw, pw) in (("identical", (jeng.params, peng.params)),
                           ("divergent", (jp99, pp99))):
        drafts[kind] = (
            JaxEngine(jeng.api, jw, cache_len=CACHE_LEN).init_slots(
                N_SLOTS, paged=False),
            InferenceEngine(api, pw, cache_len=CACHE_LEN).init_slots(
                N_SLOTS, paged=False))
    return cfg, jeng, peng, drafts


@pytest.mark.parametrize("kind", ["identical", "divergent"])
def test_speculative_serve_equals_jax(parity, kind):
    """The reference's speculative workload, plain then speculative, on
    both packages: the same streams, counters, dispatches and page
    placement, and the same executables after the same serves."""
    cfg, jeng, peng, drafts = parity
    jeng.attach_draft(drafts[kind][0], spec_k=3)
    peng.attach_draft(drafts[kind][1], spec_k=3)
    totals = {"spec_rounds": 0, "rollbacks": 0}
    for seed, kw in ((7, {}), (7, {"spec_k": 3}),
                     (13, {"spec_k": 3, "spec_knee_batch": 3})):
        reqs, prompts = _workload(cfg, seed=seed, n=6)
        a = _serve(cfg, jeng, reqs, prompts, side="jax", **kw)
        b = _serve(cfg, peng, reqs, prompts, **kw)
        assert b[0] == a[0], "port streams differ from the JAX package's"
        assert dataclasses.asdict(peng.stats) == \
            dataclasses.asdict(jeng.stats), (seed, kw)
        assert (b[2].ticks, b[2].dispatches) == (a[2].ticks, a[2].dispatches)
        peng.release_all_slots()
        jeng.release_all_slots()
        assert list(peng._kv.allocator._free) == list(
            jeng._kv.allocator._free)
        assert peng._draft._slot_free == jeng._draft._slot_free
        for k in totals:
            totals[k] += getattr(peng.stats, k)
        if kind == "identical":
            assert peng.stats.accepted_tokens == peng.stats.draft_tokens
    assert totals["spec_rounds"] > 0
    assert (totals["rollbacks"] > 0) == (kind == "divergent")
    got = {k: v for k, v in peng.jit_cache_sizes().items()
           if k in SHARED_KINDS}
    want = {k: jeng.jit_cache_sizes().get(k, 0) for k in got}
    assert got == want
    assert got["draft_scan"] >= 1 and got["spec_commit"] >= 1
    assert set(peng._graphs.entries["chunk_prefill"]) == set(
        jeng._chunk_prefill_jit)


def test_pool_speculation_equals_jax():
    """``test_pool_cross_model_speculation``'s run on both packages' pools
    (the same weights, the port planning at the v5e's field values, so
    both grant the same standby): the same steps and the target engine's
    same ``EngineStats``, speculation counters included."""
    from repro.core.hardware import V5E
    from repro.core.latency_model import CHIP_LEVELS
    from repro.core.simulator import RunRequest as JaxRunRequest
    from repro.serving.pool import build_pool as jax_build_pool
    from repro_torch.core.hardware import Hardware
    from repro_torch.core.profiles import build_profile
    from repro_torch.core.simulator import RunRequest
    from repro_torch.serving.pool import EnginePool, build_host
    hw = Hardware(**dataclasses.asdict(V5E), levels=CHIP_LEVELS, tp_cap=32,
                  tp_shard_width=512, hop_latency=1e-6)
    names = [TARGET, DRAFT]
    jpool = jax_build_pool(names, base_slots=2, cache_len=CACHE_LEN,
                           prompt_len=8, page_size=PAGE, warm=False)
    hosts = {}
    for name in names:
        jh = jpool.hosts[name]
        hosts[name] = build_host(
            name, profile=build_profile(name, request_rate=500.0, hw=hw),
            base_slots=2, cache_len=CACHE_LEN, prompt_len=8,
            page_size=PAGE, device="cpu", params=params_from_numpy(
                jh.cfg, jax.tree.map(np.asarray, jh.params), "cpu"))
        assert sorted(hosts[name].allocations) == sorted(jh.allocations)
    ppool = EnginePool(hosts)
    got = []
    for pool, req_cls, run_cls in ((jpool, jax_request.Request,
                                    JaxRunRequest),
                                   (ppool, Request, RunRequest)):
        assert pool.enable_speculation(TARGET, DRAFT, spec_k=3) >= 1
        for i in range(4):
            pool.push(req_cls(arrival=0.0, rid=i, model=TARGET, slo=1e9,
                              n_tokens=6, prompt_len=8))
        chips = max(pool.hosts[TARGET].allocations)
        run = pool.admit(run_cls(model=TARGET, chips=chips, batch=2),
                         now=0.0, gen_len=6)
        steps = 0
        while not pool.step_run(run, now=float(steps)) and steps < 64:
            steps += 1
        got.append((steps, run.batch, dataclasses.asdict(run.engine.stats),
                    dataclasses.asdict(run.engine._draft.stats)))
    assert got[1] == got[0]
    assert got[1][2]["spec_rounds"] > 0
