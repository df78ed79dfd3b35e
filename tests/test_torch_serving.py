"""The port's serving slice against the JAX package's on the CPU: the same
JAX-initialised weights, the same seeded workload (the shape of
``tests/test_plan.py``'s) and the same planner settings go through
``serve_ticks`` on a paged or ring engine of each package. The greedy
token streams must be equal token for token, the engines' ``EngineStats``
equal field for field, and every tick of the port must run at most three
dispatches — for whole-prompt admission, chunked prefill (incremental on
pages, prefix recompute on rings), a lazy tight pool that preempts, a
seeded fault schedule and tiered admission; plus the engines' page
bookkeeping call by call, batch ``generate``, and ring ≡ paged within
the port. The mixture-of-experts configs (granite-moe, phi3.5-moe
reduced) serve the JAX streams on paged and ring slots, their
continuations recomputing the prefix. The Mamba2 family (mamba2-1.3b
reduced) serves the same way on its per-slot state (paged slots fall
back to it; continuations recompute the prefix), and the packed-segment
scatter writes stacked per-segment leaves as the JAX scatter does.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.serving import faults as jax_faults  # noqa: E402
from repro.serving import plan as jax_plan  # noqa: E402
from repro.serving import request as jax_request  # noqa: E402
from repro.serving.engine import _make_write_segments  # noqa: E402
from repro.serving.engine import make_engine as jax_make_engine  # noqa
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402
from repro_torch.serving import faults as port_faults  # noqa: E402
from repro_torch.serving import plan as port_plan  # noqa: E402
from repro_torch.serving import request as port_request  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402
from repro_torch.serving.engine import SamplingParams  # noqa: E402
from repro_torch.serving.engine import _write_segments  # noqa: E402
from repro_torch.serving.engine import make_engine  # noqa: E402

CACHE_LEN = 32
N_SLOTS = 4
PAGE = 8
# the remaining dense configs: MHA, GQA and early-fusion vlm (layernorm)
DENSE = ["deepseek-7b", "yi-9b", "chameleon-34b"]
# the mixture-of-experts configs (4 experts, top-2 reduced)
MOE = ["granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced models' ops are tiny: one intra-op thread serves them
    as fast, and keeps this module from oversubscribing the cores that
    parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) with the same weights, per (model, page
    budget), built once for the module."""
    built = {}

    def get(name, pages=None, paged=True):
        key = (name, pages, paged)
        if key not in built:
            jeng = jax_make_engine(jax_config(name).reduced(),
                                   cache_len=CACHE_LEN).init_slots(
                N_SLOTS, paged=paged, page_size=PAGE, total_pages=pages)
            cfg = get_config(name).reduced()
            params = params_from_numpy(
                cfg, jax.tree.map(np.asarray, jeng.params), device="cpu")
            peng = InferenceEngine(build_model(cfg, device="cpu"), params,
                                   cache_len=CACHE_LEN).init_slots(
                N_SLOTS, paged=paged, page_size=PAGE, total_pages=pages)
            built[key] = (cfg, jeng, peng)
        return built[key]

    return get


def _workload(cfg, seed, n, prompt_range=(3, 20), budget_range=(2, 8)):
    """[(rid, prompt_len, n_tokens, arrival)] and numpy prompts, seeded."""
    rng = np.random.default_rng(seed)
    spec, prompts = [], {}
    for i in range(n):
        p = int(rng.integers(*prompt_range))
        nt = int(rng.integers(*budget_range))
        spec.append((i, p, nt, 0.0))
        prompts[i] = np.random.default_rng(1000 + i).integers(
            1, cfg.vocab_size, size=(1, p)).astype(np.int32)
    return spec, prompts


def _serve(side, cfg, eng, spec, prompts, *, fault_kw=None,
           max_retries=None, tiers_of=None, **planner_kw):
    """Serve the workload to drain on one package's engine. Returns
    (streams, planner, server, per-tick dispatch counts)."""
    plan, request, faults = ((jax_plan, jax_request, jax_faults)
                             if side == "jax"
                             else (port_plan, port_request, port_faults))
    if side == "jax":
        def prompt_fn(r):
            return {"tokens": jnp.asarray(prompts[r.rid])}
    else:
        def prompt_fn(r):
            return {"tokens": prompts[r.rid]}
    eng.release_all_slots()
    eng.reset_stats()
    reqs = [request.Request(arrival=at, rid=i, model=cfg.name, slo=1e9,
                            n_tokens=nt, prompt_len=p)
            for i, p, nt, at in spec]
    for r in reqs:
        if tiers_of is not None:
            r.tier, r.tenant = tiers_of(r.rid)
    planner = plan.StepPlanner(eng, request.RequestQueue(cfg.name, slo=1e9),
                               plan.PlannerConfig(gen_len=4, **planner_kw))
    inj = faults.FaultInjector(**fault_kw) if fault_kw else None
    per_tick = []
    execute = eng.execute

    def counted(p):
        res = execute(p)
        per_tick.append(res.dispatches)
        return res

    eng.execute = counted
    if inj is not None:
        eng.attach_faults(inj, max_retries=max_retries)
    try:
        srv = plan.serve_ticks(planner, reqs, prompt_fn, faults=inj,
                               stall_limit=50)
    finally:
        del eng.execute
        eng.attach_faults(None, max_retries=2)
    assert not srv.truncated
    assert eng.free_pages == eng.total_pages, "leaked pages"
    assert eng.check_page_invariants()
    streams = {r: tuple(t) for r, t in planner.streams.items()}
    return streams, planner, srv, per_tick


def _assert_same(a, b):
    (sa, pa, va, _), (sb, pb, vb, ticks) = a, b
    assert sb == sa, "port streams differ from the JAX package's"
    assert dataclasses.asdict(pb.engine.stats) == \
        dataclasses.asdict(pa.engine.stats)
    assert dataclasses.asdict(pb.metrics) == dataclasses.asdict(pa.metrics)
    assert (vb.ticks, vb.dispatches) == (va.ticks, va.dispatches)
    assert max(ticks) <= 3, "more than three dispatches in a tick"


@pytest.mark.parametrize("chunk_tokens", [0, 3, 8])
def test_serve_ticks_streams_match_jax(engines, chunk_tokens):
    cfg, jeng, peng = engines("olmo-1b")
    spec, prompts = _workload(cfg, seed=7, n=6)
    a = _serve("jax", cfg, jeng, spec, prompts, chunk_tokens=chunk_tokens)
    b = _serve("port", cfg, peng, spec, prompts, chunk_tokens=chunk_tokens)
    assert all(len(t) for t in b[0].values())
    _assert_same(a, b)
    if chunk_tokens:
        assert b[1].engine.stats.incr_chunks > 0


@pytest.mark.parametrize("name", DENSE)
def test_dense_config_serve_ticks_match_jax(engines, name):
    """The remaining dense configs serve the JAX streams with chunked
    admission on paged slots. chameleon-34b's prompts are early-fusion
    ones: stub VQ image tokens ahead of the text
    (``modality.interleave_multimodal``)."""
    from repro_torch.serving import modality
    cfg, jeng, peng = engines(name)
    spec, prompts = _workload(cfg, seed=5, n=6, prompt_range=(6, 20))
    if cfg.family == "vlm":
        for i, p in prompts.items():
            img = modality.image_tokens(cfg, 1, n_tokens=4, seed=i)
            prompts[i] = modality.interleave_multimodal(
                cfg, torch.from_numpy(p[:, 4:]), img).numpy()
            assert prompts[i].shape == p.shape
    a = _serve("jax", cfg, jeng, spec, prompts, chunk_tokens=3)
    b = _serve("port", cfg, peng, spec, prompts, chunk_tokens=3)
    assert all(len(t) for t in b[0].values())
    _assert_same(a, b)
    assert b[1].engine.stats.incr_chunks > 0


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "ring"])
@pytest.mark.parametrize("name", MOE)
def test_moe_serve_ticks_match_jax(engines, name, paged):
    """The experts serve the JAX streams and counters with chunked
    admission: the engine is not ``chunk_capable``, so every continuation
    recomputes its prefix through a packed prefill (no incremental
    chunk), on paged and ring slots alike."""
    cfg, jeng, peng = engines(name, paged=paged)
    assert not peng.chunk_capable() and not peng.spec_capable()
    spec, prompts = _workload(cfg, seed=5, n=6, prompt_range=(6, 20))
    a = _serve("jax", cfg, jeng, spec, prompts, chunk_tokens=3)
    b = _serve("port", cfg, peng, spec, prompts, chunk_tokens=3)
    assert all(len(t) for t in b[0].values())
    _assert_same(a, b)
    st = b[1].engine.stats
    assert st.incr_chunks == 0 and st.chunk_prefills > 0


@pytest.mark.parametrize("chunk_tokens", [0, 3, 8])
def test_ring_serve_ticks_streams_match_jax(engines, chunk_tokens):
    """Ring slots: admissions are packed prefills, continuations recompute
    the prefix through the same packed prefill, decodes run the
    contiguous decode attention."""
    cfg, jeng, peng = engines("olmo-1b", paged=False)
    assert not peng.paged and peng.free_pages == 0
    spec, prompts = _workload(cfg, seed=7, n=6)
    a = _serve("jax", cfg, jeng, spec, prompts, chunk_tokens=chunk_tokens)
    b = _serve("port", cfg, peng, spec, prompts, chunk_tokens=chunk_tokens)
    _assert_same(a, b)
    st = b[1].engine.stats
    assert st.incr_chunks == 0
    if chunk_tokens:
        assert st.chunk_prefills > 0
    # ring and paged slots serve the same streams
    assert b[0] == _serve("port", cfg, engines("olmo-1b")[2], spec,
                          prompts, chunk_tokens=chunk_tokens)[0]


@pytest.mark.parametrize("name", ["olmo-1b", "qwen2-0.5b"] + DENSE + MOE)
def test_generate_matches_jax(engines, name):
    """Batch ``generate`` (bucketed prefill + decode loop) and
    ``generate_eager`` give the JAX engine's tokens and counters."""
    cfg, jeng, peng = engines(name)
    tokens = np.random.default_rng(2).integers(
        1, cfg.vocab_size, (3, 21)).astype(np.int32)
    for fn in ("generate", "generate_eager"):
        for n_new in (5, 13):                     # 13 > cache_len - 21
            jeng.reset_stats()
            peng.reset_stats()
            want = getattr(jeng, fn)({"tokens": jnp.asarray(tokens)}, n_new)
            got = getattr(peng, fn)({"tokens": tokens}, n_new)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert dataclasses.asdict(peng.stats) == \
                dataclasses.asdict(jeng.stats), (fn, n_new)
    # sampled generation runs: in-vocabulary tokens of the asked shape,
    # and a zero temperature is the greedy arg-max
    got = peng.generate({"tokens": tokens}, 4, rng=1,
                        sampling=SamplingParams(temperature=0.8, top_k=50))
    assert got.shape == (3, 4) and int(got.max()) < cfg.vocab_size
    np.testing.assert_array_equal(
        peng.generate({"tokens": tokens}, 4,
                      sampling=SamplingParams(temperature=0.0)).numpy(),
        peng.generate({"tokens": tokens}, 4).numpy())


def _insert_step_stream(eng, prompts, budgets, n_steps):
    """Continuous batching through ``insert``/``step``/``free`` (the shape
    of ``tests/test_paged_kv.py``'s): the greedy token of every active
    slot at every step."""
    out, nxt = [], 0
    for _ in range(n_steps):
        while nxt < len(budgets) and eng.can_admit(
                prompts[nxt].shape[1], budgets[nxt]):
            eng.insert({"tokens": prompts[nxt]}, n_tokens=budgets[nxt])
            nxt += 1
        active = [s for s in range(eng.n_slots) if eng.slot_active(s)]
        tok, done = eng.step()
        t = np.asarray(tok)
        out.append([(s, int(t[s])) for s in active])
        for s in done:
            eng.free(s)
    return out


@pytest.mark.parametrize("name", ["olmo-1b", "qwen2-0.5b"] + DENSE + MOE)
def test_paged_matches_ring_greedy_mixed_lengths(name):
    """``tests/test_paged_kv.py``'s acceptance bar inside the port: paged
    decode equals ring-slot decode on a mixed-length continuous-batching
    stream with churn."""
    cfg = get_config(name).reduced()
    prompts = [np.random.default_rng(i).integers(
        1, cfg.vocab_size, (1, 8)).astype(np.int32) for i in range(6)]
    budgets = [3, 7, 2, 5, 4, 6]
    streams = []
    for paged in (False, True):
        eng = make_engine(cfg, cache_len=32, device="cpu").init_slots(
            3, paged=paged, page_size=8)
        assert eng.paged == paged
        streams.append(_insert_step_stream(eng, prompts, budgets, 10))
    assert streams[0] == streams[1]


def test_windowed_ring_wraps_like_jax():
    """A sliding-window config stays on ring slots even when paged slots
    are asked for; budgets past the ring wrap it, and the streams equal
    the JAX engine's."""
    jcfg = dataclasses.replace(jax_config("olmo-1b").reduced(),
                               sliding_window=16)
    cfg = dataclasses.replace(get_config("olmo-1b").reduced(),
                              sliding_window=16)
    jeng = jax_make_engine(jcfg, cache_len=16).init_slots(2, paged=True)
    peng = InferenceEngine(
        build_model(cfg, device="cpu"),
        params_from_numpy(cfg, jax.tree.map(np.asarray, jeng.params),
                          device="cpu"), cache_len=16).init_slots(2)
    assert not jeng.paged and not peng.paged
    prompts = [np.random.default_rng(50 + i).integers(
        1, cfg.vocab_size, (1, p)).astype(np.int32)
        for i, p in enumerate((12, 5, 16, 9))]
    budgets = [20, 6, 9, 14]
    want = _insert_step_stream(jeng, [jnp.asarray(p) for p in prompts],
                               budgets, 30)
    got = _insert_step_stream(peng, prompts, budgets, 30)
    assert got == want
    assert max(len(s) for s in got) > 0
    assert dataclasses.asdict(peng.stats) == dataclasses.asdict(jeng.stats)


def test_lazy_tight_pool_preempts_and_matches_jax(engines):
    """Lazy reservation on a 6-page pool: residents are preempted and
    requeued, and the streams still equal the unchunked ones."""
    cfg, jeng, peng = engines("olmo-1b")
    spec, prompts = _workload(cfg, seed=3, n=8, budget_range=(10, 20),
                              prompt_range=(4, 12))
    base = _serve("port", cfg, peng, spec, prompts)
    _, jtight, ptight = engines("olmo-1b", pages=6)
    a = _serve("jax", cfg, jtight, spec, prompts, chunk_tokens=4, lazy=True)
    b = _serve("port", cfg, ptight, spec, prompts, chunk_tokens=4, lazy=True)
    _assert_same(a, b)
    assert b[0] == base[0]
    m = b[1].metrics
    assert m.preemptions > 0 and m.requeues == m.preemptions
    assert b[1].engine.stats.grows > 0


def test_gqa_bias_model_streams_match_jax(engines):
    """qwen2-0.5b: grouped KV heads and QKV biases, chunked."""
    cfg, jeng, peng = engines("qwen2-0.5b")
    spec, prompts = _workload(cfg, seed=11, n=6)
    a = _serve("jax", cfg, jeng, spec, prompts, chunk_tokens=8)
    b = _serve("port", cfg, peng, spec, prompts, chunk_tokens=8)
    _assert_same(a, b)


def test_seeded_faults_recover_like_jax(engines):
    """The same seeded fault schedule (transient dispatch faults, spurious
    allocator failures, stuck ticks) drives the same retries, resets and
    requeues in both packages, and the same streams come out."""
    cfg, jeng, peng = engines("olmo-1b")
    spec, prompts = _workload(cfg, seed=5, n=8)
    kw = dict(seed=13, dispatch_rate=0.1, alloc_rate=0.05, stuck_rate=0.05,
              max_faults=10)
    a = _serve("jax", cfg, jeng, spec, prompts, fault_kw=kw, max_retries=1,
               chunk_tokens=3, lazy=True)
    b = _serve("port", cfg, peng, spec, prompts, fault_kw=kw, max_retries=1,
               chunk_tokens=3, lazy=True)
    _assert_same(a, b)
    m = b[1].metrics
    assert m.engine_retries + m.engine_resets + b[2].stuck_ticks > 0
    assert (b[2].stuck_ticks, b[2].recoveries) == \
        (a[2].stuck_ticks, a[2].recoveries)


def test_tiered_admission_matches_jax(engines):
    """Weighted tiers and tenant-fair picks under staggered arrivals: the
    copied ``TieredAdmission`` orders admissions as the JAX one does."""
    cfg, jeng, peng = engines("olmo-1b")
    spec, prompts = _workload(cfg, seed=9, n=10)
    spec = [(i, p, nt, 0.002 * (i // 3)) for i, p, nt, _ in spec]

    def tiers_of(rid):
        return (("batch", "interactive", "standard")[rid % 3],
                f"tenant{rid % 2}")

    kw = dict(tiers={"interactive": 4.0, "standard": 2.0, "batch": 1.0},
              tier_bypass_limit=2, chunk_tokens=8, tiers_of=tiers_of)
    a = _serve("jax", cfg, jeng, spec, prompts, **kw)
    b = _serve("port", cfg, peng, spec, prompts, **kw)
    _assert_same(a, b)
    assert b[1].admission is not None


def test_page_bookkeeping_matches_jax(engines):
    """Admission with a lazy horizon, decode-room growth, frees and an
    engine reset leave the same pages and slots in both packages."""
    cfg, jeng, peng = engines("olmo-1b")
    _, prompts = _workload(cfg, seed=2, n=3, prompt_range=(5, 15))
    views = []
    for side, eng in (("jax", jeng), ("port", peng)):
        eng.release_all_slots()
        eng.reset_stats()
        wrap = jnp.asarray if side == "jax" else np.asarray
        batches = [{"tokens": wrap(prompts[i])} for i in range(3)]
        slots = eng.insert_many(batches, n_tokens=[6, 6, 6],
                                reserve_tokens=[b["tokens"].shape[1]
                                                for b in batches])
        eng.ensure_decode_room(slots)
        grown = eng.grow_slot(slots[1], 24)
        eng.free(slots[0])
        view = (slots, grown, eng.free_pages, eng.free_slots,
                [eng.reserved_tokens(s) for s in slots[1:]],
                [eng.slot_page_count(s) for s in slots[1:]],
                eng.stats.grows, eng.recover(), eng.free_pages)
        views.append(view)
    assert views[1] == views[0]
    assert peng.kv_cache_bytes() == jeng.kv_cache_bytes()


def test_unported_planner_features_raise():
    """Every planner feature is ported: sampled slot steps set up (and
    make the engine unfit for speculation, which needs greedy steps), the
    prefix cache and speculative decoding, whose knobs the planner
    takes; a slot length off the page size still raises."""
    assert port_plan.PlannerConfig(spec_k=2).spec_k == 2
    assert port_plan.PlannerConfig(prefix_cache=True).prefix_cache
    cfg = get_config("olmo-1b").reduced()
    eng = InferenceEngine(build_model(cfg, device="cpu"), None,
                          cache_len=CACHE_LEN)
    eng.init_slots(2, page_size=8, rng_seed=3,
                   sampling=SamplingParams(temperature=0.8, top_p=0.9))
    assert eng.chunk_capable() and not eng.spec_capable()
    with pytest.raises(ValueError, match="multiple of page_size"):
        eng.init_slots(2, cache_len=20, page_size=8)
    eng.init_slots(2, page_size=8)
    assert eng.enable_prefix_cache() is eng.prefix_cache
    assert eng.spec_capable()


# ------------------------------------------------------------ Mamba2 (ssm)
SSM = "mamba2-1.3b"


@pytest.mark.parametrize("chunk_tokens", [0, 3, 8])
def test_ssm_serve_ticks_streams_match_jax(engines, chunk_tokens):
    """Paged slots are asked for and both engines fall back to per-slot
    state; admissions are packed prefills, continuations recompute their
    prefix, decodes step the recurrent state under the step mask."""
    cfg, jeng, peng = engines(SSM)
    assert not jeng.paged and not peng.paged
    assert not peng.chunk_capable() and not peng.prefix_cache_capable()
    spec, prompts = _workload(cfg, seed=7, n=6)
    a = _serve("jax", cfg, jeng, spec, prompts, chunk_tokens=chunk_tokens)
    b = _serve("port", cfg, peng, spec, prompts, chunk_tokens=chunk_tokens)
    assert all(len(t) for t in b[0].values())
    _assert_same(a, b)
    st = b[1].engine.stats
    assert st.incr_chunks == 0 and st.packed_prefills > 0
    if chunk_tokens:
        assert st.chunk_prefills > 0


def test_ssm_generate_matches_jax(engines):
    cfg, jeng, peng = engines(SSM)
    tokens = np.random.default_rng(2).integers(
        1, cfg.vocab_size, (3, 37)).astype(np.int32)    # 2 chunks, padded
    for fn in ("generate", "generate_eager"):
        jeng.reset_stats()
        peng.reset_stats()
        want = getattr(jeng, fn)({"tokens": jnp.asarray(tokens)}, 9)
        got = getattr(peng, fn)({"tokens": tokens}, 9)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert dataclasses.asdict(peng.stats) == \
            dataclasses.asdict(jeng.stats), fn


def test_ssm_insert_step_matches_jax(engines):
    """Single-request ``insert`` (padded prefill, row write of every
    stacked leaf), masked ``step`` and ``free`` with churn."""
    cfg, jeng, peng = engines(SSM)
    prompts = [np.random.default_rng(70 + i).integers(
        1, cfg.vocab_size, (1, p)).astype(np.int32)
        for i, p in enumerate((9, 3, 20, 14, 6))]
    budgets = [4, 7, 3, 5, 6]
    for eng in (jeng, peng):
        eng.release_all_slots()
        eng.reset_stats()
    want = _insert_step_stream(jeng, [jnp.asarray(p) for p in prompts],
                               budgets, 14)
    got = _insert_step_stream(peng, prompts, budgets, 14)
    assert got == want
    assert dataclasses.asdict(peng.stats) == dataclasses.asdict(jeng.stats)
    jeng.release_all_slots()
    peng.release_all_slots()


@pytest.mark.parametrize("layers,n_slots,s_bucket,slots", [
    (3, 4, 4, [2, 0]),     # several segments, layers != S
    (3, 4, 1, [2]),        # one segment in a bucket of 1
])
def test_write_segments_scatters_stacked_leaves_like_jax(layers, n_slots,
                                                         s_bucket, slots):
    """The packed-segment scatter of per-segment leaves: an (S,) leaf
    (``pos``) and stacked (layers, S, ...) leaves (an SSM state, a conv
    tail) land at their slots' rows in EVERY layer, as the JAX scatter
    writes them (padding segments carry slot id n_slots and are
    dropped)."""
    rng = np.random.default_rng(layers * 10 + s_bucket)
    cache = {"ssm": rng.standard_normal((layers, n_slots, 2, 3, 2),
                                        np.float32),
             "conv": rng.standard_normal((layers, n_slots, 3, 5),
                                         np.float32),
             "pos": np.arange(n_slots, dtype=np.int32) + 100}
    pcache = {"ssm": rng.standard_normal((layers, s_bucket, 2, 3, 2),
                                         np.float32),
              "conv": rng.standard_normal((layers, s_bucket, 3, 5),
                                          np.float32),
              "pos": np.arange(s_bucket, dtype=np.int32) + 7}
    logits = rng.standard_normal((s_bucket, 11), np.float32)
    seg_slots = np.full((s_bucket,), n_slots, np.int32)
    seg_slots[:len(slots)] = slots
    t = 4
    dest0, dest1 = np.zeros((t,), np.int32), np.full((t,), 99, np.int32)
    last = np.zeros((n_slots,), np.int32)
    want, want_last = _make_write_segments(())(
        _to_jax_tree(cache), jnp.asarray(last), _to_jax_tree(pcache),
        jnp.asarray(logits), jnp.asarray(dest0), jnp.asarray(dest1),
        jnp.asarray(seg_slots), None)
    got = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got_last = torch.from_numpy(last.astype(np.int64))
    dev = {"seg_slots": torch.from_numpy(seg_slots),
           "dest0": torch.from_numpy(dest0),
           "dest1": torch.from_numpy(dest1)}
    _write_segments(got, got_last, {k: torch.from_numpy(v)
                                    for k, v in pcache.items()},
                    torch.from_numpy(logits), dev, len(slots), 0, ())
    for key in cache:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(got_last.numpy(), np.asarray(want_last))
    for i, slot in enumerate(slots):          # every layer of the slot
        for layer in range(layers):
            np.testing.assert_array_equal(got["ssm"][layer, slot].numpy(),
                                          pcache["ssm"][layer, i])


def _to_jax_tree(d):
    return {k: jnp.asarray(v) for k, v in d.items()}
