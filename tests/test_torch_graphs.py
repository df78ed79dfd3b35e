"""The port's step executables (``repro_torch.serving.graphs``) against the
JAX engine's jitted functions, on the CPU, where every entry runs eagerly
under the same keys as the CUDA graphs it would capture on a card:

* the keys: the admission stream of ``test_packed_prefill_compile_count_
  gate`` and the chunked serves of ``test_chunk_compile_count_gate`` give
  the port the JAX engine's ``_packed_prefill_jit`` and
  ``_chunk_prefill_jit`` keys, under the same O(log) bounds;
* no new entries: ``jit_cache_sizes()`` is unchanged by a repeat serve
  and by a seeded-fault serve with ``recover`` (``test_chaos.py``'s
  "chaos recovery compiles NOTHING");
* fixed addresses: every slot-cache leaf and ``_last_tok`` keep their
  ``data_ptr()`` across serves, on paged, ring and Mamba2 slots — what a
  captured graph needs;
* the state a graphed step writes: streams equal to the JAX package's,
  the slot state after a serve and the logits read from it equal to
  1e-5 (float32 reduced configs);
* the Mamba2 prepared weights: bit for bit what a step derives;
* the experts (granite-moe, phi3.5-moe reduced): no new kind of entry —
  every dispatch shape is static inside a bucket, the capacity coming
  from the bucket's token count — and the JAX engine's keys after the
  same serves; so the hybrid family (zamba2-7b reduced), whose slot
  state (stacked over mamba layers and over attention invocations) is
  held against the JAX engine's leaf by leaf.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.serving import faults as jax_faults  # noqa: E402
from repro.serving import plan as jax_plan  # noqa: E402
from repro.serving import request as jax_request  # noqa: E402
from repro.serving.engine import make_engine as jax_make_engine  # noqa
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.layers import layer_params  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402
from repro_torch.serving import faults as port_faults  # noqa: E402
from repro_torch.serving import plan as port_plan  # noqa: E402
from repro_torch.serving import request as port_request  # noqa: E402
from repro_torch.serving.engine import (InferenceEngine,  # noqa: E402
                                        _packed_bucket, _pow2_at_least,
                                        _write_segments)
from repro_torch.serving.graphs import (KINDS, PREFIX_KINDS,  # noqa
                                       SPEC_KINDS)

SSM = "mamba2-1.3b"
MOE = ["granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b"]
HYBRID = "zamba2-7b"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced models' ops are tiny: one intra-op thread serves them
    as fast, and keeps this module from oversubscribing the cores that
    parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name, cache_len, n_slots, paged=True, page_size=8):
    """(reduced cfg, JAX engine, port engine) on the same weights."""
    jeng = jax_make_engine(jax_config(name).reduced(),
                           cache_len=cache_len).init_slots(
        n_slots, paged=paged, page_size=page_size)
    cfg = get_config(name).reduced()
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jeng.params),
                               device="cpu")
    peng = InferenceEngine(build_model(cfg, device="cpu"), params,
                           cache_len=cache_len).init_slots(
        n_slots, paged=paged, page_size=page_size)
    return cfg, jeng, peng


@pytest.fixture(scope="module")
def pairs():
    built = {}

    def get(name, paged=True):
        if (name, paged) not in built:
            built[(name, paged)] = _pair(name, 32, 4, paged)
        return built[(name, paged)]

    return get


def _prompts(cfg, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=(1, n)).astype(np.int32)
            for n in lens]


def _serve(side, cfg, eng, spec, prompts, *, fault_kw=None,
           max_retries=None, **planner_kw):
    """Serve ``spec`` [(rid, prompt_len, n_tokens)] to drain on one
    package's engine; returns (streams, planner, server)."""
    plan, request, faults = ((jax_plan, jax_request, jax_faults)
                             if side == "jax"
                             else (port_plan, port_request, port_faults))
    wrap = jnp.asarray if side == "jax" else (lambda a: a)
    eng.release_all_slots()
    eng.reset_stats()
    reqs = [request.Request(arrival=0.0, rid=i, model=cfg.name, slo=1e9,
                            n_tokens=nt, prompt_len=p)
            for i, p, nt in spec]
    planner = plan.StepPlanner(eng, request.RequestQueue(cfg.name, slo=1e9),
                               plan.PlannerConfig(gen_len=4, **planner_kw))
    inj = faults.FaultInjector(**fault_kw) if fault_kw else None
    if inj is not None:
        eng.attach_faults(inj, max_retries=max_retries)
    try:
        srv = plan.serve_ticks(planner, reqs,
                               lambda r: {"tokens": wrap(prompts[r.rid])},
                               faults=inj, stall_limit=50)
    finally:
        eng.attach_faults(None, max_retries=2)
    assert not srv.truncated
    held = eng.prefix_cache.held_pages if eng.prefix_cache else 0
    assert eng.free_pages + held == eng.total_pages, "leaked pages"
    return ({r: tuple(t) for r, t in planner.streams.items()}, planner,
            srv)


def _spec(seed, n, prompt_range=(3, 20), budget_range=(2, 8)):
    rng = np.random.default_rng(seed)
    return [(i, int(rng.integers(*prompt_range)),
             int(rng.integers(*budget_range))) for i in range(n)]


def _spec_prompts(cfg, spec):
    return {i: np.random.default_rng(1000 + i).integers(
        1, cfg.vocab_size, size=(1, p)).astype(np.int32)
        for i, p, _ in spec}


# --------------------------------------------------------------------------
# executable keys
# --------------------------------------------------------------------------
def test_packed_prefill_keys_equal_jax_under_the_compile_gate():
    """``test_packed_prefill_compile_count_gate``'s admission stream (12
    batches of 1-8 prompts of 2-15 tokens into 8 paged slots): the port's
    ``packed_prefill`` keys are the JAX engine's, under the same bound,
    and ``jit_cache_sizes`` counts them."""
    cfg, jeng, peng = _pair("olmo-1b", 32, 8)
    rng = np.random.default_rng(0)
    max_total = max_len = max_batch = 0
    for trial in range(12):
        n = int(rng.integers(1, 9))
        lens = rng.integers(2, 16, size=n).tolist()
        max_total = max(max_total, sum(lens))
        max_len = max(max_len, max(lens))
        max_batch = max(max_batch, n)
        prompts = _prompts(cfg, trial, lens)
        for eng, wrap in ((jeng, jnp.asarray), (peng, lambda a: a)):
            slots = eng.insert_many([{"tokens": wrap(p)} for p in prompts],
                                    n_tokens=[1] * n)
            eng.step()
            for slot in slots:
                eng.free(slot)
    bound = (2 * int(np.ceil(np.log2(max(2, max_total))))
             + int(np.ceil(np.log2(max(2, max_len))))
             + int(np.ceil(np.log2(max(2, max_batch)))) + 3)
    keys = set(peng._graphs.entries["packed_prefill"])
    assert keys == set(jeng._packed_prefill_jit)
    assert len(keys) <= bound, (len(keys), bound)
    sizes = peng.jit_cache_sizes()
    assert sizes["packed_prefill"] == len(keys)
    assert sizes["slot_step"] == 1 == len(jeng._slot_step_jit)
    assert sizes["chunk_prefill"] == sizes["generate"] == 0


def test_chunk_prefill_keys_equal_jax_under_the_compile_gate():
    """``test_chunk_compile_count_gate``'s stream (10 serves of 3 requests,
    chunk sizes 1-13): the port's ``chunk_prefill`` and ``packed_prefill``
    keys are the JAX engine's, on the same half-pow2 / pow2 lattice and
    within the same O(log) counts."""
    cfg, jeng, peng = _pair("olmo-1b", 32, 4)
    rng = np.random.default_rng(0)
    n_incr = 0
    for trial in range(10):
        ct = int(rng.integers(1, 14))
        spec = _spec(trial, 3, prompt_range=(2, 24), budget_range=(1, 3))
        prompts = _spec_prompts(cfg, spec)
        a = _serve("jax", cfg, jeng, spec, prompts, chunk_tokens=ct)
        b = _serve("port", cfg, peng, spec, prompts, chunk_tokens=ct)
        assert b[0] == a[0]
        n_incr += peng.stats.incr_chunks
    assert n_incr > 0
    ckeys = set(peng._graphs.entries["chunk_prefill"])
    assert ckeys == set(jeng._chunk_prefill_jit)
    assert ckeys and len(ckeys) <= 8, ckeys
    assert all(t == _packed_bucket(t) for t, _, _ in ckeys), ckeys
    assert all(r == _pow2_at_least(r) or r == peng.slot_len
               for _, r, _ in ckeys), ckeys
    assert all(s == _pow2_at_least(s) for _, _, s in ckeys), ckeys
    keys = set(peng._graphs.entries["packed_prefill"])
    assert keys == set(jeng._packed_prefill_jit)
    buckets = {t for t, _, _ in keys}
    rows = {r for _, r, _ in keys}
    segs = {s for _, _, s in keys}
    assert len(buckets) <= 2 * math.ceil(math.log2(max(buckets))) + 2
    assert len(rows) <= math.ceil(math.log2(max(rows))) + 2
    assert len(segs) <= math.ceil(math.log2(max(max(segs), 2))) + 2
    sizes = peng.jit_cache_sizes()
    assert (sizes["chunk_prefill"], sizes["packed_prefill"]) == (
        len(ckeys), len(keys))


@pytest.mark.parametrize("name", ["olmo-1b", SSM])
def test_generate_keys_on_batch_and_cache_length(pairs, name):
    """``generate`` keeps one step executable per (B, cache length,
    sampling config — None when greedy): a second call of the same bucket
    adds none and gives the same tokens, another bucket adds one; the
    streams are the JAX engine's."""
    cfg, jeng, peng = pairs(name)
    before = peng.jit_cache_sizes()["generate"]
    toks = np.random.default_rng(3).integers(
        1, cfg.vocab_size, (3, 9)).astype(np.int32)
    want = np.asarray(jeng.generate({"tokens": jnp.asarray(toks)}, 7))
    got = peng.generate({"tokens": toks}, 7).numpy()
    np.testing.assert_array_equal(got, want)
    key = (3, peng.bucket_len(9 + 8), None)
    assert key in peng._graphs.entries["generate"]
    assert peng.jit_cache_sizes()["generate"] == before + 1
    np.testing.assert_array_equal(
        peng.generate({"tokens": toks}, 5).numpy(), want[:, :5])
    assert peng.jit_cache_sizes()["generate"] == before + 1
    peng.generate({"tokens": toks[:2]}, 7)
    assert peng.jit_cache_sizes()["generate"] == before + 2


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "ring"])
@pytest.mark.parametrize("name", MOE + [HYBRID])
def test_moe_keys_equal_jax_after_the_same_serves(name, paged):
    """Chunked serves (chunk sizes 1-13) and a batch ``generate``: the
    continuations of the experts and of the hybrid family recompute the
    prefix, so the port keeps no ``chunk_prefill`` entry, and its
    ``packed_prefill``, ``slot_step`` and ``generate`` keys are the JAX
    engine's jit keys; a repeat serve adds none."""
    cfg, jeng, peng = _pair(name, 32, 4, paged)
    rng = np.random.default_rng(2)
    for trial in range(6):
        ct = int(rng.integers(1, 14))
        spec = _spec(trial, 3, prompt_range=(2, 24), budget_range=(1, 3))
        prompts = _spec_prompts(cfg, spec)
        a = _serve("jax", cfg, jeng, spec, prompts, chunk_tokens=ct)
        b = _serve("port", cfg, peng, spec, prompts, chunk_tokens=ct)
        assert b[0] == a[0]
        assert peng.stats.incr_chunks == 0
    toks = np.random.default_rng(3).integers(
        1, cfg.vocab_size, (3, 9)).astype(np.int32)
    np.testing.assert_array_equal(
        peng.generate({"tokens": toks}, 5).numpy(),
        np.asarray(jeng.generate({"tokens": jnp.asarray(toks)}, 5)))
    assert set(peng._graphs.entries["packed_prefill"]) == set(
        jeng._packed_prefill_jit)
    assert set(peng._graphs.entries) <= set(KINDS)
    sizes = peng.jit_cache_sizes()
    assert sizes["chunk_prefill"] == 0 == len(jeng._chunk_prefill_jit)
    assert sizes["slot_step"] == 1 == len(jeng._slot_step_jit)
    assert sizes["generate"] == 1
    _serve("port", cfg, peng, spec, prompts, chunk_tokens=ct)
    assert peng.jit_cache_sizes() == sizes


# --------------------------------------------------------------------------
# no new executables: repeat serves, faults and recover
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name,paged", [("olmo-1b", True),
                                        ("olmo-1b", False), (SSM, True)])
def test_repeat_serve_adds_no_executable(pairs, name, paged):
    cfg, _, peng = pairs(name, paged)
    spec = _spec(11, 6)
    prompts = _spec_prompts(cfg, spec)
    first = _serve("port", cfg, peng, spec, prompts, chunk_tokens=4)[0]
    sizes = peng.jit_cache_sizes()
    assert sizes["slot_step"] == 1 and sizes["packed_prefill"] > 0
    again = _serve("port", cfg, peng, spec, prompts, chunk_tokens=4)[0]
    assert again == first
    assert peng.jit_cache_sizes() == sizes


def test_faults_and_recover_add_no_executable():
    """A seeded fault schedule (transient dispatch faults past the retry
    limit, allocator failures, stuck ticks) drives resets through
    ``recover``; served again under the same seed, it adds no executable
    — as the JAX engine's, whose keys the port's equal throughout."""
    cfg, jeng, peng = _pair("olmo-1b", 32, 4)
    spec = _spec(5, 8)
    prompts = _spec_prompts(cfg, spec)
    kw = dict(seed=13, dispatch_rate=0.1, alloc_rate=0.05, stuck_rate=0.05,
              max_faults=10)
    runs = []
    for _ in range(2):
        for side, eng in (("jax", jeng), ("port", peng)):
            _serve(side, cfg, eng, spec, prompts, chunk_tokens=3, lazy=True)
            before = eng.jit_cache_sizes()
            got = _serve(side, cfg, eng, spec, prompts, fault_kw=kw,
                         max_retries=1, chunk_tokens=3, lazy=True)
            runs.append((side, before, eng.jit_cache_sizes(), got))
    (_, _, _, ja), (_, _, _, pa) = runs[0], runs[1]
    assert pa[0] == ja[0]
    assert pa[1].engine.stats.engine_resets > 0, "no recover ran"
    side, before, after, _ = runs[3]
    assert side == "port" and after == before
    for kind in ("packed_prefill", "chunk_prefill"):
        assert set(peng._graphs.entries[kind]) == set(
            getattr(jeng, f"_{kind}_jit"))


def test_init_slots_and_new_weights_drop_the_slot_executables():
    cfg = get_config("olmo-1b").reduced()
    from repro_torch.serving.engine import make_engine
    eng = make_engine(cfg, cache_len=32, device="cpu").init_slots(2)
    eng.insert_many([{"tokens": p} for p in _prompts(cfg, 0, [5, 7])])
    eng.step()
    eng.generate({"tokens": _prompts(cfg, 1, [4])[0]}, 2)
    assert eng.jit_cache_sizes() == {"packed_prefill": 1,
                                     "chunk_prefill": 0, "slot_step": 1,
                                     "generate": 1}
    eng.init_slots(2)
    assert eng.jit_cache_sizes() == {"packed_prefill": 0,
                                     "chunk_prefill": 0, "slot_step": 0,
                                     "generate": 1}
    eng.params = eng.params
    assert eng.jit_cache_sizes() == dict.fromkeys(KINDS, 0)


# --------------------------------------------------------------------------
# fixed addresses and the state a step writes
# --------------------------------------------------------------------------
def _addresses(eng):
    out = {k: v.data_ptr() for k, v in eng._slot_cache.items()}
    out["_last_tok"] = eng._last_tok.data_ptr()
    return out


@pytest.mark.parametrize("name,paged,chunk_tokens", [
    ("olmo-1b", True, 3), ("olmo-1b", False, 3), ("qwen2-0.5b", True, 0),
    (SSM, True, 3), ("deepseek-7b", True, 3), ("yi-9b", True, 3),
    ("chameleon-34b", True, 3), (MOE[0], True, 3), (MOE[1], False, 3),
    (HYBRID, True, 3), (HYBRID, False, 3)])
def test_serve_keeps_every_slot_buffer_in_place_and_matches_jax(
        pairs, name, paged, chunk_tokens):
    """Across a serve (admissions, continuations, decodes, frees) every
    slot-cache leaf and ``_last_tok`` keep their addresses; the streams
    are the JAX package's, and so, to 1e-5, are the state a request then
    admitted and stepped holds — its K/V pages or ring row, positions, SSM
    state and conv tail — and the logits of one more step read from
    it."""
    cfg, jeng, peng = pairs(name, paged)
    spec = _spec(21, 6)
    prompts = _spec_prompts(cfg, spec)
    # keep the last request resident: budgets of the others drain first
    spec = spec[:-1] + [(spec[-1][0], spec[-1][1], 64)]
    addr = _addresses(peng)
    a = _serve("jax", cfg, jeng, spec[:-1], prompts,
               chunk_tokens=chunk_tokens)
    b = _serve("port", cfg, peng, spec[:-1], prompts,
               chunk_tokens=chunk_tokens)
    assert b[0] == a[0]
    assert _addresses(peng) == addr
    # one resident request, admitted and stepped identically
    last = {"tokens": prompts[spec[-1][0]]}
    js = jeng.insert_many([{"tokens": jnp.asarray(last["tokens"])}],
                          n_tokens=[8])
    ps = peng.insert_many([last], n_tokens=[8])
    assert js == ps
    for _ in range(3):
        jt, _ = jeng.step()
        pt, _ = peng.step()
        assert int(np.asarray(jt)[ps[0]]) == int(pt[ps[0]])
    assert _addresses(peng) == addr
    # the resident slot's state: the entries written into its pages or
    # ring row (or its SSM state and conv tail), its table row and every
    # position
    slot = ps[0]
    jc = jax.tree.map(np.asarray, jeng._slot_cache)
    pages = (np.asarray(peng._kv.pages(slot)) if peng.paged
             else None)
    for key, leaf in peng._slot_cache.items():
        got, want = leaf.float().numpy(), np.asarray(jc[key], np.float32)
        n = peng.slot_pos(slot)                 # the entries written
        if key in peng.api.paged_keys and peng.paged:
            got, want = (x[:, pages].reshape(
                (x.shape[0], -1) + x.shape[3:])[:, :n] for x in (got, want))
        elif key in peng.api.paged_keys:
            got, want = got[:, slot, :n], want[:, slot, :n]
        elif key == "block_tables":
            got, want = got[slot], want[slot]
        elif key != "pos":
            got, want = got[:, slot], want[:, slot]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                                   err_msg=key)
    jl, _ = jeng.api.decode_step(jeng.params, jeng._last_tok,
                                 jeng._slot_cache)
    pl, _ = peng.api.decode_step(
        peng.params, peng._last_tok,
        {k: v.clone() for k, v in peng._slot_cache.items()})
    np.testing.assert_allclose(pl[slot].numpy(), np.asarray(jl)[slot],
                               atol=1e-5, rtol=1e-5)
    jeng.release_all_slots()
    peng.release_all_slots()
    assert _addresses(peng) == addr


def _shared_prefix_spec(cfg, seed, n):
    """``tests/test_prefix_cache.py``'s shared-prefix stream as
    [(rid, prompt_len, n_tokens)] and host prompts: templates of 20 and 8
    tokens (20 is not a page multiple, so hits copy a page) plus tails
    of 2-5."""
    rng = np.random.default_rng(seed)
    temps = [rng.integers(1, cfg.vocab_size, size=s).astype(np.int32)
             for s in (20, 8)]
    spec, prompts = [], {}
    for i in range(n):
        t = temps[int(rng.integers(0, 2))]
        tail = rng.integers(1, cfg.vocab_size,
                            size=int(rng.integers(2, 6))).astype(np.int32)
        prompts[i] = np.concatenate([t, tail])[None, :]
        spec.append((i, prompts[i].shape[1], int(rng.integers(3, 9))))
    return spec, prompts


def test_prefix_and_spec_kinds_equal_jax_after_the_same_serves():
    """The prefix cache's ``copy_page``/``alias_slot`` and speculation's
    ``draft_scan``/``spec_commit`` (the registry's new kinds, registered
    when the features attach): after the same serves — the shared-prefix
    stream with the cache and speculation both on, twice — the port
    counts as many executables of each kind as the JAX engine
    (``alias_slot``: see below), its ``chunk_prefill`` keys
    (continuations and verify chunks) are the JAX engine's, the streams
    are the JAX package's, and the repeat serve adds nothing. Alias
    admissions catch up through forced tokens while other slots run
    speculative rounds."""
    cfg, jeng, peng = _pair("olmo-1b", 32, 4)
    assert set(peng.jit_cache_sizes()) == set(KINDS)
    drafts = (type(jeng)(jeng.api, jeng.params, cache_len=32),
              InferenceEngine(peng.api, peng.params, cache_len=32))
    for eng, draft in zip((jeng, peng), drafts):
        eng.enable_prefix_cache()
        eng.warm_prefix_ops()
        eng.attach_draft(draft.init_slots(4, paged=False), spec_k=3)
    assert set(peng.jit_cache_sizes()) == set(KINDS) | set(PREFIX_KINDS) \
        | set(SPEC_KINDS)
    # the JAX engine jits the module-level ``_alias_slot``, whose trace
    # cache every JAX engine of the process shares: it is held to tracing
    # it anew in no serve, the port to one entry
    alias = jeng.jit_cache_sizes()["alias_slot"]
    spec, prompts = _shared_prefix_spec(cfg, 3, 8)
    runs = []
    for _ in range(2):
        a = _serve("jax", cfg, jeng, spec, prompts, prefix_cache=True,
                   spec_k=3)
        b = _serve("port", cfg, peng, spec, prompts, prefix_cache=True,
                   spec_k=3)
        assert b[0] == a[0]
        assert dataclasses.asdict(peng.stats) == \
            dataclasses.asdict(jeng.stats)
        runs.append(peng.jit_cache_sizes())
    st = peng.stats
    assert st.spec_rounds and st.prefix_hits and st.forced_catchup_tokens
    want = jeng.jit_cache_sizes()
    kinds = ("copy_page",) + SPEC_KINDS
    assert {k: runs[-1][k] for k in kinds} == {k: want[k] for k in kinds}
    assert runs[-1]["copy_page"] == runs[-1]["alias_slot"] == 1
    assert want["alias_slot"] == alias
    assert set(peng._graphs.entries["chunk_prefill"]) == set(
        jeng._chunk_prefill_jit)
    assert runs[1] == runs[0]


def test_fixed_shape_scatter_with_device_counts_equals_int_counts():
    """The scatter over every lane of the bucket with its counts as 0-d
    tensors (what a captured step reads) writes what it writes with the
    counts as ints: padding lanes repeat the last real one."""
    rng = np.random.default_rng(9)
    n_slots, s_bucket, t = 5, 4, 8
    cache = {"k": torch.from_numpy(rng.standard_normal(
        (2, 9, 2, 1, 3)).astype(np.float32)),
        "pos": torch.arange(n_slots, dtype=torch.int32),
        "block_tables": torch.zeros((n_slots, 3), dtype=torch.int32)}
    pcache = {"k": torch.from_numpy(rng.standard_normal(
        (2, t, 1, 3)).astype(np.float32)),
        "pos": torch.arange(s_bucket, dtype=torch.int32) + 7}
    logits = torch.from_numpy(rng.standard_normal((s_bucket, 6)).astype(
        np.float32))
    dev = {"seg_slots": torch.tensor([3, 1, n_slots, n_slots],
                                     dtype=torch.int32),
           "dest0": torch.tensor([4, 4, 7, 2, 2, 0, 0, 0],
                                 dtype=torch.int32),
           "dest1": torch.tensor([0, 1, 0, 1, 0, 0, 0, 0],
                                 dtype=torch.int32),
           "table_rows": torch.tensor([[4, 7, 0], [2, 0, 0], [0, 0, 0],
                                       [0, 0, 0]], dtype=torch.int32)}
    outs = []
    for counts in ((2, 5), (torch.tensor(2, dtype=torch.int32),
                            torch.tensor(5, dtype=torch.int32))):
        c = {k: v.clone() for k, v in cache.items()}
        last = torch.zeros((n_slots,), dtype=torch.int64)
        _write_segments(c, last, pcache, logits, dev, *counts, ("k",))
        outs.append((c, last))
    for key in cache:
        assert torch.equal(outs[0][0][key], outs[1][0][key]), key
    assert torch.equal(outs[0][1], outs[1][1])
    got = outs[0][0]
    assert torch.equal(got["k"][:, 4, 0], pcache["k"][:, 0])
    assert torch.equal(got["k"][:, 2, 0], pcache["k"][:, 4])
    assert torch.equal(got["k"][:, 0], cache["k"][:, 0])  # null page
    assert got["pos"].tolist() == [0, 8, 2, 7, 4]
    assert got["block_tables"][3].tolist() == [4, 7, 0]


# --------------------------------------------------------------------------
# Mamba2: derived weights made once
# --------------------------------------------------------------------------
def test_mamba2_prepared_weights_equal_what_a_step_derives():
    """``prepare_params`` makes each layer's float32 copies, ``-exp(A_log)``
    and concatenated conv weight once; a decode step and a packed prefill
    on the prepared parameters give the same logits and state, bit for
    bit, as on the raw ones; an engine keeps them prepared, re-derived
    from the raw leaves when it is handed parameters that carry some."""
    cfg = dataclasses.replace(get_config(SSM).reduced(), num_layers=3)
    api = build_model(cfg, device="cpu")
    raw = api.init(torch.Generator().manual_seed(4))
    prep = api.prepare(raw)
    assert "prep" not in raw["layers"] and "prep" in prep["layers"]
    for i in range(cfg.num_layers):
        want = ssm._derive(layer_params(raw["layers"], i), torch.float32)
        for key, leaf in want.items():
            assert torch.equal(prep["layers"]["prep"][key][i], leaf), key
    cache = api.init_cache(3, 16)
    cache["ssm"].normal_(generator=torch.Generator().manual_seed(5))
    tok = torch.tensor([3, 9, 27])
    got = api.decode_step(prep, tok, {k: v.clone() for k, v in cache.items()})
    want = api.decode_step(raw, tok, {k: v.clone() for k, v in cache.items()})
    assert torch.equal(got[0], want[0])
    for key in want[1]:
        assert torch.equal(got[1][key], want[1][key]), key
    eng = InferenceEngine(api, raw, cache_len=16)
    assert "prep" in eng.params["layers"]
    spoiled = dict(prep, layers=dict(prep["layers"], prep={
        k: v + 1 for k, v in prep["layers"]["prep"].items()}))
    eng.params = spoiled
    for key, leaf in prep["layers"]["prep"].items():
        assert torch.equal(eng.params["layers"]["prep"][key], leaf), key
