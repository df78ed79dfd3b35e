"""The port's encoder-decoder family (whisper-small reduced: 2 encoder
and 2 decoder layers, d_model 256, 16 encoder frames, float32) against
the JAX package's on the CPU. The same JAX-initialised weights (through
``params_from_numpy``) and the same frame embeddings — the JAX package's
``modality.audio_frames`` as numpy, since torch's generator draws other
numbers — go through both packages:

* the model: ``encode``, ``forward``, ``prefill``, ``prefill_packed`` and
  ``decode_step`` (paged and ring), logits and caches within 1e-5;
* #5's plain version with more keys than queries against the JAX
  package's oracle ``kernels.ref.attention_ref``, and the reference
  caveat that the JAX Pallas kernel sizes its key walk from the queries;
* the engine and the planner, each the twin of a reference test's
  whisper case: scan against eager ``generate``, paged against ring
  serving, packed against per-request prefill and ``insert_many``,
  chunked, lazily preempted and forcibly preempted streams — each stream
  also equal to the JAX engine's;
* the modality stubs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels import flash_attention as jax_flash  # noqa: E402
from repro.models.registry import build_model as jax_build  # noqa: E402
from repro.serving import modality as jax_modality  # noqa: E402
from repro.serving import plan as jax_plan  # noqa: E402
from repro.serving import request as jax_request  # noqa: E402
from repro.serving.engine import make_engine as jax_make_engine  # noqa
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402
from repro_torch.serving import modality  # noqa: E402
from repro_torch.serving import plan as port_plan  # noqa: E402
from repro_torch.serving import request as port_request  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

NAME = "whisper-small"
TOL = dict(atol=1e-5, rtol=1e-5)
CACHE_LEN = 32
N_SLOTS = 4
PAGE = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced models' ops are tiny: one intra-op thread serves them
    as fast, and keeps this module from oversubscribing the cores that
    parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n, seed):
    """The JAX package's stub frames (n, 16, 256) as numpy float32."""
    return np.asarray(jax_modality.audio_frames(
        jax_config(NAME).reduced(), n, seed=seed), np.float32)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, shape).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    """(cfg, JAX api, JAX params, port api, port params)."""
    jcfg = jax_config(NAME).reduced()
    japi = jax_build(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    cfg = get_config(NAME).reduced()
    api = build_model(cfg, device="cpu")
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return cfg, japi, jparams, api, params


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- the model
def test_encode_forward_and_prefill_match_jax(pair):
    cfg, japi, jparams, api, params = pair
    enc = _frames(2, 3)
    tok = _tokens(cfg, (2, 7), 0)
    from repro.models import encdec as jax_encdec
    want = jax_encdec.encode(jparams, jax_config(NAME).reduced(),
                             jnp.asarray(enc))
    got = encdec.encode(params, cfg, _t(enc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jbatch = {"tokens": jnp.asarray(tok), "enc_embeds": jnp.asarray(enc)}
    tbatch = {"tokens": _t(tok), "enc_embeds": _t(enc)}
    jl, _ = japi.forward(jparams, jbatch)
    tl, aux = api.forward(params, tbatch)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert float(aux["load_balance_loss"]) == 0.0
    jl, jc = japi.prefill(jparams, jbatch, 16)
    tl, tc = api.prefill(params, tbatch, 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert list(tc) == list(jc)
    for key in ("k", "v", "cross_k", "cross_v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def _packed(lens, s_max, t, cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((1, t), np.int32)
    seg = np.full((t,), s_max, np.int32)
    starts = np.zeros((s_max,), np.int32)
    slens = np.zeros((s_max,), np.int32)
    off = 0
    for i, n in enumerate(lens):
        tokens[0, off:off + n] = rng.integers(1, cfg.vocab_size, n)
        seg[off:off + n] = i
        starts[i] = off
        slens[i] = n
        off += n
    enc = np.zeros((s_max, cfg.encoder_seq, cfg.d_model), np.float32)
    enc[:len(lens)] = _frames(len(lens), seed)
    return {"tokens": tokens, "seg_ids": seg, "seg_starts": starts,
            "seg_lens": slens, "enc_embeds": enc}


def test_prefill_packed_matches_jax(pair):
    cfg, japi, jparams, api, params = pair
    lens = [5, 11, 3]
    packed = _packed(lens, 4, 24, cfg, 0)
    jl, jc = jax.jit(japi.prefill_packed, static_argnums=2)(
        jparams, {k: jnp.asarray(v) for k, v in packed.items()}, 16)
    tl, tc = api.prefill_packed(params, {k: _t(v) for k, v in
                                         packed.items()}, 16)
    np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3], **TOL)
    n = sum(lens)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy()[:, :n],
                                   np.asarray(jc[key])[:, :n], **TOL)
    for key in ("cross_k", "cross_v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("paged", [True, False])
def test_decode_step_matches_jax(pair, paged):
    """Prefill two requests, then three decode steps on a paged cache
    (scrambled tables) or a ring: logits within 1e-5, the self K/V written
    in place as the JAX step returns it, the cross K/V untouched."""
    cfg, japi, jparams, api, params = pair
    enc = _frames(2, 5)
    tok = _tokens(cfg, (2, 6), 1)
    jbatch = {"tokens": jnp.asarray(tok), "enc_embeds": jnp.asarray(enc)}
    _, jc = japi.prefill(jparams, jbatch, 16)
    if paged:
        # rows own pages [3, 1] and [4, 2] of a 5-page pool of 8 tokens
        tables = np.asarray([[3, 1], [4, 2]], np.int32)
        jp = japi.init_paged_cache(2, 5, 8, 2)
        for key in ("k", "v"):
            pool = np.zeros(jp[key].shape, np.float32)
            dense = np.asarray(jc[key])
            for r in range(2):
                for j, page in enumerate(tables[r]):
                    pool[:, page] = dense[:, r, 8 * j:8 * j + 8]
            jp[key] = jnp.asarray(pool)
        for key in ("cross_k", "cross_v", "pos"):
            jp[key] = jc[key]
        jp["block_tables"] = jnp.asarray(tables)
        jc = jp
    tc = {k: _t(np.asarray(v)) for k, v in jc.items()}
    cross = tc["cross_k"].clone()
    jstep = jax.jit(japi.decode_step)
    for i in range(3):
        t = np.asarray([3 + i, 7 + i], np.int32)
        jl, jc = jstep(jparams, jnp.asarray(t), jc)
        tl, tc = api.decode_step(params, _t(t), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       **TOL)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))
    assert torch.equal(tc["cross_k"], cross)


def test_cache_plans_equal_jax(pair):
    cfg, japi, _, api, _ = pair
    for got, want in ((api.init_cache(3, 16), japi.init_cache(3, 16)),
                      (api.init_paged_cache(3, 9, 8, 2),
                       japi.init_paged_cache(3, 9, 8, 2))):
        assert list(got) == list(want)
        for k in got:
            assert tuple(got[k].shape) == tuple(want[k].shape), k
    assert encdec.PAGED_KEYS == ("k", "v") == api.paged_keys
    assert api.prefill_chunk is None


# --------------------------------------------- #5 with more keys than queries
def _ref_other_length(q, k, v):
    """The oracle ``attention_ref`` (it takes one length for queries and
    keys) over Sk keys for any Sq: the queries go in blocks of Sk rows
    (the last padded with zero rows), each block a batch row of its own
    over the same keys, non-causal, and the padding rows are dropped."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    n = -(-sq // sk)
    qp = np.zeros((b, n * sk, h, d), q.dtype)
    qp[:, :sq] = q
    out = jax_ref.attention_ref(
        jnp.asarray(qp.reshape(b * n, sk, h, d)),
        jnp.asarray(np.repeat(k, n, axis=0)),
        jnp.asarray(np.repeat(v, n, axis=0)), causal=False)
    return np.asarray(out).reshape(b, n * sk, h, d)[:, :sq]


@pytest.mark.parametrize("b,sq,sk,h,kv,d", [
    (2, 5, 16, 4, 4, 64),       # reduced whisper's cross-attention
    (3, 64, 192, 4, 2, 64),     # GQA, a 64-row tile over three key tiles
    (1, 70, 33, 2, 2, 128),     # fewer keys than queries
])
def test_plain_flash_with_other_key_length_matches_ref(b, sq, sk, h, kv, d):
    rng = np.random.default_rng(sq + sk)
    q = rng.standard_normal((b, sq, h, d), np.float32)
    k = rng.standard_normal((b, sk, kv, d), np.float32)
    v = rng.standard_normal((b, sk, kv, d), np.float32)
    want = _ref_other_length(q, k, v)
    got = FA.flash_attention_plain(_t(q), _t(k), _t(v), causal=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the plain version's query blocks change nothing
    old, FA.PLAIN_Q_BLOCK = FA.PLAIN_Q_BLOCK, 16
    try:
        again = FA.flash_attention_plain(_t(q), _t(k), _t(v), causal=False)
    finally:
        FA.PLAIN_Q_BLOCK = old
    np.testing.assert_allclose(again.numpy(), got.numpy(), **TOL)


def test_pallas_flash_walks_only_query_length_keys_reference_caveat():
    """The reference caveat: the JAX Pallas ``flash_attention`` sizes its
    key grid from the QUERY length (``nk = s // block_k``), so 64 queries
    over 192 keys (blocks of 64, interpret mode) attend only the first 64
    keys and differ from the oracle ``attention_ref`` over all 192 (query
    blocks of the key length, ``_ref_other_length``). The port's plain
    version (and its kernel) read them all and equal the oracle; on the
    first 64 keys alone the Pallas kernel equals it."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, 64, 2, 64), np.float32)
    k = rng.standard_normal((1, 192, 2, 64), np.float32)
    v = rng.standard_normal((1, 192, 2, 64), np.float32)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want = _ref_other_length(q, k, v)
    pallas = np.asarray(jax_flash.flash_attention(
        jq, jk, jv, causal=False, block_q=64, block_k=64, interpret=True))
    assert np.abs(pallas - want).max() > 1e-2
    first = np.asarray(jax_ref.attention_ref(jq, jk[:, :64], jv[:, :64],
                                             causal=False))
    np.testing.assert_allclose(pallas, first, atol=1e-5, rtol=1e-5)
    got = FA.flash_attention_plain(_t(q), _t(k), _t(v), causal=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ------------------------------------------------------ engine and planner
@pytest.fixture(scope="module")
def engines(pair):
    """(JAX engine, port engine) with the same weights, per (paged, page
    budget), built once for the module."""
    cfg = pair[0]
    built = {}

    def get(paged=True, pages=None):
        key = (paged, pages)
        if key not in built:
            jeng = jax_make_engine(jax_config(NAME).reduced(),
                                   cache_len=CACHE_LEN).init_slots(
                N_SLOTS, paged=paged, page_size=PAGE, total_pages=pages)
            params = params_from_numpy(
                cfg, jax.tree.map(np.asarray, jeng.params), device="cpu")
            peng = InferenceEngine(build_model(cfg, device="cpu"), params,
                                   cache_len=CACHE_LEN).init_slots(
                N_SLOTS, paged=paged, page_size=PAGE, total_pages=pages)
            built[key] = (jeng, peng)
        return built[key]

    return get


def _workload(cfg, seed, n, prompt_range=(3, 20), budget_range=(2, 8)):
    """[(rid, prompt_len, n_tokens)] and numpy prompts with their own
    frames, seeded."""
    rng = np.random.default_rng(seed)
    spec, prompts = [], {}
    for i in range(n):
        p = int(rng.integers(*prompt_range))
        nt = int(rng.integers(*budget_range))
        spec.append((i, p, nt))
        prompts[i] = {"tokens": _tokens(cfg, (1, p), 1000 + i),
                      "enc_embeds": _frames(1, 100 + i)}
    return spec, prompts


class _ForcedPreempt:
    """Preempt the newest resident at the given tick indices, on top of
    either package's planner (``tests/test_plan.py``'s harness)."""

    def __init__(self, preempt_ticks):
        self.ticks = set(preempt_ticks)

    def wrap(self, planner):
        build, tick = planner.build, [0]

        def forced(now):
            plan = build(now)
            if tick[0] in self.ticks and planner._resident:
                v = planner._pick_victim(excluded=set(plan.preemptions))
                if v is not None:
                    planner._preempt(v, plan, now)
            tick[0] += 1
            return plan

        planner.build = forced
        return planner


def _serve(side, cfg, eng, spec, prompts, preempt=None, **planner_kw):
    """Serve the workload to drain. Returns (streams, planner, server)."""
    plan, request = ((jax_plan, jax_request) if side == "jax"
                     else (port_plan, port_request))
    conv = ((lambda b: {k: jnp.asarray(v) for k, v in b.items()})
            if side == "jax" else (lambda b: b))
    eng.release_all_slots()
    eng.reset_stats()
    reqs = [request.Request(arrival=0.0, rid=i, model=cfg.name, slo=1e9,
                            n_tokens=nt, prompt_len=p)
            for i, p, nt in spec]
    planner = plan.StepPlanner(eng, request.RequestQueue(cfg.name, slo=1e9),
                               plan.PlannerConfig(gen_len=4, **planner_kw))
    if preempt is not None:
        _ForcedPreempt(preempt).wrap(planner)
    srv = plan.serve_ticks(planner, reqs, lambda r: conv(prompts[r.rid]),
                           stall_limit=50)
    assert not srv.truncated
    assert eng.free_pages == eng.total_pages, "leaked pages"
    return {r: tuple(t) for r, t in planner.streams.items()}, planner, srv


def _same(a, b):
    (sa, pa, va), (sb, pb, vb) = a, b
    assert sb == sa, "port streams differ from the JAX package's"
    assert dataclasses.asdict(pb.engine.stats) == \
        dataclasses.asdict(pa.engine.stats)
    assert dataclasses.asdict(pb.metrics) == dataclasses.asdict(pa.metrics)
    assert (vb.ticks, vb.dispatches) == (va.ticks, va.dispatches)


def test_engine_capabilities_like_jax(engines):
    """Per-row cross K/V beyond pages and ``pos``: no prefix cache, no
    incremental chunks, no speculation — on either package."""
    jeng, peng = engines()
    assert peng.paged and jeng.paged
    for eng in (jeng, peng):
        assert not eng.prefix_cache_capable()
        assert not eng.chunk_capable()
        assert not eng.spec_capable()
    assert set(peng._slot_cache) == set(jeng._slot_cache)


@pytest.mark.parametrize("chunk_tokens", [0, 3, 8])
def test_serve_streams_match_jax_paged_and_ring(engines, chunk_tokens):
    """``tests/test_paged_kv.py``'s and ``tests/test_plan.py``'s whisper
    cases: whole-prompt and chunked admission (continuations recompute the
    prefix, frames and all) on paged and ring slots give the JAX engine's
    streams and counters, and paged equals ring."""
    cfg = get_config(NAME).reduced()
    spec, prompts = _workload(cfg, seed=7, n=6)
    streams = []
    for paged in (True, False):
        jeng, peng = engines(paged)
        a = _serve("jax", cfg, jeng, spec, prompts, chunk_tokens=chunk_tokens)
        b = _serve("port", cfg, peng, spec, prompts,
                   chunk_tokens=chunk_tokens)
        _same(a, b)
        st = peng.stats
        assert st.incr_chunks == 0 and st.packed_prefills > 0
        if chunk_tokens:
            assert st.chunk_prefills > 0
        streams.append(b[0])
    assert all(len(t) for t in streams[0].values())
    assert streams[0] == streams[1]


def test_lazy_preemption_and_forced_preemption_match_jax(engines):
    """A tight pool (6 pages) under lazy reservation preempts and requeues
    (``tests/test_plan.py:117``), and preemption at chosen ticks
    (``:154``): both give the unchunked streams, as the JAX engine's."""
    cfg = get_config(NAME).reduced()
    spec, prompts = _workload(cfg, seed=3, n=8, budget_range=(10, 20),
                              prompt_range=(4, 12))
    base = _serve("port", cfg, engines()[1], spec, prompts)[0]
    jeng, peng = engines(True, 6)
    a = _serve("jax", cfg, jeng, spec, prompts, chunk_tokens=4, lazy=True)
    b = _serve("port", cfg, peng, spec, prompts, chunk_tokens=4, lazy=True)
    _same(a, b)
    assert b[0] == base
    assert b[1].metrics.preemptions > 0
    spec, prompts = _workload(cfg, seed=11, n=5)
    jeng, peng = engines()
    base = _serve("port", cfg, peng, spec, prompts)[0]
    for ticks in ((2,), (1, 4, 9)):
        a = _serve("jax", cfg, jeng, spec, prompts, chunk_tokens=3,
                   preempt=ticks)
        b = _serve("port", cfg, peng, spec, prompts, chunk_tokens=3,
                   preempt=ticks)
        _same(a, b)
        assert b[0] == base and b[1].metrics.preemptions >= 1


def test_generate_scan_equals_eager_and_jax(engines):
    """``tests/test_decode_path.py:75``'s whisper case: the graphed-step
    ``generate`` equals ``generate_eager`` token for token, and both equal
    the JAX engine's, counters included."""
    jeng, peng = engines()
    cfg = get_config(NAME).reduced()
    batch = {"tokens": _tokens(cfg, (3, 8), 2), "enc_embeds": _frames(3, 9)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    outs = []
    for fn in ("generate", "generate_eager"):
        jeng.reset_stats()
        peng.reset_stats()
        want = getattr(jeng, fn)(dict(jbatch), 10)
        got = getattr(peng, fn)(dict(batch), 10)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert dataclasses.asdict(peng.stats) == \
            dataclasses.asdict(jeng.stats), fn
        outs.append(got)
    assert outs[0].shape == (3, 10) and torch.equal(outs[0], outs[1])


def test_packed_prefill_and_insert_many_match_per_request(pair, engines):
    """``tests/test_packed_prefill.py:143`` and ``:189``: a packed
    admission's last logits equal per-request prefills' within 1e-5 (the
    reference misses bit equality, see ROADMAP's caveats) with the same
    argmax, and ``insert_many`` equals a chain of ``insert`` calls slot
    for slot and token for token on paged slots — as the JAX engine's
    ``insert_many`` does."""
    cfg, _, _, api, params = pair
    lens = [5, 12, 3, 8]
    prompts = [{"tokens": _tokens(cfg, (1, n), 50 + i),
                "enc_embeds": _frames(1, 60 + i)}
               for i, n in enumerate(lens)]
    packed = _packed(lens, 8, 32, cfg, 0)
    off = 0
    for i, p in enumerate(prompts):
        packed["tokens"][0, off:off + lens[i]] = p["tokens"][0]
        packed["enc_embeds"][i] = p["enc_embeds"][0]
        off += lens[i]
    logits, _ = api.prefill_packed(params, {k: _t(v) for k, v in
                                            packed.items()}, 16)
    for i, p in enumerate(prompts):
        want, _ = api.prefill(params, {k: _t(v) for k, v in p.items()}, 16)
        np.testing.assert_allclose(logits[i].numpy(), want[0].numpy(),
                                   **TOL)
        assert int(logits[i].argmax()) == int(want[0].argmax())
    streams = []
    for many in (False, True):
        jeng, peng = engines()
        got = []
        for eng, conv in ((jeng, lambda b: {k: jnp.asarray(v)
                                            for k, v in b.items()}),
                          (peng, lambda b: b)):
            eng.release_all_slots()
            eng.reset_stats()
            if many:
                slots = eng.insert_many([conv(p) for p in prompts],
                                        n_tokens=[6] * len(lens))
                assert eng.stats.packed_prefills == 1
            else:
                slots = [eng.insert(conv(p), n_tokens=6) for p in prompts]
            toks = []
            for _ in range(6):
                t, _ = eng.step()
                toks.append(np.asarray(t)[slots].tolist())
            got.append((slots, toks))
            eng.release_all_slots()
        assert got[1] == got[0]
        streams.append(got[1])
    assert streams[0] == streams[1]


def test_vacant_slots_stay_finite(engines):
    """A vacant slot's cross length is the encoder's, over zero K/V: its
    logits are finite, as the JAX step's, and the step leaves its pending
    token alone."""
    _, peng = engines()
    peng.release_all_slots()
    cfg = get_config(NAME).reduced()
    slot = peng.insert({"tokens": _tokens(cfg, (1, 5), 4),
                        "enc_embeds": _frames(1, 4)}, n_tokens=3)
    logits = peng._step_body({"mask": torch.ones(N_SLOTS, dtype=torch.int32),
                              "forced": torch.full((N_SLOTS,), -1)})
    assert torch.isfinite(logits).all()
    peng.free(slot)
    peng.release_all_slots()


# ------------------------------------------------------------------ modality
def test_modality_stubs():
    cfg = get_config(NAME).reduced()
    a = modality.audio_frames(cfg, 2, seed=4)
    assert a.shape == (2, cfg.encoder_seq, cfg.d_model)
    assert a.dtype == torch.float32 and a.device.type == "cpu"
    assert torch.equal(a, modality.audio_frames(cfg, 2, seed=4))
    assert not torch.equal(a, modality.audio_frames(cfg, 2, seed=5))
    assert 0.01 < float(a.std()) < 0.03
    gen = torch.Generator().manual_seed(4)
    assert torch.equal(modality.audio_frames(cfg, 2, generator=gen), a)
    full = get_config(NAME)
    assert modality.audio_frames(full, 1).dtype == torch.bfloat16
    cham = get_config("chameleon-34b").reduced()
    img = modality.image_tokens(cham, 2, n_tokens=8, seed=1)
    assert img.shape == (2, 8) and img.dtype == torch.int32
    assert int(img.min()) >= max(0, cham.vocab_size - 8192)
    assert int(img.max()) < cham.vocab_size
    text = torch.ones((2, 3), dtype=torch.int32)
    fused = modality.interleave_multimodal(cham, text, img)
    assert torch.equal(fused[:, :8], img) and torch.equal(fused[:, 8:], text)
