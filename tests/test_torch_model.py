"""The port's transformer against the JAX package's on the CPU: the same
JAX-initialised weights (converted through numpy with
``params_from_numpy``) and the same numpy inputs go through ``forward``
(with the experts' aux), the padded ``prefill``, ``prefill_packed``,
``prefill_chunk`` and ``decode_step`` (paged and ring) of both, for the
dense configs (olmo-1b, qwen2-0.5b, deepseek-7b, yi-9b and chameleon-34b)
and the mixture-of-experts configs (granite-moe, phi3.5-moe) reduced
(float32).
Logits and written K/V must agree within atol/rtol 1e-5 — not bit for bit: the two frameworks reduce
float32 matmuls in different orders (even the JAX package misses
bit-equality across its own shapes). The Mamba2 family (mamba2-1.3b
reduced, float32) is held the same way — logits, the per-layer SSM states
and conv tails of ``prefill`` and ``prefill_packed``, and ``decode_step``
— within the same 1e-5. Plus the layer primitives, the parameter plans
and the device rules of the entry points.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.registry import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import ssm, transformer  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.weights import (init_params,  # noqa: E402
                                        params_from_numpy)
from repro_torch.serving.engine import make_engine  # noqa: E402

# the dense configs: olmo-1b, qwen2-0.5b (GQA, qkv bias), deepseek-7b
# (MHA), yi-9b (GQA) and chameleon-34b (early-fusion vlm, layernorm), and
# the experts: granite-moe and phi3.5-moe (layernorm), all reduced (4
# experts, top-2)
MODELS = ["olmo-1b", "qwen2-0.5b", "deepseek-7b", "yi-9b", "chameleon-34b",
          "granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b"]
TOL = dict(atol=1e-5, rtol=1e-5)


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
def pair():
    """(cfg, JAX api, JAX params, port api, port params) per model."""
    built = {}

    def get(name):
        if name not in built:
            jcfg = jax_config(name).reduced()
            japi = jax_build(jcfg)
            jparams = japi.init(jax.random.PRNGKey(0))
            cfg = get_config(name).reduced()
            api = build_model(cfg, device="cpu")
            params = params_from_numpy(
                cfg, jax.tree.map(np.asarray, jparams), device="cpu")
            built[name] = (cfg, japi, jparams, api, params)
        return built[name]

    return get


def _packed(lens, s_max, t, vocab, seed):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((1, t), np.int32)
    seg = np.full((t,), s_max, np.int32)
    starts = np.zeros((s_max,), np.int32)
    slens = np.zeros((s_max,), np.int32)
    off = 0
    for i, n in enumerate(lens):
        tokens[0, off:off + n] = rng.integers(1, vocab, n)
        seg[off:off + n] = i
        starts[i] = off
        slens[i] = n
        off += n
    return {"tokens": tokens, "seg_ids": seg, "seg_starts": starts,
            "seg_lens": slens}


def _to_jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _to_torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _paged_cache(cfg, n_rows, n_pages, ps, max_pages, seed):
    """Random page pools and scrambled block tables (numpy)."""
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, n_pages, ps, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    tables = (rng.permutation(n_pages - 1) + 1)[:n_rows * max_pages]
    return {"k": rng.standard_normal(shape, np.float32),
            "v": rng.standard_normal(shape, np.float32),
            "block_tables": tables.reshape(n_rows, max_pages)
            .astype(np.int32)}


@pytest.mark.parametrize("name", MODELS)
def test_prefill_packed_matches_jax(pair, name):
    cfg, japi, jparams, api, params = pair(name)
    lens = [5, 11, 3]
    packed = _packed(lens, 4, 24, cfg.vocab_size, 0)
    jl, jc = jax.jit(japi.prefill_packed, static_argnums=2)(
        jparams, _to_jax(packed), 16)
    tl, tc = api.prefill_packed(params, _to_torch(packed), 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    n = sum(lens)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy()[:, :n],
                                   np.asarray(jc[key])[:, :n], **TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("name", MODELS)
def test_prefill_chunk_matches_jax(pair, name):
    cfg, japi, jparams, api, params = pair(name)
    ps, max_pages, n_rows = 8, 4, 3
    cache = _paged_cache(cfg, n_rows, n_rows * max_pages + 1, ps, max_pages,
                         1)
    lens = [4, 7]                                   # new tokens per segment
    packed = _packed(lens, 2, 12, cfg.vocab_size, 2)
    packed["seg_slots"] = np.asarray([2, 0], np.int32)
    packed["hist_lens"] = np.asarray([13, 0], np.int32)   # 0: fresh row
    jl, ja, jc = jax.jit(japi.prefill_chunk, static_argnums=3)(
        jparams, _to_jax(packed), _to_jax(cache), 8)
    tl, ta, tc = api.prefill_chunk(params, _to_torch(packed),
                                   _to_torch(cache), 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    n = sum(lens)
    np.testing.assert_array_equal(ta.numpy()[:n], np.asarray(ja)[:n])
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy()[:, :n],
                                   np.asarray(jc[key])[:, :n], **TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("name", MODELS)
def test_decode_step_matches_jax(pair, name):
    """Same logits and the same written pool: the port writes every row's
    K/V in place (vacant rows on the null page), the JAX step returns the
    rewritten pool."""
    cfg, japi, jparams, api, params = pair(name)
    ps, max_pages, n_rows = 8, 4, 4
    cache = _paged_cache(cfg, n_rows, n_rows * max_pages + 1, ps, max_pages,
                         3)
    cache["block_tables"][3] = 0                       # vacant row
    cache["pos"] = np.asarray([9, 0, 31, 0], np.int32)
    token = np.asarray([7, 1, 300, 0], np.int32)
    jl, jc = jax.jit(japi.decode_step)(jparams, jnp.asarray(token),
                                       _to_jax(cache))
    tcache = _to_torch(cache)
    tl, tc = api.decode_step(params, torch.from_numpy(token), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["k"] is tcache["k"] and tc["v"] is tcache["v"]   # in place
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for key in ("k", "v"):
        got, want = tc[key].numpy(), np.asarray(jc[key])
        # the null page takes every vacant row's write: compare real pages
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], **TOL)


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_jax(pair, name):
    cfg, japi, jparams, api, params = pair(name)
    tokens = np.random.default_rng(4).integers(
        1, cfg.vocab_size, (2, 19)).astype(np.int32)
    jl, jaux = jax.jit(japi.forward)(jparams, {"tokens": jnp.asarray(tokens)})
    tl, taux = api.forward(params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert sorted(taux) == sorted(jaux)
    for key, v in taux.items():
        np.testing.assert_allclose(float(v), float(jaux[key]), **TOL)
    if not cfg.num_experts:
        assert all(float(v) == 0.0 for v in taux.values())


@pytest.mark.parametrize("name,s,cache_len", [
    ("olmo-1b", 19, 32), ("qwen2-0.5b", 19, 32),
    ("olmo-1b", 20, 8),               # prompt longer than the cache: tail
    ("granite-moe-3b-a800m", 19, 32), ("phi3.5-moe-42b-a6.6b", 19, 32),
    ("granite-moe-3b-a800m", 260, 272),   # S >= 256: per-row dispatch
])
def test_prefill_matches_jax(pair, name, s, cache_len):
    cfg, japi, jparams, api, params = pair(name)
    tokens = np.random.default_rng(s).integers(
        1, cfg.vocab_size, (2, s)).astype(np.int32)
    jl, jc = jax.jit(japi.prefill, static_argnums=2)(
        jparams, {"tokens": jnp.asarray(tokens)}, cache_len)
    tl, tc = api.prefill(params, {"tokens": torch.from_numpy(tokens)},
                         cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for key in ("k", "v"):
        assert tc[key].shape == jc[key].shape
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    cp = transformer.cache_plan(cfg, 2, cache_len)
    assert {k: tuple(v.shape) for k, v in cp.items()} == \
        {k: tuple(v.shape) for k, v in japi.cache_plan(2, cache_len).items()}


@pytest.mark.parametrize("name", MODELS)
def test_ring_decode_step_matches_jax(pair, name):
    """Ring (contiguous) caches with rows before, at and past a wrap and a
    vacant row: the same logits, positions and written rows."""
    cfg, japi, jparams, api, params = pair(name)
    rng = np.random.default_rng(6)
    c = 16
    shape = (cfg.num_layers, 4, c, cfg.num_kv_heads, cfg.resolved_head_dim)
    cache = {"k": rng.standard_normal(shape, np.float32),
             "v": rng.standard_normal(shape, np.float32),
             "pos": np.asarray([5, 0, 16, 37], np.int32)}
    token = np.asarray([3, 0, 99, 250], np.int32)
    jl, jc = jax.jit(japi.decode_step)(jparams, jnp.asarray(token),
                                       _to_jax(cache))
    tcache = _to_torch(cache)
    tl, tc = api.decode_step(params, torch.from_numpy(token), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["k"] is tcache["k"] and tc["v"] is tcache["v"]   # in place
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)


def _window_api(pair, window):
    cfg, japi, jparams, api, params = pair("olmo-1b")
    wcfg = dataclasses.replace(cfg, sliding_window=window)
    jwcfg = dataclasses.replace(jax_config("olmo-1b").reduced(),
                                sliding_window=window)
    return (jax_build(jwcfg), jparams, build_model(wcfg, device="cpu"),
            params, api)


def test_sliding_window_ring_matches_full_for_short_seq(pair):
    """While pos < window a ring of window rows decodes exactly as a full
    cache does (``tests/test_serving.py``'s check, in the port)."""
    _, _, wapi, params, api = _window_api(pair, 24)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, api.cfg.vocab_size, (1, 10)).astype(np.int32))
    lf, cache_f = api.prefill(params, {"tokens": toks}, 40)
    lw, cache_w = wapi.prefill(params, {"tokens": toks}, 24)
    np.testing.assert_allclose(lf.numpy(), lw.numpy(), atol=1e-5)
    tok = torch.argmax(lf, -1)
    for _ in range(8):
        lf, cache_f = api.decode_step(params, tok, cache_f)
        lw, cache_w = wapi.decode_step(params, tok, cache_w)
        np.testing.assert_allclose(lf.numpy(), lw.numpy(), atol=1e-4)
        tok = torch.argmax(lf, -1)


def test_ring_cache_wraps_beyond_window_like_jax(pair):
    """Past the window the ring keeps the last W tokens: 20 steps wrap an
    8-row ring 2.5 times, the logits stay finite and equal the JAX
    package's step for step, and the position ends at 24."""
    jwapi, jparams, wapi, params, _ = _window_api(pair, 8)
    toks = np.ones((1, 4), np.int32)
    jl, jc = jwapi.prefill(jparams, {"tokens": jnp.asarray(toks)}, 8)
    tl, tc = wapi.prefill(params, {"tokens": torch.from_numpy(toks)}, 8)
    jstep = jax.jit(jwapi.decode_step)
    for _ in range(20):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        assert (torch.argmax(tl, -1).numpy() == tok).all()
        jl, jc = jstep(jparams, jnp.asarray(tok), jc)
        tl, tc = wapi.decode_step(params, torch.from_numpy(tok), tc)
        assert torch.isfinite(tl).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert int(tc["pos"][0]) == int(jc["pos"][0]) == 24


@pytest.mark.parametrize("s", [16, 11])
def test_ring_prefill_longer_than_ring_like_jax(pair, s):
    """A prompt longer than its ring: prefill keeps the last C keys at
    rows 0..C-1 while decode writes row pos % C, so the two agree only
    when s % C == 0 (a reference caveat, ROADMAP "Reference caveats").
    The port reproduces the JAX package step for step either way; the
    windowed ``forward`` over the whole sequence shows where the ring
    decode departs from the window."""
    jwapi, jparams, wapi, params, _ = _window_api(pair, 8)
    toks = np.random.default_rng(s).integers(
        1, wapi.cfg.vocab_size, (1, s + 4)).astype(np.int32)
    full, _ = wapi.forward(params, {"tokens": torch.from_numpy(toks)})
    jl, jc = jwapi.prefill(jparams, {"tokens": jnp.asarray(toks[:, :s])}, 8)
    tl, tc = wapi.prefill(params, {"tokens": torch.from_numpy(toks[:, :s])},
                          8)
    jstep = jax.jit(jwapi.decode_step)
    gaps = []
    for i in range(4):
        tok = toks[:, s + i].copy()
        jl, jc = jstep(jparams, jnp.asarray(tok), jc)
        tl, tc = wapi.decode_step(params, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        gaps.append(float((tl - full[:, s + i]).abs().max()))
    if s % 8 == 0:
        assert max(gaps) < 1e-5, gaps
    else:
        assert max(gaps) > 1e-2, gaps


def test_layer_primitives_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 3, 64), np.float32)
    pos = rng.integers(0, 500, size=(2, 6)).astype(np.int32)
    np.testing.assert_allclose(
        TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                      10_000.0).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                 10_000.0)), **TOL)
    h = rng.standard_normal((3, 32), np.float32)
    p = {"scale": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    for kind in ("rmsnorm", "layernorm", "layernorm_nonparam"):
        np.testing.assert_allclose(
            TL.apply_norm(_to_torch(p), torch.from_numpy(h), kind).numpy(),
            np.asarray(JL.apply_norm(_to_jax(p), jnp.asarray(h), kind)),
            **TOL)


@pytest.mark.parametrize("name", MODELS)
def test_init_params_follow_the_plan(name):
    cfg = get_config(name).reduced()
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, device="cpu")
    jshapes = jax.tree.map(lambda a: tuple(a.shape),
                           jax_build(jax_config(name).reduced()).init(
                               jax.random.PRNGKey(0)))
    tshapes = jax.tree.map(lambda t: tuple(t.shape), params)
    assert tshapes == jshapes
    wq = params["layers"]["attn"]["wq"]
    assert abs(float(wq.std()) - 0.02) < 2e-3
    if cfg.qkv_bias:
        assert not params["layers"]["attn"]["bq"].any()
    again = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["embed"]["embedding"],
                       params["embed"]["embedding"])


def test_params_from_numpy_checks_shapes():
    cfg = get_config("olmo-1b").reduced()
    tree = jax.tree.map(np.asarray, jax_build(jax_config("olmo-1b").reduced())
                        .init(jax.random.PRNGKey(1)))
    tree["layers"]["mlp"]["wo"] = tree["layers"]["mlp"]["wo"][:, :3]
    with pytest.raises(ValueError, match="mlp/wo"):
        params_from_numpy(cfg, tree, device="cpu")


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("olmo-1b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, torch.Generator())
    assert make_engine(cfg, cache_len=16, device="cpu").device.type == "cpu"


def test_unported_features_raise():
    cfg = get_config("olmo-1b").reduced()
    cache = transformer.init_paged_cache(cfg, 2, 5, 8, 2)
    pos = torch.zeros(2, dtype=torch.int32)
    _, attend, _ = TL.decode_index(pos, cache, "k")
    q = torch.zeros(2, cfg.num_heads, cfg.resolved_head_dim)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        attend(q, cache["k"][0], cache["v"][0], window=4)



# ------------------------------------------------------------ Mamba2 (ssm)
SSM = "mamba2-1.3b"


def _assert_cache_close(tc, jc, n_seg=None):
    """Every leaf of a port cache against the JAX one (``n_seg``: only the
    first segments of per-segment leaves)."""
    assert sorted(tc) == sorted(jc)
    for key in ("ssm", "conv"):
        got, want = tc[key].numpy(), np.asarray(jc[key])
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got[:, :n_seg], want[:, :n_seg], **TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("s", [19, 45, 2])       # 1 chunk, 2 (padded), tiny
def test_ssm_forward_and_prefill_match_jax(pair, s):
    cfg, japi, jparams, api, params = pair(SSM)
    tokens = np.random.default_rng(s).integers(
        1, cfg.vocab_size, (2, s)).astype(np.int32)
    batch, jbatch = {"tokens": torch.from_numpy(tokens)}, {
        "tokens": jnp.asarray(tokens)}
    jl, _ = jax.jit(japi.forward)(jparams, jbatch)
    tl, taux = api.forward(params, batch)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert all(float(v) == 0.0 for v in taux.values())
    jl, jc = jax.jit(japi.prefill, static_argnums=2)(jparams, jbatch, 32)
    tl, tc = api.prefill(params, batch, 32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(tc, jc)
    cp = ssm.cache_plan(cfg, 2, 32)
    assert {k: tuple(v.shape) for k, v in cp.items()} == \
        {k: tuple(v.shape) for k, v in japi.cache_plan(2, 32).items()}


def test_ssm_prefill_packed_matches_jax(pair):
    """Per-segment logits, SSM states and conv tails (segments shorter
    than the conv window included) and positions."""
    cfg, japi, jparams, api, params = pair(SSM)
    lens = [5, 40, 2]
    packed = _packed(lens, 4, 64, cfg.vocab_size, 7)
    jl, jc = jax.jit(japi.prefill_packed, static_argnums=2)(
        jparams, _to_jax(packed), 64)
    tl, tc = api.prefill_packed(params, _to_torch(packed), 64)
    np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3], **TOL)
    _assert_cache_close(tc, jc, n_seg=3)


def test_ssm_decode_step_matches_jax(pair):
    cfg, japi, jparams, api, params = pair(SSM)
    rng = np.random.default_rng(8)
    b = 3
    cache = {"ssm": rng.standard_normal(
        (cfg.num_layers, b, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
        np.float32),
        "conv": rng.standard_normal(
            (cfg.num_layers, b, cfg.ssm_conv_width - 1,
             cfg.d_inner + 2 * cfg.ssm_state), np.float32),
        "pos": np.asarray([4, 0, 17], np.int32)}
    token = np.asarray([9, 1, 400], np.int32)
    jl, jc = jax.jit(japi.decode_step)(jparams, jnp.asarray(token),
                                       _to_jax(cache))
    tl, tc = api.decode_step(params, torch.from_numpy(token),
                             _to_torch(cache))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(tc, jc)


def test_ssm_prefill_then_decode_continues_forward(pair):
    """Prefill of a prefix then decode steps give the logits ``forward``
    gives over the whole sequence (the recurrent and chunked forms
    agree)."""
    cfg, _, _, api, params = pair(SSM)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab_size, (2, 40)).astype(np.int32))
    full, _ = api.forward(params, {"tokens": toks})
    logits, cache = api.prefill(params, {"tokens": toks[:, :33]}, 64)
    np.testing.assert_allclose(logits.numpy(), full[:, 32].numpy(),
                               atol=1e-4)
    for t in range(33, 40):
        logits, cache = api.decode_step(params, toks[:, t], cache)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   atol=1e-4)
    assert cache["pos"].tolist() == [40, 40]


@pytest.mark.parametrize("stepped", [(1, 0, 1), (0, 0, 0), (1, 1, 1)])
@pytest.mark.parametrize("name", [SSM, "zamba2-7b"])
def test_masked_decode_step_advances_the_state_in_place(name, stepped):
    """``decode_step(..., mask=)`` of the Mamba2 and hybrid families (the
    slot step's form) returns the cache's own ``ssm`` tensor, advanced on
    the masked rows; after the engine's merge of the other leaves the
    cache equals the functional ``decode_step`` followed by the merge, bit
    for bit, and so do the stepped rows' logits."""
    from repro_torch.serving.engine import _merge_rows
    cfg = get_config(name).reduced()
    api = build_model(cfg, device="cpu")
    params = api.prepare(api.init(torch.Generator().manual_seed(1)))
    gen = torch.Generator().manual_seed(2)
    b = len(stepped)
    cache = api.init_cache(b, 32)
    for key in ("ssm", "conv"):
        cache[key].copy_(torch.randn(cache[key].shape, generator=gen))
    cache["pos"].copy_(torch.tensor([4, 0, 17], dtype=torch.int32))
    token = torch.tensor([9, 1, 400], dtype=torch.int32)
    mask = torch.tensor(stepped, dtype=torch.bool)
    # K/V rows a step writes in place: the engine restores them
    skip = ("attn_k", "attn_v")
    want = {k: v.clone() for k, v in cache.items()}
    wl, new = api.decode_step(params, token, {k: v.clone()
                                              for k, v in cache.items()})
    _merge_rows(new, want, mask, skip)
    got = {k: v.clone() for k, v in cache.items()}
    leaf = got["ssm"]
    gl, out = api.decode_step(params, token, got, mask=mask)
    assert out["ssm"] is leaf
    _merge_rows(out, got, mask, skip)
    for key in ("ssm", "conv", "pos"):
        assert torch.equal(got[key], want[key]), key
    assert torch.equal(got["ssm"][:, ~mask], cache["ssm"][:, ~mask])
    assert torch.equal(gl[mask], wl[mask])


def test_ssm_init_params_follow_the_plan():
    cfg = get_config(SSM).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.tree.map(lambda a: tuple(a.shape),
                           jax_build(jax_config(SSM).reduced()).init(
                               jax.random.PRNGKey(0)))
    assert jax.tree.map(lambda t: tuple(t.shape), params) == jshapes
    lp = params["layers"]
    assert abs(float(lp["conv_x"].std()) - 0.2) < 0.02
    assert abs(float(lp["wx"].std()) - 0.02) < 2e-3
    assert not lp["A_log"].any() and not lp["dt_bias"].any()
    assert bool((lp["D"] == 1).all())
    assert bool((lp["gate_norm"]["scale"] == 1).all())


def test_ssm_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_config(SSM))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine(get_config(SSM).reduced())
    api = build_model(get_config(SSM).reduced(), device="cpu")
    assert api.paged_keys == () and api.init_paged_cache is None
    assert api.prefill_chunk is None
