"""The port's hybrid family (zamba2-7b: a Mamba2 backbone and one shared
attention block) against the JAX package's on the CPU, at the reduced
config (2 layers, ``attn_every`` 2: one invocation) and a 5-layer variant
(two invocations and a trailing mamba layer that runs none), float32:

* ``forward``, ``prefill`` (a cache longer and shorter than the prompt),
  ``prefill_packed`` (per-segment logits, SSM states, conv tails, the
  packed K/V of every invocation) and ``decode_step`` over paged and ring
  caches, within the port's bar of atol/rtol 1e-5 (the two frameworks
  reduce float32 matmuls in other orders);
* greedy ``serve_ticks`` streams (paged and ring slots, chunked admission
  whose continuations recompute the prefix) and batch ``generate`` equal
  to the JAX engine's token for token, with equal engine counters;
* the three capabilities False; ``params_from_numpy`` and
  ``init_params`` carrying ``shared_attn``;
* the plain versions of the kernels at zamba2's shapes — #1, #2, #4 and
  #5 at head_dim 112, #6 at state N 64 (P 64) — against the JAX package's
  Pallas kernels in interpret mode (atol 2e-5: their online softmax and
  chunk sums run in another order) and the SSD's JAX CPU path (1e-5 of
  the output's scale, as ``tests/test_torch_kernels.py`` holds it).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention as jax_decode_kernel  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as jax_flash_kernel  # noqa: E402
from repro.kernels.flash_attention import \
    segment_flash_attention as jax_segment_kernel  # noqa: E402
from repro.kernels.paged_attention import \
    paged_decode_attention as jax_paged_kernel  # noqa: E402
from repro.models.registry import build_model as jax_build  # noqa: E402
from repro.serving import plan as jax_plan  # noqa: E402
from repro.serving import request as jax_request  # noqa: E402
from repro.serving.engine import make_engine as jax_make_engine  # noqa
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.models import hybrid  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.weights import (init_params,  # noqa: E402
                                        params_from_numpy)
from repro_torch.serving import plan as port_plan  # noqa: E402
from repro_torch.serving import request as port_request  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

NAME = "zamba2-7b"
TOL = dict(atol=1e-5, rtol=1e-5)
KERNEL_ATOL = 2e-5
# the reduced config (2 layers, one invocation) and 5 layers at attn_every
# 2: invocations after layers 1 and 3, none after layer 4
DEPTHS = [2, 5]
CACHE_LEN, N_SLOTS, PAGE = 32, 4, 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced model's ops are tiny: one intra-op thread serves them
    as fast, and keeps this module from oversubscribing the cores that
    parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(layers):
    return tuple(dataclasses.replace(get(NAME).reduced(), num_layers=layers)
                 for get in (jax_config, get_config))


@pytest.fixture(scope="module")
def pair():
    """(cfg, JAX api, JAX params, port api, port params) per depth."""
    built = {}

    def get(layers):
        if layers not in built:
            jcfg, cfg = _configs(layers)
            japi = jax_build(jcfg)
            jparams = japi.init(jax.random.PRNGKey(0))
            api = build_model(cfg, device="cpu")
            params = params_from_numpy(
                cfg, jax.tree.map(np.asarray, jparams), device="cpu")
            built[layers] = (cfg, japi, jparams, api, params)
        return built[layers]

    return get


def _to_jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _to_torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _close_cache(tc, jc, keys, n=None):
    """Leaves ``keys`` of two caches, each cut to its first ``n`` entries
    along axis 1 (segments or packed tokens) where ``n`` is given."""
    for key in keys:
        got, want = tc[key].numpy(), np.asarray(jc[key])
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got[:, :n], want[:, :n], err_msg=key,
                                   **TOL)


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


def _state(cfg, b, rng):
    """Random per-row Mamba state (numpy)."""
    return {"ssm": rng.standard_normal(
        (cfg.num_layers, b, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
        np.float32),
        "conv": rng.standard_normal(
            (cfg.num_layers, b, cfg.ssm_conv_width - 1,
             cfg.d_inner + 2 * cfg.ssm_state), np.float32)}


# --------------------------------------------------------------------------
# the model's entry points
# --------------------------------------------------------------------------
@pytest.mark.parametrize("layers", DEPTHS)
def test_forward_matches_jax(pair, layers):
    cfg, japi, jparams, api, params = pair(layers)
    tokens = np.random.default_rng(4).integers(
        1, cfg.vocab_size, (2, 45)).astype(np.int32)     # 2 SSD chunks
    jl, jaux = jax.jit(japi.forward)(jparams, {"tokens": jnp.asarray(tokens)})
    tl, taux = api.forward(params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert sorted(taux) == sorted(jaux)
    assert all(float(v) == 0.0 for v in taux.values())


@pytest.mark.parametrize("layers,s,cache_len", [
    (2, 19, 32), (5, 19, 32),
    (5, 20, 8),               # prompt longer than the ring: its tail
])
def test_prefill_matches_jax(pair, layers, s, cache_len):
    cfg, japi, jparams, api, params = pair(layers)
    tokens = np.random.default_rng(s).integers(
        1, cfg.vocab_size, (2, s)).astype(np.int32)
    jl, jc = jax.jit(japi.prefill, static_argnums=2)(
        jparams, {"tokens": jnp.asarray(tokens)}, cache_len)
    tl, tc = api.prefill(params, {"tokens": torch.from_numpy(tokens)},
                         cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert sorted(tc) == sorted(jc)
    _close_cache(tc, jc, ("ssm", "conv", "attn_k", "attn_v"))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert {k: tuple(v.shape) for k, v in hybrid.cache_plan(
        cfg, 2, cache_len).items()} == {
        k: tuple(v.shape) for k, v in japi.cache_plan(2, cache_len).items()}


@pytest.mark.parametrize("layers", DEPTHS)
def test_prefill_packed_matches_jax(pair, layers):
    """Per-segment logits, SSM states and conv tails (a segment shorter
    than the conv window included), and every invocation's packed K/V."""
    cfg, japi, jparams, api, params = pair(layers)
    lens = [5, 40, 2]
    packed = _packed(lens, 4, 64, cfg.vocab_size, 7)
    jl, jc = jax.jit(japi.prefill_packed, static_argnums=2)(
        jparams, _to_jax(packed), 64)
    tl, tc = api.prefill_packed(params, _to_torch(packed), 64)
    np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3], **TOL)
    assert sorted(tc) == sorted(jc)
    _close_cache(tc, jc, ("ssm", "conv"), n=3)
    _close_cache(tc, jc, ("attn_k", "attn_v"), n=sum(lens))
    assert tc["attn_k"].shape[0] == hybrid.n_attn_blocks(cfg)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("layers", DEPTHS)
def test_paged_decode_step_matches_jax(pair, layers):
    """Same logits, states and written pools; the port writes every row's
    K/V in place (a vacant row on the null page)."""
    cfg, japi, jparams, api, params = pair(layers)
    rng = np.random.default_rng(3)
    ps, max_pages, b = 8, 4, 4
    n_pages = b * max_pages + 1
    kv = (hybrid.n_attn_blocks(cfg), n_pages, ps, cfg.num_kv_heads,
          cfg.resolved_head_dim)
    tables = (rng.permutation(n_pages - 1) + 1)[:b * max_pages]
    cache = dict(_state(cfg, b, rng),
                 attn_k=rng.standard_normal(kv, np.float32),
                 attn_v=rng.standard_normal(kv, np.float32),
                 block_tables=tables.reshape(b, max_pages).astype(np.int32),
                 pos=np.asarray([9, 0, 31, 0], np.int32))
    cache["block_tables"][3] = 0                       # vacant row
    token = np.asarray([7, 1, 300, 0], np.int32)
    jl, jc = jax.jit(japi.decode_step)(jparams, jnp.asarray(token),
                                       _to_jax(cache))
    tcache = _to_torch(cache)
    tl, tc = api.decode_step(params, torch.from_numpy(token), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["attn_k"] is tcache["attn_k"]            # in place
    assert sorted(tc) == sorted(jc)
    _close_cache(tc, jc, ("ssm", "conv"))
    for key in ("attn_k", "attn_v"):
        # the null page takes the vacant row's write: compare real pages
        np.testing.assert_allclose(tc[key].numpy()[:, 1:],
                                   np.asarray(jc[key])[:, 1:], **TOL)
    for key in ("pos", "block_tables"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))
    assert {k: tuple(v.shape) for k, v in hybrid.paged_cache_plan(
        cfg, b, n_pages, ps, max_pages).items()} == {
        k: tuple(v.shape) for k, v in japi.paged_cache_plan(
            b, n_pages, ps, max_pages).items()}


@pytest.mark.parametrize("layers", DEPTHS)
def test_ring_decode_step_matches_jax(pair, layers):
    """Ring rows before, at and past a wrap and a vacant row."""
    cfg, japi, jparams, api, params = pair(layers)
    rng = np.random.default_rng(6)
    c, b = 16, 4
    kv = (hybrid.n_attn_blocks(cfg), b, c, cfg.num_kv_heads,
          cfg.resolved_head_dim)
    cache = dict(_state(cfg, b, rng),
                 attn_k=rng.standard_normal(kv, np.float32),
                 attn_v=rng.standard_normal(kv, np.float32),
                 pos=np.asarray([5, 0, 16, 37], np.int32))
    token = np.asarray([3, 0, 99, 250], np.int32)
    jl, jc = jax.jit(japi.decode_step)(jparams, jnp.asarray(token),
                                       _to_jax(cache))
    tl, tc = api.decode_step(params, torch.from_numpy(token),
                             _to_torch(cache))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_cache(tc, jc, ("ssm", "conv", "attn_k", "attn_v"))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_prefill_then_decode_continues_forward(pair):
    """Prefill of a prefix, then decode steps on a ring, give the logits
    ``forward`` gives over the whole sequence."""
    cfg, _, _, api, params = pair(5)
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


def test_params_carry_the_shared_block():
    """``params_from_numpy`` keeps every leaf of the JAX parameters,
    ``shared_attn`` included; ``init_params`` follows the same plan; the
    prepared parameters add the mamba layers' derived weights and keep
    the shared block as it is."""
    jcfg, cfg = _configs(5)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(1))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = params
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert set(params["shared_attn"]) == {"ln1", "attn", "ln2", "mlp"}
    shapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    rand = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), rand) == shapes
    prepared = build_model(cfg, device="cpu").prepare(params)
    assert prepared["shared_attn"] is params["shared_attn"]
    assert prepared["layers"]["prep"]["a"].shape[0] == cfg.num_layers


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines():
    """(cfg, JAX engine, port engine) on the same weights, per (depth,
    paged)."""
    built = {}

    def get(layers, paged):
        if (layers, paged) not in built:
            jcfg, cfg = _configs(layers)
            jeng = jax_make_engine(jcfg, cache_len=CACHE_LEN).init_slots(
                N_SLOTS, paged=paged, page_size=PAGE)
            params = params_from_numpy(
                cfg, jax.tree.map(np.asarray, jeng.params), device="cpu")
            peng = InferenceEngine(build_model(cfg, device="cpu"), params,
                                   cache_len=CACHE_LEN).init_slots(
                N_SLOTS, paged=paged, page_size=PAGE)
            built[(layers, paged)] = (cfg, jeng, peng)
        return built[(layers, paged)]

    return get


def _serve(side, cfg, eng, spec, prompts, chunk_tokens):
    plan, request = ((jax_plan, jax_request) if side == "jax"
                     else (port_plan, port_request))
    wrap = jnp.asarray if side == "jax" else (lambda a: a)
    eng.release_all_slots()
    eng.reset_stats()
    reqs = [request.Request(arrival=0.0, rid=i, model=cfg.name, slo=1e9,
                            n_tokens=nt, prompt_len=p)
            for i, p, nt in spec]
    planner = plan.StepPlanner(eng, request.RequestQueue(cfg.name, slo=1e9),
                               plan.PlannerConfig(
                                   gen_len=4, chunk_tokens=chunk_tokens))
    srv = plan.serve_ticks(planner, reqs,
                           lambda r: {"tokens": wrap(prompts[r.rid])},
                           stall_limit=50)
    assert not srv.truncated
    assert eng.free_pages == eng.total_pages, "leaked pages"
    return ({r: tuple(t) for r, t in planner.streams.items()},
            dataclasses.asdict(eng.stats), (srv.ticks, srv.dispatches))


def _workload(cfg, seed, n=6):
    rng = np.random.default_rng(seed)
    spec = [(i, int(rng.integers(3, 20)), int(rng.integers(2, 8)))
            for i in range(n)]
    prompts = {i: np.random.default_rng(1000 + i).integers(
        1, cfg.vocab_size, size=(1, p)).astype(np.int32)
        for i, p, _ in spec}
    return spec, prompts


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "ring"])
@pytest.mark.parametrize("layers", DEPTHS)
def test_serve_ticks_streams_match_jax(engines, layers, paged):
    """Chunked admission on paged and ring slots: the same streams,
    counters, ticks and dispatches as the JAX engine; every continuation
    recomputes its prefix (no incremental chunk)."""
    cfg, jeng, peng = engines(layers, paged)
    assert peng.paged == jeng.paged == paged
    spec, prompts = _workload(cfg, 7)
    want = _serve("jax", cfg, jeng, spec, prompts, 3)
    got = _serve("port", cfg, peng, spec, prompts, 3)
    assert all(len(t) for t in got[0].values())
    assert got == want
    st = peng.stats
    assert st.incr_chunks == 0 and st.chunk_prefills > 0


@pytest.mark.parametrize("layers", DEPTHS)
def test_generate_matches_jax(engines, layers):
    cfg, jeng, peng = engines(layers, False)
    tokens = np.random.default_rng(2).integers(
        1, cfg.vocab_size, (3, 37)).astype(np.int32)   # 2 SSD chunks
    for n_new in (5, 13):
        jeng.reset_stats()
        peng.reset_stats()
        want = jeng.generate({"tokens": jnp.asarray(tokens)}, n_new)
        got = peng.generate({"tokens": tokens}, n_new)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert dataclasses.asdict(peng.stats) == \
            dataclasses.asdict(jeng.stats)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "ring"])
def test_capabilities_are_false(engines, paged):
    """The per-slot Mamba state is sequence state beyond pages and
    positions: no prefix cache, no incremental chunks, no speculation —
    as the JAX engine says."""
    _, jeng, peng = engines(2, paged)
    for fn in ("prefix_cache_capable", "chunk_capable", "spec_capable"):
        assert getattr(peng, fn)() is False
        assert bool(getattr(jeng, fn)()) is False
    assert peng.api.prefill_chunk is None
    assert peng.api.paged_keys == hybrid.PAGED_KEYS


# --------------------------------------------------------------------------
# the kernels' plain versions at zamba2's shapes
# --------------------------------------------------------------------------
def _t(a):
    return torch.from_numpy(np.array(a))


def test_paged_and_ring_decode_plain_at_head_dim_112_match_jax():
    rng = np.random.default_rng(0)
    b, h, d, ps, maxp = 3, 4, 112, 8, 3
    n_phys = b * maxp + 1
    q = rng.standard_normal((b, h, d), np.float32)
    kp = rng.standard_normal((n_phys, ps, h, d), np.float32)
    vp = rng.standard_normal((n_phys, ps, h, d), np.float32)
    tables = (rng.permutation(n_phys - 1) + 1)[:b * maxp].reshape(
        b, maxp).astype(np.int32)
    lens = np.asarray([0, 17, 24], np.int32)
    got = PA.paged_decode_attention_plain(*map(_t, (q, kp, vp, tables,
                                                    lens))).numpy()
    want = jax_paged_kernel(*map(jnp.asarray, (q, kp, vp, tables, lens)),
                            interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=KERNEL_ATOL)
    assert (got[0] == 0).all()
    c = 64
    kc = rng.standard_normal((b, c, h, d), np.float32)
    vc = rng.standard_normal((b, c, h, d), np.float32)
    lens = np.asarray([64, 0, 13], np.int32)
    got = DA.decode_attention_plain(*map(_t, (q, kc, vc, lens))).numpy()
    want = jax_decode_kernel(*map(jnp.asarray, (q, kc, vc, lens)),
                             block_k=32, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=KERNEL_ATOL)


def test_flash_and_segment_plain_at_head_dim_112_match_jax():
    rng = np.random.default_rng(1)
    h, d = 2, 112
    qkv = [rng.standard_normal((1, 128, h, d), np.float32) for _ in range(3)]
    got = FA.flash_attention_plain(*map(_t, qkv), causal=True).numpy()
    want = jax_flash_kernel(*map(jnp.asarray, qkv), causal=True, block_q=64,
                            block_k=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=KERNEL_ATOL)
    t, lens = 96, [40, 17, 30]
    seg = np.full((t,), len(lens), np.int32)
    starts = np.asarray([0, 40, 57], np.int32)
    for i, (s0, n) in enumerate(zip(starts, lens)):
        seg[s0:s0 + n] = i
    qkv = [rng.standard_normal((1, t, h, d), np.float32) for _ in range(3)]
    pos = TL.packed_positions(_t(seg), _t(starts))
    got = FA.segment_flash_attention_plain(
        *map(_t, qkv), _t(seg), pos, _t(starts), _t(np.asarray(lens,
                                                               np.int32)),
        row_len=64).numpy()[0, :sum(lens)]
    want = jax_segment_kernel(*map(jnp.asarray, qkv), jnp.asarray(seg),
                              block_q=96, block_k=96, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want)[0, :sum(lens)],
                               atol=KERNEL_ATOL)


@pytest.mark.parametrize("backend,length", [
    ("jnp", 300),             # L no multiple of the chunk: dt = 0 padding
    ("interpret", 256)])      # the Pallas kernel takes whole chunks
def test_ssd_plain_at_state_64_matches_jax(backend, length):
    """zamba2's SSD heads (N 64, P 64) at its chunk of 128."""
    rng = np.random.default_rng(2)
    b, h, p, n = 2, 3, 64, 64
    x = rng.standard_normal((b, length, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, length, h)))).astype(
        np.float32)
    a = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    bb = rng.standard_normal((b, length, n), np.float32)
    cc = rng.standard_normal((b, length, n), np.float32)
    args = (x, dt, a, bb, cc)
    y, s = SSD.ssd_chunked_plain(*map(_t, args), 128)
    jy, js = jax_ops.ssd(*map(jnp.asarray, args), chunk=128, backend=backend)
    for got, want in ((y.numpy(), jy), (s.numpy(), js)):
        want = np.asarray(want)
        assert got.shape == want.shape
        err = float(np.abs(got - want).max())
        assert err <= 1e-5 * max(1.0, float(np.abs(want).max())), err
    assert (n, p) in SSD.BUILT_SHAPES
