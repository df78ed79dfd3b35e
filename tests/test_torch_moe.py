"""The port's mixture-of-experts dispatch (``repro_torch.models.moe``)
against the JAX package's ``repro.models.moe`` on the CPU: the port's
counterpart of each test of ``tests/test_moe.py``, the batch-shape caveat
held as an equality with the JAX package's packed dispatch, and
``apply_moe`` beside the JAX ``apply_moe`` at phi3.5-moe reduced and at
granite's routing width (40 experts, top-8) — outputs and aux within
atol/rtol 1e-5, expert indices and drop masks equal. Weights are the JAX
package's, converted through numpy; inputs are seeded numpy draws.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.serving.engine import make_engine  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
# granite's routing (40 experts, top-8) at a narrow width
GRANITE_NARROW = dict(num_experts=40, experts_per_token=8, d_model=64,
                      d_ff=32)


def _configs(name, **over):
    return (dataclasses.replace(jax_configs.get_config(name).reduced(),
                                **over),
            dataclasses.replace(configs.get_config(name).reduced(), **over))


def _weights(jcfg, seed=3):
    jp = JL.init_from_plan(jax.random.PRNGKey(seed), JM.moe_plan(jcfg))
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


@pytest.fixture(scope="module")
def setup():
    """phi3.5-moe reduced (4 experts, top-2), both packages' weights and
    one (2, 16, d) input."""
    jcfg, cfg = _configs("phi3.5-moe")
    jp, tp = _weights(jcfg)
    x = np.random.default_rng(4).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, tp, jp, x


def _dense_reference(p, cfg, x):
    """Dense top-k reference: compute every expert for every token."""
    t = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(t.float() @ p["router"].float(), -1)
    w, idx = torch.topk(probs, cfg.experts_per_token, -1)
    w = w / w.sum(-1, keepdim=True)
    g = torch.einsum("td,edf->tef", t, p["wi_gate"])
    u = torch.einsum("td,edf->tef", t, p["wi_up"])
    h = torch.nn.functional.silu(g.float()).to(t.dtype) * u
    all_out = torch.einsum("tef,efd->ted", h, p["wo"])
    picked = torch.gather(all_out, 1,
                          idx[..., None].expand(-1, -1, t.shape[-1]))
    return (picked.float() * w[..., None]).sum(1).reshape(x.shape)


def _jax_dispatch(p, cfg, x, cf):
    """The JAX ``apply_moe``'s dispatch groups and ``_dispatch`` outputs."""
    d = x.shape[-1]
    if x.ndim == 3 and x.shape[1] >= 256:
        cap, x3 = JM.capacity_for(x.shape[1], cfg, cf), x
    else:
        cap, x3 = JM.capacity_for(x.size // d, cfg, cf), x.reshape(1, -1, d)
    return JM._dispatch(p, cfg, jnp.asarray(x3), cap)


def test_no_drop_matches_dense_reference(setup):
    cfg, _, tp, _, x = setup
    cf_nodrop = cfg.num_experts / cfg.experts_per_token   # 0 drops
    y, aux = TM.apply_moe(tp, cfg, torch.from_numpy(x),
                          capacity_factor=cf_nodrop)
    assert float(aux["dropped_fraction"]) == 0.0
    np.testing.assert_allclose(
        y.numpy(), _dense_reference(tp, cfg, torch.from_numpy(x)).numpy(),
        **TOL)


def test_tiny_capacity_drops_tokens(setup):
    cfg, jcfg, tp, jp, x = setup
    y, aux = TM.apply_moe(tp, cfg, torch.from_numpy(x), capacity_factor=0.1)
    _, jaux = JM.apply_moe(jp, jcfg, jnp.asarray(x), capacity_factor=0.1)
    assert float(aux["dropped_fraction"]) > 0.0
    assert float(aux["dropped_fraction"]) == float(jaux["dropped_fraction"])
    assert torch.isfinite(y).all()


def test_dropped_tokens_pass_through_residual(setup):
    """Capacity ~0: the output is ~0 on most rows (the residual carries
    the token) — on the same rows as in the JAX package."""
    cfg, jcfg, tp, jp, x = setup
    y, _ = TM.apply_moe(tp, cfg, torch.from_numpy(x), capacity_factor=1e-9)
    jy, _ = JM.apply_moe(jp, jcfg, jnp.asarray(x), capacity_factor=1e-9)
    # capacity floor is 8 slots, so a few tokens still flow; most are zero
    zero_rows = (y.abs().amax(-1) < 1e-6).numpy()
    assert zero_rows.mean() > 0.3
    np.testing.assert_array_equal(
        zero_rows, np.asarray(jnp.abs(jy).max(-1) < 1e-6))


def test_load_balance_loss_bounds(setup):
    cfg, jcfg, tp, jp, x = setup
    _, aux = TM.apply_moe(tp, cfg, torch.from_numpy(x))
    lb = float(aux["load_balance_loss"])
    assert lb >= 1.0 - 0.5         # ~1 when balanced, > 1 when skewed
    assert lb < cfg.num_experts + 1
    _, jaux = JM.apply_moe(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(lb, float(jaux["load_balance_loss"]), **TOL)


@pytest.mark.parametrize("tokens", [1, 8, 100, 1000, 4096])
@pytest.mark.parametrize("name", ["phi3.5-moe", "granite-moe"])
def test_capacity_rounding(name, tokens):
    jcfg, cfg = _configs(name)
    c = TM.capacity_for(tokens, cfg)
    assert c % 8 == 0 and c >= 8
    assert c >= tokens * cfg.experts_per_token / cfg.num_experts
    assert c == JM.capacity_for(tokens, jcfg)
    full = configs.get_config(name)
    assert TM.capacity_for(tokens, full) == JM.capacity_for(
        tokens, jax_configs.get_config(name))


def test_moe_engine_refuses_incremental_paths():
    """The port's MoE engine: no packed chunk continuations and no
    speculative verification, as the JAX engine; the prefix cache stays
    (pages plus ``pos`` hold a row's whole state)."""
    from repro.serving.engine import make_engine as jax_make_engine
    cfg = configs.get_config("phi3.5-moe").reduced()
    eng = make_engine(cfg, cache_len=32, device="cpu").init_slots(
        2, paged=True, page_size=8)
    jeng = jax_make_engine(jax_configs.get_config("phi3.5-moe").reduced(),
                           cache_len=32).init_slots(2, paged=True,
                                                    page_size=8)
    assert not eng.chunk_capable() and not jeng.chunk_capable()
    assert not eng.spec_capable() and not jeng.spec_capable()
    assert eng.prefix_cache_capable() == jeng.prefix_cache_capable()


def test_batch_invariance_to_token_order(setup):
    """Permuting tokens then unpermuting gives the same result when no
    tokens are dropped (dispatch is order-dependent only under drops)."""
    cfg, _, tp, _, x = setup
    cf = cfg.num_experts / cfg.experts_per_token
    t = torch.from_numpy(x.reshape(-1, cfg.d_model))
    perm = torch.from_numpy(np.random.default_rng(9).permutation(t.shape[0]))
    inv = torch.argsort(perm)
    y1, _ = TM.apply_moe(tp, cfg, t[perm], capacity_factor=cf)
    y0, _ = TM.apply_moe(tp, cfg, t, capacity_factor=cf)
    np.testing.assert_allclose(y1[inv].numpy(), y0.numpy(), **TOL)


def test_packed_batch_shape_caveat_matches_jax(setup):
    """The caveat that ``tests/test_moe.py`` pins as a strict xfail, held
    here as it is: a probe segment co-packed behind an expert-overloading
    segment differs from the probe run alone (the hot segment exhausts its
    experts' capacity ahead of it) — and equals the JAX package's packed
    output, drops included."""
    cfg, jcfg, tp, jp, _ = setup
    rng = np.random.default_rng(4)
    probe = rng.standard_normal((1, 16, cfg.d_model)).astype(np.float32)
    # 48 copies of one token: all route to the same top-2 experts
    hot = np.tile(rng.standard_normal((1, 1, cfg.d_model)).astype(
        np.float32), (1, 48, 1))
    packed = np.concatenate([hot, probe], axis=1)
    y_alone, aux_alone = TM.apply_moe(tp, cfg, torch.from_numpy(probe))
    y_packed, aux_packed = TM.apply_moe(tp, cfg, torch.from_numpy(packed))
    assert float(aux_alone["dropped_fraction"]) == 0.0
    assert float(aux_packed["dropped_fraction"]) > 0.0
    gap = (y_packed[:, 48:] - y_alone).abs().max()
    assert float(gap) > 1e-3
    jy, jaux = JM.apply_moe(jp, jcfg, jnp.asarray(packed))
    np.testing.assert_allclose(y_packed.numpy(), np.asarray(jy), **TOL)
    assert float(aux_packed["dropped_fraction"]) == float(
        jaux["dropped_fraction"])


@pytest.mark.parametrize("shape", [(2, 16), (8, 1), (2, 300)],
                         ids=["flat", "decode", "per_row"])
@pytest.mark.parametrize("cf", [1.25, 0.1])
@pytest.mark.parametrize("name,over", [("phi3.5-moe", {}),
                                       ("granite-moe", GRANITE_NARROW)],
                         ids=["phi35", "granite_routing"])
def test_apply_moe_matches_jax(name, over, cf, shape):
    """Outputs and both aux keys within 1e-5; the expert indices and the
    drop masks of the dispatch groups equal. (8, 1) is the port's decode
    step's (B, 1, d): one group with capacity from B, as the JAX step's
    (B, d); (2, 300) dispatches per row with capacity from S."""
    jcfg, cfg = _configs(name, **over)
    jp, tp = _weights(jcfg)
    x = np.random.default_rng(sum(shape)).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    y, aux = TM.apply_moe(tp, cfg, torch.from_numpy(x), capacity_factor=cf)
    jy, jaux = JM.apply_moe(jp, jcfg, jnp.asarray(x), capacity_factor=cf)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for key in jaux:
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]), **TOL)
    _, probs, gate_i, dropped = TM.dispatch(tp, cfg, torch.from_numpy(x),
                                            cf)
    _, jprobs, jgate_i, jdropped = _jax_dispatch(jp, jcfg, x, cf)
    assert gate_i.shape == jgate_i.shape
    np.testing.assert_array_equal(gate_i.numpy(), np.asarray(jgate_i))
    np.testing.assert_array_equal(dropped.numpy(), np.asarray(jdropped))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), **TOL)
    if cf == 0.1 and shape != (8, 1):
        assert dropped.any()


def test_aliases_resolve_as_in_jax():
    """Every alias of the JAX registry resolves, in the port, to the
    config of the same name."""
    assert configs.ALIASES == jax_configs.ALIASES
    for alias in jax_configs.ALIASES:
        assert configs.get_config(alias).name == \
            jax_configs.get_config(alias).name
    with pytest.raises(KeyError):
        configs.get_config("granite")
