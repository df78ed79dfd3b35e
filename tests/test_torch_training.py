"""The port's training modules against the JAX package's, on the CPU: the
counterpart of each case of ``tests/test_training.py``, each also held
against the JAX result on the same inputs — reduced configs, float32,
the JAX-initialised weights converted with ``params_from_numpy``.

Tolerances: AdamW's update, clipping and schedule within rtol 1e-6;
``_chunked_ce`` within rtol 1e-6 and its gradient within atol 1e-6 (the
JAX test's); ``lm_loss`` within rtol 1e-5 and every gradient leaf within
1e-5 of that leaf's max |value| (the two frameworks sum float32 matmuls
in other orders); 5 ``train_step``s from the same weights and batches
loss by loss within rtol 1e-4 (losses, not parameters: AdamW's first
steps move each element by about +-lr whatever the size of its gradient,
so a parameter comparison would only measure rounding); the pipeline's
tokens and the checkpoint files exactly.
"""
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.models.registry import build_model as jax_build  # noqa: E402
from repro.training import checkpoint as jax_checkpoint  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training import train_step as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.weights import (init_params,  # noqa: E402
                                        params_from_numpy)
from repro_torch.training import checkpoint  # noqa: E402
from repro_torch.training.optimizer import AdamW  # noqa: E402
from repro_torch.training.train_step import (_chunked_ce,  # noqa: E402
                                             lm_loss, loss_and_grads,
                                             make_eval_step,
                                             make_train_step)

LM_MODELS = ["olmo-1b", "qwen2-0.5b", "granite-moe", "phi3.5-moe"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Reduced models: one intra-op thread serves them as fast, and keeps
    this module from oversubscribing the cores parallel workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _t(v, grad) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree)).requires_grad_(grad)


def _pairs(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        return [x for k in sorted(a) for x in _pairs(a[k], b[k], f"{path}/{k}")]
    return [(path, a, b)]


@pytest.fixture(scope="module")
def models():
    """(cfg, JAX api, JAX params, port api, port params) per model."""
    built = {}

    def get(name):
        if name not in built:
            japi = jax_build(jax_config(name).reduced())
            jparams = japi.init(jax.random.PRNGKey(0))
            cfg = get_config(name).reduced()
            api = build_model(cfg, device="cpu")
            built[name] = (cfg, japi, jparams, api,
                           params_from_numpy(cfg, _np_tree(jparams), "cpu"))
        return built[name]

    return get


def _batches(cfg, n, b, s, seed=0):
    """n JAX pipeline batches and the same as port tensors."""
    pipe = iter(JTokenPipeline(jax_config(cfg.name).reduced(),
                               JDataConfig(b, s, seed=seed)))
    jb = [next(pipe) for _ in range(n)]
    tb = [{k: torch.tensor(np.asarray(v)).long() for k, v in x.items()}
          for x in jb]
    return jb, tb


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------
def test_adamw_matches_manual_step():
    opt = AdamW(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                warmup_steps=1, total_steps=10**9, max_grad_norm=1e9)
    p = {"w": torch.tensor([[1.0, 2.0]])}
    g = {"w": torch.tensor([[0.5, -0.5]])}
    p0 = p["w"].clone()
    p2, _, _ = opt.update(g, opt.init(p), p)
    m = 0.1 * g["w"]
    v = 0.01 * g["w"] ** 2
    want = p0 - opt.schedule(0) * (m / (1 - 0.9)) / (
        torch.sqrt(v / (1 - 0.99)) + 1e-8)
    np.testing.assert_allclose(p2["w"].numpy(), want.numpy(), rtol=1e-6)


def _random_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((4, 3, 2), np.float32),
                  "b": rng.standard_normal((3,), np.float32)},
            "z": rng.standard_normal((5, 6), np.float32)}


@pytest.mark.parametrize("max_grad_norm", [1.0, 1e9])
def test_adamw_three_updates_match_jax(max_grad_norm):
    """Three updates with weight decay on (matrices only), clipping active
    or not, from identical params and grads: params, moments and metrics
    within rtol 1e-6 of JAX's."""
    kw = dict(lr=0.05, weight_decay=0.1, warmup_steps=2, total_steps=10,
              max_grad_norm=max_grad_norm)
    jopt, opt = JO.AdamW(**kw), AdamW(**kw)
    jp, p = _random_tree(0), _t(_random_tree(0))
    js, s = jopt.init(jp), opt.init(p)
    for i in range(3):
        g = _random_tree(10 + i)
        jp, js, jm = jopt.update(g, js, jp)
        p, s, m = opt.update(_t(g), s, p)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-6)
        for tree, jtree in ((p, jp), (s.m, js.m), (s.v, js.v)):
            for path, a, b in _pairs(tree, jtree):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-7,
                                           err_msg=path)
    assert s.step == int(js.step) == 3


def test_grad_clipping():
    opt = AdamW(lr=1e-3, max_grad_norm=1.0)
    p = {"w": torch.ones(4)}
    g = {"w": torch.full((4,), 100.0)}
    _, _, metrics = opt.update(g, opt.init(p), p)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0, rel=1e-3)
    _, _, jm = JO.AdamW(lr=1e-3, max_grad_norm=1.0).update(
        {"w": jnp.full((4,), 100.0)}, JO.AdamW().init({"w": jnp.ones(4)}),
        {"w": jnp.ones(4)})
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)


def test_lr_schedule_warmup_and_decay():
    opt = AdamW(lr=1.0, warmup_steps=10, total_steps=100)
    assert opt.schedule(0) < opt.schedule(9)
    assert opt.schedule(9) == pytest.approx(1.0, rel=0.2)
    assert opt.schedule(99) < 0.2
    jopt = JO.AdamW(lr=1.0, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(opt.schedule(step),
                                   float(jopt.schedule(jnp.int32(step))),
                                   rtol=1e-6)


# --------------------------------------------------------------------------
# the loss
# --------------------------------------------------------------------------
def test_chunked_ce_matches_direct_and_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 32, 100), np.float32)
    labels = rng.integers(0, 100, (2, 32)).astype(np.int32)
    labels[0, :5] = -1                                 # masked positions
    lg = torch.tensor(logits, requires_grad=True)
    lb = torch.tensor(labels).long()
    chunked = _chunked_ce(lg, lb, n_chunks=4)
    keep = lb >= 0
    direct = -torch.log_softmax(lg, -1).gather(
        -1, lb.clamp(min=0)[..., None])[..., 0][keep].mean()
    np.testing.assert_allclose(float(chunked), float(direct), rtol=1e-6)
    jchunked = JT._chunked_ce(jnp.asarray(logits), jnp.asarray(labels), 4)
    np.testing.assert_allclose(float(chunked), float(jchunked), rtol=1e-6)
    (g,) = torch.autograd.grad(chunked, lg)
    jg = jax.grad(lambda x: JT._chunked_ce(x, jnp.asarray(labels), 4))(
        jnp.asarray(logits))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-6)
    (g2,) = torch.autograd.grad(direct, lg)
    np.testing.assert_allclose(g.numpy(), g2.numpy(), atol=1e-6)


def test_chunked_ce_chunk_count_halves_until_it_divides():
    """S 24: 16 chunks halve to 8 (3 tokens each), as in JAX."""
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((1, 24, 10), np.float32)
    labels = rng.integers(0, 10, (1, 24)).astype(np.int32)
    got = _chunked_ce(torch.tensor(logits), torch.tensor(labels).long())
    want = JT._chunked_ce(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _jax_loss_grads(japi, jparams, batch, aux_weight, remat=False):
    def f(p):
        return JT.lm_loss(japi, p, batch, remat=remat, aux_weight=aux_weight)
    (total, metrics), grads = jax.value_and_grad(f, has_aux=True)(jparams)
    return total, metrics, grads


@pytest.mark.parametrize("name", LM_MODELS)
def test_lm_loss_and_every_gradient_match_jax(models, name):
    """``lm_loss`` (the experts' aux loss included, at the JAX test's
    weight 0.5 for the experts) and the gradient of every parameter leaf
    against JAX's, on a pipeline batch of 2 x 64."""
    cfg, japi, jparams, api, params = models(name)
    aux_weight = 0.5 if cfg.num_experts else 0.01
    jb, tb = _batches(cfg, 1, 2, 64)
    jtotal, jm, jgrads = _jax_loss_grads(japi, jparams, jb[0], aux_weight)
    p = _t(_np_tree(jparams), grad=True)
    total, m = lm_loss(api, p, tb[0], remat=False, aux_weight=aux_weight)
    grads = torch.autograd.grad(total, [x for _, x, _ in _pairs(p, p)])
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    for key in ("loss", "aux_loss", "dropped_fraction"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    if cfg.num_experts:
        assert float(m["aux_loss"]) > 0
    for (path, _, jg), g in zip(_pairs(p, _np_tree(jgrads)), grads):
        scale = max(float(np.abs(jg).max()), 1e-30)
        assert float(np.abs(g.numpy() - jg).max()) <= 1e-5 * scale, path


def test_moe_aux_loss_flows_into_training(models):
    cfg, japi, jparams, api, params = models("phi3.5-moe")
    jb, tb = _batches(cfg, 1, 2, 16)
    total, metrics = lm_loss(api, params, tb[0], remat=False, aux_weight=0.5)
    assert float(total) >= float(metrics["loss"])
    assert float(metrics["aux_loss"]) > 0
    jtotal, _ = JT.lm_loss(japi, jparams, jb[0], remat=False, aux_weight=0.5)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "granite-moe"])
def test_remat_gives_the_same_loss_and_gradients(models, name):
    """Activation checkpointing recomputes the layers in the backward: the
    same loss and the same gradients (bit for bit on the CPU: the same
    ops run again)."""
    cfg, _, jparams, api, _ = models(name)
    _, tb = _batches(cfg, 1, 2, 64)
    out = {}
    for remat in (False, True):
        p = _t(_np_tree(jparams), grad=True)
        out[remat] = loss_and_grads(api, p, tb[0], remat=remat)
    assert float(out[True][0]["loss"]) == float(out[False][0]["loss"])
    for path, a, b in _pairs(out[True][1], out[False][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=path)


def test_five_train_steps_match_jax(models):
    """5 ``train_step``s (remat on, as ``launch.train`` runs them) from
    identical weights and pipeline batches: the losses within rtol 1e-4 of
    JAX's."""
    cfg, japi, jparams, api, _ = models("qwen2-0.5b")
    kw = dict(lr=2e-3, warmup_steps=2, total_steps=20)
    jstep = jax.jit(JT.make_train_step(japi, JO.AdamW(**kw)))
    step = make_train_step(api, AdamW(**kw))
    jb, tb = _batches(cfg, 5, 4, 64, seed=3)
    jp, js = jparams, JO.AdamW(**kw).init(jparams)
    p = _t(_np_tree(jparams), grad=True)
    s = AdamW(**kw).init(p)
    jl, tl = [], []
    for i in range(5):
        jp, js, jm = jstep(jp, js, jb[i])
        p, s, m = step(p, s, tb[i])
        jl.append(float(jm["loss"]))
        tl.append(float(m["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def test_loss_decreases_50_steps(models):
    """The JAX test's run on the port (olmo-1b reduced, 8 x 64, lr 2e-3):
    the loss falls by more than 0.5 and stays finite; the first loss is
    JAX's."""
    cfg, japi, jparams, api, _ = models("olmo-1b")
    opt = AdamW(lr=2e-3, warmup_steps=5, total_steps=100)
    step = make_train_step(api, opt)
    p = _t(_np_tree(jparams), grad=True)
    state = opt.init(p)
    pipe = iter(TokenPipeline(cfg, DataConfig(batch_size=8, seq_len=64),
                              device="cpu"))
    losses = []
    for _ in range(50):
        p, state, m = step(p, state, next(pipe))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5
    assert all(np.isfinite(losses))
    jb = next(iter(JTokenPipeline(jax_config("olmo-1b").reduced(),
                                  JDataConfig(batch_size=8, seq_len=64))))
    _, jm = JT.lm_loss(japi, jparams, jb)
    np.testing.assert_allclose(losses[0], float(jm["loss"]), rtol=1e-5)


def test_eval_step_matches_lm_loss_without_grad(models):
    cfg, japi, jparams, api, params = models("olmo-1b")
    jb, tb = _batches(cfg, 1, 2, 32)
    m = make_eval_step(api)(_t(_np_tree(jparams), grad=True), tb[0])
    assert m["loss"].grad_fn is None
    jm = JT.make_eval_step(japi)(jparams, jb[0])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)


# --------------------------------------------------------------------------
# data, checkpoints, the training entry point
# --------------------------------------------------------------------------
def test_pipeline_determinism_and_shapes():
    cfg = get_config("qwen2-0.5b").reduced()
    p1 = next(iter(TokenPipeline(cfg, DataConfig(4, 32, seed=11), "cpu")))
    p2 = next(iter(TokenPipeline(cfg, DataConfig(4, 32, seed=11), "cpu")))
    assert torch.equal(p1["tokens"], p2["tokens"])
    assert p1["tokens"].shape == (4, 32) and p1["labels"].shape == (4, 32)
    assert p1["tokens"].dtype == torch.int64
    assert int(p1["tokens"].max()) < cfg.vocab_size
    assert torch.equal(p1["tokens"][:, 1:], p1["labels"][:, :-1])


@pytest.mark.parametrize("seed", [0, 11])
def test_pipeline_gives_jax_tokens(seed):
    """The same seed draws the same stream in both packages, batch after
    batch."""
    name = "qwen2-0.5b"
    pipe = iter(TokenPipeline(get_config(name).reduced(),
                              DataConfig(4, 48, seed=seed), "cpu"))
    jpipe = iter(JTokenPipeline(jax_config(name).reduced(),
                                JDataConfig(4, 48, seed=seed)))
    for _ in range(3):
        b, jb = next(pipe), next(jpipe)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(b[key].numpy(),
                                          np.asarray(jb[key]))


def test_pipeline_gives_encoder_models_frames():
    cfg = get_config("whisper-small").reduced()
    batch = next(iter(TokenPipeline(cfg, DataConfig(2, 16), "cpu")))
    assert batch["enc_embeds"].shape == (2, cfg.encoder_seq, cfg.d_model)


def test_checkpoint_roundtrip_nested():
    cfg = get_config("granite-moe").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params["extra"] = {"bf16": torch.randn(3, 5).to(torch.bfloat16),
                       "step": torch.tensor(7, dtype=torch.int32)}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ck.msgpack")
        checkpoint.save(path, params)
        loaded = checkpoint.load(path, params)
    for path, a, b in _pairs(params, loaded):
        assert a.dtype == b.dtype, path
        assert torch.equal(a, b), path


def test_checkpoint_files_are_the_jax_package_files(models):
    """A JAX ``checkpoint.save`` file loads in the port, and the port's
    ``save`` of the same parameters is byte-equal to JAX's (a bfloat16
    leaf too); the port's file is the msgpack map JAX's ``load`` reads."""
    cfg, _, jparams, _, params = models("granite-moe")
    jtree = dict(jparams, extra={"bf16": jnp.arange(6.0).astype(
        jnp.bfloat16).reshape(2, 3)})
    ttree = dict(params, extra={"bf16": torch.arange(6.0).to(
        torch.bfloat16).reshape(2, 3)})
    with tempfile.TemporaryDirectory() as d:
        jpath, tpath = os.path.join(d, "j.msgpack"), os.path.join(d, "t.msgpack")
        jax_checkpoint.save(jpath, jtree)
        checkpoint.save(tpath, ttree)
        jbytes, tbytes = (open(x, "rb").read() for x in (jpath, tpath))
        assert tbytes == jbytes
        loaded = checkpoint.load(jpath, ttree)
        back = jax_checkpoint.load(tpath, jtree)
    for path, a, b in _pairs(loaded, ttree):
        assert torch.equal(a, b), path
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert set(msgpack.unpackb(tbytes)) == {p.lstrip("/") for p, _, _ in
                                            _pairs(ttree, ttree)}


def test_launch_train_runs_on_the_cpu(tmp_path):
    """``launch.train.main`` on ``device="cpu"``: a few steps of the
    reduced model, the losses returned and falling, the checkpoint saved
    and loadable."""
    ckpt = str(tmp_path / "ck.msgpack")
    seen = []
    losses = launch_train.main(
        ["--device", "cpu", "--arch", "olmo-1b", "--steps", "8", "--batch",
         "4", "--seq", "32", "--ckpt", ckpt],
        on_step=lambda i, p, m, s: seen.append((i, float(m["loss"]), s)))
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert [x[1] for x in seen] == losses
    assert losses[-1] < losses[0]
    cfg = get_config("olmo-1b").reduced()
    like = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    loaded = checkpoint.load(ckpt, like)
    assert not torch.equal(loaded["embed"]["embedding"],
                           like["embed"]["embedding"])


def test_launch_train_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("the machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--steps", "1"])


@pytest.mark.parametrize("name", ["mamba2-1.3b", "zamba2-7b",
                                  "whisper-small"])
def test_untrained_families_refuse_training(name):
    """The SSM, hybrid and encoder-decoder forwards raise under autograd
    and with ``remat``, naming what is missing; without grad they run."""
    cfg = get_config(name).reduced()
    api = build_model(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    batch = next(iter(TokenPipeline(cfg, DataConfig(1, 16), "cpu")))
    with pytest.raises(NotImplementedError, match="not ported"):
        api.forward(params, batch, remat=True)
    trainable = {k: v for k, v in params.items()}
    trainable["final_norm"] = {k: v.clone().requires_grad_(True)
                               for k, v in params["final_norm"].items()}
    with pytest.raises(NotImplementedError, match="not ported"):
        api.forward(trainable, batch)
    with torch.no_grad():
        logits, _ = api.forward(trainable, batch)
    assert logits.shape[:2] == (1, 16)
