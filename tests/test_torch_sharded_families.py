"""The port's sharded steps of the expert, Mamba2 and encoder-decoder
families against the JAX package, on real tensors on the CPU.

Four gloo ranks over a ``FileStore`` (each its own process, so no process
group outlives this module) run reduced float32 steps on DTensors under a
(2, 2) ``("data", "model")`` mesh, their parameters placed by
``ModelAPI.param_specs``: granite-moe's dispatch (2 x 256 tokens, one
group per batch row, and two single groups: 2 x 64 tokens and a decode
step of 64 rows; at a capacity factor of 0.5, so that each drops), its
prefill at S 256 and a decode step; mamba2-1.3b's
prefill (the SSD scan per (batch, head) shard); whisper-small's prefill
and decode step (cross-attention lengths laid out as the batch); and one
``loss_and_grads`` of each of the three on a data-sharded batch. The JAX
package runs the same functions unsharded on the same numpy weights
(``params_from_numpy``), in this process. Outputs, losses and every
gradient leaf agree within 1e-5 (a gradient at the scale of its leaf, as
``tests/test_torch_training.py`` holds it); the dispatch's expert indices
and drop masks are equal.

About 100 s in one process on the CPU (the JAX side's jit and four
torch processes).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.registry import build_model as jax_build  # noqa: E402
from repro.training import train_step as JT  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
MODELS = ("granite-moe", "mamba2-1.3b", "whisper-small")
# (batch, seq) of each step; a dispatch group per batch row needs S >= 256
PREFILL = {"granite-moe": (2, 256), "mamba2-1.3b": (2, 128),
           "whisper-small": (2, 12)}
TRAIN = {"granite-moe": (2, 256), "mamba2-1.3b": (2, 64),
         "whisper-small": (2, 32)}
DISPATCH = {"rows": (2, 256), "group": (2, 64), "decode": (64, 1)}
# the dispatch cases' capacity factor: low enough that every case drops
DISPATCH_CF = 0.5
CACHE_EXTRA = 8
AUX_WEIGHT = 0.01
TOL = dict(atol=1e-5, rtol=1e-5)

TORCH_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.registry import build_model
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.training.train_step import loss_and_grads
    from repro_torch.utils import sharding
    from repro_torch.utils.sharding import use_mesh

    MODELS, PREFILL, DISPATCH = {models!r}, {prefill!r}, {dispatch!r}
    DISPATCH_CF = {dispatch_cf!r}
    CACHE_EXTRA, AUX_WEIGHT = {cache_extra!r}, {aux_weight!r}
    rank, store, inputs, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
        sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)

    def tree(flat, prefix):
        out = {{}}
        for key, arr in flat.items():
            if not key.startswith(prefix):
                continue
            node = out
            *path, leaf = key[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {{}})
            node[leaf] = arr
        return out

    def place(t, logical=("batch",), grad=False):
        spec = sharding.resolve_spec(logical, tuple(t.shape), mesh)
        x = distribute_tensor(t, mesh, sharding.placements(spec, mesh))
        return x.detach().requires_grad_(grad)

    def placed(params, specs, grad=False):
        if isinstance(params, dict):
            return {{k: placed(v, specs[k], grad) for k, v in params.items()}}
        x = distribute_tensor(params, mesh, sharding.placements(specs, mesh))
        return x.detach().requires_grad_(grad)

    def full(x):
        if isinstance(x, dict):
            return {{k: full(v) for k, v in x.items()}}
        return (x.full_tensor() if isinstance(x, DTensor) else x).detach()

    def save(res, prefix, x):
        if isinstance(x, dict):
            for k, v in x.items():
                save(res, f"{{prefix}}/{{k}}", v)
        else:
            res[prefix] = full(x).numpy()

    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        inp = dict(np.load(inputs))
        res = {{}}
        with use_mesh(mesh), implicit_replication():
            for name in MODELS:
                cfg = get_config(name).reduced()
                api = build_model(cfg, device="cpu")
                numpy_params = tree(inp, f"{{name}}/params/")
                specs = api.param_specs(mesh)
                params = placed(params_from_numpy(cfg, numpy_params, "cpu"),
                                specs)
                t = {{k[len(name) + 1:]: torch.from_numpy(v)
                     for k, v in inp.items()
                     if k.startswith(name + "/") and "/params/" not in k}}
                batch = {{"tokens": place(t["tokens"])}}
                if "enc_embeds" in t:
                    batch["enc_embeds"] = place(t["enc_embeds"])
                clen = PREFILL[name][1] + CACHE_EXTRA
                with torch.no_grad():
                    logits, cache = api.prefill(params, batch, clen)
                    save(res, f"{{name}}/prefill/logits", logits)
                    if name == "mamba2-1.3b":
                        save(res, f"{{name}}/prefill/cache", cache)
                    else:
                        logits, _ = api.decode_step(
                            params, place(t["token"]), cache)
                        save(res, f"{{name}}/decode/logits", logits)
                    if name == "granite-moe":
                        lp = {{k: v[0] for k, v in
                              params["layers"]["moe"].items()}}
                        for case in DISPATCH:
                            x = place(t[f"dispatch/{{case}}"],
                                      ("batch", None, "act_embed"))
                            y, _, gate_i, dropped = moe.dispatch(lp, cfg, x,
                                                                 DISPATCH_CF)
                            for k, v in (("y", y), ("gate_i", gate_i),
                                         ("dropped", dropped)):
                                save(res, f"{{name}}/dispatch/{{case}}/{{k}}",
                                     v)
                train = placed(params_from_numpy(cfg, numpy_params, "cpu"),
                               specs, grad=True)
                tb = {{k: place(t["train/" + k]) for k in
                      ("tokens", "labels", "enc_embeds")
                      if "train/" + k in t}}
                metrics, grads = loss_and_grads(api, train, tb, remat=False,
                                                aux_weight=AUX_WEIGHT)
                save(res, f"{{name}}/train/loss", metrics["loss"])
                save(res, f"{{name}}/train/grads", grads)
        if rank == 0:
            np.savez(out, **res)
    finally:
        dist.destroy_process_group()
""")


def _flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}/{k}", out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def _jax_side(rng):
    """(inputs for the ranks, the JAX package's results), both flat dicts
    of numpy arrays keyed by path."""
    inputs, want = {}, {}
    for name in MODELS:
        cfg = jax_config(name).reduced()
        api = jax_build(cfg)
        params = api.init(jax.random.PRNGKey(0))
        _flat(params, f"{name}/params", inputs)
        b, s = PREFILL[name]
        tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        batch = {"tokens": tok}
        if cfg.encoder_layers:
            batch["enc_embeds"] = rng.standard_normal(
                (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        for k, v in batch.items():
            inputs[f"{name}/{k}"] = v
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        logits, cache = api.prefill(params, jbatch, s + CACHE_EXTRA)
        want[f"{name}/prefill/logits"] = np.asarray(logits)
        if name == "mamba2-1.3b":
            _flat(cache, f"{name}/prefill/cache", want)
        else:
            token = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
            inputs[f"{name}/token"] = token
            logits, _ = api.decode_step(params, jnp.asarray(token), cache)
            want[f"{name}/decode/logits"] = np.asarray(logits)
        if name == "granite-moe":
            lp = jax.tree.map(lambda x: x[0], params["layers"]["moe"])
            for case, (db, ds) in DISPATCH.items():
                x = rng.standard_normal((db, ds, cfg.d_model)).astype(
                    np.float32)
                inputs[f"{name}/dispatch/{case}"] = x
                x3 = x if ds >= 256 else x.reshape(1, -1, cfg.d_model)
                cap = jmoe.capacity_for(x3.shape[1], cfg, DISPATCH_CF)
                y, _, gate_i, dropped = jmoe._dispatch(
                    lp, cfg, jnp.asarray(x3), cap)
                for k, v in (("y", y), ("gate_i", gate_i),
                             ("dropped", dropped)):
                    want[f"{name}/dispatch/{case}/{k}"] = np.asarray(v)
        b, s = TRAIN[name]
        tokens = rng.integers(0, cfg.vocab_size, (b, s + 1))
        train = {"tokens": tokens[:, :-1].astype(np.int32),
                 "labels": tokens[:, 1:].astype(np.int32)}
        if cfg.encoder_layers:
            train["enc_embeds"] = rng.standard_normal(
                (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        for k, v in train.items():
            inputs[f"{name}/train/{k}"] = v

        def loss(p):
            return JT.lm_loss(api, p, {k: jnp.asarray(v)
                                       for k, v in train.items()},
                              remat=False, aux_weight=AUX_WEIGHT)
        (_, metrics), grads = jax.value_and_grad(loss, has_aux=True)(params)
        want[f"{name}/train/loss"] = np.asarray(metrics["loss"])
        _flat(grads, f"{name}/train/grads", want)
    return inputs, want


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("families")
    inputs, want = _jax_side(np.random.default_rng(0))
    inputs = {k: v.astype(np.int64) if v.dtype == np.int32 else v
              for k, v in inputs.items()}
    np.savez(d / "in.npz", **inputs)
    (d / "rank.py").write_text(TORCH_RANK.format(
        models=MODELS, prefill=PREFILL, dispatch=DISPATCH,
        dispatch_cf=DISPATCH_CF,
        cache_extra=CACHE_EXTRA, aux_weight=AUX_WEIGHT))
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    ranks = [subprocess.Popen(
        [sys.executable, str(d / "rank.py"), str(r), str(d / "store"),
         str(d / "in.npz"), str(d / "torch.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(4)]
    logs = [p.communicate(timeout=600)[0].decode() for p in ranks]
    for p, log in zip(ranks, logs):
        assert p.returncode == 0, log[-3000:]
    return dict(np.load(d / "torch.npz")), want


def _keys(want, prefix):
    return sorted(k for k in want if k.startswith(prefix))


@pytest.mark.parametrize("name", MODELS)
def test_sharded_prefill_and_decode_match_jax(results, name):
    got, want = results
    keys = _keys(want, f"{name}/prefill/") + _keys(want, f"{name}/decode/")
    assert keys
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_sharded_dispatch_keeps_the_groups_of_jax(results, case):
    """One group per batch row at S 256, one group over every token below:
    the same expert choices and drops as JAX's unsharded dispatch (drops
    occur in each case), and the same combined outputs."""
    got, want = results
    pre = f"granite-moe/dispatch/{case}/"
    np.testing.assert_array_equal(got[pre + "gate_i"].reshape(-1),
                                  want[pre + "gate_i"].reshape(-1))
    np.testing.assert_array_equal(got[pre + "dropped"].reshape(-1),
                                  want[pre + "dropped"].reshape(-1))
    assert want[pre + "dropped"].any(), "no drop: a case without a test"
    np.testing.assert_allclose(got[pre + "y"].reshape(-1),
                               want[pre + "y"].reshape(-1), **TOL)


@pytest.mark.parametrize("name", MODELS)
def test_sharded_loss_and_every_gradient_match_jax(results, name):
    got, want = results
    np.testing.assert_allclose(got[f"{name}/train/loss"],
                               want[f"{name}/train/loss"], rtol=1e-5)
    keys = _keys(want, f"{name}/train/grads/")
    assert keys and sorted(k for k in got if k.startswith(
        f"{name}/train/grads/")) == keys
    for key in keys:
        scale = max(float(np.abs(want[key]).max()), 1e-30)
        assert float(np.abs(got[key] - want[key]).max()) <= 1e-5 * scale, key
