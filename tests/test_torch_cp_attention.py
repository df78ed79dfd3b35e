"""The sequence-sharded branch of the port's ``layers.cp_attention`` against
the JAX package's ``shard_map`` branch, on the CPU.

Two gloo ranks over a ``FileStore`` (each its own process, so no process
group outlives this module) run the port's ``cp_attention`` on DTensors
under a (1, 2) ``("data", "model")`` mesh: q sequence-sharded over
``model``, k and v replicated, each rank's ``flash_attention_vjp`` at its
``q_offset``. A JAX subprocess with two forced host devices runs the JAX
package's ``cp_attention`` on the same numpy inputs under the same mesh
(its ``shard_map`` branch). H 3 (not a multiple of the ``model`` axis),
KV 1, D 16, S 1024, float32: the output and dq, dk, dv (for one cotangent)
agree within 1e-5.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
CASES = {"causal": (True, 0), "window": (True, 300), "full": (False, 0)}
TOL = dict(atol=1e-5, rtol=1e-5)

TORCH_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models import layers as L
    from repro_torch.utils.sharding import use_mesh

    CASES = {cases!r}
    rank, store, inputs, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
        sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    try:
        mesh = init_device_mesh("cpu", (1, 2),
                                mesh_dim_names=("data", "model"))

        class Cfg:
            num_heads = 3

        inp = np.load(inputs)
        rep = [Replicate(), Replicate()]
        res = {{}}
        for name, (causal, window) in CASES.items():
            q, k, v = (distribute_tensor(torch.from_numpy(inp[x]), mesh, rep)
                       .detach().requires_grad_() for x in "qkv")
            with use_mesh(mesh):
                o = L.cp_attention(Cfg, q, k, v, causal=causal,
                                   window=window)
            assert tuple(o.placements) == (Replicate(), Shard(1)), \\
                o.placements
            g = distribute_tensor(torch.from_numpy(inp["g"]), mesh,
                                  o.placements)
            grads = torch.autograd.grad(o, [q, k, v], grad_outputs=g)
            for key, t in zip(("out", "dq", "dk", "dv"), (o,) + grads):
                res[name + "/" + key] = t.full_tensor().detach().numpy()
        if rank == 0:
            np.savez(out, **res)
    finally:
        dist.destroy_process_group()
""")

JAX_SIDE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.models import layers as JL
    from repro.utils.sharding import active_mesh

    CASES = {cases!r}

    class Cfg:
        num_heads = 3

    inp = np.load(sys.argv[1])
    mesh = jax.make_mesh((1, 2), ("data", "model"))
    res = {{}}
    with mesh:
        assert active_mesh() is not None
        for name, (causal, window) in CASES.items():
            def f(q, k, v):
                return JL.cp_attention(Cfg, q, k, v, causal=causal,
                                       window=window)
            o, vjp = jax.vjp(f, *(jnp.asarray(inp[x]) for x in "qkv"))
            # the shard_map branch: q's sequence over "model"
            assert "model" in str(o.sharding.spec), o.sharding
            grads = vjp(jnp.asarray(inp["g"]))
            for key, t in zip(("out", "dq", "dk", "dv"), (o,) + grads):
                res[name + "/" + key] = np.asarray(t)
    np.savez(sys.argv[2], **res)
""")


def _env():
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("cp")
    rng = np.random.default_rng(0)
    shapes = {"q": (2, 1024, 3, 16), "k": (2, 1024, 1, 16),
              "v": (2, 1024, 1, 16), "g": (2, 1024, 3, 16)}
    np.savez(d / "in.npz", **{k: rng.standard_normal(s).astype(np.float32)
                              for k, s in shapes.items()})
    (d / "rank.py").write_text(TORCH_RANK.format(cases=CASES))
    (d / "jax_side.py").write_text(JAX_SIDE.format(cases=CASES))
    env = _env()
    ranks = [subprocess.Popen(
        [sys.executable, str(d / "rank.py"), str(r), str(d / "store"),
         str(d / "in.npz"), str(d / "torch.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in (0, 1)]
    jax_run = subprocess.run(
        [sys.executable, str(d / "jax_side.py"), str(d / "in.npz"),
         str(d / "jax.npz")], env=env, capture_output=True, text=True,
        timeout=300)
    logs = [p.communicate(timeout=300)[0].decode() for p in ranks]
    for p, log in zip(ranks, logs):
        assert p.returncode == 0, log[-3000:]
    assert jax_run.returncode == 0, jax_run.stderr[-3000:]
    return np.load(d / "torch.npz"), np.load(d / "jax.npz")


@pytest.mark.parametrize("key", ["out", "dq", "dk", "dv"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_cp_attention_matches_jax_shard_map(results, case, key):
    got, want = results
    np.testing.assert_allclose(got[f"{case}/{key}"], want[f"{case}/{key}"],
                               **TOL)


def test_q_offset_slices_of_the_plain_route_tile_the_whole_attention():
    """What each rank computes: two ``flash_attention_vjp`` calls at
    offsets 0 and S/2 give the unsharded call's output, and their dk, dv
    sum to its dk, dv."""
    from repro_torch.kernels import flash_vjp
    rng = np.random.default_rng(1)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((1, 256, 4, 16), (1, 256, 2, 16),
                            (1, 256, 2, 16), (1, 256, 4, 16)))
    kw = dict(causal=True, window=100, chunk_q=64, chunk_k=64)

    def run(qs, off):
        qs = qs.detach().requires_grad_()
        kk, vv = k.detach().requires_grad_(), v.detach().requires_grad_()
        o = flash_vjp.flash_attention_vjp(qs, kk, vv, q_offset=off, **kw)
        return (o,) + torch.autograd.grad(o, [qs, kk, vv],
                                          grad_outputs=g[:, off:off + 128]
                                          if qs.shape[1] == 128 else g)

    whole = run(q, 0)
    halves = [run(q[:, o:o + 128], o) for o in (0, 128)]
    # the halves' float32 products reduce in another order than the
    # whole's (BLAS blocks by the operands' row count): 1e-4, not 1e-5
    tol = dict(atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(torch.cat([h[0] for h in halves], 1),
                               whole[0], **tol)
    torch.testing.assert_close(torch.cat([h[1] for h in halves], 1),
                               whole[1], **tol)
    for i in (2, 3):
        torch.testing.assert_close(halves[0][i] + halves[1][i], whole[i],
                                   **tol)
