"""The port's dry run (``repro_torch.launch.dryrun``) and its trace
analysis (``launch.trace_analysis``), on the CPU at reduced size.

``run_one`` runs a reduced olmo-1b step (train, prefill, decode) on the
card's 1×1 mesh and on a fake 2×4 mesh (a ``fake`` process group of 8
ranks, created and destroyed inside ``run_one``): its argument bytes are
the local shards' sum; a prefill's flop count is the hand count of its
matmuls; a known redistribute gives the expected collective bytes; and
the argument bytes equal the JAX package's ``memory_summary`` of the same
steps compiled on a 2×4 mesh of 8 forced host devices (a subprocess).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import dryrun, roofline_report  # noqa: E402
from repro_torch.launch import trace_analysis as TA  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.utils import sharding as TS  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
SHAPES = {"train": InputShape("train_4k", 128, 4, "train"),
          "prefill": InputShape("prefill_32k", 64, 2, "prefill"),
          "decode": InputShape("decode_32k", 256, 8, "decode")}


@pytest.fixture
def reduced(monkeypatch):
    """run_one over reduced configs, the small SHAPES, and a 2×4 mesh."""
    orig = dryrun.get_config
    monkeypatch.setattr(dryrun, "get_config", lambda n: orig(n).reduced())
    by_name = {s.name: s for s in SHAPES.values()}
    orig_shape = dryrun.get_shape
    monkeypatch.setattr(dryrun, "get_shape",
                        lambda n: by_name.get(n) or orig_shape(n))
    monkeypatch.setitem(dryrun.MESHES, "2x4", ((2, 4), ("data", "model")))


def _local_bytes(metas, specs, mesh):
    if isinstance(metas, torch.Tensor):
        n = int(np.prod(TS.local_shape(tuple(metas.shape), specs, mesh)))
        return n * metas.element_size()
    return sum(_local_bytes(metas[k], specs[k], mesh) for k in metas)


def _expected_argument_bytes(kind, mesh):
    cfg = get_config("olmo-1b").reduced()
    api = build_model(cfg, device="cpu")
    shape = SHAPES[kind]
    ps = api.param_specs(mesh)
    total = _local_bytes(api.input_specs(shape),
                         api.input_shardings(shape, mesh), mesh)
    if kind == "train":
        return total + 3 * _local_bytes(api.abstract_params(), ps, mesh)
    total += _local_bytes(api.abstract_params(cfg.dtype), ps, mesh)
    if kind == "decode":
        clen = dryrun.cache_len_for(cfg, shape)
        total += _local_bytes(api.abstract_cache(shape.global_batch, clen),
                              api.cache_specs(mesh, shape.global_batch,
                                              clen), mesh)
    return total


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    return {}


@pytest.mark.parametrize("mesh", ["card", "2x4"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_run_one_argument_bytes_are_the_local_shards(reduced, records,
                                                     tmp_path, mesh, kind):
    rec = dryrun.run_one("olmo-1b", SHAPES[kind].name, mesh, str(tmp_path),
                         verbose=False)
    assert rec["ok"], rec.get("traceback")
    assert rec["route"] == "plain" and rec["kind"] == kind
    shape, axes = dryrun.MESHES[mesh]
    m = TS.MeshShape(axes, shape)
    assert rec["memory"]["argument_size_in_bytes"] == \
        _expected_argument_bytes(kind, m)
    assert rec["n_devices"] == int(np.prod(shape))
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["fits"] is True
    with open(tmp_path / f"olmo-1b__{SHAPES[kind].name}__{mesh}.json") as f:
        assert json.load(f)["ok"]
    records[(kind, mesh)] = rec
    if mesh == "card":
        assert sum(rec["collective_counts"].values()) == 0


def test_sharding_splits_the_work(reduced, records, tmp_path):
    """On 2×4 a device holds less and computes less than the card."""
    for kind in ("train", "prefill", "decode"):
        for mesh in ("card", "2x4"):
            if (kind, mesh) not in records:
                records[(kind, mesh)] = dryrun.run_one(
                    "olmo-1b", SHAPES[kind].name, mesh, str(tmp_path),
                    verbose=False)
        one, many = records[(kind, "card")], records[(kind, "2x4")]
        assert many["memory"]["argument_size_in_bytes"] < \
            one["memory"]["argument_size_in_bytes"]
        assert many["flops_per_device"] < one["flops_per_device"]
        assert sum(many["collective_counts"].values()) > 0


def test_prefill_flops_are_the_hand_count(reduced, tmp_path):
    """FlopCounterMode's formulas over a reduced dense prefill on the
    card: the matmuls of every layer (q/k/v, the plain attention's full
    S × S scores and weighted values, the output projection, the three
    MLP products) and the last position's unembedding."""
    cfg = get_config("olmo-1b").reduced()
    s = SHAPES["prefill"]
    b, n = s.global_batch, s.seq_len
    d, h, kv, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.resolved_head_dim, cfg.d_ff)
    per_layer = (2 * b * n * d * (h + 2 * kv) * hd
                 + 2 * 2 * b * h * n * n * hd
                 + 2 * b * n * h * hd * d
                 + 3 * 2 * b * n * d * ff)
    want = cfg.num_layers * per_layer + 2 * b * d * cfg.padded_vocab
    rec = dryrun.run_one("olmo-1b", s.name, "card", str(tmp_path),
                         verbose=False)
    assert rec["flops_per_device"] == want


def test_collective_stats_of_known_redistributes():
    """Gathering a model-sharded (8, 16) float32 tensor is one all-gather
    of its whole 512 bytes on a device; a partial sum made whole is one
    all-reduce of its local 512 bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.device_mesh import init_device_mesh
    with dryrun.fake_group(8):
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        with fake:
            a = torch.empty(8, 4)
            p = torch.empty(8, 16)
        x = DTensor.from_local(a, mesh, [Replicate(), Shard(1)],
                               run_check=False)
        y = DTensor.from_local(p, mesh, [Replicate(), Partial()],
                               run_check=False)
        with TA.trace_modes(fake) as (comm, cost):
            x.redistribute(mesh, [Replicate(), Replicate()])
            y.redistribute(mesh, [Replicate(), Replicate()])
        stats = TA.collective_stats(comm)
    assert stats.count_by_kind["all-gather"] == 1
    assert stats.bytes_by_kind["all-gather"] == 8 * 16 * 4
    assert stats.count_by_kind["all-reduce"] == 1
    assert stats.bytes_by_kind["all-reduce"] == 8 * 16 * 4
    assert stats.total_bytes == stats.ar_bytes == 2 * 512
    assert stats.a2a_bytes == 0


JAX_MEMORY = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro.configs import get_config
    from repro.configs.base import InputShape
    from repro.launch import hlo_analysis
    from repro.models.registry import build_model

    SHAPES = {shapes!r}
    cfg = get_config("olmo-1b").reduced()
    api = build_model(cfg)
    import numpy as np
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    named = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t)
    out = {{}}
    for kind, (name, seq, batch) in SHAPES.items():
        shape = InputShape(name, seq, batch, kind)
        params = api.abstract_params(jnp.dtype(cfg.dtype))
        psh = named(api.param_specs(mesh))
        bsd = api.input_specs(shape)
        bsh = named(api.input_shardings(shape, mesh))
        if kind == "prefill":
            fn = lambda p, b: api.prefill(p, b, seq)
            args, sh = (params, bsd), (psh, bsh)
        else:
            cache = api.abstract_cache(batch, seq)
            csh = named(api.cache_specs(mesh, batch, seq))
            fn = lambda p, t, c: api.decode_step(p, t, c)
            args, sh = (params, bsd["token"], cache), (psh, bsh["token"], csh)
        with mesh:
            compiled = jax.jit(fn, in_shardings=sh).lower(*args).compile()
        out[kind] = hlo_analysis.memory_summary(compiled)
    print(json.dumps(out))
""")


def test_argument_bytes_equal_jax_memory_summary(reduced, tmp_path):
    """The JAX package's ``memory_analysis`` of the same reduced steps on
    a 2×4 mesh: its argument bytes are the port's, to the byte (the
    port's train state would differ by JAX's 4-byte int32 step counter, a
    host int in the port, so train is not compared here)."""
    shapes = {k: (SHAPES[k].name, SHAPES[k].seq_len, SHAPES[k].global_batch)
              for k in ("prefill", "decode")}
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, "-c",
                          JAX_MEMORY.format(shapes=shapes)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    want = json.loads(run.stdout.strip().splitlines()[-1])
    for kind in ("prefill", "decode"):
        rec = dryrun.run_one("olmo-1b", SHAPES[kind].name, "2x4",
                             str(tmp_path), verbose=False)
        assert rec["memory"]["argument_size_in_bytes"] == \
            want[kind]["argument_size_in_bytes"], kind


def test_long_500k_whisper_is_skipped_as_in_jax(tmp_path):
    from repro.configs import get_config as jax_config
    from repro.configs import get_shape as jax_shape
    rec = dryrun.run_one("whisper-small", "long_500k", "card", str(tmp_path),
                         verbose=False)
    assert rec["ok"] and "skipped" in rec
    assert dryrun.effective_config(get_config("whisper-small"),
                                   dryrun.get_shape("long_500k")) is None
    jcfg, jshape = jax_config("whisper-small"), jax_shape("long_500k")
    assert jcfg.family == "audio" and jshape.seq_len == 524_288
    olmo = dryrun.effective_config(get_config("olmo-1b"),
                                   dryrun.get_shape("long_500k"))
    assert olmo.sliding_window == dryrun.SLIDING_WINDOW_500K == 8192
    assert dryrun.cache_len_for(olmo, dryrun.get_shape("long_500k")) == 8192


def test_roofline_report_prints_the_table(reduced, tmp_path, capsys):
    dryrun.run_one("olmo-1b", SHAPES["decode"].name, "card", str(tmp_path),
                   verbose=False)
    dryrun.run_one("whisper-small", "long_500k", "card", str(tmp_path),
                   verbose=False)
    roofline_report.main("card", str(tmp_path))
    out = capsys.readouterr().out
    assert "NVLink 4" in out and "InfiniBand" in out
    rows = [r for r in out.splitlines() if r.startswith("| olmo-1b")]
    assert len(rows) == 1 and "ms" in rows[0]
    assert any("skipped" in r for r in out.splitlines()
               if r.startswith("| whisper-small"))


def test_dryrun_main_exits_1_on_a_failure(monkeypatch, tmp_path):
    def boom(*a, **k):
        raise RuntimeError("no")
    monkeypatch.setattr(dryrun, "prepare", boom)
    assert dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k",
                        "--mesh", "card", "--out", str(tmp_path)]) == 1
    rec = json.load(open(tmp_path / "olmo-1b__decode_32k__card.json"))
    assert rec["ok"] is False and "RuntimeError: no" in rec["error"]
