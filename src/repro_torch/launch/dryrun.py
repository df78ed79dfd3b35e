"""Multi-device dry run of the port: prove the distribution config is
coherent, with nothing allocated.

For every (architecture × input shape × mesh) this builds the step at full
width — ``train_step`` (AdamW, remat), ``prefill`` or ``decode_step`` —
makes its parameters, optimizer state, cache and inputs as DTensors of
fake tensors (``FakeTensorMode``: shapes and dtypes, no storage) placed by
the model's logical-axis specs (``ModelAPI.param_specs`` and friends), and
runs it once under the counting modes of ``launch.trace_analysis``. Each
record holds per-device flops and bytes, the collectives, the memory and
whether it fits the card (the JAX package's ``repro.launch.dryrun`` record
schema, one JSON file per case under ``--out``).

Meshes: ``single`` = (16, 16) ``("data", "model")``, ``multi`` = (2, 16,
16) ``("pod", "data", "model")`` — the JAX package's layouts, over a
``fake`` process group of 256 or 512 ranks (rank 0 stands for every
device; the counterpart of ``--xla_force_host_platform_device_count``) —
and ``card``, the one H100 as a 1×1 mesh. The fake tensors live on the
CPU device, so every kernel call takes its plain route (``"route":
"plain"`` in each record): a CUDA kernel needs real pointers.

Run: ``python -m repro_torch.launch.dryrun --arch olmo-1b --shape
decode_32k --mesh card``; ``python -m repro_torch.launch.roofline_report
card`` prints the table of what it wrote.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config, get_shape
from repro_torch.core.hardware import H100, local_gpu
from repro_torch.device import dtype_of
from repro_torch.launch import trace_analysis
from repro_torch.launch.mesh import PRODUCTION
from repro_torch.models import layers as L
from repro_torch.models.registry import build_model
from repro_torch.training.optimizer import AdamW, AdamWState
from repro_torch.training.train_step import make_train_step
from repro_torch.utils.sharding import local_shape, placements, use_mesh

SLIDING_WINDOW_500K = 8192   # sub-quadratic variant for dense archs
MESHES = {"16x16": PRODUCTION[False], "2x16x16": PRODUCTION[True],
          "card": ((1, 1), ("data", "model"))}
MESH_ARGS = {"single": ["16x16"], "multi": ["2x16x16"],
             "both": ["16x16", "2x16x16"], "card": ["card"]}


def effective_config(cfg, shape):
    """long_500k needs sub-quadratic attention: dense/vlm archs run the
    sliding-window variant; ssm/hybrid run natively; whisper skips."""
    if shape.name == "long_500k":
        if cfg.family == "audio":
            return None
        if cfg.family in ("dense", "moe", "vlm"):
            return dataclasses.replace(cfg, sliding_window=SLIDING_WINDOW_500K)
    return cfg


def cache_len_for(cfg, shape) -> int:
    if cfg.sliding_window:
        return min(shape.seq_len, cfg.sliding_window)
    return shape.seq_len


@contextlib.contextmanager
def fake_group(world_size: int):
    """A ``fake`` default process group of ``world_size`` ranks (this
    process is rank 0), destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(name: str):
    """The named mesh over the default group, on the CPU device."""
    shape, axes = MESHES[name]
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


class Placer:
    """Makes DTensors of fake local shards, placed by specs on ``mesh``,
    and keeps the local shards (the step's arguments)."""

    def __init__(self, fake_mode, mesh):
        self.fake_mode, self.mesh = fake_mode, mesh
        self.tensors = []

    def leaf(self, shape, spec, dtype, requires_grad=False):
        with self.fake_mode:
            t = torch.empty(local_shape(shape, spec, self.mesh), dtype=dtype)
        self.tensors.append(t)
        x = DTensor.from_local(t, self.mesh, placements(spec, self.mesh),
                               run_check=False)
        return x.requires_grad_() if requires_grad else x

    def tree(self, metas, specs, requires_grad=False):
        if isinstance(metas, torch.Tensor):
            return self.leaf(tuple(metas.shape), specs, metas.dtype,
                             requires_grad)
        return {k: self.tree(v, specs[k], requires_grad)
                for k, v in metas.items()}


def prepare(cfg, shape, mesh, placer: Placer):
    """(step, args): the step function and its placed arguments."""
    api = build_model(cfg, device="cpu")
    pspecs = api.param_specs(mesh)
    batch = placer.tree(api.input_specs(shape),
                        api.input_shardings(shape, mesh))

    if shape.kind == "train":
        params = placer.tree(api.abstract_params(torch.float32), pspecs,
                             requires_grad=True)
        moments = api.abstract_params(torch.float32)
        opt_state = AdamWState(0, placer.tree(moments, pspecs),
                               placer.tree(moments, pspecs))
        step = make_train_step(api, AdamW(), remat=True)
        return step, (params, opt_state, batch)

    params = placer.tree(api.abstract_params(dtype_of(cfg.dtype)), pspecs)
    clen = cache_len_for(cfg, shape)
    if shape.kind == "prefill":
        def fn(p, batch):
            with torch.no_grad():
                return api.prefill(p, batch, clen)
        return fn, (params, batch)

    # decode: ONE new token against a seq_len-sized cache
    cache = placer.tree(api.abstract_cache(shape.global_batch, clen),
                        api.cache_specs(mesh, shape.global_batch, clen))

    def fn(p, token, cache):
        with torch.no_grad():
            return api.decode_step(p, token, cache)
    return fn, (params, batch["token"], cache)


def hbm_bytes() -> float:
    """The card's memory where there is one, else the H100's data sheet."""
    return local_gpu().hbm_bytes if torch.cuda.is_available() \
        else H100.hbm_bytes


def run_one(arch: str, shape_name: str, mesh_name: str, out_dir: str,
            verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    rec = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
           "kind": shape.kind, "route": "plain", "ok": False}
    eff = effective_config(cfg, shape)
    if eff is None:
        rec.update(ok=True, skipped="full-attention enc-dec: 500k decode "
                   "outside model family (DESIGN.md §4)")
        _save(rec, out_dir)
        return rec
    dims, _ = MESHES[mesh_name]
    n_dev = 1
    for d in dims:
        n_dev *= d
    try:
        with fake_group(n_dev):
            mesh = make_mesh(mesh_name)
            fake = FakeTensorMode(allow_non_fake_inputs=True)
            placer = Placer(fake, mesh)
            t0 = time.time()
            fn, args = prepare(eff, shape, mesh, placer)
            t_build = time.time() - t0
            with use_mesh(mesh), implicit_replication(), \
                    trace_analysis.trace_modes(fake) as (comm, cost):
                cost.add_arguments(placer.tensors)
                out = fn(*args)
                mem = trace_analysis.memory_summary(cost, out)
            t_trace = time.time() - t0 - t_build
        costs = trace_analysis.cost_summary(cost)
        colls = trace_analysis.collective_stats(comm)
        rec.update(
            ok=True,
            build_s=round(t_build, 2),
            trace_s=round(t_trace, 2),
            flops_per_device=costs["flops"],
            bytes_per_device=costs["bytes_accessed"],
            memory=mem,
            collective_bytes=colls.bytes_by_kind,
            collective_counts=colls.count_by_kind,
            sliding_window=eff.sliding_window,
            n_devices=n_dev,
            hbm_bytes=hbm_bytes(),
            fits=mem["total_per_device"] <= hbm_bytes(),
        )
        if verbose:
            print(f"  mem/device = {mem['total_per_device']/1e9:.2f} GB, "
                  f"flops = {costs['flops']:.3g}, "
                  f"coll = {colls.total_bytes/1e6:.1f} MB "
                  f"(build {t_build:.1f}s trace {t_trace:.1f}s)")
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"  FAILED: {rec['error'][:300]}")
    finally:
        L.clear_caches()     # what the trace cached holds fake tensors
    _save(rec, out_dir)
    return rec


def _save(rec: dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=float)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all' (see repro_torch.configs.ARCHS)")
    ap.add_argument("--shape", default="all",
                    help="input-shape id or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "card"])
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mesh in MESH_ARGS[args.mesh]:
                print(f"[dryrun] {arch} × {shape} × {mesh}", flush=True)
                rec = run_one(arch, shape, mesh, args.out)
                n_fail += 0 if rec["ok"] else 1
    print(f"[dryrun] done, failures: {n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
