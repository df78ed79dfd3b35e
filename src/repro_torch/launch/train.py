"""Training entry point of the port: every family (dense,
mixture-of-experts, Mamba2, hybrid, encoder-decoder) on a GPU, or reduced
on the CPU.

  python -m repro_torch.launch.train --arch qwen2-0.5b --full-size \\
      --steps 30 --batch 8 --seq 2048
  python -m repro_torch.launch.train --arch mamba2-1.3b --full-size \\
      --steps 10 --batch 4 --seq 2048 --dtype bfloat16
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch olmo-1b --steps 20 --batch 8 --seq 64

An encoder model's batches carry the pipeline's stub frame embeddings.

The flags are the JAX package's ``launch/train.py``'s, plus ``--device``
(default: the CUDA device), ``--dtype`` (the compute dtype; default the
config's: bfloat16 at full size, float32 reduced), ``--no-remat`` and
``--layers`` (the depth cut to the first N layers).
Parameters are float32 leaves that require grad, drawn from a generator
seeded 0; the step runs the layers in ``--dtype`` and AdamW updates the
float32 leaves in place.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import AdamW, tree_leaves
from repro_torch.training.train_step import make_train_step


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full config (default: reduced smoke size)")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--dtype", default=None,
                    help="compute dtype (default: the config's)")
    ap.add_argument("--no-remat", action="store_true",
                    help="keep every layer's activations for the backward")
    ap.add_argument("--layers", type=int, default=None,
                    help="train only the first N layers (a model whose "
                         "whole depth does not fit the card)")
    return ap


def main(argv=None, on_step=None):
    """Train; returns the losses, one float per step. ``on_step(i, params,
    metrics, seconds)``, when given, runs after each step with the step's
    wall time (the device synchronised)."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = cfg.reduced()
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    api = build_model(cfg, dev)
    params = api.init(torch.Generator(device=dev).manual_seed(0))
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M device={dev} "
          f"dtype={cfg.dtype}", flush=True)

    opt = AdamW(lr=args.lr, warmup_steps=max(10, args.steps // 10),
                total_steps=args.steps)
    step_fn = make_train_step(api, opt, remat=not args.no_remat)
    state = opt.init(params)
    pipe = iter(TokenPipeline(cfg, DataConfig(args.batch, args.seq), dev))

    losses = []
    t0 = time.time()
    for i in range(args.steps):
        ts = time.perf_counter()
        params, state, m = step_fn(params, state, next(pipe))
        losses.append(float(m["loss"]))         # synchronises the device
        step_s = time.perf_counter() - ts
        if on_step is not None:
            on_step(i, params, m, step_s)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss={losses[-1]:.4f} "
                  f"gnorm={float(m['grad_norm']):.3f} "
                  f"lr={float(m['lr']):.2e} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)
    if args.ckpt:
        checkpoint.save(args.ckpt, params)
        print(f"saved checkpoint to {args.ckpt}", flush=True)
    return losses


if __name__ == "__main__":
    main()
