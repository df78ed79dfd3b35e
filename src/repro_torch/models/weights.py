"""Parameters of the port: random initialisation from the model's
``ParamDef`` plan, and conversion of the JAX package's parameters.

Both return the JAX package's dictionary layout (``embed``, ``layers`` with
every leaf stacked on a leading layer axis, ``final_norm``; the
encoder-decoder family adds ``enc_pos``, ``dec_pos``, ``enc_layers`` and
``enc_final``; the hybrid family adds ``shared_attn``), so a leaf's path
and shape are the same in both packages.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import dtype_of, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import encdec, hybrid, ssm, transformer

# family -> the module that holds its plan (the JAX registry's routing:
# the experts' ``moe`` and chameleon's early-fusion ``vlm`` are the same
# transformer as the dense family)
FAMILY_MODULES = {"dense": transformer, "moe": transformer,
                  "vlm": transformer, "ssm": ssm, "hybrid": hybrid,
                  "audio": encdec}


def plan_of(cfg) -> dict:
    """The parameter plan of ``cfg``'s family."""
    if cfg.family not in FAMILY_MODULES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    return FAMILY_MODULES[cfg.family].plan(cfg)


def _materialize(pd: L.ParamDef, generator, device, dtype):
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=dtype, device=device)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=dtype, device=device)
    x = torch.randn(pd.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * pd.std).to(dtype)


def _init_tree(plan, generator, device, dtype):
    if isinstance(plan, L.ParamDef):
        return _materialize(plan, generator, device, dtype)
    return {k: _init_tree(v, generator, device, dtype)
            for k, v in sorted(plan.items())}


def init_params(cfg, generator: torch.Generator, device=None,
                dtype=torch.float32):
    """Random parameters following the family's plan: normal with
    std 0.02, ones or zeros, as each ``ParamDef`` says. ``generator`` must
    live on ``device`` (default: the CUDA device; raises where there is
    none unless ``device="cpu"`` is passed)."""
    dev = resolve_device(device)
    return _init_tree(plan_of(cfg), generator, dev, dtype_of(dtype))


def params_from_numpy(cfg, tree: Any, device=None):
    """Convert the JAX package's ``api.init(...)`` parameters — the same
    nested dictionaries with numpy arrays (``np.asarray`` of each leaf) at
    the leaves — into the port's parameters on ``device``. Every leaf of
    the family's plan must be present with the plan's shape."""
    dev = resolve_device(device)

    def convert(plan, sub, path):
        if isinstance(plan, L.ParamDef):
            arr = np.asarray(sub)
            if tuple(arr.shape) != tuple(plan.shape):
                raise ValueError(f"{path}: shape {arr.shape}, plan "
                                 f"{plan.shape}")
            return torch.from_numpy(np.array(arr)).to(dev)
        return {k: convert(v, sub[k], f"{path}/{k}")
                for k, v in plan.items()}

    return convert(plan_of(cfg), tree, "")
