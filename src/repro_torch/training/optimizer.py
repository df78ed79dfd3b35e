"""AdamW over the port's nested dictionaries of tensors: the JAX package's
``training/optimizer.py`` with the same fields, defaults and arithmetic.

The math is the JAX package's, step for step: a global-norm clip with
``+1e-12`` under the square root; float32 moments; the bias corrections
from the incremented step while the learning rate is the schedule's at
the old step; decoupled weight decay on leaves with ``ndim >= 2`` only;
the update computed in float32 and cast back to the leaf's dtype.

Unlike the JAX package, which returns new trees, ``update`` writes the
moments and the parameters IN PLACE under ``torch.no_grad()`` and returns
the same tensors, so a full-width model holds one copy of each (the
caller's parameter leaves keep their ``requires_grad``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch


class AdamWState(NamedTuple):
    step: int
    m: Any
    v: Any


def flatten(tree, path=()):
    """(key path, leaf) pairs of a nested dictionary, keys sorted at every
    level: the order ``jax.tree_util`` flattens dictionaries in. The
    optimizer, the gradient tree and the checkpoint's keys all use it."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k], path + (k,))]
    return [(path, tree)]


def unflatten(pairs):
    """The nested dictionary of (key path, leaf) pairs."""
    tree = {}
    for path, x in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return tree


def tree_leaves(tree):
    """The leaves of a nested dictionary in ``flatten``'s order."""
    return [x for _, x in flatten(tree)]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    max_grad_norm: float = 1.0

    def init(self, params) -> AdamWState:
        pairs = flatten(params)
        return AdamWState(0, unflatten((k, self._zeros(x)) for k, x in pairs),
                          unflatten((k, self._zeros(x)) for k, x in pairs))

    @staticmethod
    def _zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def schedule(self, step) -> float:
        """The learning rate at ``step``: linear warm-up, then a cosine to
        a tenth, in float32 as the JAX package computes it."""
        f32 = np.float32
        step = f32(int(step))
        warm = min(f32(1.0), (step + f32(1)) / f32(max(1, self.warmup_steps)))
        prog = np.clip((step - f32(self.warmup_steps))
                       / f32(max(1, self.total_steps - self.warmup_steps)),
                       f32(0.0), f32(1.0))
        cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * prog))
        return float(f32(self.lr) * warm * (f32(0.1) + f32(0.9) * cos))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """One step: (params, new state, {"grad_norm", "lr"}), the metrics
        as float32 0-d tensors on the parameters' device."""
        gl, pl = tree_leaves(grads), tree_leaves(params)
        ml, vl = tree_leaves(state.m), tree_leaves(state.v)
        dev = pl[0].device
        sq = sum(torch.sum(torch.square(g.float())) for g in gl)
        gnorm = torch.sqrt(sq + 1e-12)
        scale = torch.clamp(self.max_grad_norm / gnorm, max=1.0)

        step = state.step + 1
        lr = self.schedule(state.step)
        bc1 = float(1 - np.float32(self.b1) ** np.float32(step))
        bc2 = float(1 - np.float32(self.b2) ** np.float32(step))
        for p, g, m, v in zip(pl, gl, ml, vl):
            g = g.float() * scale
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            pf = p.float()
            if p.dim() >= 2:
                delta = delta + self.weight_decay * pf
            p.copy_((pf - lr * delta).to(p.dtype))
        metrics = {"grad_norm": gnorm.to(dev),
                   "lr": torch.tensor(lr, dtype=torch.float32, device=dev)}
        return params, AdamWState(step, state.m, state.v), metrics
