"""Seeded weights made on the device, in the type they are served in.

A reference module describes its parameters as a nested dict whose leaves
are ``Leaf``s (shape and how to draw it). ``make`` draws all leaves of one
kind in one call from a ``torch.Generator`` on the device: one ``randn``
per standard deviation, sliced into views, and one ``rand`` per
uniform kind. The same tensors go to the program and to the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Leaf:
    shape: Tuple[int, ...]
    init: str = "normal"        # normal | ones | zeros | a_log | dt_bias
    std: float = 0.02
    lo: float = 0.0             # a_log: A range; dt_bias: dt range
    hi: float = 0.0


def leaves(tree, prefix=()) -> List[Tuple[Tuple[str, ...], Leaf]]:
    if isinstance(tree, Leaf):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(leaves(tree[k], prefix + (k,)))
    return out


def _set(tree: Dict[str, Any], path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _skeleton(layout) -> Dict[str, Any]:
    """The layout's dicts, empty groups kept (a norm without parameters)."""
    return {k: _skeleton(v) for k, v in layout.items()
            if not isinstance(v, Leaf)}


def make(layout, seed: int, device, dtype) -> Dict[str, Any]:
    """The weights of ``layout`` drawn from ``seed``, on ``device`` in
    ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    out = _skeleton(layout)
    flat = leaves(layout)
    groups: Dict[Tuple[str, float], list] = {}
    for path, leaf in flat:
        if leaf.init in ("ones", "zeros"):
            fill = torch.ones if leaf.init == "ones" else torch.zeros
            _set(out, path, fill(leaf.shape, dtype=dtype, device=device))
        else:
            key = (leaf.init, leaf.std if leaf.init == "normal" else 0.0)
            groups.setdefault(key, []).append((path, leaf))
    for (init, std), items in sorted(groups.items()):
        sizes = [math.prod(leaf.shape) for _, leaf in items]
        total = sum(sizes)
        if init == "normal":
            buf = torch.randn(total, generator=gen, dtype=dtype,
                              device=device).mul_(std)
        else:
            u = torch.rand(total, generator=gen, dtype=torch.float32,
                           device=device)
            buf = None
        off = 0
        for (path, leaf), n in zip(items, sizes):
            if init == "normal":
                t = buf[off:off + n].view(leaf.shape)
            elif init == "a_log":
                a = leaf.lo + (leaf.hi - leaf.lo) * u[off:off + n]
                t = torch.log(a).to(dtype).view(leaf.shape)
            elif init == "dt_bias":
                dt = torch.exp(math.log(leaf.lo) + (math.log(leaf.hi)
                               - math.log(leaf.lo)) * u[off:off + n])
                # the inverse of softplus: softplus(dt_bias) = dt
                t = (dt + torch.log(-torch.expm1(-dt))).to(dtype).view(
                    leaf.shape)
            else:
                raise ValueError(f"unknown init {init!r}")
            _set(out, path, t)
            off += n
    return out


def shapes(tree, prefix=()) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """Every tensor's path and shape in a nested dict of tensors (or of
    objects with a ``shape``); empty groups appear as a path to ``None``."""
    if not isinstance(tree, dict):
        return {prefix: tuple(tree.shape)}
    if not tree:
        return {prefix: None}
    out = {}
    for k, v in tree.items():
        out.update(shapes(v, prefix + (k,)))
    return out
