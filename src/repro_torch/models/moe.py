"""Top-k mixture-of-experts with capacity-based scatter dispatch: the JAX
package's ``repro.models.moe`` on tensors.

Each token's top-k choices take slot positions in their experts' buffers
by an exclusive cumsum over expert one-hots, in (token, choice) order with
each token's choices in descending probability. The tokens are scattered
into an ``(experts, capacity, d_model)`` buffer, every expert runs its
capacity rows through one batched matmul per projection, and the outputs
are gathered back and combined with the renormalised gate weights.
Choices past their expert's capacity are dropped: they add nothing, and
the token passes through on the residual path.

Nothing here synchronises with the host, so a dispatch replays inside a
CUDA graph: the capacity is a Python int from the input's shape, the
one-hots name their class count, a dropped choice's scatter lands in a
spare row past the buffer (the JAX package's ``mode="drop"``) and its
gather reads a clamped slot that ``masked_fill`` then zeroes (its
``mode="fill"``). The stages (``_route``, ``_slots``, ``_scatter``,
``_experts``, ``_combine``) are functions of their own, so each can be
timed alone.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamDef
from repro_torch.utils import sharding
from repro_torch.utils.sharding import maybe_constrain

# Default capacity factor; tests may raise it (cf >= E/k guarantees zero
# drops). Read at call time so it is monkeypatch-able.
CAPACITY_FACTOR = 1.25


def moe_plan(cfg) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        # Megatron-style expert tensor-parallelism: the per-expert ffn dim
        # shards, the expert dim stays replicated (the JAX package's rules)
        "router": ParamDef((d, e), ("embed", None)),
        "wi_gate": ParamDef((e, d, ff), (None, "embed", "mlp")),
        "wi_up": ParamDef((e, d, ff), (None, "embed", "mlp")),
        "wo": ParamDef((e, ff, d), (None, "mlp", "embed")),
    }


def capacity_for(tokens: int, cfg, capacity_factor: float = 1.25) -> int:
    c = int(tokens * cfg.experts_per_token * capacity_factor / cfg.num_experts)
    return max(8, -(-c // 8) * 8)          # round up to multiple of 8


def _route(p, x3, k: int):
    """Router, softmax and top-k, in float32: (probs (b, t, e), the
    renormalised gate weights (b, t, k), the expert indices (b, t, k))."""
    logits = x3.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_i = torch.topk(probs, k, dim=-1, sorted=True)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_w, gate_i


def _slots(gate_i, e: int, cap: int):
    """Each (token, choice)'s slot in the expert-major buffer
    (e, b * cap): ``slot`` (b, t*k) clamped into its expert's rows for the
    gather, ``dest`` with every dropped choice sent to the spare row
    e * b * cap, and ``dropped`` (b, t*k)."""
    b = gate_i.shape[0]
    flat_e = gate_i.reshape(b, -1)
    # expert-major one-hots (b, e, tk), so the cumsum runs along the
    # innermost axis (a scan along the middle one is serial per column)
    onehot = F.one_hot(flat_e, num_classes=e).transpose(1, 2).contiguous()
    pos = torch.cumsum(onehot, dim=-1) - onehot                    # exclusive
    flat_pos = torch.gather(pos, 1, flat_e[:, None, :])[:, 0]
    dropped = flat_pos >= cap
    bidx = torch.arange(b, device=gate_i.device)[:, None]
    slot = (flat_e * b + bidx) * cap + torch.clamp(flat_pos, max=cap - 1)
    dest = torch.where(dropped, e * b * cap, slot)
    return slot, dest, dropped


def _scatter(x3, k: int, dest, rows: int):
    """Every (token, choice) written to its slot: (rows, d); the spare
    row past ``rows`` takes the dropped choices."""
    b, t, d = x3.shape
    xk = x3[:, :, None, :].expand(b, t, k, d).reshape(-1, d)
    buffer = x3.new_zeros((rows + 1, d))
    buffer.index_copy_(0, dest.reshape(-1), xk)
    return buffer[:-1]


def _experts(p, buf):
    """Every expert over its capacity rows: buf (e, n, d) -> (e, n, d),
    one batched matmul per projection, silu in float32."""
    dtype = buf.dtype
    g = torch.bmm(buf, p["wi_gate"].to(dtype))
    u = torch.bmm(buf, p["wi_up"].to(dtype))
    h = F.silu(g.float()).to(dtype) * u
    return torch.bmm(h, p["wo"].to(dtype))


def _combine(out, slot, dropped, gate_w):
    """Gather each choice's output back (a dropped one reads zero) and
    sum the top-k with the gate weights, in the compute dtype, as the JAX
    package does: (b, t, d)."""
    b, t, k = gate_w.shape
    d = out.shape[-1]
    y_flat = out.reshape(-1, d).index_select(0, slot.reshape(-1))
    y_flat = y_flat.view(b, t * k, d).masked_fill(dropped[..., None], 0)
    return (y_flat.view(b, t, k, d)
            * gate_w[..., None].to(out.dtype)).sum(dim=2)


def _groups(x3, gate_w, gate_i, wi_gate, wi_up, wo, e: int, cap: int):
    """Slots, scatter, experts and combine of the groups (rows) of x3
    (b, t, d): (y (b, t, d) in the compute dtype, dropped (b, t*k))."""
    b, t, d = x3.shape
    k = gate_i.shape[-1]
    slot, dest, dropped = _slots(gate_i, e, cap)
    buf = _scatter(x3, k, dest, e * b * cap).view(e, b * cap, d)
    out = _experts({"wi_gate": wi_gate, "wi_up": wi_up, "wo": wo}, buf)
    return _combine(out, slot, dropped, gate_w), dropped


def _sharded_dispatch(p, x3, e: int, k: int, cap: int):
    """``_dispatch``'s stages on DTensors, run shard by shard
    (``local_map``): each device routes and dispatches the groups of its
    batch shard (every group where x3's batch does not divide the batch
    axes: the one group of a short input is never split, its capacity and
    drops are the group's) into its own buffer, and runs them through its
    ffn slice of the experts (the weights' ``mlp`` layout), so y is a
    partial sum over the axis that slices the ffn (the JAX package
    constrains its (b, e, cap, d) buffer on "batch" and shards the ffn dim
    alike). Returns (y, probs, gate_i, dropped)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = x3.device_mesh
    rows = sharding.layout(x3, mesh, "batch")
    rep = (Replicate(),) * mesh.ndim
    split = sharding.split_dims(rows)
    probs, gate_w, gate_i = local_map(
        lambda x, router: _route({"router": router}, x, k),
        out_placements=(rows, rows, rows), in_placements=(rows, rep),
        in_grad_placements=(rows, sharding.grad_placements(rep, split)),
        device_mesh=mesh, redistribute_inputs=True)(x3, p["router"])

    ws = (p["wi_gate"], p["wi_up"], p["wo"])
    w_pl = (sharding.layout(ws[0], mesh, None, "embed", "mlp"),
            sharding.layout(ws[1], mesh, None, "embed", "mlp"),
            sharding.layout(ws[2], mesh, None, "mlp", "embed"))
    split = sharding.split_dims(rows, *w_pl)
    ffn = sharding.split_dims(w_pl[2])
    y_pl = tuple(Partial() if i in ffn else pl for i, pl in enumerate(rows))
    in_pl = (rows, rows, rows) + w_pl
    y, dropped = local_map(
        functools.partial(_groups, e=e, cap=cap),
        out_placements=(y_pl, rows), in_placements=in_pl,
        in_grad_placements=tuple(sharding.grad_placements(pl, split)
                                 for pl in in_pl),
        device_mesh=mesh, redistribute_inputs=True)(x3, gate_w, gate_i, *ws)
    return y, probs, gate_i, dropped


def _dispatch(p, cfg, x3, cap: int):
    """Grouped dispatch. x3: (b, t, d) — one dispatch group per batch row.

    Returns (y (b, t, d), probs (b, t, e), gate_i (b, t, k),
    dropped (b, t*k)).
    """
    e, k = cfg.num_experts, cfg.experts_per_token
    if sharding.is_dtensor(x3):
        y, probs, gate_i, dropped = _sharded_dispatch(p, x3, e, k, cap)
    else:
        probs, gate_w, gate_i = _route(p, x3, k)
        y, dropped = _groups(x3, gate_w, gate_i, p["wi_gate"], p["wi_up"],
                             p["wo"], e, cap)
    return y.to(x3.dtype), probs, gate_i, dropped


def dispatch(p, cfg, x, capacity_factor: float = None):
    """``apply_moe``'s dispatch with its routing: (y, probs, gate_i,
    dropped) of the groups that ``x`` dispatches as (see ``apply_moe``)."""
    if capacity_factor is None:
        capacity_factor = CAPACITY_FACTOR
    d = x.shape[-1]
    if x.dim() == 3 and x.shape[1] >= 256:
        # one dispatch group per batch row, capacity from the row's length
        cap = capacity_for(x.shape[1], cfg, capacity_factor)
        x3 = maybe_constrain(x, "batch", None, None)
    else:
        cap = capacity_for(x.numel() // d, cfg, capacity_factor)
        # one group over every token: whole on each device under a mesh
        # (pinned on both sides of the reshape, so its gradient comes back
        # whole too: DTensor cannot view a row-sharded (1, n, d) as x)
        x3 = sharding.replicated(sharding.replicated(x).reshape(1, -1, d))
    return _dispatch(p, cfg, x3, cap)


def apply_moe(p, cfg, x, *, capacity_factor: float = None,
              aux: bool = True):
    """x: (..., d_model) -> (same shape, aux dict; None when ``aux`` is
    False: the serving paths discard it, as the JAX package's do).

    A sequence input (B, S, d) with S >= 256 dispatches per batch row, with
    capacity from S; anything else (a decode step's (B, 1, d) included) is
    one group, with capacity from its total token count.
    """
    e = cfg.num_experts
    y, probs, gate_i, dropped = dispatch(p, cfg, x, capacity_factor)
    if not aux:
        return y.reshape(x.shape).to(x.dtype), None

    # GShard/Switch load-balance auxiliary loss
    me = probs.reshape(-1, e).mean(dim=0)
    ce = F.one_hot(gate_i.reshape(-1, cfg.experts_per_token)[:, 0],
                   num_classes=e).float().mean(dim=0)
    return y.reshape(x.shape).to(x.dtype), {
        "load_balance_loss": e * torch.sum(me * ce),
        "dropped_fraction": dropped.float().mean(),
    }
