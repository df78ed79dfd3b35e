"""Mamba2 (SSD — state-space duality) decoder, attention-free: the serving
entry points of the JAX package's ``repro.models.ssm`` — the
full-sequence ``forward``, the padded ``prefill``, the packed ragged
``prefill_packed`` of slot admission and ``decode_step`` — with the same
block plumbing: gated in-projection, a shared causal depthwise conv over
(x, B, C), dt softplus, the SSD scan, gated RMSNorm and out-projection.

The scan goes through ``repro_torch.kernels.ops.ssd``: the hand-written
CUDA kernel for tensors on a GPU, the JAX CPU path's chunked arithmetic
for tensors on the CPU. A decode step is the recurrent update
(``ops.ssd_decode``), elementwise work and a mat-vec in plain PyTorch.

Parameters are the JAX package's dictionary layout (every ``layers`` leaf
stacked on a leading layer axis); layers run as a Python loop over that
axis. ``prepare_params`` adds ``layers["prep"]``: the weights a block
derives from its parameters (float32 copies, ``A = -exp(A_log)``, the
concatenated conv weight), made once per parameter set instead of at every
step; a block without it derives them itself, by the same function, so
the values are the same bit for bit. The cache is per sequence and O(1) in its length: ``ssm`` (layers,
B, H, N, P) float32, ``conv`` (layers, B, W-1, d_inner + 2N) raw
(pre-conv) inputs, ``pos`` (B,) int32 — nothing to page. Every entry
point returns fresh cache tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import dtype_of
from repro_torch.kernels import ops
from repro_torch.models import layers as L

# the SSD state is O(1) per sequence: there is nothing to page, and the
# engine keeps per-slot state
PAGED_KEYS = ()


# --------------------------------------------------------------------------
# plans
# --------------------------------------------------------------------------
def mamba_layer_plan(cfg) -> dict:
    d, di, n, h, w = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_conv_width)
    return {
        "norm": L.norm_plan(d, cfg.norm),
        "wz": L.ParamDef((d, di)),
        "wx": L.ParamDef((d, di)),
        "wB": L.ParamDef((d, n)),
        "wC": L.ParamDef((d, n)),
        "wdt": L.ParamDef((d, h)),
        "dt_bias": L.ParamDef((h,), "zeros"),
        "A_log": L.ParamDef((h,), "zeros"),          # A = -exp(A_log)
        "D": L.ParamDef((h,), "ones"),
        "conv_x": L.ParamDef((w, di), std=0.2),
        "conv_B": L.ParamDef((w, n), std=0.2),
        "conv_C": L.ParamDef((w, n), std=0.2),
        "gate_norm": {"scale": L.ParamDef((di,), "ones")},
        "wo": L.ParamDef((di, d)),
    }


def plan(cfg) -> dict:
    return {
        "embed": L.embed_plan(cfg),
        "layers": L.stack_plan(mamba_layer_plan(cfg), cfg.num_layers),
        "final_norm": L.norm_plan(cfg.d_model, cfg.norm),
    }


# --------------------------------------------------------------------------
# block internals
# --------------------------------------------------------------------------
def _causal_conv(x, w):
    """Depthwise causal conv. x: (B, S, C); w: (W, C)."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = 0
    for i in range(width):
        out = out + xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
    return out


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _derive(lp, dtype) -> dict:
    """The weights a block derives from its layer's parameters ``lp``:
    float32 ``wdt``, ``dt_bias`` and gate-norm scale, ``a`` =
    -exp(A_log), and the conv weight (W, di + 2N) in ``dtype``."""
    return {"wdt": lp["wdt"].float(), "dt_bias": lp["dt_bias"].float(),
            "a": -torch.exp(lp["A_log"].float()),
            "gate_scale": lp["gate_norm"]["scale"].float(),
            "conv_w": torch.cat([lp["conv_x"], lp["conv_B"], lp["conv_C"]],
                                dim=-1).to(dtype)}


def prepare_params(params, cfg):
    """``params`` with ``layers["prep"]`` (re)derived from its leaves on
    their device, in the config's activation type: what the blocks would
    otherwise derive at every call. Derived layer by layer, at the shapes
    a block derives them (a CPU ``exp`` may round a vector's tail apart
    from its body), then stacked."""
    layers = {k: v for k, v in params["layers"].items() if k != "prep"}
    per = [_derive(L.layer_params(layers, i), dtype_of(cfg.dtype))
           for i in range(cfg.num_layers)]
    layers["prep"] = {k: torch.stack([p[k] for p in per]) for k in per[0]}
    return dict(params, layers=layers)


def _prep(lp, dtype) -> dict:
    """The layer's derived weights: prepared, or derived now."""
    return lp["prep"] if "prep" in lp else _derive(lp, dtype)


def _proj_in(lp, prep, xin):
    z = xin @ lp["wz"].to(xin.dtype)
    xr = xin @ lp["wx"].to(xin.dtype)
    bc = xin @ lp["wB"].to(xin.dtype)
    cc = xin @ lp["wC"].to(xin.dtype)
    dt = _softplus(xin.float() @ prep["wdt"] + prep["dt_bias"])
    return z, xr, bc, cc, dt


def _gate_out(lp, prep, y, z, dtype):
    g = y.float() * F.silu(z.float())
    g = g * torch.rsqrt((g * g).mean(-1, keepdim=True) + 1e-5)
    g = (g * prep["gate_scale"]).to(dtype)
    return g @ lp["wo"].to(dtype)


def _silu_as(x, dtype):
    return F.silu(x.float()).to(dtype)


def mamba_block(lp, cfg, h) -> Tuple[torch.Tensor, Tuple]:
    """Full-sequence block. h: (B, S, d). Returns (h_out, (ssm_state
    (B, H, N, P), conv_tail (B, W-1, di + 2N)))."""
    b, s, _ = h.shape
    di, n, nh, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    w = cfg.ssm_conv_width
    prep = _prep(lp, h.dtype)
    xin = L.apply_norm(lp["norm"], h, cfg.norm)
    z, xr, bc, cc, dt = _proj_in(lp, prep, xin)

    xbc = torch.cat([xr, bc, cc], dim=-1)                  # (B, S, di+2N)
    if s < w - 1:                                          # tiny sequence
        conv_tail = F.pad(xbc, (0, 0, w - 1 - s, 0))
    else:
        # a copy: a view would keep the whole (B, S, di+2N) input alive
        # until every layer's tail is stacked
        conv_tail = xbc[:, s - (w - 1):, :].clone()
    xbc = _silu_as(_causal_conv(xbc, prep["conv_w"]), h.dtype)
    xr, bc, cc = torch.split(xbc, [di, n, n], dim=-1)

    x4 = xr.reshape(b, s, nh, p).contiguous()
    y, state = ops.ssd(x4, dt, prep["a"], bc.contiguous(), cc.contiguous(),
                       chunk=cfg.ssm_chunk)
    y = y + x4 * lp["D"].to(y.dtype)[None, None, :, None]
    out = _gate_out(lp, prep, y.reshape(b, s, di), z, h.dtype)
    return h + out, (state, conv_tail)


def mamba_block_decode(lp, cfg, h, ssm_state, conv_buf
                       ) -> Tuple[torch.Tensor, Tuple]:
    """Single-token recurrent step. h: (B, d); ssm_state (B, H, N, P);
    conv_buf (B, W-1, di + 2N) raw (pre-conv) inputs."""
    b, _ = h.shape
    di, n, nh, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    prep = _prep(lp, h.dtype)
    xin = L.apply_norm(lp["norm"], h, cfg.norm)
    z, xr, bc, cc, dt = _proj_in(lp, prep, xin)

    xbc_new = torch.cat([xr, bc, cc], dim=-1)              # (B, di+2N)
    window = torch.cat([conv_buf, xbc_new[:, None, :]], dim=1)
    conv_out = (window * prep["conv_w"][None]).sum(dim=1)
    xbc = _silu_as(conv_out, h.dtype)
    xr, bc, cc = torch.split(xbc, [di, n, n], dim=-1)

    x4 = xr.reshape(b, nh, p)
    y, state = ops.ssd_decode(x4, dt, prep["a"], bc, cc, ssm_state)
    y = y + x4 * lp["D"].to(y.dtype)[None, :, None]
    out = _gate_out(lp, prep, y.reshape(b, di), z, h.dtype)
    return h + out, (state, window[:, 1:, :])


def mamba_block_packed(lp, cfg, h, seg_ids, pos, seg_starts, seg_lens,
                       row_len: int) -> Tuple[torch.Tensor, Tuple]:
    """Packed ragged block. h: (1, T, d) packed tokens.

    Projections, gating and the out-projection run on the packed row; the
    sequence-mixing ops (causal conv, SSD scan) run on per-segment rows
    (``layers.segments_to_rows``), where ``dt`` is exactly zero on row
    padding: the state freezes at each segment's last token, so each
    segment ends with the state of its own unpadded prefill.

    Returns (h_out (1, T, d), (per-segment ssm states (S, H, N, P),
    per-segment conv tails (S, W-1, di + 2N)))."""
    di, n, nh, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    w = cfg.ssm_conv_width
    s_max = seg_lens.shape[0]
    prep = _prep(lp, h.dtype)
    xin = L.apply_norm(lp["norm"], h, cfg.norm)
    z, xr, bc, cc, dt = _proj_in(lp, prep, xin)            # packed

    xbc = torch.cat([xr, bc, cc], dim=-1)                  # (1, T, di+2N)
    raw_rows = L.segments_to_rows(xbc[0], seg_starts, seg_lens, row_len)
    mixed = _silu_as(_causal_conv(raw_rows, prep["conv_w"]), h.dtype)
    xr_r, bc_r, cc_r = torch.split(mixed, [di, n, n], dim=-1)
    dt_rows = L.segments_to_rows(dt[0], seg_starts, seg_lens, row_len)

    x4 = xr_r.reshape(s_max, row_len, nh, p).contiguous()
    y_r, states = ops.ssd(x4, dt_rows, prep["a"], bc_r.contiguous(),
                          cc_r.contiguous(), chunk=cfg.ssm_chunk)
    y_r = y_r + x4 * lp["D"].to(y_r.dtype)[None, None, :, None]
    y = L.rows_to_segments(y_r.reshape(s_max, row_len, di), seg_ids,
                           pos)[None]
    out = _gate_out(lp, prep, y, z, h.dtype)

    # conv tail: each segment's last W-1 raw inputs, left-padded with
    # zeros for segments shorter than the window
    j = torch.arange(w - 1, device=h.device)
    idx = seg_lens.long()[:, None] - (w - 1) + j[None, :]  # (S, W-1)
    rows = torch.arange(s_max, device=h.device)[:, None]
    tails = raw_rows[rows, torch.clamp(idx, 0, row_len - 1)]
    tails = torch.where((idx >= 0)[..., None], tails,
                        torch.zeros_like(tails)).to(h.dtype)
    return h + out, (states, tails)


# --------------------------------------------------------------------------
# model-level API
# --------------------------------------------------------------------------
def forward(params, cfg, tokens, *, remat: bool = False):
    """tokens: (B, S) int -> (logits (B, S, V), aux); aux holds the JAX
    package's two auxiliary losses at 0."""
    L.refuse_training("ssm", params, remat,
                      "a backward of the SSD scan (#6 has none)")
    dtype = dtype_of(cfg.dtype)
    x = L.embed_tokens(params["embed"], tokens, dtype)
    for i in range(cfg.num_layers):
        x, _ = mamba_block(L.layer_params(params["layers"], i), cfg, x)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.unembed(params["embed"], x, cfg), {
        "load_balance_loss": zero, "dropped_fraction": zero}


def cache_plan(cfg, batch: int, cache_len: int) -> dict:
    nl = cfg.num_layers
    di, n, nh, p, w = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                       cfg.ssm_head_dim, cfg.ssm_conv_width)
    return {"ssm": L.ParamDef((nl, batch, nh, n, p), "zeros"),
            "conv": L.ParamDef((nl, batch, w - 1, di + 2 * n), "zeros"),
            "pos": L.ParamDef((batch,), "zeros")}


def init_cache(cfg, batch: int, cache_len: int, dtype=None, device="cpu"):
    """Zero per-sequence state: ``ssm`` float32, ``conv`` in ``dtype``
    (default the config's), ``pos`` int32. ``cache_len`` is unused (the
    state does not grow with the sequence)."""
    dtype = dtype_of(dtype or cfg.dtype)
    cp = cache_plan(cfg, batch, cache_len)
    return {
        "ssm": torch.zeros(cp["ssm"].shape, dtype=torch.float32,
                           device=device),
        "conv": torch.zeros(cp["conv"].shape, dtype=dtype, device=device),
        "pos": torch.zeros(cp["pos"].shape, dtype=torch.int32,
                           device=device),
    }


def prefill(params, cfg, tokens, cache_len: int):
    """Run a batch of prompts (B, S). Returns (logits of the last position
    (B, V), cache with ``pos`` = S)."""
    dtype = dtype_of(cfg.dtype)
    b, s = tokens.shape
    x = L.embed_tokens(params["embed"], tokens, dtype)
    states, convs = [], []
    for i in range(cfg.num_layers):
        x, (state, conv) = mamba_block(L.layer_params(params["layers"], i),
                                       cfg, x)
        states.append(state)
        convs.append(conv)
    x = L.apply_norm(params["final_norm"], x[:, -1], cfg.norm)
    return L.unembed(params["embed"], x, cfg), {
        "ssm": torch.stack(states), "conv": torch.stack(convs),
        "pos": torch.full((b,), s, dtype=torch.int32, device=tokens.device)}


def prefill_packed(params, cfg, packed, max_seg_len: int):
    """Packed ragged prefill: ONE (1, T) row of concatenated prompts, the
    SSD state reset at segment boundaries (``mamba_block_packed``).
    Returns per-segment last logits (S, V) and a per-segment cache
    ({ssm (layers, S, H, N, P), conv (layers, S, W-1, di + 2N), pos =
    seg_lens}) that the engine writes into slot rows."""
    dtype = dtype_of(cfg.dtype)
    tokens = packed["tokens"]
    seg_ids, seg_starts = packed["seg_ids"], packed["seg_starts"]
    seg_lens = packed["seg_lens"]
    t = tokens.shape[1]
    x = L.embed_tokens(params["embed"], tokens, dtype)
    pos = L.packed_positions(seg_ids, seg_starts)
    states, convs = [], []
    for i in range(cfg.num_layers):
        x, (st, tail) = mamba_block_packed(
            L.layer_params(params["layers"], i), cfg, x, seg_ids, pos,
            seg_starts, seg_lens, max_seg_len)
        states.append(st)
        convs.append(tail)
    last = torch.clamp(seg_starts + seg_lens - 1, 0, t - 1)
    xl = L.apply_norm(params["final_norm"], x[0, last], cfg.norm)
    return L.unembed(params["embed"], xl, cfg), {
        "ssm": torch.stack(states), "conv": torch.stack(convs),
        "pos": seg_lens.to(torch.int32)}


def decode_step(params, cfg, token, cache):
    """token: (B,) int; one recurrent step. Returns (logits (B, V), a NEW
    cache: every layer's state and conv window advanced, ``pos`` + 1)."""
    dtype = dtype_of(cfg.dtype)
    x = L.embed_tokens(params["embed"], token, dtype)      # (B, d)
    states, convs = [], []
    for i in range(cfg.num_layers):
        x, (state, conv) = mamba_block_decode(
            L.layer_params(params["layers"], i), cfg, x, cache["ssm"][i],
            cache["conv"][i])
        states.append(state)
        convs.append(conv)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    logits = L.unembed(params["embed"], x, cfg)
    pos = cache["pos"].to(torch.int32)
    return logits, {"ssm": torch.stack(states), "conv": torch.stack(convs),
                    "pos": pos + 1}
