"""Zamba2-style hybrid (zamba2-7b): a Mamba2 backbone and ONE shared
attention block, the serving entry points of the JAX package's
``repro.models.hybrid`` — ``forward``, the padded ``prefill``, the packed
ragged ``prefill_packed`` and ``decode_step`` over ring or paged caches.

The backbone's layers are ``repro_torch.models.ssm``'s blocks. A single
weight-tied block (attention and a SwiGLU MLP, ``shared_attn``) runs after
every ``cfg.attn_every``-th mamba layer; its invocation ``j`` keeps its own
K/V at index ``j`` of the ``attn_k``/``attn_v`` leaves. The JAX package
takes that branch by ``lax.cond`` inside its layer scan; here the layers
are a Python loop and the branch is static in the layer index, so a
captured step holds no host sync. Layers past the last multiple of
``attn_every`` run no attention.

Cache leaves have two leading axes: the per-sequence ``ssm`` (layers, B,
H, N, P) float32 and ``conv`` (layers, B, W-1, di + 2N) are stacked over
mamba layers, the shared block's ``attn_k``/``attn_v`` over invocations —
(invocations, B, C, KV, D) on a ring, (invocations, pages, page_size, KV,
D) in the page pool, (invocations, T, KV, D) in packed order from
``prefill_packed``. Only the attention K/V is paged (``PAGED_KEYS``); the
Mamba state is O(1) per row and stays per slot.

Attention goes through ``repro_torch.kernels.ops`` as the transformer's
does: the flash kernel (#5) in ``forward`` and ``prefill``, the segment
kernel (#2) in ``prefill_packed``, the paged (#1) or ring (#4) decode
kernel in ``decode_step``; every mamba layer of a prefill scans through
the SSD kernel (#6). As in ``repro_torch.models.transformer``,
``decode_step`` writes the step's K/V into the cache IN PLACE. There is
no ``prefill_chunk``, as in the JAX package: an engine runs this family's
continuations by prefix recompute.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.device import dtype_of
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.utils.sharding import maybe_constrain

# only the shared attention's K/V is paged; the Mamba state stays per slot
PAGED_KEYS = ("attn_k", "attn_v")


def n_attn_blocks(cfg) -> int:
    return cfg.num_layers // cfg.attn_every


def _invocation(cfg, i: int):
    """The shared block's invocation after mamba layer ``i``, or None
    where the layer runs none (the JAX package's ``min(i // attn_every,
    na - 1)`` under ``(i + 1) % attn_every == 0``)."""
    if (i + 1) % cfg.attn_every:
        return None
    return min(i // cfg.attn_every, n_attn_blocks(cfg) - 1)


def shared_attn_plan(cfg) -> dict:
    return {
        "ln1": L.norm_plan(cfg.d_model, cfg.norm),
        "attn": L.attn_plan(cfg),
        "ln2": L.norm_plan(cfg.d_model, cfg.norm),
        "mlp": L.mlp_plan(cfg),
    }


def plan(cfg) -> dict:
    return {
        "embed": L.embed_plan(cfg),
        "layers": L.stack_plan(ssm.mamba_layer_plan(cfg), cfg.num_layers),
        "shared_attn": shared_attn_plan(cfg),
        "final_norm": L.norm_plan(cfg.d_model, cfg.norm),
    }


# the mamba layers' derived weights (``layers["prep"]``); ``shared_attn``
# is kept as it is
prepare_params = ssm.prepare_params


def _shared(sp, cfg, x, rope, attention):
    """The shared block over x (B, S, d): pre-norm attention through
    ``attention(q, k, v)``, then the MLP. Returns (x, k, v)."""
    h = L.apply_norm(sp["ln1"], x, cfg.norm)
    q, k, v = L.attn_qkv(sp["attn"], cfg, h, rope)
    x = x + L.attn_out(sp["attn"], x.dtype, attention(q, k, v))
    h = L.apply_norm(sp["ln2"], x, cfg.norm)
    return x + L.apply_mlp(sp["mlp"], h), k, v


def _causal(cfg, q, k, v):
    return L.big_attention(L.constrain_q_prefill(cfg, q), k, v, causal=True)


def _rope(cfg, positions):
    return L.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)


def forward(params, cfg, tokens, *, remat: bool = False):
    """tokens: (B, S) int -> (logits (B, S, V), aux); aux holds the JAX
    package's two auxiliary losses at 0. Differentiable in every leaf:
    ``remat`` checkpoints each layer's body, the mamba block and the
    shared block's invocation after it (the JAX package's scanned body);
    the shared block's gradient sums over its invocations."""
    dtype = dtype_of(cfg.dtype)
    x = L.embed_tokens(params["embed"], tokens, dtype)
    rope = _rope(cfg, torch.arange(tokens.shape[1],
                                   device=tokens.device)[None, :])
    sp = params["shared_attn"]
    layers = ssm.leaf_layers(params)

    def body(lp, sp, x, rope, shared: bool):
        x = ssm.block_body(lp, cfg, x)
        if shared:
            x = _shared(sp, cfg, x, rope, functools.partial(_causal, cfg))[0]
        return x

    for i in range(cfg.num_layers):
        x = L.run_layer(body, remat, L.layer_params(layers, i), sp, x,
                        rope, _invocation(cfg, i) is not None)
        x = maybe_constrain(x, "batch", None, "act_embed")
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.unembed(params["embed"], x, cfg), {
        "load_balance_loss": zero, "dropped_fraction": zero}


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------
def cache_plan(cfg, batch: int, cache_len: int) -> dict:
    """The ring cache: the Mamba state of ``ssm.cache_plan`` and the
    shared block's K/V (invocations, batch, cache_len, KV, D)."""
    base = ssm.cache_plan(cfg, batch, cache_len)
    kv = (n_attn_blocks(cfg), batch, cache_len, cfg.num_kv_heads,
          cfg.resolved_head_dim)
    spec = L.kv_cache_spec(cfg)
    base["attn_k"] = L.ParamDef(kv, spec, "zeros")
    base["attn_v"] = L.ParamDef(kv, spec, "zeros")
    return base


def init_cache(cfg, batch: int, cache_len: int, dtype=None, device="cpu",
               like=None):
    """Zero ring cache: ``ssm`` float32, ``conv`` and the K/V in ``dtype``
    (default the config's), ``pos`` int32; placed on ``like``'s mesh when
    it is a DTensor (``L.plan_zeros``)."""
    dtype = dtype_of(dtype or cfg.dtype)
    cache = ssm.init_cache(cfg, batch, cache_len, dtype, device=device,
                           like=like)
    cp = cache_plan(cfg, batch, cache_len)
    cache["attn_k"] = L.plan_zeros(cp["attn_k"], dtype, device, like)
    cache["attn_v"] = L.plan_zeros(cp["attn_v"], dtype, device, like)
    return cache


def paged_cache_plan(cfg, batch: int, num_pages: int, page_size: int,
                     max_pages: int) -> dict:
    base = ssm.cache_plan(cfg, batch, 0)
    kv = (n_attn_blocks(cfg), num_pages, page_size, cfg.num_kv_heads,
          cfg.resolved_head_dim)
    spec = L.paged_kv_cache_spec(cfg)
    base["attn_k"] = L.ParamDef(kv, spec, "zeros")
    base["attn_v"] = L.ParamDef(kv, spec, "zeros")
    base["block_tables"] = L.ParamDef((batch, max_pages), None, "zeros")
    return base


def init_paged_cache(cfg, batch: int, num_pages: int, page_size: int,
                     max_pages: int, dtype=None, device="cpu"):
    """Per-slot Mamba state beside the shared block's K/V in a page pool
    of ``num_pages`` pages per invocation, behind one ``block_tables``
    row per slot (every invocation's pool is indexed by the same row)."""
    dtype = dtype_of(dtype or cfg.dtype)
    cache = ssm.init_cache(cfg, batch, 0, dtype, device=device)
    shape = paged_cache_plan(cfg, batch, num_pages, page_size,
                             max_pages)["attn_k"].shape
    cache["attn_k"] = torch.zeros(shape, dtype=dtype, device=device)
    cache["attn_v"] = torch.zeros(shape, dtype=dtype, device=device)
    cache["block_tables"] = torch.zeros((batch, max_pages),
                                        dtype=torch.int32, device=device)
    return cache


# --------------------------------------------------------------------------
# prefill and decode
# --------------------------------------------------------------------------
def prefill(params, cfg, tokens, cache_len: int):
    """Run a padded batch of prompts (B, S), building a fresh ring cache of
    ``cache_len`` rows per sequence. Returns (logits of the last position
    (B, V), cache with ``pos`` = S). A prompt longer than the cache keeps
    its last ``cache_len`` keys at rows 0..cache_len-1, as the JAX package
    does."""
    dtype = dtype_of(cfg.dtype)
    b, s = tokens.shape
    x = L.embed_tokens(params["embed"], tokens, dtype)
    rope = _rope(cfg, torch.arange(s, device=tokens.device)[None, :])
    sp = params["shared_attn"]
    cache = init_cache(cfg, b, cache_len, dtype, device=tokens.device,
                       like=tokens)
    keep = min(s, cache_len)
    states, convs = [], []
    for i in range(cfg.num_layers):
        x, (state, conv) = ssm.mamba_block(
            L.layer_params(params["layers"], i), cfg, x)
        states.append(state)
        convs.append(conv)
        j = _invocation(cfg, i)
        if j is not None:
            x, k, v = _shared(sp, cfg, x, rope,
                              functools.partial(_causal, cfg))
            L.write_prefix(cache["attn_k"], j, k[:, s - keep:])
            L.write_prefix(cache["attn_v"], j, v[:, s - keep:])
    x = L.apply_norm(params["final_norm"], x[:, -1], cfg.norm)
    cache["ssm"] = torch.stack(states)
    cache["conv"] = torch.stack(convs)
    cache["pos"].fill_(s)
    return L.unembed(params["embed"], x, cfg), cache


def prefill_packed(params, cfg, packed, max_seg_len: int):
    """Packed ragged prefill: ONE (1, T) row of concatenated prompts. The
    backbone resets its state at segment boundaries
    (``ssm.mamba_block_packed``), the shared block runs segment-masked
    over the packed row at within-segment positions. Returns per-segment
    last logits (S, V) and a packed cache: per-segment ``ssm`` (layers, S,
    H, N, P) and ``conv`` (layers, S, W-1, di + 2N), the shared block's
    per-token K/V (invocations, T, KV, D) in packed order (the engine
    scatters each segment's tokens into its slot's pages), ``pos`` =
    seg_lens."""
    dtype = dtype_of(cfg.dtype)
    tokens = packed["tokens"]
    seg_ids, seg_starts = packed["seg_ids"], packed["seg_starts"]
    seg_lens = packed["seg_lens"]
    t = tokens.shape[1]
    x = L.embed_tokens(params["embed"], tokens, dtype)
    pos = L.packed_positions(seg_ids, seg_starts)
    rope = _rope(cfg, pos[None, :])
    sp = params["shared_attn"]
    kv = (n_attn_blocks(cfg), t, cfg.num_kv_heads, cfg.resolved_head_dim)
    kc = torch.zeros(kv, dtype=dtype, device=tokens.device)
    vc = torch.zeros(kv, dtype=dtype, device=tokens.device)

    def attention(q, k, v):
        return L.packed_prefill_attention(
            q, k, v, seg_ids, pos, seg_starts, seg_lens, row_len=max_seg_len)

    states, convs = [], []
    for i in range(cfg.num_layers):
        x, (st, tail) = ssm.mamba_block_packed(
            L.layer_params(params["layers"], i), cfg, x, seg_ids, pos,
            seg_starts, seg_lens, max_seg_len)
        states.append(st)
        convs.append(tail)
        j = _invocation(cfg, i)
        if j is not None:
            x, k, v = _shared(sp, cfg, x, rope, attention)
            kc[j] = k[0]
            vc[j] = v[0]
    last = torch.clamp(seg_starts + seg_lens - 1, 0, t - 1)
    xl = L.apply_norm(params["final_norm"], x[0, last], cfg.norm)
    return L.unembed(params["embed"], xl, cfg), {
        "ssm": torch.stack(states), "conv": torch.stack(convs),
        "attn_k": kc, "attn_v": vc, "pos": seg_lens.to(torch.int32)}


def decode_step(params, cfg, token, cache, mask=None
                ) -> Tuple[torch.Tensor, dict]:
    """token: (B,) int; one step. Every mamba layer advances its state and
    conv window (fresh tensors; with the slot step's ``mask`` (B,) bool the
    state advances IN PLACE in ``cache["ssm"]`` on the masked rows, which
    is returned as it is, and the other rows' logits are not meaningful,
    as in ``ssm.decode_step``); each invocation of the shared block
    writes the step's K/V IN PLACE at index j of ``attn_k``/``attn_v`` —
    at ring row ``pos % C`` or at (block_tables[b, pos // page_size],
    pos % page_size) — and attends the row's valid keys there. Returns
    (logits (B, V), cache with fresh ``ssm``/``conv``, the same K/V
    tensors and ``pos`` + 1)."""
    dtype = dtype_of(cfg.dtype)
    x = L.embed_tokens(params["embed"], token, dtype)             # (B, d)
    pos = cache["pos"].to(torch.int32)
    update, attend, _ = L.decode_index(pos, cache, "attn_k")
    rope = _rope(cfg, pos[:, None])
    sp = params["shared_attn"]

    def attention(j, q, k, v):
        kc, vc = cache["attn_k"][j], cache["attn_v"][j]
        update(kc, k)
        update(vc, v)
        return attend(L.constrain_q_decode(cfg, q[:, 0]), kc, vc)[:, None]

    states, convs = [], []
    for i in range(cfg.num_layers):
        x, (state, conv) = ssm.mamba_block_decode(
            L.layer_params(params["layers"], i), cfg, x, cache["ssm"][i],
            cache["conv"][i], mask)
        states.append(state)
        convs.append(conv)
        j = _invocation(cfg, i)
        if j is not None:
            h, _, _ = _shared(sp, cfg, x[:, None, :], rope,
                              lambda q, k, v, j=j: attention(j, q, k, v))
            x = h[:, 0]
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    logits = L.unembed(params["embed"], x, cfg)
    return logits, L.carry_cache_meta(
        {"ssm": cache["ssm"] if mask is not None else torch.stack(states),
         "conv": torch.stack(convs),
         "attn_k": cache["attn_k"], "attn_v": cache["attn_v"],
         "pos": pos + 1}, cache)
