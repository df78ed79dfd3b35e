"""Decoder-only transformer: the dense family (olmo-1b, qwen2-0.5b, ...),
the mixture-of-experts family (granite-moe, phi3.5-moe:
``cfg.num_experts > 0``, ``repro_torch.models.moe``) and chameleon's
early-fusion ``vlm``. The serving entry points of the JAX package's
``repro.models.transformer``: the full-sequence ``forward``, the padded
``prefill`` into a ring/contiguous cache, the packed and chunked prefills
of paged serving, and ``decode_step`` over either cache layout.

Parameters are the JAX package's dictionary layout: ``embed``, ``layers``
(every leaf stacked on a leading layer axis) and ``final_norm``. Layers run
as a Python loop over that axis (the JAX package scans them).

Unlike the JAX package, which threads the cache through functionally,
``decode_step`` writes the step's K/V into the cache IN PLACE (the
returned cache holds the same K/V tensors): at ring row ``pos % C`` of a
contiguous cache, or at (page, offset) of the page pool. The dead-write
semantics are the JAX package's: every row writes; the engine restores
or parks the rows it did not step. ``prefill_packed`` and
``prefill_chunk`` read the pool only; the engine scatters the K/V they
return.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.utils.checkpoint

from repro_torch.device import dtype_of
from repro_torch.models import layers as L
from repro_torch.models.moe import apply_moe, moe_plan

# cache leaves that live in the shared page pool
PAGED_KEYS = ("k", "v")


def layer_plan(cfg) -> dict:
    p = {
        "ln1": L.norm_plan(cfg.d_model, cfg.norm),
        "attn": L.attn_plan(cfg),
        "ln2": L.norm_plan(cfg.d_model, cfg.norm),
    }
    if cfg.num_experts:
        p["moe"] = moe_plan(cfg)
    else:
        p["mlp"] = L.mlp_plan(cfg)
    return p


def plan(cfg) -> dict:
    return {
        "embed": L.embed_plan(cfg),
        "layers": L.stack_plan(layer_plan(cfg), cfg.num_layers),
        "final_norm": L.norm_plan(cfg.d_model, cfg.norm),
    }


def _block(cfg, lp, x, rope, attention, aux: bool = False):
    """One pre-norm block; ``attention(q, k, v)`` mixes the sequence.
    Returns (x, k, v, aux): aux is the experts' auxiliary dict where
    ``aux`` asks for it, else None."""
    h = L.apply_norm(lp["ln1"], x, cfg.norm)
    q, k, v = L.attn_qkv(lp["attn"], cfg, h, rope)
    x1 = x + L.attn_out(lp["attn"], x.dtype, attention(q, k, v))
    h2 = L.apply_norm(lp["ln2"], x1, cfg.norm)
    if cfg.num_experts:
        y, aux = apply_moe(lp["moe"], cfg, h2, aux=aux)
    else:
        y, aux = L.apply_mlp(lp["mlp"], h2), None
    return x1 + y, k, v, aux


# --------------------------------------------------------------------------
# full-sequence forward and padded prefill
# --------------------------------------------------------------------------
def forward(params, cfg, tokens, *, remat: bool = False):
    """tokens: (B, S) int -> (logits (B, S, V), aux). aux holds the JAX
    package's two keys: each the mean over layers of the experts' value,
    0 for the dense family. ``remat``: each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant), which keeps only the
    layer's input for the backward and runs the layer again there, as the
    JAX package wraps its scanned layer in ``jax.checkpoint``. Under
    autograd the attention is ``flash_vjp``'s (``L.big_attention``)."""
    dtype = dtype_of(cfg.dtype)
    x = L.embed_tokens(params["embed"], tokens, dtype)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    rope = L.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)

    def attention(q, k, v):
        return L.cp_attention(cfg, q, k, v, causal=True,
                              window=cfg.sliding_window)

    def layer(lp, x):
        x, _, _, aux = _block(cfg, lp, x, rope, attention, aux=True)
        return x, aux

    auxes = []
    for i in range(cfg.num_layers):
        lp = L.layer_params(params["layers"], i)
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                layer, lp, x, use_reentrant=False)
        else:
            x, aux = layer(lp, x)
        auxes.append(aux)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    if cfg.num_experts:
        aux = {key: torch.stack([a[key] for a in auxes]).mean()
               for key in auxes[0]}
    else:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = {"load_balance_loss": zero, "dropped_fraction": zero}
    return L.unembed(params["embed"], x, cfg), aux


def cache_plan(cfg, batch: int, cache_len: int) -> dict:
    """The contiguous (ring) cache: K/V (layers, batch, cache_len, KV, D)
    and the per-row positions."""
    lcfg = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads,
            cfg.resolved_head_dim)
    return {"k": L.ParamDef(lcfg, "zeros"), "v": L.ParamDef(lcfg, "zeros"),
            "pos": L.ParamDef((batch,), "zeros")}


def init_cache(cfg, batch: int, cache_len: int, dtype=None, device="cpu"):
    dtype = dtype_of(dtype or cfg.dtype)
    cp = cache_plan(cfg, batch, cache_len)
    return {
        "k": torch.zeros(cp["k"].shape, dtype=dtype, device=device),
        "v": torch.zeros(cp["v"].shape, dtype=dtype, device=device),
        "pos": torch.zeros(cp["pos"].shape, dtype=torch.int32,
                           device=device),
    }


def prefill(params, cfg, tokens, cache_len: int):
    """Run a padded batch of prompts (B, S) through the model, building a
    fresh contiguous cache of ``cache_len`` rows per sequence. Returns
    (logits of the last position (B, V), cache with ``pos`` = S).

    A prompt longer than the cache (a sliding-window ring) keeps its last
    ``cache_len`` keys at rows 0..cache_len-1, as the JAX package does."""
    dtype = dtype_of(cfg.dtype)
    b, s = tokens.shape
    x = L.embed_tokens(params["embed"], tokens, dtype)
    positions = torch.arange(s, device=tokens.device)[None, :]
    rope = L.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    cache = init_cache(cfg, b, cache_len, dtype, device=tokens.device)
    keep = min(s, cache_len)

    def attention(q, k, v):
        return L.cp_attention(cfg, q, k, v, causal=True,
                              window=cfg.sliding_window)

    for i in range(cfg.num_layers):
        x, k, v, _ = _block(cfg, L.layer_params(params["layers"], i), x,
                            rope, attention)
        cache["k"][i, :, :keep] = k[:, s - keep:]
        cache["v"][i, :, :keep] = v[:, s - keep:]
    x = L.apply_norm(params["final_norm"], x[:, -1], cfg.norm)
    cache["pos"].fill_(s)
    return L.unembed(params["embed"], x, cfg), cache


# --------------------------------------------------------------------------
# paged KV-cache serving
# --------------------------------------------------------------------------
def init_paged_cache(cfg, batch: int, num_pages: int, page_size: int,
                     max_pages: int, dtype=None, device="cpu"):
    """Block-table paged layout: K/V in a shared (num_pages, page_size)
    pool per layer; each row maps logical pages to physical ones through
    its ``block_tables`` row (see ``repro_torch.serving.kv_cache``)."""
    dtype = dtype_of(dtype or cfg.dtype)
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "block_tables": torch.zeros((batch, max_pages), dtype=torch.int32,
                                    device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def prefill_packed(params, cfg, packed, max_seg_len: int):
    """Packed ragged prefill: a whole admission batch of prompts
    concatenated into ONE (1, T) row. ``packed`` holds ``tokens`` (1, T),
    ``seg_ids`` (T,) non-decreasing int32 (padding = S), ``seg_starts`` /
    ``seg_lens`` (S,). Returns (per-segment last-token logits (S, V), a
    packed cache: per-token K/V (layers, T, KV, D) in packed order, and
    ``pos`` = seg_lens)."""
    dtype = dtype_of(cfg.dtype)
    tokens = packed["tokens"]
    seg_ids, seg_starts = packed["seg_ids"], packed["seg_starts"]
    seg_lens = packed["seg_lens"]
    t = tokens.shape[1]
    x = L.embed_tokens(params["embed"], tokens, dtype)
    pos = L.packed_positions(seg_ids, seg_starts)
    rope = L.rope_tables(pos[None, :], cfg.resolved_head_dim, cfg.rope_theta)

    def attention(q, k, v):
        return L.packed_prefill_attention(
            q, k, v, seg_ids, pos, seg_starts, seg_lens, row_len=max_seg_len,
            window=cfg.sliding_window)

    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, k, v, _ = _block(cfg, L.layer_params(params["layers"], i), x,
                            rope, attention)
        ks.append(k[0])
        vs.append(v[0])
    last = torch.clamp(seg_starts + seg_lens - 1, 0, t - 1)
    xl = L.apply_norm(params["final_norm"], x[0, last], cfg.norm)
    logits = L.unembed(params["embed"], xl, cfg)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                    "pos": seg_lens.to(torch.int32)}


def prefill_chunk(params, cfg, packed, cache, max_seg_len: int):
    """Incremental chunked prefill: a packed batch of NEW token segments
    attends the K/V their slots already hold in the page pool (through
    each slot's block-table row) plus the chunk's earlier tokens causally.

    ``packed`` holds the ``prefill_packed`` leaves plus ``seg_slots`` (S,)
    (the cache row each segment reads; padding = n_rows, clamped) and
    ``hist_lens`` (S,) (tokens already resident; padding 0). ``cache`` is
    the engine's paged slot cache, READ ONLY. Returns (per-segment last
    logits (S, V), per-token argmax (T,), packed cache {k/v: (layers, T,
    KV, D), pos: hist + seg_lens})."""
    dtype = dtype_of(cfg.dtype)
    tokens = packed["tokens"]
    seg_ids, seg_starts = packed["seg_ids"], packed["seg_starts"]
    seg_lens = packed["seg_lens"]
    seg_slots = packed["seg_slots"]
    hist = packed["hist_lens"].to(torch.int32)
    t = tokens.shape[1]
    s = seg_starts.shape[0]
    x = L.embed_tokens(params["embed"], tokens, dtype)
    local = L.packed_positions(seg_ids, seg_starts)
    hist_t = torch.where(seg_ids < s, hist[torch.clamp(seg_ids, max=s - 1)],
                         torch.zeros_like(seg_ids))
    rope = L.rope_tables((local + hist_t)[None, :], cfg.resolved_head_dim,
                         cfg.rope_theta)
    n_rows = cache["block_tables"].shape[0]
    tables = cache["block_tables"][torch.clamp(seg_slots, 0, n_rows - 1)]

    def attention(i, q, k, v):
        qr = L.segments_to_rows(q[0], seg_starts, seg_lens, max_seg_len)
        kr = L.segments_to_rows(k[0], seg_starts, seg_lens, max_seg_len)
        vr = L.segments_to_rows(v[0], seg_starts, seg_lens, max_seg_len)
        ar = L.paged_chunk_attention(qr, cache["k"][i], cache["v"][i], kr,
                                     vr, tables, hist, seg_lens)
        return L.rows_to_segments(ar, seg_ids, local)[None]

    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, k, v, _ = _block(cfg, L.layer_params(params["layers"], i), x,
                            rope, functools.partial(attention, i))
        ks.append(k[0])
        vs.append(v[0])
    xl = L.apply_norm(params["final_norm"], x[0], cfg.norm)
    logits_all = L.unembed(params["embed"], xl, cfg)             # (T, V)
    tok_argmax = torch.argmax(logits_all, -1).to(torch.int32)
    last = torch.clamp(seg_starts + seg_lens - 1, 0, t - 1)
    return logits_all[last], tok_argmax, {
        "k": torch.stack(ks), "v": torch.stack(vs),
        "pos": (hist + seg_lens).to(torch.int32)}


def decode_step(params, cfg, token, cache) -> Tuple[torch.Tensor, dict]:
    """token: (B,) int; one autoregressive step against the cache. Each row
    writes its new K/V in place in ``cache["k"]``/``cache["v"]`` — at ring
    row ``pos % C`` of a contiguous cache, attending its last
    ``min(pos + 1, C)`` tokens, or at (block_tables[b, pos // page_size],
    pos % page_size) of a paged one, attending its first pos + 1. Returns
    (logits (B, V), cache with the same K/V tensors and ``pos`` + 1)."""
    dtype = dtype_of(cfg.dtype)
    x = L.embed_tokens(params["embed"], token, dtype)             # (B, d)
    pos = cache["pos"].to(torch.int32)
    update, attend, _ = L.decode_index(pos, cache, "k")
    rope = L.rope_tables(pos[:, None], cfg.resolved_head_dim, cfg.rope_theta)

    def attention(i, q, k, v):
        kc, vc = cache["k"][i], cache["v"][i]
        update(kc, k)
        update(vc, v)
        return attend(q[:, 0], kc, vc, window=cfg.sliding_window)[:, None]

    h = x[:, None, :]
    for i in range(cfg.num_layers):
        h, _, _, _ = _block(cfg, L.layer_params(params["layers"], i), h,
                            rope, functools.partial(attention, i))
    h = L.apply_norm(params["final_norm"], h[:, 0], cfg.norm)
    logits = L.unembed(params["embed"], h, cfg)
    return logits, L.carry_cache_meta(
        {"k": cache["k"], "v": cache["v"], "pos": pos + 1}, cache)
