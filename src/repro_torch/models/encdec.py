"""Whisper-style encoder-decoder transformer (whisper-small): the JAX
package's ``repro.models.encdec`` on tensors.

The mel-spectrogram and conv feature extractor is a stub, as in the JAX
package: ``enc_embeds`` carries precomputed frame embeddings (B,
encoder_seq, d_model) (``repro_torch.serving.modality.audio_frames``).
Positions are learned embeddings; decoder layers run causal, KV-cached
self-attention and cross-attention over the encoder output, whose K/V is
computed once at prefill.

Parameters are the JAX package's dictionary layout (``embed``,
``enc_pos``, ``dec_pos``, ``enc_layers``, ``enc_final``, ``layers`` with
``self_attn``/``cross_attn``/``ln3``, ``final_norm``). Layers run as a
Python loop over the stacked layer axis (the JAX package scans them).

Attention routes: the encoder's self-attention and the padded prefill's
self- and cross-attention go through the flash kernel (#5, non-causal over
the encoder's frames), the packed prefill's self-attention through the
segment kernel (#2) and its cross-attention through #5 with one batch row
per segment (``layers.packed_cross_attention``); decode runs the paged
(#1) or ring (#4) self-attention and the cross-attention over the
per-slot encoder block through #4.

As in ``repro_torch.models.transformer``, ``decode_step`` writes the
step's self-attention K/V into the cache IN PLACE; the cross K/V is read
only. There is no ``prefill_chunk``, as in the JAX package: an engine
runs this family's continuations by prefix recompute.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.device import dtype_of
from repro_torch.models import layers as L
from repro_torch.utils.sharding import is_dtensor, maybe_constrain

MAX_DEC_POS = 32_768

# decoder self-attention K/V pages; the cross K/V is a fixed
# encoder_seq-long read-only block per request, so it stays a per-slot
# dense leaf
PAGED_KEYS = ("k", "v")


def enc_layer_plan(cfg) -> dict:
    return {
        "ln1": L.norm_plan(cfg.d_model, cfg.norm),
        "attn": L.attn_plan(cfg),
        "ln2": L.norm_plan(cfg.d_model, cfg.norm),
        "mlp": L.mlp_plan(cfg),
    }


def dec_layer_plan(cfg) -> dict:
    return {
        "ln1": L.norm_plan(cfg.d_model, cfg.norm),
        "self_attn": L.attn_plan(cfg),
        "ln2": L.norm_plan(cfg.d_model, cfg.norm),
        "cross_attn": L.attn_plan(cfg),
        "ln3": L.norm_plan(cfg.d_model, cfg.norm),
        "mlp": L.mlp_plan(cfg),
    }


def plan(cfg) -> dict:
    return {
        "embed": L.embed_plan(cfg),
        "enc_pos": L.ParamDef((cfg.encoder_seq, cfg.d_model),
                              (None, "embed")),
        "dec_pos": L.ParamDef((MAX_DEC_POS, cfg.d_model), (None, "embed")),
        "enc_layers": L.stack_plan(enc_layer_plan(cfg), cfg.encoder_layers),
        "enc_final": L.norm_plan(cfg.d_model, cfg.norm),
        "layers": L.stack_plan(dec_layer_plan(cfg), cfg.num_layers),
        "final_norm": L.norm_plan(cfg.d_model, cfg.norm),
    }


def _proj(x, w):
    """x (..., d) @ w (d, heads, hd) -> (..., heads, hd); a DTensor's rows
    laid out by ``layers._rows`` first (the product keeps w's layout of
    the heads, as ``layers.attn_qkv``'s does)."""
    lead = x.shape[:-1]
    w2 = w.reshape(w.shape[0], -1).to(x.dtype)
    if is_dtensor(x):
        y = L._rows(x)[0] @ w2
    else:
        y = x.reshape(-1, x.shape[-1]) @ w2
    return y.reshape(*lead, w.shape[1], w.shape[2])


# --------------------------------------------------------------------------
# encoder
# --------------------------------------------------------------------------
def encode(params, cfg, enc_embeds):
    """(B, S_enc, d) frame embeddings -> the encoder output (B, S_enc, d)
    in the config's dtype; non-causal self-attention in every layer."""
    dtype = dtype_of(cfg.dtype)
    s = enc_embeds.shape[1]
    x = enc_embeds.to(dtype) + params["enc_pos"][:s].to(dtype)
    for i in range(cfg.encoder_layers):
        lp = L.layer_params(params["enc_layers"], i)
        h = L.apply_norm(lp["ln1"], x, cfg.norm)
        q, k, v = L.attn_qkv(lp["attn"], cfg, h, None)
        attn = L.cp_attention(cfg, q, k, v, causal=False)
        x1 = x + L.attn_out(lp["attn"], x.dtype, attn)
        h2 = L.apply_norm(lp["ln2"], x1, cfg.norm)
        x = x1 + L.apply_mlp(lp["mlp"], h2)
    return L.apply_norm(params["enc_final"], x, cfg.norm)


def _cross_kv(lp, cfg, enc_out):
    """The cross-attention K/V of one decoder layer over the encoder
    output: (B, S_enc, KV, D) each."""
    p = lp["cross_attn"]
    k, v = _proj(enc_out, p["wk"]), _proj(enc_out, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"].to(enc_out.dtype)
        v = v + p["bv"].to(enc_out.dtype)
    return k, v


def _dec_block(lp, cfg, x, enc_out, self_attention, cross_attention):
    """One decoder layer on x (B, S, d): causal self-attention through
    ``self_attention(q, k, v)``, then cross-attention of its queries over
    ``enc_out`` through ``cross_attention(q, kc, vc)``, then the MLP.
    Returns (x, k, v, kc, vc)."""
    h = L.apply_norm(lp["ln1"], x, cfg.norm)
    q, k, v = L.attn_qkv(lp["self_attn"], cfg, h, None)
    x = x + L.attn_out(lp["self_attn"], x.dtype, self_attention(q, k, v))
    h = L.apply_norm(lp["ln2"], x, cfg.norm)
    qc = _proj(h, lp["cross_attn"]["wq"])
    kc, vc = _cross_kv(lp, cfg, enc_out)
    x = x + L.attn_out(lp["cross_attn"], x.dtype,
                       cross_attention(qc, kc, vc))
    h = L.apply_norm(lp["ln3"], x, cfg.norm)
    return x + L.apply_mlp(lp["mlp"], h), k, v, kc, vc


def _dense(cfg):
    """The padded paths' self- and cross-attention: ``cp_attention``
    (``big_attention`` on one device)."""
    return (functools.partial(L.cp_attention, cfg, causal=True),
            functools.partial(L.cp_attention, cfg, causal=False))


def forward(params, cfg, tokens, enc_embeds, *,
            remat: bool = False):
    """tokens: (B, S) int; enc_embeds: (B, S_enc, d) -> (logits (B, S, V),
    aux with the JAX package's two keys at 0). Differentiable in every
    leaf: every attention goes through ``big_attention`` (on the card
    under autograd the flash kernel with its lse and the backward kernel);
    ``remat`` checkpoints each decoder layer, as the JAX package wraps
    only its decoder's scanned body, and the encoder runs unwrapped."""
    dtype = dtype_of(cfg.dtype)
    enc_out = encode(params, cfg, enc_embeds)
    s = tokens.shape[1]
    x = (L.embed_tokens(params["embed"], tokens, dtype)
         + params["dec_pos"][:s].to(dtype))

    def body(lp, x, enc_out):
        return _dec_block(lp, cfg, x, enc_out, *_dense(cfg))[0]

    for i in range(cfg.num_layers):
        x = L.run_layer(body, remat, L.layer_params(params["layers"], i), x,
                        enc_out)
        x = maybe_constrain(x, "batch", None, "act_embed")
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.unembed(params["embed"], x, cfg), {
        "load_balance_loss": zero, "dropped_fraction": zero}


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
def cache_plan(cfg, batch: int, cache_len: int) -> dict:
    """The contiguous cache: self K/V (layers, batch, cache_len, KV, D),
    cross K/V (layers, batch, encoder_seq, KV, D) and the positions."""
    hd = cfg.resolved_head_dim
    kv_shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads, hd)
    cross = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads, hd)
    spec = L.kv_cache_spec(cfg)
    return {"k": L.ParamDef(kv_shape, spec, "zeros"),
            "v": L.ParamDef(kv_shape, spec, "zeros"),
            "cross_k": L.ParamDef(cross, spec, "zeros"),
            "cross_v": L.ParamDef(cross, spec, "zeros"),
            "pos": L.ParamDef((batch,), None, "zeros")}


def _zeros(plan, dtype, device, like=None, ints=("pos", "block_tables")):
    return {k: L.plan_zeros(pd, torch.int32 if k in ints else dtype,
                            device, like)
            for k, pd in plan.items()}


def init_cache(cfg, batch: int, cache_len: int, dtype=None, device="cpu",
               like=None):
    """Zero cache; placed on ``like``'s mesh when it is a DTensor
    (``L.plan_zeros``)."""
    return _zeros(cache_plan(cfg, batch, cache_len),
                  dtype_of(dtype or cfg.dtype), device, like)


def paged_cache_plan(cfg, batch: int, num_pages: int, page_size: int,
                     max_pages: int) -> dict:
    """The paged layout: self K/V in a shared (num_pages, page_size) pool
    per layer behind ``block_tables``; the cross K/V stays a per-row
    dense leaf."""
    hd = cfg.resolved_head_dim
    kv_shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads, hd)
    cross = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads, hd)
    paged, spec = L.paged_kv_cache_spec(cfg), L.kv_cache_spec(cfg)
    return {"k": L.ParamDef(kv_shape, paged, "zeros"),
            "v": L.ParamDef(kv_shape, paged, "zeros"),
            "cross_k": L.ParamDef(cross, spec, "zeros"),
            "cross_v": L.ParamDef(cross, spec, "zeros"),
            "block_tables": L.ParamDef((batch, max_pages), None, "zeros"),
            "pos": L.ParamDef((batch,), None, "zeros")}


def init_paged_cache(cfg, batch: int, num_pages: int, page_size: int,
                     max_pages: int, dtype=None, device="cpu"):
    return _zeros(paged_cache_plan(cfg, batch, num_pages, page_size,
                                   max_pages),
                  dtype_of(dtype or cfg.dtype), device)


def prefill(params, cfg, tokens, cache_len: int, enc_embeds):
    """Encode the (stub) audio, cache the cross K/V, run the decoder
    prompt (B, S) into a fresh contiguous cache of ``cache_len`` rows.
    Returns (last logits (B, V), cache with ``pos`` = S)."""
    dtype = dtype_of(cfg.dtype)
    b, s = tokens.shape
    enc_out = encode(params, cfg, enc_embeds)
    x = (L.embed_tokens(params["embed"], tokens, dtype)
         + params["dec_pos"][:s].to(dtype))
    cache = init_cache(cfg, b, cache_len, dtype, device=tokens.device,
                       like=tokens)
    for i in range(cfg.num_layers):
        x, k, v, kc, vc = _dec_block(L.layer_params(params["layers"], i),
                                     cfg, x, enc_out, *_dense(cfg))
        L.write_prefix(cache["k"], i, k)
        L.write_prefix(cache["v"], i, v)
        cache["cross_k"][i] = kc
        cache["cross_v"][i] = vc
    x = L.apply_norm(params["final_norm"], x[:, -1], cfg.norm)
    cache["pos"].fill_(s)
    return L.unembed(params["embed"], x, cfg), cache


def prefill_packed(params, cfg, packed, max_seg_len: int):
    """Packed ragged prefill: only the DECODER side packs. The encoder runs
    densely over the per-segment ``enc_embeds`` stack (S, enc_seq, d) and
    each packed decoder token cross-attends its own segment's encoder
    output (``layers.packed_cross_attention``). Returns (per-segment last
    logits (S, V), a packed cache: self K/V (layers, T, KV, D) in packed
    order, cross K/V (layers, S, enc_seq, KV, D) per segment, ``pos`` =
    seg_lens)."""
    dtype = dtype_of(cfg.dtype)
    tokens = packed["tokens"]
    seg_ids, seg_starts = packed["seg_ids"], packed["seg_starts"]
    seg_lens = packed["seg_lens"]
    t = tokens.shape[1]
    enc_out = encode(params, cfg, packed["enc_embeds"])
    pos = L.packed_positions(seg_ids, seg_starts)
    x = (L.embed_tokens(params["embed"], tokens, dtype)
         + params["dec_pos"][pos.long()][None].to(dtype))

    def self_attention(q, k, v):
        return L.packed_prefill_attention(q, k, v, seg_ids, pos, seg_starts,
                                          seg_lens, row_len=max_seg_len)

    def cross_attention(q, kc, vc):
        return L.packed_cross_attention(q, kc, vc, seg_ids, pos, seg_starts,
                                        seg_lens, row_len=max_seg_len)

    ks, vs, cks, cvs = [], [], [], []
    for i in range(cfg.num_layers):
        x, k, v, kc, vc = _dec_block(L.layer_params(params["layers"], i),
                                     cfg, x, enc_out, self_attention,
                                     cross_attention)
        ks.append(k[0])
        vs.append(v[0])
        cks.append(kc)
        cvs.append(vc)
    last = torch.clamp(seg_starts + seg_lens - 1, 0, t - 1)
    xl = L.apply_norm(params["final_norm"], x[0, last.long()], cfg.norm)
    logits = L.unembed(params["embed"], xl, cfg)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                    "cross_k": torch.stack(cks), "cross_v": torch.stack(cvs),
                    "pos": seg_lens.to(torch.int32)}


def decode_step(params, cfg, token, cache) -> Tuple[torch.Tensor, dict]:
    """token: (B,) int; one step against the cache. Each row writes its
    self-attention K/V in place (ring row ``pos % C``, or its page) and
    attends every encoder frame of its cross block. Returns (logits
    (B, V), cache with the same K/V tensors and ``pos`` + 1)."""
    dtype = dtype_of(cfg.dtype)
    pos = cache["pos"].to(torch.int32)
    update, attend, _ = L.decode_index(pos, cache, "k")
    x = (L.embed_tokens(params["embed"], token, dtype)
         + params["dec_pos"][pos.long()].to(dtype))[:, None, :]
    enc_len = int(cache["cross_k"].shape[2])
    for i in range(cfg.num_layers):
        lp = L.layer_params(params["layers"], i)
        h = L.apply_norm(lp["ln1"], x, cfg.norm)
        q, k, v = L.attn_qkv(lp["self_attn"], cfg, h, None)
        kc, vc = cache["k"][i], cache["v"][i]
        update(kc, k)
        update(vc, v)
        q = L.constrain_q_decode(cfg, q[:, 0])
        x = x + L.attn_out(lp["self_attn"], x.dtype,
                           attend(q, kc, vc)[:, None])
        h = L.apply_norm(lp["ln2"], x, cfg.norm)
        qc = L.constrain_q_decode(cfg, _proj(h[:, 0], lp["cross_attn"]["wq"]))
        cross = L.decode_attention(qc, cache["cross_k"][i],
                                   cache["cross_v"][i], enc_len)
        x = x + L.attn_out(lp["cross_attn"], x.dtype, cross[:, None])
        h = L.apply_norm(lp["ln3"], x, cfg.norm)
        x = x + L.apply_mlp(lp["mlp"], h)
    x = L.apply_norm(params["final_norm"], x[:, 0], cfg.norm)
    logits = L.unembed(params["embed"], x, cfg)
    return logits, L.carry_cache_meta(
        {"k": cache["k"], "v": cache["v"], "cross_k": cache["cross_k"],
         "cross_v": cache["cross_v"], "pos": pos + 1}, cache)
