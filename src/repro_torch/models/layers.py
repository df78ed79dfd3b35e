"""Model-building primitives of the port: the dense-decoder and
encoder-decoder subset of the JAX package's ``repro.models.layers``, as
plain functions on tensors — for padded and packed prefill (self- and
cross-attention), and decode over ring or paged caches.

Parameters are declared through a *plan* of ``ParamDef``s (same shapes and
initialisers as the JAX package), and the apply functions take the same
parameter dictionaries with the same leaf names, so weights convert
between the two packages leaf for leaf (``repro_torch.models.weights``).

Attention on the serving path goes through ``repro_torch.kernels.ops``: the
hand-written CUDA kernels for tensors on a GPU, their plain versions —
the JAX CPU path's arithmetic — for tensors on the CPU.

Sampling (``top_k_top_p_filter``, ``sample_logits``) is the JAX package's
plain sampler: ``jax.random.categorical`` is the arg-max of Gumbel noise
plus the logits, and the noise comes from an explicit ``torch.Generator``
through ``gumbel_noise``, the one function that draws.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels import flash_vjp, ops
from repro_torch.kernels.flash_attention import (attention_dense,
                                                 repeat_kv, rows_to_segments,
                                                 segments_to_rows)

__all__ = [
    "ParamDef", "stack_plan", "norm_plan", "attn_plan", "mlp_plan",
    "embed_plan", "layer_params", "apply_norm", "rope_tables", "apply_rope",
    "attn_qkv", "attn_out", "apply_mlp", "embed_tokens", "unembed",
    "repeat_kv",
    "attention_dense", "run_layer", "big_attention", "cp_attention",
    "packed_positions",
    "segments_to_rows", "rows_to_segments", "packed_prefill_attention",
    "packed_cross_attention", "cache_row_update", "paged_cache_update",
    "decode_attention", "paged_decode_attention", "paged_chunk_attention",
    "decode_index", "carry_cache_meta", "gumbel_noise",
    "top_k_top_p_filter", "sample_logits",
]


# --------------------------------------------------------------------------
# parameter plans
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"                             # normal | zeros | ones
    std: float = 0.02


def stack_plan(plan, n: int):
    """The plan of ``n`` copies of ``plan`` stacked on a leading axis."""
    if isinstance(plan, ParamDef):
        return ParamDef((n,) + tuple(plan.shape), plan.init, plan.std)
    return {k: stack_plan(v, n) for k, v in plan.items()}


def layer_params(tree, i: int):
    """Layer ``i``'s parameters: a view into every stacked leaf."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def norm_plan(d: int, kind: str):
    if kind == "rmsnorm":
        return {"scale": ParamDef((d,), "ones")}
    if kind == "layernorm":
        return {"scale": ParamDef((d,), "ones"),
                "bias": ParamDef((d,), "zeros")}
    if kind == "layernorm_nonparam":
        return {}
    raise ValueError(kind)


def attn_plan(cfg) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": ParamDef((d, h, hd)),
        "wk": ParamDef((d, kv, hd)),
        "wv": ParamDef((d, kv, hd)),
        "wo": ParamDef((h, hd, d)),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamDef((h, hd), "zeros")
        p["bk"] = ParamDef((kv, hd), "zeros")
        p["bv"] = ParamDef((kv, hd), "zeros")
    return p


def mlp_plan(cfg, d_ff: Optional[int] = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi_gate": ParamDef((d, ff)),
        "wi_up": ParamDef((d, ff)),
        "wo": ParamDef((ff, d)),
    }


def embed_plan(cfg) -> dict:
    p = {"embedding": ParamDef((cfg.padded_vocab, cfg.d_model))}
    if not cfg.tie_embeddings:
        p["lm_head"] = ParamDef((cfg.d_model, cfg.padded_vocab))
    return p


# --------------------------------------------------------------------------
# norms, rotary embeddings, projections
# --------------------------------------------------------------------------
def apply_norm(p, x, kind: str, eps: float = 1e-5):
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (y * p["scale"].float()).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _inv_freq(d: int, theta: float, device: torch.device) -> torch.Tensor:
    # the JAX package's float32 numpy formula, uploaded once per device
    half = d // 2
    freq = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) * 2.0 / d))
    return torch.from_numpy(np.asarray(freq, np.float32)).to(device)


def rope_tables(positions, d: int, theta: float):
    """(cos, sin) of shape positions.shape + (1, d // 2), float32 — built
    once per dispatch and shared by every layer's q and k."""
    freq = _inv_freq(d, float(theta), positions.device)
    ang = positions[..., None].float() * freq
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def _rotate(x, cos, sin):
    half = cos.shape[-1]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2, x[..., 2 * half:]], dim=-1).to(x.dtype)


def apply_rope(x, positions, theta: float):
    """Half-split rotary embedding. x: (..., S, H, D); positions:
    broadcastable to (..., S)."""
    return _rotate(x, *rope_tables(positions, x.shape[-1], theta))


def attn_qkv(p, cfg, x, rope):
    """Project + rotate. x: (B, S, d) -> q (B, S, H, hd), k, v
    (B, S, KV, hd); ``rope`` is ``rope_tables`` of the positions."""
    b, s, d = x.shape

    def proj(w):
        return (x.reshape(b * s, d) @ w.reshape(d, -1).to(x.dtype)).reshape(
            b, s, w.shape[1], w.shape[2])

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if not cfg.learned_pos_emb:
        q = _rotate(q, *rope)
        k = _rotate(k, *rope)
    return q, k, v


def attn_out(p, x_dtype, attn):
    """attn: (..., H, hd) -> (..., d_model)."""
    w = p["wo"]
    lead = attn.shape[:-2]
    y = attn.reshape(-1, w.shape[0] * w.shape[1]) @ w.reshape(
        -1, w.shape[2]).to(x_dtype)
    return y.reshape(*lead, w.shape[2])


def apply_mlp(p, x):
    g = x @ p["wi_gate"].to(x.dtype)
    u = x @ p["wi_up"].to(x.dtype)
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p["wo"].to(x.dtype)


def embed_tokens(p, tokens, dtype):
    return p["embedding"][tokens].to(dtype)


def unembed(p, x, cfg):
    """Logits over the padded vocab; pad rows masked to -1e9."""
    w = p.get("lm_head")
    if w is None:
        logits = x @ p["embedding"].to(x.dtype).T
    else:
        logits = x @ w.to(x.dtype)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e9)
    return logits


# --------------------------------------------------------------------------
# padded (dense) attention
# --------------------------------------------------------------------------
def run_layer(body, remat: bool, *args):
    """``body(*args)``, under ``torch.utils.checkpoint`` (non-reentrant:
    only the layer's inputs are kept, its activations are recomputed in
    the backward) with ``remat``, as the JAX package wraps its scanned
    layer in ``jax.checkpoint``."""
    if remat:
        return torch.utils.checkpoint.checkpoint(body, *args,
                                                 use_reentrant=False)
    return body(*args)


def big_attention(q, k, v, *, causal: bool, window: int = 0):
    """Attention of a padded batch. q: (B, S, H, D); k, v: (B, Sk, KV, D),
    Sk != S only for non-causal attention without a window (an encoder's
    frames under a decoder's queries). On a GPU every length goes through
    the flash kernel (it masks the ragged edges, so there is no
    tile-multiple gate); on the CPU the plain version runs
    ``attention_dense`` under the causal/window mask, as the JAX CPU path
    does.

    Under autograd (grad mode on and q, k or v requiring grad) it is the
    training path's ``flash_vjp.flash_attention_vjp``: on a GPU the flash
    kernel with its lse and the hand-written backward; on the CPU, as the
    JAX CPU path, ``attention_dense`` under autograd up to 1024 tokens and
    the plain flash VJP (chunks of 512 where they divide) beyond."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        s, sk = q.shape[1], k.shape[1]
        if q.device.type == "cuda" or max(s, sk) > 1024:
            return flash_vjp.flash_attention_vjp(
                q, k, v, causal=causal, window=window,
                chunk_q=512 if s % 512 == 0 else s,
                chunk_k=512 if sk % 512 == 0 else sk)
    return ops.flash_attention(q, k, v, causal=causal, window=window)


def cp_attention(cfg, q, k, v, *, causal: bool, window: int = 0):
    """Context-parallel attention on one device: ``big_attention`` (the
    JAX package's sequence-sharded branch needs a mesh)."""
    return big_attention(q, k, v, causal=causal, window=window)


# --------------------------------------------------------------------------
# packed ragged prefill
# --------------------------------------------------------------------------
def packed_positions(seg_ids, seg_starts):
    """Within-segment position of every token of a packed row; padding
    tokens (id == S) get position 0."""
    t = torch.arange(seg_ids.shape[0], device=seg_ids.device,
                     dtype=seg_ids.dtype)
    s = seg_starts.shape[0]
    start = seg_starts[torch.clamp(seg_ids, max=s - 1)]
    return torch.where(seg_ids < s, t - start, torch.zeros_like(t))


def packed_prefill_attention(q, k, v, seg_ids, positions, seg_starts,
                             seg_lens, *, row_len: int, window: int = 0):
    """Segment-blocked causal self-attention over a packed token row.
    q: (1, T, H, D); k/v: (1, T, KV, D). Token i attends token j iff
    their segment ids are equal and j <= i. On a GPU every packed length
    goes through the segment flash kernel."""
    return ops.segment_flash_attention(q, k, v, seg_ids, positions,
                                       seg_starts, seg_lens,
                                       row_len=row_len, window=window)


def packed_cross_attention(q, k_cross, v_cross, seg_ids, positions,
                           seg_starts, seg_lens, *, row_len: int):
    """Per-segment cross-attention of a packed encoder-decoder prefill.
    q: (1, T, H, D) packed decoder queries; k_cross, v_cross:
    (S, enc_seq, KV, D), one read-only encoder block per segment. Each
    packed token attends its OWN segment's encoder output: the queries
    gather to per-segment rows (S, row_len, H, D), attend their block
    non-causally — the flash kernel on a GPU (B = S, Sq = row_len, Sk =
    enc_seq, no (S, H, row_len, enc_seq) scores held), its plain version
    (the JAX package's ``attention_dense``) on the CPU — and gather
    back."""
    qr = segments_to_rows(q[0], seg_starts, seg_lens, row_len)
    ar = ops.flash_attention(qr, k_cross, v_cross, causal=False)
    return rows_to_segments(ar, seg_ids, positions)[None]


# --------------------------------------------------------------------------
# ring and paged KV caches
# --------------------------------------------------------------------------
def cache_row_update(buf, new, slot):
    """Write ``new`` (B, 1, ...) IN PLACE into ``buf`` (B, C, ...) at
    per-row ring position ``slot`` (B,): one row per sequence."""
    bidx = torch.arange(buf.shape[0], device=buf.device)
    buf[bidx, slot.long()] = new[:, 0].to(buf.dtype)
    return buf


def decode_attention(q, k_cache, v_cache, valid_len):
    """Single-token attention over contiguous per-row caches. q: (B, H, D);
    caches: (B, C, KV, D); valid_len: (B,) lengths (0 = zeros) or one int
    for every row (cross-attention's encoder length). On a GPU every C
    goes through the decode kernel (no tile-multiple gate). An int length
    is filled on the device, so a captured step holds no host copy."""
    if isinstance(valid_len, int):
        lengths = torch.full((q.shape[0],), valid_len, dtype=torch.int32,
                             device=q.device)
    else:
        lengths = torch.broadcast_to(
            torch.as_tensor(valid_len, dtype=torch.int32,
                            device=q.device).reshape(-1),
            (q.shape[0],)).contiguous()
    return ops.decode_attention(q, k_cache, v_cache, lengths)


def paged_cache_update(buf, new, pages, slots):
    """Write ``new`` (B, 1, ...) IN PLACE into the paged pool ``buf``
    (P, page_size, ...) at physical page ``pages`` (B,) and in-page offset
    ``slots`` (B,). Live rows own disjoint pages; vacant rows all target
    the never-read null page 0, where duplicate writes are harmless."""
    buf[pages.long(), slots.long()] = new[:, 0].to(buf.dtype)
    return buf


def paged_decode_attention(q, k_pages, v_pages, block_tables, valid_len):
    """Single-token attention over a block-table paged cache. q: (B, H, D);
    pages: (P, page_size, KV, D); block_tables: (B, max_pages) int32;
    valid_len: (B,) int32 lengths (0 = zeros)."""
    return ops.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                      valid_len)


def paged_chunk_attention(q_rows, k_pages, v_pages, k_rows, v_rows,
                          block_tables, hist_lens, seg_lens):
    """Incremental chunk attention: R new tokens per segment attend the
    segment's paged history plus the chunk's own K/V causally. Rows
    r >= seg_lens[s] are padding (callers discard them)."""
    return ops.paged_chunk_attention(q_rows, k_pages, v_pages, k_rows,
                                     v_rows, block_tables, hist_lens,
                                     seg_lens)


def decode_index(pos, cache, key):
    """Per-row write/read machinery of one decode step over either cache
    layout (``block_tables`` present = paged). pos: (B,) int32 positions;
    ``key``: the K leaf the layout is read from. Returns ``(update,
    attend, valid)``: ``update(buf, new)`` writes the step's (B, 1, ...)
    entries in place at each row's coordinates — (page, offset) when
    paged, ring row ``pos % C`` otherwise; ``attend(q, kc, vc, window=0)``
    runs decode attention against the updated buffer; ``valid`` is the
    (B,) lengths vector."""
    if "block_tables" in cache:
        tables = cache["block_tables"]
        page_size = cache[key].shape[2]
        max_pages = tables.shape[1]
        bidx = torch.arange(pos.shape[0], device=pos.device)
        # past-capacity clamp is belt-and-braces: the engine caps every
        # slot's budget at its page capacity (vacant rows sit at pos 0,
        # null page)
        page = tables[bidx, torch.clamp(pos // page_size, max=max_pages - 1)]
        slot = pos % page_size
        valid = torch.clamp(pos + 1, max=max_pages * page_size).to(
            torch.int32)

        def update(buf, new):
            return paged_cache_update(buf, new, page, slot)

        def attend(q, kc, vc, window: int = 0):
            if window:
                # a paged slot keeps its full history (pages never evict),
                # so a window would need page-level masking that is not
                # written; windowed configs stay on ring slots
                raise NotImplementedError(
                    "sliding-window attention over a paged cache")
            return paged_decode_attention(q, kc, vc, tables, valid)

        return update, attend, valid

    cache_len = cache[key].shape[2]
    slot = pos % cache_len if cache_len > 0 else torch.zeros_like(pos)
    valid = torch.clamp(pos + 1, max=cache_len).to(torch.int32)

    def update(buf, new):
        return cache_row_update(buf, new, slot)

    def attend(q, kc, vc, window: int = 0):
        # a ring slot's overwrite is its window: nothing more to mask
        return decode_attention(q, kc, vc, valid)

    return update, attend, valid


def carry_cache_meta(out, cache):
    """Carry the leaves a decode step only reads (``block_tables``) from
    the old cache into the new one."""
    if "block_tables" in cache:
        out["block_tables"] = cache["block_tables"]
    return out


# --------------------------------------------------------------------------
# sampling
# --------------------------------------------------------------------------
def gumbel_noise(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(U))`` of ``shape`` in float32 on
    the generator's device, U uniform on [tiny, 1) — what
    ``jax.random.gumbel`` draws from a key. Every sampled token of the port
    draws its noise here."""
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def top_k_top_p_filter(logits: torch.Tensor, *, top_k: int = 0,
                       top_p: float = 1.0) -> torch.Tensor:
    """Mask logits outside the top-k set and/or the top-p nucleus to -1e30.
    ``top_k``/``top_p`` are Python values (one captured step per pair). The
    arg-max token is always kept, so a degenerate ``top_p`` can never mask
    the whole vocabulary."""
    if top_k and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -1e30)
    if top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt.float(), dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens whose cumulative mass BEFORE them is < top_p
        keep = (cum - probs) < top_p
        keep[..., 0] = True
        thresh = torch.where(keep, srt, torch.full_like(srt, float("inf"))
                             ).amin(-1, keepdim=True).to(logits.dtype)
        logits = logits.masked_fill(logits < thresh, -1e30)
    return logits


def sample_logits(generator: torch.Generator, logits: torch.Tensor, *,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """Next tokens (B,) from (B, V) logits. ``temperature <= 0`` is the
    greedy arg-max; otherwise temperature-scaled top-k/top-p sampling by
    the Gumbel trick: the arg-max of ``gumbel_noise`` plus the filtered
    float32 logits."""
    if temperature <= 0.0:
        return torch.argmax(logits, -1)
    lg = logits.float() / temperature
    lg = top_k_top_p_filter(lg, top_k=top_k, top_p=top_p)
    return torch.argmax(gumbel_noise(generator, lg.shape) + lg, -1)
