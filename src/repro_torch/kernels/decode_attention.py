"""Ragged single-token decode attention over contiguous per-row caches: the
CUDA kernel's wrapper, its plain PyTorch version, and the kernel's launch
count.

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py``
(``decode_attention``). Row ``b`` attends the first ``lengths[b]`` entries
of its cache ``(C, KV, D)``; rows of length 0 (vacant slots) return exact
zeros. Ring slots and the batch ``generate`` loop decode through it.

``decode_attention_cuda`` launches ``csrc/decode_attention.cu`` (one block
per (KV head, row), walking only the row's live keys);
``decode_attention_plain`` runs the masked decode body the JAX package's
CPU path runs (``layers._masked_decode_attention``), which the paged plain
version (``paged_attention``) shares after its page gather.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

# kernel launches so far; a run resets it to 0 and reads it back to show
# that its path went through the kernel
launches = 0


def masked_decode_attention(q, k_cache, v_cache, lengths):
    """The masked decode-attention body over a logical cache.

    q: (B, H, D); caches: (B, C, KV, D); lengths: (B,) int. Scores and
    the weighted sum accumulate in float32, the softmax weights round to
    q's dtype in between (as the JAX CPU path does); rows with length 0
    return zeros."""
    b, c, kvh, d = k_cache.shape
    h = q.shape[1]
    qg = q.reshape(b, kvh, h // kvh, d)
    sc = torch.einsum("bgrd,bkgd->bgrk", qg.float(), k_cache.float())
    sc = sc / math.sqrt(d)
    pos = torch.arange(c, device=q.device)
    mask = pos[None, None, None, :] < lengths.reshape(b, 1, 1, 1)
    sc = torch.where(mask, sc, torch.full_like(sc, -1e30))
    w = torch.softmax(sc, dim=-1).to(q.dtype)
    out = torch.einsum("bgrk,bkgd->bgrd", w.float(), v_cache.float())
    out = torch.where(lengths.reshape(b, 1, 1, 1) > 0, out,
                      torch.zeros_like(out))
    return out.reshape(b, h, d).to(q.dtype)


def decode_attention_plain(q, k_cache, v_cache, lengths):
    """Plain version: the masked decode body. Same contract as the
    kernel."""
    return masked_decode_attention(q, k_cache, v_cache, lengths)


def decode_attention_cuda(q, k_cache, v_cache, lengths):
    """Launch the CUDA kernel. q: (B, H, D); caches: (B, C, KV, D);
    lengths: (B,) int32 (clamped to [0, C] by the kernel); head_dim 64 or
    128."""
    global launches
    b, h, d = q.shape
    _, c, kvh, _ = k_cache.shape
    build.check_operands("decode_attention", d, q=q, k_cache=k_cache,
                         v_cache=v_cache, lengths=lengths)
    if (h % kvh or v_cache.shape != k_cache.shape or k_cache.shape[0] != b
            or k_cache.shape[3] != d):
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise ValueError("lengths must be an int32 (B,) vector")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError("q and the caches must share one dtype")
    out = torch.empty_like(q)
    fn = build.function("decode_attention")
    err = fn(out.data_ptr(), q.data_ptr(), k_cache.data_ptr(),
             v_cache.data_ptr(), lengths.data_ptr(), b, h, kvh, d, c,
             build.dtype_code(q.dtype), 1.0 / math.sqrt(d),
             build.stream_of(q))
    build.check(err, "decode_attention")
    launches += 1
    return out
