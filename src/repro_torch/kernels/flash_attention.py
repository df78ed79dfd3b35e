"""Segment-masked causal attention over a packed prefill row: the CUDA
kernel's wrapper, its plain PyTorch version, and the kernel's launch
count.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``
(``segment_flash_attention``). A packed row concatenates the prompts of an
admission batch; token ``i`` attends token ``j`` iff their segment ids are
equal and ``j <= i`` (and ``i - j < window`` when a window is given).

``segment_flash_attention_cuda`` launches ``csrc/flash_attention.cu`` for
any packed length T (the kernel masks the ragged edge);
``segment_flash_attention_plain`` gathers each segment into its own row
and runs dense causal attention there, as the JAX CPU path does
(``layers.packed_prefill_attention`` → ``attention_dense``). Padding
tokens' outputs are unspecified in both (callers discard them).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

# kernel launches so far; a run resets it to 0 and reads it back to show
# that its path went through the kernel
launches = 0


def segments_to_rows(x, seg_starts, seg_lens, row_len: int):
    """Gather a packed (T, ...) tensor into per-segment rows
    (S, row_len, ...): row i holds its segment's tokens at columns
    0..len_i-1 and exact zeros after."""
    t = x.shape[0]
    cols = torch.arange(row_len, device=x.device)
    idx = torch.clamp(seg_starts.long()[:, None] + cols[None, :], 0, t - 1)
    rows = x[idx]
    valid = cols[None, :] < seg_lens.long()[:, None]
    valid = valid.reshape(valid.shape + (1,) * (x.dim() - 1))
    return torch.where(valid, rows, torch.zeros_like(rows))


def rows_to_segments(rows, seg_ids, positions):
    """Gather per-segment rows back to the packed (T, ...) layout (the
    inverse of ``segments_to_rows`` for real tokens; padding tokens read a
    clamped entry that every consumer discards)."""
    r = torch.clamp(seg_ids.long(), 0, rows.shape[0] - 1)
    c = torch.clamp(positions.long(), 0, rows.shape[1] - 1)
    return rows[r, c]


def attention_dense(q, k, v, *, window: int = 0):
    """Dense causal attention, GQA by repeating K/V. q: (B, S, H, D); k, v:
    (B, S, KV, D). Scores in float32, weights rounded to q's dtype."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(d)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = qpos >= kpos
    if window:
        mask = mask & (qpos - kpos < window)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def segment_flash_attention_plain(q, k, v, seg_ids, positions, seg_starts,
                                  seg_lens, *, row_len: int, window: int = 0):
    """Plain version. q: (1, T, H, D); k, v: (1, T, KV, D); seg_ids,
    positions: (T,); seg_starts, seg_lens: (S,); row_len >= the longest
    segment. Segments gather into rows, run dense causal attention, and
    gather back."""
    h, kvh = q.shape[2], k.shape[2]
    qkv = torch.cat([q[0], k[0], v[0]], dim=1)            # (T, H+2KV, D)
    rows = segments_to_rows(qkv, seg_starts, seg_lens, row_len)
    qr, kr, vr = rows[:, :, :h], rows[:, :, h:h + kvh], rows[:, :, h + kvh:]
    ar = attention_dense(qr, kr, vr, window=window)
    return rows_to_segments(ar, seg_ids, positions)[None]


def segment_flash_attention_cuda(q, k, v, seg_ids, *, window: int = 0):
    """Launch the CUDA kernel. q: (B, T, H, D); k, v: (B, T, KV, D);
    seg_ids: (T,) or (B, T) int32, non-decreasing along T."""
    global launches
    b, t, h, d = q.shape
    kvh = k.shape[2]
    seg = seg_ids.reshape(-1, t).expand(b, t).contiguous()
    build.check_operands("segment_flash_attention", d, q=q, k=k, v=v,
                         seg_ids=seg)
    if h % kvh or v.shape != k.shape or k.shape[:2] != q.shape[:2]:
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if seg.dtype != torch.int32:
        raise ValueError("seg_ids must be int32")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype")
    out = torch.empty_like(q)
    fn = build.function("segment_flash_attention")
    err = fn(out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
             seg.data_ptr(), b, t, h, kvh, d, int(window),
             build.dtype_code(q.dtype), 1.0 / math.sqrt(d),
             build.stream_of(q))
    build.check(err, "segment_flash_attention")
    launches += 1
    return out
