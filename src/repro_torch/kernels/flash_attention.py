"""Flash attention forward: the dense (padded) GQA forward and the
segment-masked packed prefill — the two CUDA kernels' wrappers, their
plain PyTorch versions, and one launch count for each kernel.

Replaces the TPU kernels of ``src/repro/kernels/flash_attention.py``:

* ``flash_attention``: q (B, S, H, D) against k, v (B, Sk, KV, D); token
  ``i`` attends token ``j`` iff ``j <= i`` when causal and ``i - j <
  window`` when a window is given. Padded ``prefill`` and ``forward`` run
  it (``layers.big_attention``), and so do the encoder-decoder family's
  encoder and cross-attention (non-causal, Sk the encoder's frames: the
  only calls with Sk != S, which causal or windowed calls refuse).
  ``flash_attention_cuda`` launches ``csrc/flash_attention.cu`` for any S
  and Sk (the kernel masks the ragged edges): bfloat16 on the tensor
  cores (``wgmma``), float32 on the CUDA cores, chosen by dtype behind
  the one C entry; ``flash_attention_plain`` is ``attention_dense`` under
  the same mask, as the JAX CPU path's ``big_attention`` runs it.
* ``segment_flash_attention``: a packed row concatenates the prompts of an
  admission batch; token ``i`` attends token ``j`` iff their segment ids
  are equal and ``j <= i`` (and ``i - j < window`` when a window is
  given). ``segment_flash_attention_cuda`` launches the same source for
  any packed length T (bfloat16 on the dense kernel's tensor-core main
  loop under a segment mask, float32 on the CUDA cores);
  ``segment_flash_attention_plain`` gathers each segment into its own
  row and runs the dense causal plain version there,
  as the JAX CPU path does (``layers.packed_prefill_attention``). Padding
  tokens' outputs are unspecified in both (callers discard them).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

# kernel launches so far, one count per kernel; a run resets them to 0 and
# reads them back to show that its path went through the kernels
flash_launches = 0
segment_launches = 0

# query rows per block of the plain version's dense scores: beyond it the
# (B, H, rows, S) score tensor is built block by block (each row's softmax
# is whole either way)
PLAIN_Q_BLOCK = 1024


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


def repeat_kv(k, n_rep: int):
    """(B, S, KV, D) -> (B, S, KV * n_rep, D), each KV head repeated for
    the n_rep query heads of its group."""
    if n_rep == 1:
        return k
    b, s, kv, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, d).reshape(
        b, s, kv * n_rep, d)


def attention_dense(q, k, v, *, causal: bool, q_offset: int = 0,
                    bias_mask=None):
    """Plain quadratic attention. q: (B, Sq, H, D); k, v: (B, Sk, KV, D).
    Scores in float32, masked to -1e30, weights rounded to q's dtype."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    k = repeat_kv(k, h // kv)
    v = repeat_kv(v, h // kv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(d)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        scores = torch.where(qpos >= kpos, scores,
                             torch.full_like(scores, -1e30))
    if bias_mask is not None:
        scores = torch.where(bias_mask, scores,
                             torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """Plain version: ``attention_dense`` under the causal/window mask.
    q: (B, S, H, D); k, v: (B, Sk, KV, D). Queries go in blocks of
    ``PLAIN_Q_BLOCK`` rows so long prompts never hold all S * Sk
    scores."""
    s, sk = q.shape[1], k.shape[1]
    outs = []
    for q0 in range(0, s, PLAIN_Q_BLOCK):
        qb = q[:, q0:q0 + PLAIN_Q_BLOCK]
        qp = torch.arange(q0, q0 + qb.shape[1], device=q.device)[:, None]
        kp = torch.arange(sk, device=q.device)[None, :]
        mask = torch.ones(qb.shape[1], sk, dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (qp >= kp)
        if window:
            mask = mask & (qp - kp < window)
        outs.append(attention_dense(qb, k, v, causal=False, bias_mask=mask))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         lse: bool = False):
    """Launch the dense CUDA kernel. q: (B, S, H, D); k, v: (B, Sk, KV, D);
    head_dim 64, 128 or 112; any S and Sk, Sk != S only non-causal without a
    window. ``lse``: also return each row's log-sum-exp of its scaled
    scores, (B, H, S) float32 (the training path's forward,
    ``flash_vjp``; a row that sees no key gets -1e30); serving passes no
    lse pointer and the kernel stores none."""
    global flash_launches
    b, s, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    build.check_operands("flash_attention", d, q=q, k=k, v=v)
    if q.dtype == torch.bfloat16:  # the tensor-core kernel copies 16 B
        build.check_aligned("flash_attention", q=q, k=k, v=v)
    if (h % kvh or v.shape != k.shape or k.shape[0] != b
            or k.shape[3] != d):
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if sk != s and (causal or window):
        raise ValueError(f"{sk} keys for {s} queries: causal or windowed "
                         f"attention needs as many keys as queries")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype")
    out = torch.empty_like(q)
    lse_out = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
               if lse else None)
    fn = build.function("flash_attention")
    err = fn(out.data_ptr(), lse_out.data_ptr() if lse else None,
             q.data_ptr(), k.data_ptr(), v.data_ptr(), b, s, sk, h, kvh, d,
             int(bool(causal)), int(window), build.dtype_code(q.dtype),
             1.0 / math.sqrt(d), build.stream_of(q))
    build.check(err, "flash_attention")
    flash_launches += 1
    return (out, lse_out) if lse else out


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
    ar = flash_attention_plain(qr, kr, vr, causal=True, window=window)
    return rows_to_segments(ar, seg_ids, positions)[None]


def segment_flash_attention_cuda(q, k, v, seg_ids, *, window: int = 0):
    """Launch the CUDA kernel. q: (B, T, H, D); k, v: (B, T, KV, D);
    seg_ids: (T,) or (B, T) int32, non-decreasing along T."""
    global segment_launches
    b, t, h, d = q.shape
    kvh = k.shape[2]
    seg = seg_ids.reshape(-1, t).expand(b, t).contiguous()
    build.check_operands("segment_flash_attention", d, q=q, k=k, v=v,
                         seg_ids=seg)
    if q.dtype == torch.bfloat16:  # the tensor-core kernel copies 16 B
        build.check_aligned("segment_flash_attention", q=q, k=k, v=v)
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
    segment_launches += 1
    return out
