"""Incremental chunk attention over paged K/V: the CUDA kernel's wrapper,
its plain PyTorch version, and the kernel's launch count.

Replaces the TPU kernel ``src/repro/kernels/chunk_attention.py``
(``paged_chunk_attention``). Segment ``s`` holds R new chunk rows; row
``r`` sits at absolute position ``hist_lens[s] + r`` and attends the
segment's paged history ``[0, hist_lens[s])`` (through its block-table
row) plus the chunk's rows ``c <= r`` with ``c < seg_lens[s]``. Rows
``r >= seg_lens[s]`` are padding: unspecified in the plain version, zeros
from the kernel.

``paged_chunk_attention_cuda`` launches ``csrc/chunk_attention.cu``: in
bfloat16 the tensor-core attend body of the flash kernels over absolute
key positions (the paged history below ``hist_lens[s]``, the chunk above
it), one warpgroup per 64 chunk rows of one (segment, query head); in
float32 the FMA tiles of ``csrc/attn_common.cuh``.
``paged_chunk_attention_plain`` gathers the history pages, scatters the
chunk in at its absolute positions, and runs the masked decode body once
per chunk row, as the JAX CPU path does (``layers.paged_chunk_attention``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

# kernel launches so far; a run resets it to 0 and reads it back to show
# that its path went through the kernel
launches = 0


def paged_chunk_attention_plain(q, k_pages, v_pages, k_rows, v_rows,
                                block_tables, hist_lens, seg_lens, *,
                                window: int = 0):
    """Plain version. q/k_rows/v_rows: (S, R, H|KV, D); pages:
    (P, page_size, KV, D); block_tables: (S, max_pages); hist_lens,
    seg_lens: (S,). Each chunk row runs the masked decode body against
    the segment's logical cache with its own length (hist + r + 1, or 0
    for padding rows); with a window, keys at least ``window`` positions
    behind the row are masked too."""
    s, r_len, h, d = q.shape
    _, page_size, kvh, _ = k_pages.shape
    max_pages = block_tables.shape[1]
    cap = max_pages * page_size
    dev = q.device
    hist = hist_lens.long().reshape(s)
    slen = seg_lens.long().reshape(s)
    kc = k_pages[block_tables].reshape(s, cap, kvh, d).clone()
    vc = v_pages[block_tables].reshape(s, cap, kvh, d).clone()
    rows = torch.arange(r_len, device=dev)
    pos = hist[:, None] + rows[None, :]                       # (S, R)
    keep = pos < cap                                          # drop the rest
    sidx = torch.arange(s, device=dev)[:, None].expand(s, r_len)
    kc[sidx[keep], pos[keep]] = k_rows[keep].to(kc.dtype)
    vc[sidx[keep], pos[keep]] = v_rows[keep].to(vc.dtype)
    lengths = torch.where(rows[None, :] < slen[:, None], pos + 1,
                          torch.zeros_like(pos))              # (S, R)
    rep = h // kvh
    qg = q.reshape(s, r_len, kvh, rep, d)
    sc = torch.einsum("srgud,skgd->srguk", qg.float(), kc.float())
    sc = sc / math.sqrt(d)
    kpos = torch.arange(cap, device=dev)
    mask = kpos[None, None, :] < lengths[:, :, None]          # (S, R, C)
    if window:
        mask = mask & (pos[:, :, None] - kpos[None, None, :] < window)
    mask = mask[:, :, None, None, :]
    sc = torch.where(mask, sc, torch.full_like(sc, -1e30))
    w = torch.softmax(sc, dim=-1).to(q.dtype)
    out = torch.einsum("srguk,skgd->srgud", w.float(), vc.float())
    out = torch.where((lengths > 0)[:, :, None, None, None], out,
                      torch.zeros_like(out))
    return out.reshape(s, r_len, h, d).to(q.dtype)


def paged_chunk_attention_cuda(q, k_pages, v_pages, k_rows, v_rows,
                               block_tables, hist_lens, seg_lens, *,
                               window: int = 0):
    """Launch the CUDA kernel. Shapes as the plain version; block_tables,
    hist_lens and seg_lens int32; page_size a multiple of 8; head_dim 64
    or 128. Padding rows come back as zeros."""
    global launches
    s, r_len, h, d = q.shape
    _, page_size, kvh, _ = k_pages.shape
    max_pages = block_tables.shape[1]
    build.check_operands("paged_chunk_attention", d,
                         head_dims=build.CHUNK_HEAD_DIMS, q=q,
                         k_pages=k_pages, v_pages=v_pages, k_rows=k_rows,
                         v_rows=v_rows, block_tables=block_tables,
                         hist_lens=hist_lens, seg_lens=seg_lens)
    build.check_aligned("paged_chunk_attention", q=q, k_pages=k_pages,
                        v_pages=v_pages, k_rows=k_rows, v_rows=v_rows)
    if page_size % 8:
        raise ValueError(f"page_size {page_size} is not a multiple of 8")
    if (h % kvh or v_pages.shape != k_pages.shape
            or tuple(k_rows.shape) != (s, r_len, kvh, d)
            or v_rows.shape != k_rows.shape):
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}, chunk "
                         f"{tuple(k_rows.shape)}/{tuple(v_rows.shape)}")
    for name, t in (("block_tables", block_tables), ("hist_lens", hist_lens),
                    ("seg_lens", seg_lens)):
        if t.dtype != torch.int32 or t.shape[0] != s:
            raise ValueError(f"{name} must be int32 with S = {s} rows")
    if any(t.dtype != q.dtype for t in (k_pages, v_pages, k_rows, v_rows)):
        raise ValueError("q, the pages and the chunk must share one dtype")
    out = torch.empty_like(q)
    fn = build.function("paged_chunk_attention")
    err = fn(out.data_ptr(), q.data_ptr(), k_pages.data_ptr(),
             v_pages.data_ptr(), k_rows.data_ptr(), v_rows.data_ptr(),
             block_tables.data_ptr(), hist_lens.data_ptr(),
             seg_lens.data_ptr(), s, r_len, h, kvh, d, page_size, max_pages,
             int(window), build.dtype_code(q.dtype), 1.0 / math.sqrt(d),
             build.stream_of(q))
    build.check(err, "paged_chunk_attention")
    launches += 1
    return out
