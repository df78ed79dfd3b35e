"""Paged single-token decode attention: the CUDA kernel's wrapper, its plain
PyTorch version, and the kernel's launch count.

Replaces the TPU kernel ``src/repro/kernels/paged_attention.py``
(``paged_decode_attention``). K/V live in a shared pool of fixed-size pages
``(P, page_size, KV, D)``; row ``b``'s logical position ``t`` is stored at
``(block_tables[b, t // page_size], t % page_size)``. Rows of length 0
(vacant slots, parked on the null page) return exact zeros.

``paged_decode_attention_cuda`` launches ``csrc/paged_attention.cu``: the
split-K flash-decoding body of the contiguous decode kernel with a
block-table lookup for the key address, one block per (split of
``decode_attention.decode_splits``' ranges of logical positions, KV head,
row), walking only the row's live keys, then a kernel that merges the
splits. ``paged_decode_attention_plain`` gathers the pages into logical
order and runs the masked decode body the JAX package's CPU path runs
(``layers._masked_decode_attention``; here
``decode_attention.masked_decode_attention``). ``repro_torch.kernels.ops``
picks one by the device the tensors lie on.
``paged_decode_attention_split_plain`` emulates the kernel's split and
merge over the pages on the CPU for the tests; no path runs it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (
    decode_attention_split_plain, decode_splits, masked_decode_attention,
    sm_count)

# kernel launches so far (one per wrapper call: the split and merge
# kernels together); a run resets it to 0 and reads it back to show that
# its path went through the kernel
launches = 0


def paged_decode_attention_plain(q, k_pages, v_pages, block_tables,
                                 lengths):
    """Plain version: gather every table entry's page, then the masked
    decode body. Same contract as the kernel."""
    b = q.shape[0]
    _, page_size, kvh, d = k_pages.shape
    max_pages = block_tables.shape[1]
    kc = k_pages[block_tables].reshape(b, max_pages * page_size, kvh, d)
    vc = v_pages[block_tables].reshape(b, max_pages * page_size, kvh, d)
    return masked_decode_attention(q, kc, vc, lengths)


def paged_decode_attention_split_plain(q, k_pages, v_pages, block_tables,
                                       lengths, splits: int,
                                       split_len: int):
    """The kernel's arithmetic in plain PyTorch, for the tests: each row's
    live keys fetched through its block table (an entry at or past
    ``ceil(length / page_size)`` is never used, so it may hold anything),
    then the split-K partials and merge of
    ``decode_attention.decode_attention_split_plain`` over the logical
    positions ``[0, max_pages * page_size)``. Same contract as the
    kernel."""
    _, page_size, _, _ = k_pages.shape
    cap = block_tables.shape[1] * page_size
    lens = lengths.long().clamp(0, cap)
    pos = torch.arange(cap, device=q.device)
    live = pos[None, :] < lens[:, None]                         # (B, cap)
    pages = torch.where(live, block_tables.long()[:, pos // page_size], 0)
    kc = k_pages[pages, pos % page_size]             # (B, cap, KV, D)
    vc = v_pages[pages, pos % page_size]
    return decode_attention_split_plain(q, kc, vc, lens, splits, split_len)


def paged_decode_attention_cuda(q, k_pages, v_pages, block_tables,
                                lengths):
    """Launch the CUDA kernels (the splits, then their merge). q:
    (B, H, D); pages: (P, page_size, KV, D); block_tables: (B, max_pages)
    int32; lengths: (B,) int32 (clamped to [0, max_pages * page_size] by
    the kernel). page_size must be a multiple of 8 and head_dim 64, 128
    or 112."""
    global launches
    b, h, d = q.shape
    _, page_size, kvh, _ = k_pages.shape
    max_pages = block_tables.shape[1]
    build.check_operands("paged_decode_attention", d, q=q, k_pages=k_pages,
                         v_pages=v_pages, block_tables=block_tables,
                         lengths=lengths)
    build.check_aligned("paged_decode_attention", q=q, k_pages=k_pages,
                        v_pages=v_pages)
    if page_size % 8:
        raise ValueError(f"page_size {page_size} is not a multiple of 8")
    if h % kvh or v_pages.shape != k_pages.shape:
        raise ValueError(f"bad head/page shapes: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    if (block_tables.dtype != torch.int32 or lengths.dtype != torch.int32
            or tuple(lengths.shape) != (b,)
            or block_tables.shape[0] != b):
        raise ValueError("block_tables (B, max_pages) and lengths (B,) "
                         "must be int32")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("q and the pages must share one dtype")
    splits, split_len = decode_splits(b, kvh, max_pages * page_size,
                                      sm_count(q.device.index))
    out = torch.empty_like(q)
    scratch = torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                          device=q.device)
    fn = build.function("paged_decode_attention")
    err = fn(out.data_ptr(), q.data_ptr(), k_pages.data_ptr(),
             v_pages.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
             scratch.data_ptr(), b, h, kvh, d, page_size, max_pages, splits,
             split_len, build.dtype_code(q.dtype), 1.0 / math.sqrt(d),
             build.stream_of(q))
    build.check(err, "paged_decode_attention")
    launches += 1
    return out
