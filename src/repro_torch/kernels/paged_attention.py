"""Paged single-token decode attention: the CUDA kernel's wrapper, its plain
PyTorch version, and the kernel's launch count.

Replaces the TPU kernel ``src/repro/kernels/paged_attention.py``
(``paged_decode_attention``). K/V live in a shared pool of fixed-size pages
``(P, page_size, KV, D)``; row ``b``'s logical position ``t`` is stored at
``(block_tables[b, t // page_size], t % page_size)``. Rows of length 0
(vacant slots, parked on the null page) return exact zeros.

``paged_decode_attention_cuda`` launches ``csrc/paged_attention.cu`` (one
block per (KV head, row), walking only the row's live pages);
``paged_decode_attention_plain`` gathers the pages into logical order and
runs the masked decode body the JAX package's CPU path runs
(``layers._masked_decode_attention``; here
``decode_attention.masked_decode_attention``). ``repro_torch.kernels.ops``
picks one by the device the tensors lie on.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import masked_decode_attention

# kernel launches so far; a run resets it to 0 and reads it back to show
# that its path went through the kernel
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


def paged_decode_attention_cuda(q, k_pages, v_pages, block_tables,
                                lengths):
    """Launch the CUDA kernel. q: (B, H, D); pages: (P, page_size, KV, D);
    block_tables: (B, max_pages) int32; lengths: (B,) int32. page_size
    must be a multiple of 8 and head_dim 64 or 128."""
    global launches
    b, h, d = q.shape
    _, page_size, kvh, _ = k_pages.shape
    max_pages = block_tables.shape[1]
    build.check_operands("paged_decode_attention", d, q=q, k_pages=k_pages,
                         v_pages=v_pages, block_tables=block_tables,
                         lengths=lengths)
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
    out = torch.empty_like(q)
    fn = build.function("paged_decode_attention")
    err = fn(out.data_ptr(), q.data_ptr(), k_pages.data_ptr(),
             v_pages.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
             b, h, kvh, d, page_size, max_pages, build.dtype_code(q.dtype),
             1.0 / math.sqrt(d), build.stream_of(q))
    build.check(err, "paged_decode_attention")
    launches += 1
    return out
