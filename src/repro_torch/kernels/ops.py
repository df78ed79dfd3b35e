"""Device dispatch for the attention kernels.

A tensor on a CUDA device goes to the hand-written kernel (which raises on
what it does not take); a tensor on the CPU goes to the kernel's plain
PyTorch version. There is no fallback from one to the other: a CUDA tensor
never reaches a plain version here.
"""
from __future__ import annotations

from repro_torch.kernels import chunk_attention as _chunk
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_attention as _paged


def _route(t) -> str:
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"no attention kernel for device {t.device}")


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths):
    """q: (B, H, D); pages: (P, page_size, KV, D); block_tables:
    (B, max_pages) int32; lengths: (B,) int32 -> (B, H, D)."""
    if _route(q) == "cuda":
        return _paged.paged_decode_attention_cuda(
            q, k_pages, v_pages, block_tables, lengths)
    return _paged.paged_decode_attention_plain(
        q, k_pages, v_pages, block_tables, lengths)


def decode_attention(q, k_cache, v_cache, lengths):
    """q: (B, H, D); caches: (B, C, KV, D); lengths: (B,) int32 ->
    (B, H, D)."""
    if _route(q) == "cuda":
        return _decode.decode_attention_cuda(q, k_cache, v_cache, lengths)
    return _decode.decode_attention_plain(q, k_cache, v_cache, lengths)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, D); k, v: (B, S, KV, D) -> (B, S, H, D)."""
    if _route(q) == "cuda":
        return _flash.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window)
    return _flash.flash_attention_plain(q, k, v, causal=causal, window=window)


def segment_flash_attention(q, k, v, seg_ids, positions, seg_starts,
                            seg_lens, *, row_len: int, window: int = 0):
    """q: (1, T, H, D); k, v: (1, T, KV, D); seg_ids, positions: (T,);
    seg_starts, seg_lens: (S,) -> (1, T, H, D). The kernel needs only the
    segment ids; the plain version also reads the segment layout."""
    if _route(q) == "cuda":
        return _flash.segment_flash_attention_cuda(q, k, v, seg_ids,
                                                   window=window)
    return _flash.segment_flash_attention_plain(
        q, k, v, seg_ids, positions, seg_starts, seg_lens, row_len=row_len,
        window=window)


def paged_chunk_attention(q, k_pages, v_pages, k_rows, v_rows, block_tables,
                          hist_lens, seg_lens, *, window: int = 0):
    """q/k_rows/v_rows: (S, R, H|KV, D); pages: (P, page_size, KV, D);
    block_tables: (S, max_pages); hist_lens, seg_lens: (S,) ->
    (S, R, H, D)."""
    if _route(q) == "cuda":
        return _chunk.paged_chunk_attention_cuda(
            q, k_pages, v_pages, k_rows, v_rows, block_tables, hist_lens,
            seg_lens, window=window)
    return _chunk.paged_chunk_attention_plain(
        q, k_pages, v_pages, k_rows, v_rows, block_tables, hist_lens,
        seg_lens, window=window)
