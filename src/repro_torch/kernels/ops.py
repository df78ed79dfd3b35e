"""Device dispatch for the attention kernels and the SSD scan.

A tensor on a CUDA device goes to the hand-written kernel (which raises on
what it does not take); a tensor on the CPU goes to the kernel's plain
PyTorch version. There is no fallback from one to the other: a CUDA tensor
never reaches a plain version here.

Each wrapper counts its kernel's launches in a module global;
``launch_counts`` reads them all, by kernel name, and ``add_launches``
moves them (a captured CUDA graph takes back what its capture counted and
adds it again at each replay: ``repro_torch.serving.graphs``).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import chunk_attention as _chunk
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import flash_vjp as _vjp
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ssd_scan as _ssd


# kernel name -> (module, attribute) of its launch count
_COUNTERS = {
    "paged_decode_attention": (_paged, "launches"),
    "segment_flash_attention": (_flash, "segment_launches"),
    "paged_chunk_attention": (_chunk, "launches"),
    "decode_attention": (_decode, "launches"),
    "flash_attention": (_flash, "flash_launches"),
    "ssd_scan": (_ssd, "launches"),
    "flash_attention_bwd": (_vjp, "bwd_launches"),
}


def launch_counts() -> Dict[str, int]:
    """Every kernel's launches so far, by kernel name."""
    return {n: getattr(m, a) for n, (m, a) in _COUNTERS.items()}


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (by kernel name; negative takes back) to the
    kernels' launch counts."""
    for n, k in counts.items():
        m, a = _COUNTERS[n]
        setattr(m, a, getattr(m, a) + k)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    add_launches({n: -k for n, k in launch_counts().items()})


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
    """q: (B, S, H, D); k, v: (B, Sk, KV, D) -> (B, S, H, D); Sk != S
    only non-causal without a window."""
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


def ssd(x, dt, a, b, c, *, chunk: int = 128, initial_state=None):
    """Chunked SSD (Mamba2). x: (B, L, H, P); dt: (B, L, H); a: (H,);
    b, c: (B, L, N) -> (y (B, L, H, P), final_state (B, H, N, P) float32).
    Any L: the chunk is ``min(chunk, L)`` rows and positions past L act as
    dt = 0. On a GPU the kernel takes dt, a and the initial state in
    float32."""
    if _route(x) == "cuda":
        return _ssd.ssd_scan_cuda(x, dt.float(), a.float(), b, c, chunk,
                                  initial_state)
    return _ssd.ssd_chunked_plain(x, dt, a, b, c, chunk, initial_state)


def ssd_decode(x, dt, a, b, c, state):
    """One-token SSD update. x: (B, H, P); dt: (B, H); b, c: (B, N);
    state (B, H, N, P) -> (y (B, H, P), new state float32). Elementwise
    work and a mat-vec: the JAX package has no kernel for it, and this is
    plain PyTorch on either device."""
    return _ssd.ssd_decode_plain(x, dt, a, b, c, state)
