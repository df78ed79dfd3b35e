"""The port's attention kernels on the CPU: each plain PyTorch version
against the JAX package's Pallas kernel (run in interpret mode, as the JAX
tests run it) and against the JAX CPU path the serving engine takes, on
the same numpy inputs; plus the CPU-side contracts of the CUDA wrappers
(dispatch by device, refusal of CPU tensors, the ctypes signatures) — for
the paged, packed and chunk kernels of paged serving and the contiguous
decode and dense flash kernels of ring slots and ``generate``, and the
SSD scan of the Mamba2 family (its chunked plain version against the JAX
CPU path, the interpret-mode Pallas kernel and the sequential oracle; and
the bf16 kernel's number scheme, emulated in plain PyTorch, against the
gates the card applies to the kernel); and the bf16 flash backward's
number scheme, emulated the same way, against the card's gate.

Tolerance: 2e-5 absolute against the interpret-mode kernels (their online
softmax sums in another order, as the JAX tests allow), 1e-5 against the
JAX CPU paths (same arithmetic, another framework's float32 reductions).
Padding rows/tokens are unspecified by contract and not compared. The SSD
scan: 1e-5 of the output's scale (max |y|, at least 1) against the JAX
CPU path and the interpret-mode kernel — the same chunked arithmetic in
other float32 reduction orders, whose rounding grows with the summands
(|y| reaches ~100 here, and each framework is ~3e-5 from a float64 run),
so an absolute 1e-5 on small entries would test the rounding, not the
port — and 2e-3 against the sequential oracle (the chunked form
reassociates L-long sums), as ``tests/test_kernels.py`` allows.
"""
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.chunk_attention import \
    paged_chunk_attention as jax_chunk_kernel  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention as jax_decode_kernel  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as jax_flash_kernel  # noqa: E402
from repro.kernels.flash_attention import \
    segment_flash_attention as jax_segment_kernel  # noqa: E402
from repro.kernels.paged_attention import \
    paged_decode_attention as jax_paged_kernel  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import chunk_attention as CA  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

KERNEL_ATOL = 2e-5
PATH_TOL = dict(atol=1e-5, rtol=1e-5)

# the JAX CPU paths, compiled whole (faster here than op-by-op dispatch)
jax_paged_path = jax.jit(JL.paged_decode_attention)
jax_chunk_path = jax.jit(JL.paged_chunk_attention)
jax_packed_path = jax.jit(JL.packed_prefill_attention,
                          static_argnames=("row_len", "window"))
jax_decode_path = jax.jit(JL.decode_attention)
jax_big_path = jax.jit(JL.big_attention, static_argnames=("causal", "window"))


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ paged decode
PAGED_CASES = [
    # (b, h, kv, d, page_size, max_pages, lengths)
    (4, 8, 2, 64, 16, 4, [0, 37, 64, 13]),      # empty + full rows
    (3, 4, 4, 64, 8, 2, [1, 16, 9]),            # MHA, page_size 8
    (2, 14, 2, 64, 32, 4, [100, 3]),            # qwen2 heads (rep 7)
    (5, 8, 1, 64, 16, 4, [0, 0, 64, 33, 63]),   # MQA, several empty rows
]


def _paged_case(seed, b, h, kv, d, ps, maxp):
    rng = np.random.default_rng(seed)
    n_phys = b * maxp + 1
    q = rng.standard_normal((b, h, d), np.float32)
    kp = rng.standard_normal((n_phys, ps, kv, d), np.float32)
    vp = rng.standard_normal((n_phys, ps, kv, d), np.float32)
    tables = (rng.permutation(n_phys - 1) + 1)[:b * maxp] \
        .reshape(b, maxp).astype(np.int32)
    return q, kp, vp, tables


@pytest.mark.parametrize("b,h,kv,d,ps,maxp,lengths", PAGED_CASES)
def test_paged_decode_plain_matches_jax(b, h, kv, d, ps, maxp, lengths):
    q, kp, vp, tables = _paged_case(b, b, h, kv, d, ps, maxp)
    lens = np.asarray(lengths, np.int32)
    got = PA.paged_decode_attention_plain(_t(q), _t(kp), _t(vp), _t(tables),
                                          _t(lens)).numpy()
    want = jax_paged_kernel(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                            jnp.asarray(tables), jnp.asarray(lens),
                            interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=KERNEL_ATOL)
    path = jax_paged_path(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                          jnp.asarray(tables), jnp.asarray(lens))
    np.testing.assert_allclose(got, np.asarray(path), **PATH_TOL)
    for i, n in enumerate(lengths):
        if n == 0:
            assert (got[i] == 0).all(), f"row {i} of length 0 not zero"


def test_ops_dispatches_cpu_tensors_to_plain():
    q, kp, vp, tables = _paged_case(0, 2, 4, 2, 64, 8, 2)
    lens = _t(np.asarray([5, 16], np.int32))
    args = (_t(q), _t(kp), _t(vp), _t(tables), lens)
    before = (PA.launches, DA.launches, FA.flash_launches)
    np.testing.assert_array_equal(
        ops.paged_decode_attention(*args).numpy(),
        PA.paged_decode_attention_plain(*args).numpy())
    kc = _t(kp[:2])                                 # (2, 8, 2, 64) caches
    np.testing.assert_array_equal(
        ops.decode_attention(_t(q), kc, kc, lens).numpy(),
        DA.decode_attention_plain(_t(q), kc, kc, lens).numpy())
    x = _t(kp[None, :3, 0])                         # (1, 3, 2, 64)
    np.testing.assert_array_equal(
        ops.flash_attention(x, x, x, causal=False).numpy(),
        FA.flash_attention_plain(x, x, x, causal=False).numpy())
    assert (PA.launches, DA.launches, FA.flash_launches) == before
    meta = torch.zeros(1, 4, 64, device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        ops.paged_decode_attention(meta, *args[1:])


# ------------------------------------------------ contiguous (ring) decode
DECODE_CASES = [
    # (b, h, kv, d, c, lengths, block_k): tests/test_kernels.py's shapes
    # with a scalar length, plus ragged rows with length 0 and a C that
    # is no multiple of 128
    (2, 8, 2, 64, 256, 200, 64),
    (1, 4, 4, 128, 512, 512, 128),
    (2, 14, 2, 64, 256, 100, 64),               # qwen2 heads (rep 7)
    (3, 8, 1, 64, 128, 77, 64),                 # MQA
    (4, 8, 2, 64, 200, [0, 1, 137, 200], 200),  # ragged, C = 200
    (3, 14, 2, 64, 96, [96, 0, 33], 32),        # full ring, empty row
]


@pytest.mark.parametrize("b,h,kv,d,c,lengths,blk", DECODE_CASES)
def test_decode_attention_plain_matches_jax(b, h, kv, d, c, lengths, blk):
    rng = np.random.default_rng(c + b)
    q = rng.standard_normal((b, h, d), np.float32)
    kc = rng.standard_normal((b, c, kv, d), np.float32)
    vc = rng.standard_normal((b, c, kv, d), np.float32)
    lens = np.broadcast_to(np.asarray(lengths, np.int32), (b,)).copy()
    got = DA.decode_attention_plain(_t(q), _t(kc), _t(vc), _t(lens)).numpy()
    jargs = [jnp.asarray(a) for a in (q, kc, vc, lens)]
    want = jax_decode_kernel(*jargs, block_k=blk, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=KERNEL_ATOL)
    np.testing.assert_allclose(got, np.asarray(jax_decode_path(*jargs)),
                               **PATH_TOL)
    # the layer the model calls routes CPU tensors to the same body
    np.testing.assert_array_equal(
        TL.decode_attention(_t(q), _t(kc), _t(vc), _t(lens)).numpy(), got)
    for i, n in enumerate(lens):
        if n == 0:
            assert (got[i] == 0).all(), f"row {i} of length 0 not zero"


SPLIT_SHAPES = [
    # (b, kv, c, sm_count)
    (8, 16, 4096, 132),     # olmo-1b heads, the main ragged shape
    (8, 2, 4096, 132),      # qwen2-0.5b heads
    (1, 16, 16384, 132),    # one long row
    (1, 2, 16384, 132),
    (8, 16, 200, 132),      # C no multiple of the tile
    (4, 2, 300, 132),
    (64, 16, 4096, 132),    # B * KV already fills the card
    (3, 1, 64, 132),        # C of one tile
]


@pytest.mark.parametrize("b,kv,c,sm", SPLIT_SHAPES)
def test_decode_splits_cover_c_in_whole_tiles_and_fill_the_card(b, kv, c,
                                                                sm):
    splits, n = DA.decode_splits(b, kv, c, sm)
    assert splits >= 1
    assert n >= DA.SPLIT_TILE and n % DA.SPLIT_TILE == 0  # whole tiles
    assert splits * n >= c                      # every key has a split
    assert (splits - 1) * n < c                 # no empty range below C
    tiles = -(-c // DA.SPLIT_TILE)
    # at least 2 blocks per SM (the aim, BLOCKS_PER_SM, less what rounding
    # to whole tiles costs), or the splits are as many as tiles and the
    # merge allow
    assert splits <= DA.MAX_SPLITS
    assert (b * kv * splits >= 2 * sm or splits == tiles
            or splits == DA.MAX_SPLITS)
    if b * kv >= DA.BLOCKS_PER_SM * sm:
        assert splits == 1


SPLIT_EMULATION_CASES = [
    # (b, h, kv, d, c, sm_count, lengths): lengths 0, 1, a split
    # boundary +-1 and C
    (6, 8, 2, 64, 300, 132, [0, 1, 63, 64, 65, 300]),
    (4, 14, 2, 64, 256, 132, [127, 128, 129, 256]),
    (3, 4, 4, 128, 1000, 8, [0, 999, 1000]),
    (2, 8, 1, 64, 192, 1, [191, 1]),            # one split
]


@pytest.mark.parametrize("b,h,kv,d,c,sm,lengths", SPLIT_EMULATION_CASES)
def test_decode_split_plain_matches_plain_and_jax(b, h, kv, d, c, sm,
                                                  lengths):
    """The kernel's split-and-merge, emulated on the CPU with the splits
    the wrapper would cut, equals the one-pass softmax: float32 within 1e-6
    of the plain version, of the JAX package's CPU path and of its
    interpret-mode kernel, and length-0 rows are exact zeros."""
    rng = np.random.default_rng(c + h)
    q = rng.standard_normal((b, h, d), np.float32)
    kc = rng.standard_normal((b, c, kv, d), np.float32)
    vc = rng.standard_normal((b, c, kv, d), np.float32)
    lens = np.asarray(lengths, np.int32)
    splits, n = DA.decode_splits(b, kv, c, sm)
    got = DA.decode_attention_split_plain(_t(q), _t(kc), _t(vc), _t(lens),
                                          splits, n).numpy()
    plain = DA.decode_attention_plain(_t(q), _t(kc), _t(vc), _t(lens))
    np.testing.assert_allclose(got, plain.numpy(), atol=1e-6, rtol=0)
    jargs = [jnp.asarray(a) for a in (q, kc, vc, lens)]
    np.testing.assert_allclose(got, np.asarray(jax_decode_path(*jargs)),
                               atol=1e-6, rtol=0)
    want = jax_decode_kernel(*jargs, block_k=64 if c % 64 == 0 else c,
                             interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)
    for i, m in enumerate(lens):
        if m == 0:
            assert (got[i] == 0).all(), f"row {i} of length 0 not zero"


PAGED_SPLIT_CASES = [
    # (h, kv, page_size, max_pages): group of 1 and of 7 (qwen2-0.5b)
    # heads; pages of 8, 16 and 32 over the same 192-key capacity
    (2, 2, 8, 24),
    (14, 2, 8, 24),
    (2, 2, 16, 12),
    (14, 2, 16, 12),
    (2, 2, 32, 6),
    (14, 2, 32, 6),
]


@pytest.mark.parametrize("h,kv,ps,maxp", PAGED_SPLIT_CASES)
def test_paged_decode_split_plain_matches_plain_and_jax(h, kv, ps, maxp):
    """The paged kernel's split-and-merge, emulated on the CPU with the
    splits the wrapper cuts from the capacity (three of 64 keys here, so
    on whole pages), equals the one-pass softmax: float32 within 1e-6 of
    the plain version, of the JAX package's CPU path and of its
    interpret-mode kernel, at lengths 0, 1, each split end -1, +0, +1 and
    the full capacity. The emulation gets tables whose entries past each
    row's live pages point far outside the pool (the kernel never reads
    them); length-0 rows are exact zeros."""
    d, cap = 64, ps * maxp
    lengths = [0, 1, 63, 64, 65, 127, 128, 129, 191, cap]
    b = len(lengths)
    q, kp, vp, tables = _paged_case(ps + h, b, h, kv, d, ps, maxp)
    lens = np.asarray(lengths, np.int32)
    splits, n = DA.decode_splits(b, kv, cap, 132)
    assert (splits, n) == (3, 64) and n % ps == 0
    live = -(-lens // ps)
    past = np.arange(maxp)[None, :] >= live[:, None]
    poisoned = np.where(past, 1 << 30, tables).astype(np.int32)
    got = PA.paged_decode_attention_split_plain(
        _t(q), _t(kp), _t(vp), _t(poisoned), _t(lens), splits, n).numpy()
    plain = PA.paged_decode_attention_plain(_t(q), _t(kp), _t(vp),
                                            _t(tables), _t(lens))
    np.testing.assert_allclose(got, plain.numpy(), atol=1e-6, rtol=0)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, tables, lens)]
    np.testing.assert_allclose(got, np.asarray(jax_paged_path(*jargs)),
                               atol=1e-6, rtol=0)
    want = jax_paged_kernel(*jargs, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)
    for i, m in enumerate(lengths):
        if m == 0:
            assert (got[i] == 0).all(), f"row {i} of length 0 not zero"


# --------------------------------------------------- dense (padded) flash
FLASH_CASES = [
    # (b, s, h, kv, d, block, causal, window): tests/test_kernels.py's
    # shapes and windows, a non-causal case and a bf16 one
    (1, 128, 2, 2, 64, 64, True, 0, "float32"),
    (2, 256, 4, 2, 64, 128, True, 0, "float32"),
    (1, 256, 4, 1, 128, 64, True, 0, "float32"),    # MQA, wide head
    (2, 512, 8, 8, 64, 256, True, 0, "float32"),    # MHA
    (2, 256, 4, 2, 64, 64, True, 32, "float32"),    # window
    (2, 256, 4, 2, 64, 64, True, 128, "float32"),
    (1, 128, 14, 2, 64, 64, False, 0, "float32"),   # non-causal, rep 7
    (1, 128, 4, 2, 64, 64, False, 48, "float32"),   # non-causal window
    (2, 256, 4, 2, 64, 128, True, 0, "bfloat16"),
]


@pytest.mark.parametrize("b,s,h,kv,d,blk,causal,window,dtype", FLASH_CASES)
def test_flash_attention_plain_matches_jax(b, s, h, kv, d, blk, causal,
                                           window, dtype):
    rng = np.random.default_rng(s + h)
    qkv = [rng.standard_normal((b, s, n, d), np.float32) for n in (h, kv, kv)]
    jdt = jnp.dtype(dtype)
    jargs = [jnp.asarray(a, jdt) for a in qkv]
    targs = [_t(np.asarray(a, np.float32)).to(getattr(torch, dtype))
             for a in jargs]
    got = FA.flash_attention_plain(*targs, causal=causal,
                                   window=window).float().numpy()
    want = jax_flash_kernel(*jargs, causal=causal, window=window,
                            block_q=blk, block_k=blk, interpret=True)
    path = jax_big_path(*jargs, causal=causal, window=window)
    tol = (dict(atol=KERNEL_ATOL) if dtype == "float32"
           else dict(atol=2e-2, rtol=2e-2))
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)
    np.testing.assert_allclose(got, np.asarray(path, np.float32),
                               **(PATH_TOL if dtype == "float32" else tol))
    np.testing.assert_array_equal(
        TL.big_attention(*targs, causal=causal,
                         window=window).float().numpy(), got)


def test_flash_attention_plain_long_prompt_matches_jax_path():
    """Past 1024 tokens the JAX CPU path switches to its chunked
    ``flash_attention_vjp`` and the plain version to query blocks of
    ``PLAIN_Q_BLOCK`` rows: same attention, another summation order."""
    rng = np.random.default_rng(0)
    s = 1536
    qkv = [rng.standard_normal((1, s, n, 64), np.float32) for n in (2, 1, 1)]
    got = FA.flash_attention_plain(*map(_t, qkv), causal=True,
                                   window=600).numpy()
    path = jax_big_path(*map(jnp.asarray, qkv), causal=True, window=600)
    np.testing.assert_allclose(got, np.asarray(path), **PATH_TOL)


# ------------------------------------------------------- segment (packed)
SEG_CASES = [
    # (T, lens, window, block)
    (96, [40, 17, 30], 0, 96),                  # padding tail (3·2^5)
    (64, [32, 32], 0, 16),                      # tile boundaries, skips
    (48, [1, 1, 40], 0, 48),                    # single-token segments
    (96, [40, 17, 30, 3], 16, 96),              # window inside segments
]


def _seg_layout(t, lens):
    seg = np.full((t,), len(lens), np.int32)
    starts = np.zeros((len(lens),), np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[off:off + n] = i
        starts[i] = off
        off += n
    return seg, starts, np.asarray(lens, np.int32), off


@pytest.mark.parametrize("t,lens,window,block", SEG_CASES)
def test_segment_attention_plain_matches_jax(t, lens, window, block):
    rng = np.random.default_rng(t + len(lens))
    h, kv, d = 4, 2, 64
    q = rng.standard_normal((1, t, h, d), np.float32)
    k = rng.standard_normal((1, t, kv, d), np.float32)
    v = rng.standard_normal((1, t, kv, d), np.float32)
    seg, starts, slens, n_real = _seg_layout(t, lens)
    row_len = 1 << (max(lens) - 1).bit_length()
    pos = TL.packed_positions(_t(seg), _t(starts))
    got = FA.segment_flash_attention_plain(
        _t(q), _t(k), _t(v), _t(seg), pos, _t(starts), _t(slens),
        row_len=row_len, window=window).numpy()[0, :n_real]
    want = jax_segment_kernel(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(seg), window=window,
                              block_q=block, block_k=block, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want)[0, :n_real],
                               atol=KERNEL_ATOL)
    jpos = JL.packed_positions(jnp.asarray(seg), jnp.asarray(starts))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    path = jax_packed_path(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        jpos, jnp.asarray(starts), jnp.asarray(slens), row_len=row_len,
        window=window)
    np.testing.assert_allclose(got, np.asarray(path)[0, :n_real],
                               **PATH_TOL)


def test_segment_rows_round_trip_matches_jax():
    rng = np.random.default_rng(3)
    seg, starts, slens, n_real = _seg_layout(24, [7, 1, 12])
    x = rng.standard_normal((24, 3, 8), np.float32)
    rows = FA.segments_to_rows(_t(x), _t(starts), _t(slens), 16)
    jrows = JL.segments_to_rows(jnp.asarray(x), jnp.asarray(starts),
                                jnp.asarray(slens), 16)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    pos = TL.packed_positions(_t(seg), _t(starts))
    back = FA.rows_to_segments(rows, _t(seg), pos).numpy()
    np.testing.assert_array_equal(back[:n_real], x[:n_real])


# ----------------------------------------------------- chunk (continuation)
CHUNK_CASES = [
    # (s, r, h, kv, d, page_size, max_pages, hists, slens)
    (2, 4, 4, 2, 64, 8, 3, (8, 16), (4, 4)),        # page-aligned history
    (3, 8, 4, 4, 64, 8, 4, (5, 13, 0), (8, 3, 6)),  # mid-page + fresh seq
    (1, 16, 8, 2, 64, 16, 2, (13,), (16,)),         # chunk crosses a page
    (2, 8, 14, 2, 64, 8, 3, (1, 7), (1, 8)),        # qwen2 heads, ragged
    (4, 4, 4, 2, 64, 8, 2, (3, 0, 0, 0), (4, 2, 0, 0)),  # padding segments
]


def _chunk_case(seed, s, r, h, kv, d, ps, maxp, hists):
    rng = np.random.default_rng(seed)
    n_pages = s * maxp + 1
    q = rng.standard_normal((s, r, h, d), np.float32)
    kc = rng.standard_normal((s, r, kv, d), np.float32)
    vc = rng.standard_normal((s, r, kv, d), np.float32)
    kp = rng.standard_normal((n_pages, ps, kv, d), np.float32)
    vp = rng.standard_normal((n_pages, ps, kv, d), np.float32)
    tables = (rng.permutation(n_pages - 1) + 1)[:s * maxp] \
        .reshape(s, maxp).astype(np.int32)
    return q, kp, vp, kc, vc, tables


@pytest.mark.parametrize("s,r,h,kv,d,ps,maxp,hists,slens", CHUNK_CASES)
def test_chunk_attention_plain_matches_jax(s, r, h, kv, d, ps, maxp, hists,
                                           slens):
    q, kp, vp, kc, vc, tables = _chunk_case(s + r, s, r, h, kv, d, ps, maxp,
                                            hists)
    hist = np.asarray(hists, np.int32)
    slen = np.asarray(slens, np.int32)
    got = CA.paged_chunk_attention_plain(
        _t(q), _t(kp), _t(vp), _t(kc), _t(vc), _t(tables), _t(hist),
        _t(slen)).numpy()
    jargs = [jnp.asarray(a) for a in (q, kp, vp, kc, vc, tables, hist, slen)]
    want = np.asarray(jax_chunk_kernel(*jargs, interpret=True))
    path = np.asarray(jax_chunk_path(*jargs))
    for i, n in enumerate(slens):
        np.testing.assert_allclose(got[i, :n], want[i, :n], atol=KERNEL_ATOL,
                                   err_msg=f"segment {i}")
        np.testing.assert_allclose(got[i, :n], path[i, :n], **PATH_TOL,
                                   err_msg=f"segment {i}")


@pytest.mark.parametrize("window", [4, 16])
def test_chunk_attention_plain_window_matches_jax_kernel(window):
    # history + chunk fit the slot (cap 32), as the engine guarantees
    s, r, h, kv, d, ps, maxp = 2, 8, 4, 2, 64, 8, 4
    q, kp, vp, kc, vc, tables = _chunk_case(window, s, r, h, kv, d, ps, maxp,
                                            None)
    hist = np.asarray([19, 7], np.int32)
    slen = np.asarray([8, 8], np.int32)
    got = CA.paged_chunk_attention_plain(
        _t(q), _t(kp), _t(vp), _t(kc), _t(vc), _t(tables), _t(hist),
        _t(slen), window=window).numpy()
    want = jax_chunk_kernel(*[jnp.asarray(a) for a in
                              (q, kp, vp, kc, vc, tables, hist, slen)],
                            window=window, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=KERNEL_ATOL)


def _chunk_tc_emulated(q, kp, vp, kc, vc, tables, hist, slen, window=0,
                      round_p=True):
    """The bf16 chunk kernel's walk in plain PyTorch (float32 arithmetic on
    the CPU): per (segment, query head, tile of 64 chunk rows at absolute
    positions hist + r), 64-key tiles over absolute positions from the
    window's first tile to the last real row's, each key fetched from the
    paged history (j < hist, through the block table) or the chunk (hist
    <= j < hist + seg_len), zeros past them; the mask applied only where
    the kernel's ``ChunkMask.full`` is false; the online softmax in the
    log2 domain with a reference of 0 for rows that saw no key yet; P
    rounded to bf16 before P·V when ``round_p`` (the kernel's A
    fragments; the row sums keep the unrounded P). Padding rows are
    zeros."""
    s_, r_len, h, d = q.shape
    _, ps, kvh, _ = kp.shape
    rep = h // kvh
    sl2 = math.log2(math.e) / math.sqrt(d)
    out = torch.zeros(s_, r_len, h, d)
    tile = torch.arange(64)
    for s in range(s_):
        hs, n = int(hist[s]), int(slen[s])

        def keys(k0, pool, chunk, g):
            rows = torch.zeros(64, d)
            for t in range(64):
                j = k0 + t
                if j < hs:
                    rows[t] = pool[int(tables[s, j // ps]), j % ps, g]
                elif j < hs + n:
                    rows[t] = chunk[s, j - hs, g]
            return rows

        for hh in range(h):
            g = hh // rep
            for r0 in range(0, r_len, 64):
                nq = min(64, r_len - r0, max(0, n - r0))
                if nq == 0:
                    continue
                q0 = hs + r0
                qt = torch.zeros(64, d)
                qt[:nq] = q[s, r0:r0 + nq, hh]
                first = max(0, q0 - window + 1) if window else 0
                m = torch.full((64,), -math.inf)
                l_sum = torch.zeros(64)
                o = torch.zeros(64, d)
                i = q0 + tile[:, None]
                for kt in range(first // 64, (q0 + nq - 1) // 64 + 1):
                    k0 = kt * 64
                    sc = qt @ keys(k0, kp, kc, g).T
                    full = (k0 + 63 <= q0 and nq == 64
                            and (not window or q0 + 63 - k0 < window))
                    if not full:
                        j = k0 + tile[None, :]
                        vis = (i < q0 + nq) & (j <= i)
                        if window:
                            vis &= i - j < window
                        sc = torch.where(vis, sc, -math.inf)
                    m_new = torch.maximum(m, sc.amax(1) * sl2)
                    m_use = torch.where(m_new == -math.inf, 0.0, m_new)
                    corr = torch.exp2(m - m_use)
                    p = torch.exp2(sc * sl2 - m_use[:, None])
                    l_sum = l_sum * corr + p.sum(1)
                    if round_p:
                        p = p.bfloat16().float()
                    o = o * corr[:, None] + p @ keys(k0, vp, vc, g)
                    m = m_new
                out[s, r0:r0 + nq, hh] = o[:nq] / l_sum[:nq, None]
    return out


CHUNK_TC_CASES = [
    # (h, kv, page_size, max_pages, hists, slens): history 100 ends inside
    # the second key tile (keys 64-99 paged, 100-127 the chunk), 37 inside
    # the first; a fresh sequence; a partial second row tile (65 real rows
    # of 70); a padding segment; whole row tiles at 120 and 130, whose
    # key tiles just below the diagonal (and, with a window of 100, just
    # inside it) decide between full and masked
    (4, 2, 8, 32, (100, 0, 120, 0, 130, 37), (70, 65, 70, 0, 70, 70)),
    (14, 2, 16, 16, (100, 0, 120, 0, 130, 37),           # qwen2-0.5b heads
     (70, 65, 70, 0, 70, 70)),
]


@pytest.mark.parametrize("window", [0, 40, 100])
@pytest.mark.parametrize("h,kv,ps,maxp,hists,slens", CHUNK_TC_CASES)
def test_chunk_tc_walk_matches_jax_kernel(h, kv, ps, maxp, hists, slens,
                                          window):
    """The bf16 chunk kernel's tile walk over absolute positions, emulated
    on the CPU on bf16-valued inputs, against the JAX package's
    interpret-mode kernel: with P unrounded within 2e-5 (the walk's tile
    bounds, full-tile decisions, masks and key addresses are exact), with
    P rounded to bf16 and the output to bf16 within the card's bf16
    tolerance of 2e-2 absolute and relative; padding rows are zeros.
    The emulation gets tables whose entries past each segment's history
    pages point far outside the pool (the kernel never reads them)."""
    s, r, d = len(hists), 70, 64
    q, kp, vp, kc, vc, tables = (
        _t(a).bfloat16().float().numpy() if a.dtype == np.float32 else a
        for a in _chunk_case(ps + h, s, r, h, kv, d, ps, maxp, hists))
    hist = np.asarray(hists, np.int32)
    slen = np.asarray(slens, np.int32)
    live = -(-hist // ps)
    poisoned = np.where(np.arange(maxp)[None, :] >= live[:, None], 1 << 30,
                        tables)
    want = np.asarray(jax_chunk_kernel(
        *[jnp.asarray(a) for a in (q, kp, vp, kc, vc, tables, hist, slen)],
        window=window, interpret=True))
    args = [_t(a) for a in (q, kp, vp, kc, vc, poisoned, hist, slen)]
    exact = _chunk_tc_emulated(*args, window=window, round_p=False).numpy()
    bf16 = _chunk_tc_emulated(*args, window=window).bfloat16().float()
    for i, n in enumerate(slens):
        np.testing.assert_allclose(exact[i, :n], want[i, :n],
                                   atol=KERNEL_ATOL, err_msg=f"segment {i}")
        np.testing.assert_allclose(bf16[i, :n].numpy(), want[i, :n],
                                   atol=2e-2, rtol=2e-2,
                                   err_msg=f"segment {i}")
        assert (exact[i, n:] == 0).all() and (bf16[i, n:] == 0).all()


# ------------------------------------------------------------ SSD scan
SSD_SHAPES = [
    # (b, l, h, p, n, chunk): tests/test_kernels.py's shapes
    (1, 64, 2, 16, 8, 16),
    (2, 128, 4, 32, 16, 32),
    (1, 256, 2, 64, 64, 64),
    (2, 96, 3, 32, 16, 32),        # l not a multiple of chunk: padding
]
SSD_TOL = 1e-5


def _close_at_scale(got, want, tol=SSD_TOL):
    """max |got - want| <= tol * max(1, max |want|)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err
jax_ssd = jax.jit(jax_ops.ssd, static_argnames=("chunk", "backend"))


def _ssd_case(seed, b, l, h, p, n):
    """x, dt (softplus of a normal), a (negative), b, c as numpy f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    bb = rng.standard_normal((b, l, n), np.float32)
    cc = rng.standard_normal((b, l, n), np.float32)
    return x, dt, a, bb, cc


@pytest.mark.parametrize("b,l,h,p,n,chunk", SSD_SHAPES)
def test_ssd_chunked_plain_matches_jax(b, l, h, p, n, chunk):
    args = _ssd_case(l, b, l, h, p, n)
    y, s = SSD.ssd_chunked_plain(*map(_t, args), chunk)
    jy, js = jax_ssd(*map(jnp.asarray, args), chunk=chunk, backend="jnp")
    _close_at_scale(y.numpy(), jy)
    _close_at_scale(s.numpy(), js)
    ry, rs = jax_ref.ssd_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=2e-3,
                               rtol=2e-3)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=2e-3,
                               rtol=2e-3)


@pytest.mark.parametrize("b,l,h,p,n,chunk", SSD_SHAPES[:3])
def test_ssd_chunked_plain_matches_pallas_interpret(b, l, h, p, n, chunk):
    args = _ssd_case(l + 1, b, l, h, p, n)
    y, s = SSD.ssd_chunked_plain(*map(_t, args), chunk)
    jy, js = jax_ssd(*map(jnp.asarray, args), chunk=chunk,
                     backend="interpret")
    _close_at_scale(y.numpy(), jy)
    _close_at_scale(s.numpy(), js)


def test_ssd_initial_state_and_short_sequence_match_jax():
    """A carried-in state, and L < chunk (one chunk of L rows)."""
    x, dt, a, bb, cc = _ssd_case(9, 2, 20, 3, 16, 8)
    s0 = np.random.default_rng(10).standard_normal((2, 3, 8, 16),
                                                   np.float32)
    args = (x, dt, a, bb, cc)
    y, s = SSD.ssd_chunked_plain(*map(_t, args), 32, initial_state=_t(s0))
    jy, js = jax_ops.ssd(*map(jnp.asarray, args), chunk=32, backend="jnp",
                         initial_state=jnp.asarray(s0))
    _close_at_scale(y.numpy(), jy)
    _close_at_scale(s.numpy(), js)
    ry, rs = SSD.ssd_ref_plain(*map(_t, args), initial_state=_t(s0))
    jry, jrs = jax_ref.ssd_ref(*map(jnp.asarray, args),
                               initial_state=jnp.asarray(s0))
    _close_at_scale(ry.numpy(), jry)
    _close_at_scale(rs.numpy(), jrs)


@pytest.mark.parametrize("lens", [(70, 96, 33), (32, 64, 95)])
def test_ssd_dt_zero_padding_freezes_the_state_bit_for_bit(lens):
    """Rows of a packed batch whose tails carry dt = 0 (x, b and c there
    are NOT zero, as after the causal conv) end with the state of their
    unpadded runs, bit for bit, and agree on every real row — as long as
    both runs chunk alike (each length >= chunk)."""
    chunk, row_len = 32, 96
    x, dt, a, bb, cc = _ssd_case(11, len(lens), row_len, 2, 16, 8)
    for i, n in enumerate(lens):
        dt[i, n:] = 0.0
    y, s = SSD.ssd_chunked_plain(*map(_t, (x, dt, a, bb, cc)), chunk)
    for i, n in enumerate(lens):
        one = [_t(v[i:i + 1, :n]) for v in (x, dt)] + [_t(a)] + \
            [_t(v[i:i + 1, :n]) for v in (bb, cc)]
        y1, s1 = SSD.ssd_chunked_plain(*one, chunk)
        assert torch.equal(s[i:i + 1], s1), f"row {i}: state moved"
        assert torch.equal(y[i:i + 1, :n], y1), f"row {i}: outputs differ"


def test_ssd_decode_stepped_over_l_equals_the_oracle():
    x, dt, a, bb, cc = _ssd_case(12, 2, 24, 3, 16, 8)
    state = torch.zeros(2, 3, 8, 16)
    ys = []
    for t in range(24):
        yt, state = SSD.ssd_decode_plain(_t(x[:, t]), _t(dt[:, t]), _t(a),
                                         _t(bb[:, t]), _t(cc[:, t]), state)
        ys.append(yt)
    ry, rs = jax_ref.ssd_ref(*map(jnp.asarray, (x, dt, a, bb, cc)))
    _close_at_scale(torch.stack(ys, 1).numpy(), ry)
    _close_at_scale(state.numpy(), rs)
    jy, js = jax_ref.ssd_decode_ref(*map(jnp.asarray, (
        x[:, 0], dt[:, 0], a, bb[:, 0], cc[:, 0])), jnp.asarray(rs))
    y1, s1 = ops.ssd_decode(*map(_t, (x[:, 0], dt[:, 0], a, bb[:, 0],
                                      cc[:, 0])), _t(np.asarray(rs)))
    _close_at_scale(y1.numpy(), jy)
    _close_at_scale(s1.numpy(), js)


# (B, H, P, N, stepped rows): some rows, none, all; N and P at the
# reduced and at the card's shapes
SSD_DECODE_MASKS = [
    (4, 3, 16, 8, (1, 0, 1, 1)),
    (3, 2, 64, 128, (0, 0, 0)),
    (2, 4, 64, 64, (1, 1)),
    (5, 2, 32, 16, (0, 1, 0, 0, 1)),
]


@pytest.mark.parametrize("b,h,p,n,stepped", SSD_DECODE_MASKS)
@pytest.mark.parametrize("strided", [False, True], ids=["dense", "split"])
def test_ssd_decode_masked_plain_steps_only_the_masked_rows_in_place(
        b, h, p, n, stepped, strided):
    """The masked form advances ``state`` in place: the stepped rows hold
    what the functional step gives (and JAX's ``ssd_decode_ref``), the
    other rows keep their state bit for bit and get y = 0; the same tensor
    comes back. ``ops.ssd_decode(mask=)`` takes it on the CPU, launching
    nothing. ``split``: x, b and c as views of one (B, H·P + 2N) row, as
    the block's split of the conv output gives them."""
    x, dt, a, bb, cc = (v[:, 0] if v.ndim > 1 else v
                        for v in _ssd_case(20 + b, b, 1, h, p, n))
    if strided:
        rows = np.concatenate([x.reshape(b, h * p), bb, cc], axis=1)
        whole = _t(rows)
        xt, bt, ct = torch.split(whole, [h * p, n, n], dim=-1)
        xt = xt.reshape(b, h, p)
        assert not xt.is_contiguous() and not bt.is_contiguous()
    else:
        xt, bt, ct = _t(x), _t(bb), _t(cc)
    s0 = np.random.default_rng(b).standard_normal((b, h, n, p), np.float32)
    state = _t(s0.copy())
    mask = torch.tensor(stepped, dtype=torch.bool)
    wy, ws = SSD.ssd_decode_plain(xt, _t(dt), _t(a), bt, ct, _t(s0))
    before = ops.launch_counts()
    y, out = ops.ssd_decode(xt, _t(dt), _t(a), bt, ct, state, mask=mask)
    assert ops.launch_counts() == before
    assert out is state
    assert torch.equal(state[mask], ws[mask])
    assert torch.equal(state[~mask], _t(s0)[~mask])
    assert torch.equal(y[mask], wy[mask])
    assert not y[~mask].any()
    jy, js = jax_ref.ssd_decode_ref(*map(jnp.asarray, (x, dt, a, bb, cc)),
                                    jnp.asarray(s0))
    on = mask.numpy()
    if on.any():
        _close_at_scale(y.numpy()[on], np.asarray(jy)[on])
        _close_at_scale(state.numpy()[on], np.asarray(js)[on])


def test_ssd_decode_without_a_mask_is_functional():
    """No mask: a fresh state, every row stepped, the input untouched."""
    x, dt, a, bb, cc = (_t(v[:, 0]) if v.ndim > 1 else _t(v)
                        for v in _ssd_case(30, 3, 1, 2, 16, 8))
    state = torch.randn(3, 2, 8, 16)
    keep = state.clone()
    y, new = ops.ssd_decode(x, dt, a, bb, cc, state)
    wy, ws = SSD.ssd_decode_plain(x, dt, a, bb, cc, keep)
    assert new is not state and torch.equal(state, keep)
    assert torch.equal(new, ws) and torch.equal(y, wy)


# The bf16 kernel's number scheme (csrc/ssd_scan.cu, ssd_tc_kernel): x, b
# and c are exact bf16 inputs and stay one side of their products; the side
# formed in float32 — G ∘ L ∘ dt, b·dt·w and the carried state S — enters
# the bf16 tensor-core products as a pair hi + lo. Each variant below
# replaces one pair by a single bf16 rounding, as measured when the scheme
# was chosen; the gates are the card's (chip_smoke.py, test_torch_gpu.py).
SSD_BF16_SCHEMES = {
    "kernel": {},
    "one rounding of x·dt·w in the state update": {"state": "xdtw"},
    "one rounding each of G∘L and x·dt in y_diag": {"diag": "single"},
    "a pair on G∘L only, one rounding of x·dt": {"diag": "gl pair"},
    "S as one bf16 in c·S": {"cs": "single"},
}


def _bf16(v):
    return v.bfloat16().float()


def _pair(v):
    """v as bf16 hi + lo (two operands, each exact in bf16)."""
    hi = _bf16(v)
    return hi, _bf16(v - hi)


def _ssd_bf16_emulated(x, dt, a, b, c, chunk, scheme):
    """The kernel's arithmetic in plain PyTorch on the CPU: products of
    bf16 operands are exact in float32 and summed in float32, as the
    tensor cores do; ``scheme`` (a value of ``SSD_BF16_SCHEMES``) swaps one
    pair for a single rounding. x, b, c: bf16; dt, a: float32 -> (y bf16,
    final state float32)."""
    bs, l0, h, p = x.shape
    n = b.shape[-1]
    cl = min(chunk, l0)
    pad = (-l0) % cl
    xf, bf, cf = (torch.nn.functional.pad(
        v.float(), (0, 0) * (v.dim() - 2) + (0, pad)) for v in (x, b, c))
    dtp = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    s = torch.zeros(bs, h, n, p)
    tri = torch.tril(torch.ones(cl, cl, dtype=torch.bool))[None, :, :, None]
    ys = []
    for t0 in range(0, l0 + pad, cl):
        xc, bc, cc = (v[:, t0:t0 + cl] for v in (xf, bf, cf))
        dtc = dtp[:, t0:t0 + cl]                               # (B, cl, H)
        acs = torch.cumsum(dtc * a.float(), dim=1)
        alast = acs[:, -1:]                                    # (B, 1, H)
        cb = torch.einsum("bin,bjn->bij", cc, bc)[..., None]
        lmask = torch.where(tri, torch.exp(torch.where(
            tri, acs[:, :, None] - acs[:, None], 0.0)), 0.0)   # (B, i, j, H)
        # the state entering the chunk, in c·S
        s_ops = [_bf16(s)] if scheme.get("cs") == "single" else _pair(s)
        y = sum(torch.einsum("bin,bhnp->bihp", cc, so) for so in s_ops)
        y = y * torch.exp(acs)[..., None]
        # y_diag
        if scheme.get("diag") is None:
            terms = [(g, xc) for g in _pair(cb * lmask * dtc[:, None])]
        else:
            gl = (_pair(cb * lmask) if scheme["diag"] == "gl pair"
                  else [_bf16(cb * lmask)])
            terms = [(g, _bf16(xc * dtc[..., None])) for g in gl]
        for g, xo in terms:
            y = y + torch.einsum("bijh,bjhp->bihp", g, xo)
        ys.append(y)
        # the state carry
        w = torch.exp(alast - acs)                             # (B, cl, H)
        s = s * torch.exp(alast[:, 0])[..., None, None]
        if scheme.get("state") == "xdtw":
            s = s + torch.einsum("bjn,bjhp->bhnp", bc,
                                 _bf16(xc * (dtc * w)[..., None]))
        else:
            for bw in _pair(bc[:, :, None] * (dtc * w)[..., None]):
                s = s + torch.einsum("bjhn,bjhp->bhnp", bw, xc)
    return torch.cat(ys, dim=1)[:, :l0].bfloat16(), s


@pytest.mark.parametrize("scheme", list(SSD_BF16_SCHEMES))
def test_ssd_bf16_number_scheme_meets_the_card_gates(scheme):
    """At mamba2-1.3b heads (H 64, P 64, N 128, chunk 128; B 2, L 300) the
    kernel's scheme keeps y within the bf16 tolerance (2e-2 absolute and
    relative) and the final state within 1e-4 of its scale of the plain
    version, and every variant with one pair replaced by a single bf16
    rounding misses one of the two gates."""
    rng = np.random.default_rng(15)
    b, l, h, p, n = 2, 300, 64, 64, 128
    x, bb, cc = (_t(rng.standard_normal(s, np.float32)).bfloat16()
                 for s in ((b, l, h, p), (b, l, n), (b, l, n)))
    dt = _t(np.log1p(np.exp(rng.standard_normal((b, l, h)) - 1.0))
            .astype(np.float32))
    a = _t(-np.exp(0.5 * rng.standard_normal(h)).astype(np.float32))
    want_y, want_s = SSD.ssd_chunked_plain(x, dt, a, bb, cc, 128)
    got_y, got_s = _ssd_bf16_emulated(x, dt, a, bb, cc, 128,
                                      SSD_BF16_SCHEMES[scheme])
    y_ok = bool(torch.allclose(got_y.float(), want_y.float(), atol=2e-2,
                               rtol=2e-2))
    s_err = float((got_s - want_s).abs().max())
    s_ok = s_err <= 1e-4 * max(1.0, float(want_s.abs().max()))
    if scheme == "kernel":
        assert y_ok and s_ok, (y_ok, s_err)
    else:
        assert not (y_ok and s_ok), f"{scheme} passes both gates"


# The bf16 flash backward's number scheme (csrc/tc_backward.cuh): bf16 Q,
# K, V, dO and O; S, dP and delta in float32; P = exp2(S·scale·log2 e -
# lse·log2 e) under the mask; dS = P (dP - delta) from the float32 P; P and
# dS rounded to bf16 before the products that take them (dV = P^T·dO,
# dK = dS^T·Q, dQ = dS·K), sums in float32, each gradient rounded once.
# The variant also rounds dP - delta to bf16 before dS forms. The gate is
# the card's (chip_smoke.py BWD_TOL, test_torch_gpu.py): 1e-2 of
# max(1, max |plain|) per gradient.
BWD_BF16_SCHEMES = {"kernel": False, "dP - delta rounded too": True}
BWD_BF16_HEADS = {"qwen2-0.5b": (2, 300, 14, 2, 64),
                  "olmo-1b": (1, 257, 16, 16, 128)}


def _flash_bwd_bf16_emulated(q, k, v, out, dout, lse, causal, window,
                             round_dp_delta=False):
    """The bf16 backward kernels' arithmetic in plain PyTorch on the CPU,
    GQA by repeating the KV heads (dK, dV sum their group) -> (dq, dk, dv)
    bf16."""
    from repro_torch.kernels import flash_vjp as FV
    b, s, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    scale, log2e = 1.0 / math.sqrt(d), 1.4426950408889634
    qf, dof = q.float(), dout.float()
    kf, vf = (x.float().repeat_interleave(rep, dim=2) for x in (k, v))
    mask = FV._mask(torch.arange(s)[:, None], torch.arange(sk)[None, :],
                    causal, window)
    st = torch.einsum("bihd,bjhd->bhij", qf, kf)
    p = torch.where(mask, torch.exp2(st * (scale * log2e)
                                     - (lse * log2e)[..., None]), 0.0)
    delta = torch.einsum("bihd,bihd->bhi", dof, out.float())
    dpd = torch.einsum("bihd,bjhd->bhij", dof, vf) - delta[..., None]
    if round_dp_delta:
        dpd = _bf16(dpd)
    ds = _bf16(p * dpd)
    dv = torch.einsum("bhij,bihd->bjhd", _bf16(p), dof)
    dk = torch.einsum("bhij,bihd->bjhd", ds, qf) * scale
    dq = torch.einsum("bhij,bjhd->bihd", ds, kf) * scale
    return (dq.bfloat16(), dk.reshape(b, sk, kvh, rep, d).sum(3).bfloat16(),
            dv.reshape(b, sk, kvh, rep, d).sum(3).bfloat16())


@pytest.mark.parametrize("heads", list(BWD_BF16_HEADS))
@pytest.mark.parametrize("scheme", list(BWD_BF16_SCHEMES))
def test_flash_bwd_bf16_number_scheme_meets_the_card_gate(scheme, heads):
    """At qwen2-0.5b heads (B 2, S 300) and olmo-1b heads (B 1, S 257),
    causal, the kernels' scheme keeps dq, dk and dv within the card's bf16
    gate of ``flash_bwd_plain`` (which the flash-VJP tests hold against
    the JAX ``flash_attention_vjp``) from the same bf16 inputs, output and
    lse; so does the variant that also rounds dP - delta: the gate leaves
    room for one more bf16 rounding of the scheme."""
    from repro_torch.kernels import flash_vjp as FV
    b, s, h, kv, d = BWD_BF16_HEADS[heads]
    rng = np.random.default_rng(25)
    q, k, v, dout = (_t(rng.standard_normal(shape, np.float32)).bfloat16()
                     for shape in ((b, s, h, d), (b, s, kv, d),
                                   (b, s, kv, d), (b, s, h, d)))
    out, lse = FV.flash_fwd_plain(q, k, v, causal=True)
    want = FV.flash_bwd_plain(q, k, v, out, dout, lse, causal=True)
    got = _flash_bwd_bf16_emulated(q, k, v, out, dout, lse, True, 0,
                                   BWD_BF16_SCHEMES[scheme])
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype == torch.bfloat16 and g.shape == w.shape
        err = float((g.float() - w.float()).abs().max())
        assert err <= 1e-2 * max(1.0, float(w.float().abs().max())), \
            (name, err)


def test_ops_ssd_routes_cpu_tensors_to_the_plain_version():
    args = [_t(v) for v in _ssd_case(13, 1, 40, 2, 16, 8)]
    before = SSD.launches
    y, s = ops.ssd(*args, chunk=16)
    wy, ws = SSD.ssd_chunked_plain(*args, 16)
    assert torch.equal(y, wy) and torch.equal(s, ws)
    assert SSD.launches == before
    meta = [torch.zeros(a.shape, device="meta") for a in args]
    with pytest.raises(ValueError, match="no attention kernel"):
        ops.ssd(*meta, chunk=16)


# ------------------------------------------------- CUDA wrapper contracts
def test_cuda_wrappers_refuse_cpu_tensors():
    q, kp, vp, tables = _paged_case(1, 2, 4, 2, 64, 8, 2)
    lens = _t(np.asarray([3, 9], np.int32))
    with pytest.raises(ValueError, match="CUDA device"):
        PA.paged_decode_attention_cuda(_t(q), _t(kp), _t(vp), _t(tables),
                                       lens)
    x = torch.zeros(1, 8, 4, 64)
    with pytest.raises(ValueError, match="CUDA device"):
        FA.segment_flash_attention_cuda(x, x[:, :, :2], x[:, :, :2],
                                        torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA device"):
        DA.decode_attention_cuda(_t(q), _t(kp[:2]), _t(vp[:2]), lens)
    with pytest.raises(ValueError, match="CUDA device"):
        FA.flash_attention_cuda(x, x[:, :, :2], x[:, :, :2])
    with pytest.raises(ValueError, match="CUDA device"):
        SSD.ssd_scan_cuda(*[_t(v) for v in _ssd_case(0, 1, 8, 2, 64, 128)],
                          chunk=128)
    with pytest.raises(ValueError, match="CUDA device"):
        CA.paged_chunk_attention_cuda(
            torch.zeros(1, 4, 4, 64), _t(kp), _t(vp),
            torch.zeros(1, 4, 2, 64), torch.zeros(1, 4, 2, 64),
            _t(tables[:1]), lens[:1], lens[:1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1, 4, 8])          # in elements
def test_check_aligned_refuses_views_off_a_16_byte_boundary(dtype, offset):
    """The split-K decode kernel and the bf16 flash kernel read their
    operands as 16-byte vectors; a contiguous view that starts elsewhere
    is refused before a launch, whatever its device."""
    base = torch.zeros(8 + 2 * 4 * 64, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    view = base[offset:offset + 2 * 4 * 64].view(2, 4, 64)
    assert view.is_contiguous()
    if offset * base.element_size() % 16:
        with pytest.raises(ValueError, match="16-byte boundary"):
            build.check_aligned("decode_attention", q=base[:8], k=view)
    else:
        build.check_aligned("decode_attention", q=base[:8], k=view)


_C_KINDS = {"void*": build._P, "const void*": build._P, "int": build._I,
            "float": build._F}


@pytest.mark.parametrize("entry", sorted(build.SIGNATURES))
def test_ctypes_signatures_match_c_entry_points(entry):
    """Every C argument is declared to ctypes with its own kind (an
    undeclared pointer would be cut to 32 bits). The two split-K decodes
    (contiguous and paged) take their f32 scratch after the lengths and
    the split count and length after the shapes."""
    src = (build.CSRC / f"{build.ENTRY_LIBRARY[entry]}.cu").read_text()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    assert m, entry
    kinds, names = [], []
    for param in m.group(1).split(","):
        ctype = " ".join(param.split()[:-1]).replace(" *", "*")
        kinds.append(_C_KINDS[ctype])
        names.append(param.split()[-1])
    assert tuple(kinds) == build.SIGNATURES[entry]
    if entry in ("decode_attention", "paged_decode_attention"):
        i = names.index("lengths")
        assert names[i + 1] == "scratch" and kinds[i + 1] == build._P
        j = names.index("splits")
        assert names[j:j + 3] == ["splits", "split_len", "dtype"]


def test_build_hash_covers_every_source():
    names = {p.name for p in build.CSRC.iterdir()}
    assert {f"{n}.cu" for n in build.SOURCES} <= names
    assert {"attn_common.cuh", "decode_split.cuh", "tc_attend.cuh",
            "wgmma.cuh"} <= names
    assert len(build.source_hash()) == 16
    assert build.build_dir().parent == build.BUILD_ROOT
