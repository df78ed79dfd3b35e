"""Ragged single-token decode attention over contiguous per-row caches: the
CUDA kernel's wrapper, its plain PyTorch version, and the kernel's launch
count.

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py``
(``decode_attention``). Row ``b`` attends the first ``lengths[b]`` entries
of its cache ``(C, KV, D)``; rows of length 0 (vacant slots) return exact
zeros. Ring slots and the batch ``generate`` loop decode through it.

``decode_attention_cuda`` launches ``csrc/decode_attention.cu``: split-K
flash-decoding, one block per (split of ``decode_splits``' key ranges, KV
head, row), walking only the row's live keys, then a kernel that merges
the splits; ``decode_attention_plain`` runs the masked decode body the JAX
package's CPU path runs (``layers._masked_decode_attention``), which the
paged plain version (``paged_attention``) shares after its page gather.
``decode_attention_split_plain`` emulates the kernel's split and merge on
the CPU for the tests (as does the paged version's emulation, after its
block-table fetch); no path runs it.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import build

# kernel launches so far (one per wrapper call: the split and merge
# kernels together); a run resets it to 0 and reads it back to show that
# its path went through the kernel
launches = 0

# blocks per SM the split count aims for, the key tile that is the least
# a split covers, and the most splits (the merge walks every split of a
# row, so more would cost it more than their blocks gain)
BLOCKS_PER_SM = 4
SPLIT_TILE = 64
MAX_SPLITS = 64


def decode_splits(b: int, kv: int, c: int, sm_count: int):
    """(splits, split_len): the key ranges ``[i * split_len, (i + 1) *
    split_len)``, i < splits, that the kernel's blocks take of every row of
    a (B, C, KV, D) cache. Enough splits that B * KV * splits blocks reach
    ``BLOCKS_PER_SM`` per SM, but at most ``MAX_SPLITS``, each a multiple
    of ``SPLIT_TILE`` keys, and no split that starts at or past C. It
    reads only shapes and the SM count: reading the lengths would wait for
    the device on every step."""
    def cdiv(x, y):
        return -(-x // y)
    want = cdiv(BLOCKS_PER_SM * sm_count, max(1, b * kv))
    want = max(1, min(want, MAX_SPLITS, cdiv(c, SPLIT_TILE)))
    split_len = SPLIT_TILE * max(1, cdiv(cdiv(c, want), SPLIT_TILE))
    return max(1, cdiv(c, split_len)), split_len


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The number of SMs of CUDA device ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def decode_attention_split_plain(q, k_cache, v_cache, lengths, splits: int,
                                 split_len: int):
    """The kernel's arithmetic in plain PyTorch, for the tests: keys cut
    into ``splits`` ranges of ``split_len`` as ``decode_splits`` cuts them,
    a partial (max m, sum l, unnormalised acc) per range in float32, and
    the merge by the log-sum-exp rule. Same contract as the kernel."""
    b, c, kvh, d = k_cache.shape
    h = q.shape[1]
    qg = q.reshape(b, kvh, h // kvh, d).float()
    lens = lengths.long().clamp(0, c).reshape(b, 1, 1, 1)
    ms, ls, accs = [], [], []
    for i in range(splits):
        lo, hi = i * split_len, min((i + 1) * split_len, c)
        sc = torch.einsum("bgrd,bkgd->bgrk", qg,
                          k_cache[:, lo:hi].float()) / math.sqrt(d)
        pos = torch.arange(lo, hi, device=q.device)
        sc = torch.where(pos.reshape(1, 1, 1, -1) < lens, sc,
                         torch.full_like(sc, -math.inf))
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.exp(sc - torch.where(m.isinf(), torch.zeros_like(m), m))
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bgrk,bkgd->bgrd", p,
                                 v_cache[:, lo:hi].float()))
    m_all = torch.stack(ms).amax(dim=0)
    num = torch.zeros_like(accs[0])
    den = torch.zeros_like(ls[0])
    for m, l, acc in zip(ms, ls, accs):
        w = torch.where(l > 0, torch.exp(m - m_all), torch.zeros_like(m))
        num = num + w * acc
        den = den + w * l
    out = torch.where(lens > 0, num / torch.where(den > 0, den,
                                                  torch.ones_like(den)),
                      torch.zeros_like(num))
    return out.reshape(b, h, d).to(q.dtype)


def decode_attention_cuda(q, k_cache, v_cache, lengths):
    """Launch the CUDA kernels (the splits, then their merge). q:
    (B, H, D); caches: (B, C, KV, D); lengths: (B,) int32 (clamped to
    [0, C] by the kernel); head_dim 64, 128 or 112."""
    global launches
    b, h, d = q.shape
    _, c, kvh, _ = k_cache.shape
    build.check_operands("decode_attention", d, q=q, k_cache=k_cache,
                         v_cache=v_cache, lengths=lengths)
    build.check_aligned("decode_attention", q=q, k_cache=k_cache,
                        v_cache=v_cache)
    if (h % kvh or v_cache.shape != k_cache.shape or k_cache.shape[0] != b
            or k_cache.shape[3] != d):
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise ValueError("lengths must be an int32 (B,) vector")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError("q and the caches must share one dtype")
    splits, split_len = decode_splits(b, kvh, c, sm_count(q.device.index))
    out = torch.empty_like(q)
    scratch = torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                          device=q.device)
    fn = build.function("decode_attention")
    err = fn(out.data_ptr(), q.data_ptr(), k_cache.data_ptr(),
             v_cache.data_ptr(), lengths.data_ptr(), scratch.data_ptr(), b,
             h, kvh, d, c, splits, split_len, build.dtype_code(q.dtype),
             1.0 / math.sqrt(d), build.stream_of(q))
    build.check(err, "decode_attention")
    launches += 1
    return out
