"""Attention with a recomputing backward: the training path's attention.

The JAX package's ``kernels/flash_vjp.py`` is plain jnp: a chunked flash
forward that keeps only (q, k, v, out, logsumexp) and a backward that
recomputes each score tile from q, k and the log-sum-exp. This module has
its two routes:

* on a CUDA tensor, ``flash_attention_vjp`` is a ``torch.autograd.Function``
  whose forward is one launch of the flash kernel #5
  (``flash_attention.flash_attention_cuda`` with ``lse=True``: the output
  and the (B, H, S) float32 log-sum-exp) and whose backward is the
  hand-written ``csrc/flash_backward.cu`` (``flash_attention_bwd_cuda``):
  a ``delta = rowsum(dO * O)`` kernel, a key-major kernel for dK and dV and
  a query-major kernel for dQ, no float atomics; bfloat16 runs the last
  two on the tensor cores (``wgmma``, ``csrc/tc_backward.cuh``), float32
  on the CUDA cores;
* on the CPU, the same Function shape over the plain versions
  ``flash_fwd_plain`` and ``flash_bwd_plain``: ``_fwd_impl`` and
  ``_bwd_impl`` on tensors, with the same chunked recomputation, the same
  ``NEG_INF`` and the same ``max(l, 1e-30)`` guard, so that the gradients
  are the JAX custom VJP's and not autograd's.

Both take GQA as it comes: q (B, S, H, D) against k, v (B, Sk, KV, D), query
head h reading KV head h * KV / H; nothing repeats the KV heads in memory,
and dK, dV sum their group's query heads. Token i attends token j iff
j <= i + q_offset when causal and i + q_offset - j < window when a window
is given; Sk differs from S only without either (cross-attention). A row
that sees no key gives a zero output, lse ``NEG_INF`` and zero gradients
in both routes (the JAX forward would average its values; no call of the
training path has such a row). ``q_offset`` (the context-parallel
shift of the sharded ``layers.cp_attention``) goes to both routes: on the
card both kernels take it, and a causal or windowed call then needs
``q_offset + S <= Sk``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as _flash

NEG_INF = -1e30

# backward launches so far (one per call of the C entry, which runs its
# three kernels); a run resets it to 0 and reads it back, as the other
# kernels' counts
bwd_launches = 0


def _mask(qpos, kpos, causal: bool, window: int):
    m = torch.ones(qpos.shape[0], kpos.shape[1], dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m = m & (qpos >= kpos)
    if window:
        m = m & ((qpos - kpos) < window)
    return m


def _grouped(q, kvh: int):
    """(B, S, H, D) -> (B, S, KV, G, D), a view: query head h = g_kv * G + g."""
    b, s, h, d = q.shape
    return q.reshape(b, s, kvh, h // kvh, d)


def flash_fwd_plain(q, k, v, *, causal: bool = True, window: int = 0,
                    chunk_q: int = 512, chunk_k: int = 512,
                    q_offset: int = 0):
    """``_fwd_impl`` on tensors: (out (B, S, H, D) in q's dtype, lse
    (B, H, S) float32). Any S and Sk: the last chunk of each may be
    short."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    qg = _grouped(q, kvh)
    kpos_all = torch.arange(sk, device=q.device)[None, :]
    outs, lses = [], []
    for q0 in range(0, sq, chunk_q):
        qf = qg[:, q0:q0 + chunk_q].float()                 # (b, cq, kv, g, d)
        cq = qf.shape[1]
        qpos = q_offset + torch.arange(q0, q0 + cq, device=q.device)[:, None]
        m = torch.full((b, kvh, g, cq), NEG_INF, device=q.device)
        l = torch.zeros((b, kvh, g, cq), device=q.device)
        acc = torch.zeros((b, kvh, g, cq, d), device=q.device)
        for k0 in range(0, sk, chunk_k):
            kf = k[:, k0:k0 + chunk_k].float()              # (b, ck, kv, d)
            vf = v[:, k0:k0 + chunk_k].float()
            mask = _mask(qpos, kpos_all[:, k0:k0 + kf.shape[1]], causal,
                         window)
            s = torch.einsum("bqngd,bknd->bngqk", qf, kf) * scale
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]),
                            torch.zeros_like(s))
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bngqk,bknd->bngqd", p, vf)
            m = m_new
        lg = torch.clamp(l, min=1e-30)
        outs.append((acc / lg[..., None]).permute(0, 3, 1, 2, 4))
        lses.append(m + torch.log(lg))
    out = torch.cat(outs, dim=1).reshape(b, sq, h, d).to(q.dtype)
    lse = torch.cat(lses, dim=-1).reshape(b, h, sq)
    return out, lse


def flash_bwd_plain(q, k, v, out, dout, lse, *, causal: bool = True,
                    window: int = 0, chunk_q: int = 512, chunk_k: int = 512,
                    q_offset: int = 0):
    """``_bwd_impl`` on tensors: (dq, dk, dv) in the inputs' dtypes, from
    the forward's output and lse. P is recomputed per tile as
    exp(q·k·scale - lse) under the mask, delta = rowsum(dO * O), and
    dS = P * (dO·V^T - delta)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    delta = torch.einsum("bshd,bshd->bhs", dout.float(), out.float())
    qg, dog = _grouped(q, kvh), _grouped(dout, kvh)
    lse_g = lse.reshape(b, kvh, g, sq)
    delta_g = delta.reshape(b, kvh, g, sq)
    kpos_all = torch.arange(sk, device=q.device)[None, :]
    # every accumulation is out of place (a sharded trace's DTensors
    # cannot add a partial sum into a sharded buffer in place), in the
    # same order from zeros
    starts = range(0, sq, chunk_q)
    dqs = [q.new_zeros((b, min(chunk_q, sq - q0), kvh, g, d),
                       dtype=torch.float32) for q0 in starts]
    dks, dvs = [], []
    for k0 in range(0, sk, chunk_k):
        kf = k[:, k0:k0 + chunk_k].float()                  # (b, ck, kv, d)
        vf = v[:, k0:k0 + chunk_k].float()
        dk_j = kf.new_zeros(kf.shape)
        dv_j = kf.new_zeros(kf.shape)
        for qi, q0 in enumerate(starts):
            qf = qg[:, q0:q0 + chunk_q].float()             # (b, cq, kv, g, d)
            df = dog[:, q0:q0 + chunk_q].float()
            cq = qf.shape[1]
            qpos = q_offset + torch.arange(q0, q0 + cq,
                                           device=q.device)[:, None]
            mask = _mask(qpos, kpos_all[:, k0:k0 + kf.shape[1]], causal,
                         window)
            s = torch.einsum("bqngd,bknd->bngqk", qf, kf) * scale
            p = torch.where(
                mask, torch.exp(s - lse_g[..., q0:q0 + cq, None]),
                torch.zeros_like(s))
            dv_j = dv_j + torch.einsum("bngqk,bqngd->bknd", p, df)
            dp = torch.einsum("bqngd,bknd->bngqk", df, vf)
            ds = p * (dp - delta_g[..., q0:q0 + cq, None])
            dqs[qi] = dqs[qi] + torch.einsum(
                "bngqk,bknd->bqngd", ds, kf) * scale
            dk_j = dk_j + torch.einsum("bngqk,bqngd->bknd", ds, qf) * scale
        dks.append(dk_j)
        dvs.append(dv_j)
    return (torch.cat(dqs, dim=1).reshape(b, sq, h, d).to(q.dtype),
            torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


class _PlainFlash(torch.autograd.Function):
    """The plain route: the JAX custom VJP's forward and backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk_q, chunk_k, q_offset):
        kw = dict(causal=causal, window=window, chunk_q=chunk_q,
                  chunk_k=chunk_k, q_offset=q_offset)
        out, lse = flash_fwd_plain(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_plain(q, k, v, out, dout, lse, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


class _CudaFlash(torch.autograd.Function):
    """The card's route: #5 with its lse forward, ``flash_attention_bwd``
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        out, lse = _flash.flash_attention_cuda(q, k, v, lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out,
                                              dout.contiguous(), lse,
                                              **ctx.kw)
        return dq, dk, dv, None, None, None


def flash_attention_vjp(q, k, v, *, causal: bool = True, window: int = 0,
                        chunk_q: int = 512, chunk_k: int = 512,
                        q_offset: int = 0):
    """q: (B, S, H, D); k, v: (B, Sk, KV, D) -> (B, S, H, D), differentiable
    in q, k and v; query row i stands at position i + ``q_offset`` in the
    masks. On a CUDA tensor the kernels (the chunks are the kernels' own
    tiles); on the CPU the plain versions in chunks of ``chunk_q`` queries
    and ``chunk_k`` keys."""
    if q.device.type == "cuda":
        # the kernels read dense rows: a slice of a sequence (a
        # context-parallel shard) is copied first
        q, k, v = (x.contiguous() for x in (q, k, v))
        return _CudaFlash.apply(q, k, v, bool(causal), int(window),
                                int(q_offset))
    cq = min(chunk_q, q.shape[1])
    ck = min(chunk_k, k.shape[1])
    return _PlainFlash.apply(q, k, v, bool(causal), int(window), cq, ck,
                             int(q_offset))


def flash_attention_bwd_cuda(q, k, v, out, dout, lse, *, causal: bool = True,
                             window: int = 0, q_offset: int = 0):
    """Launch ``csrc/flash_backward.cu``: (dq, dk, dv) in the inputs' dtype.
    q, out, dout: (B, S, H, D); k, v: (B, Sk, KV, D); lse: (B, H, S)
    float32 (#5's, at the same ``q_offset``); head_dim 64, 128 or 112,
    float32 or bfloat16; any S and Sk without causality or a window, else
    ``q_offset + S <= Sk``."""
    global bwd_launches
    b, s, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    build.check_operands("flash_attention_bwd", d,
                         head_dims=build.BWD_HEAD_DIMS, q=q, k=k, v=v,
                         out=out, dout=dout, lse=lse)
    if (h % kvh or v.shape != k.shape or k.shape[0] != b or k.shape[3] != d
            or out.shape != q.shape or dout.shape != q.shape
            or lse.shape != (b, h, s)):
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}, "
                         f"lse {tuple(lse.shape)}")
    _flash.check_offset(s, sk, causal, window, q_offset)
    if len({q.dtype, k.dtype, v.dtype, out.dtype, dout.dtype}) != 1:
        raise ValueError("q, k, v, out and dout must share one dtype")
    if lse.dtype != torch.float32:
        raise ValueError("lse must be float32")
    if q.dtype == torch.bfloat16:      # the tensor-core kernels' cp.async
        build.check_aligned("flash_attention_bwd", q=q, k=k, v=v, dout=dout)
    # with no query the kernel writes nothing, and dk, dv are zeros
    alloc = torch.zeros_like if s == 0 else torch.empty_like
    dq, dk, dv = torch.empty_like(q), alloc(k), alloc(v)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    fn = build.function("flash_attention_bwd")
    err = fn(dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
             q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             dout.data_ptr(), lse.data_ptr(), b, s, sk, h, kvh, d,
             int(bool(causal)), int(window), int(q_offset),
             build.dtype_code(q.dtype), 1.0 / math.sqrt(d),
             build.stream_of(q))
    build.check(err, "flash_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv
