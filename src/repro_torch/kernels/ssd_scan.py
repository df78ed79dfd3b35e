"""Mamba2 SSD (state-space duality) chunked scan: the CUDA kernel's wrapper,
its plain PyTorch versions, and the kernel's launch count.

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py`` (``ssd_scan``,
body ``_ssd_kernel``) together with the wrapper ``ops.ssd`` that feeds it.
For x (B, L, H, P), dt (B, L, H), a (H,) (negative), b, c (B, L, N) the
recurrence is

    s_t = s_{t-1} · exp(dt_t · a) + dt_t · (b_t ⊗ x_t),   y_t = c_t · s_t

and the functions return ``(y (B, L, H, P) in x's dtype, final state
(B, H, N, P) in float32)``. The chunked form splits L into chunks of
``cl = min(chunk, L)`` rows; within a chunk the quadratic (dual) form runs,
across chunks the state is carried. ``L`` need not be a multiple of
``cl``: positions past L act as ``dt = 0`` (decay exp(0) = 1, update 0),
which is exact — the state freezes at the last real row.

* ``ssd_chunked_plain`` is the JAX CPU path (``ops._ssd_chunked_jnp``):
  the same padding, chunk length, sequential inter-chunk carry and
  values, with the intra-chunk decay masked before its exp, so that its
  gradients stay finite where the decays overflow above the diagonal;
* ``ssd_ref_plain`` is the sequential oracle (``ref.ssd_ref``);
* ``ssd_decode_plain`` is one recurrent step (``ref.ssd_decode_ref``),
  functional; ``ssd_decode_masked_plain`` is the same step in place on the
  rows of a mask, the others untouched. The JAX package has no kernel for
  the step (it is XLA elementwise work and a mat-vec); the port's is
  ``ssd_decode_cuda`` (``csrc/ssd_decode.cu``), which takes both forms:
  one pass over the state, read and written once;
* ``ssd_scan_cuda`` launches ``csrc/ssd_scan.cu``, reading x, dt, b and c
  where they lie (no per-head copies of b and c). bfloat16 runs on the
  tensor cores: a block walks the chunks of one batch row for a group of
  heads, forms C·Bᵀ once per chunk for the group and keeps each head's
  state in registers; the float32-formed operands enter the bf16 products
  as hi + lo pairs. float32 runs on the CUDA cores, one block per
  (batch, head);
* ``ssd_vjp`` is the training path's scan on the card: an autograd
  Function whose forward is one launch of the kernel and whose backward
  recomputes ``ssd_chunked_plain`` from the saved inputs under autograd
  and returns its gradients. That is the JAX package's training route,
  autodiff through the plain chunked scan (its Pallas scan has no VJP),
  with the kernel kept as the forward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

# kernel launches so far (the scan's, the decode update's); a run resets
# them to 0 and reads them back to show that its path went through the
# kernels
launches = 0
decode_launches = 0

# (N, P) pairs the kernel is built for (mamba2-1.3b's, zamba2-7b's), and
# the longest chunk it holds on chip (csrc/ssd_scan.cu: kMaxCL)
BUILT_SHAPES = ((128, 64), (64, 64))
MAX_CHUNK = 128


def ssd_chunked_plain(x, dt, a, b, c, chunk: int, initial_state=None):
    """Chunked SSD in plain PyTorch, the arithmetic of the JAX CPU path.

    x: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, N) ->
    (y (B, L, H, P), final_state (B, H, N, P) float32)."""
    bs, l0, h, p = x.shape
    n = b.shape[-1]
    cl = min(chunk, l0)
    pad = (-l0) % cl
    if pad:
        # dt = 0 padding is exact: decay exp(0) = 1, update 0
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    l = l0 + pad
    nc = l // cl

    adt = dt.float() * a.float()                              # (B, L, H)
    xdt = x.float() * dt.float()[..., None]                   # (B, L, H, P)
    adt = adt.reshape(bs, nc, cl, h)
    xdt = xdt.reshape(bs, nc, cl, h, p)
    bc = b.float().reshape(bs, nc, cl, n)
    cc = c.float().reshape(bs, nc, cl, n)

    a_cs = torch.cumsum(adt, dim=2)                           # (B, NC, cl, H)
    a_tot = a_cs[:, :, -1, :]                                 # (B, NC, H)

    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)
    tri = torch.tril(torch.ones((cl, cl), dtype=torch.bool, device=x.device))
    # exp of the masked exponent, not a mask of the exp: the same values
    # (exp(-inf) = 0), but above the diagonal the exponent is positive and
    # its exp overflows once a chunk's decays sum past ~88 (a chunk of 128
    # at full width does), and the backward of where(tri, exp(.), 0) then
    # forms 0 * inf = NaN there, as the JAX package's form does
    lmask = torch.exp(torch.where(
        tri[None, None, :, :, None],
        a_cs[:, :, :, None, :] - a_cs[:, :, None, :, :],
        float("-inf")))                                 # (B, NC, cl, cl, H)
    y_diag = torch.einsum("bcij,bcijh,bcjhp->bcihp", cb, lmask, xdt)

    decay_out = torch.exp(a_tot[:, :, None, :] - a_cs)        # (B, NC, cl, H)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", bc, decay_out, xdt)

    s = (torch.zeros((bs, h, n, p), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    prev = []
    for ci in range(nc):                        # state BEFORE each chunk
        prev.append(s)
        s = s * torch.exp(a_tot[:, ci])[..., None, None] + states[:, ci]
    s_prev = torch.stack(prev, dim=1)                   # (B, NC, H, N, P)

    y_off = torch.einsum("bcin,bchnp,bcih->bcihp", cc, s_prev,
                         torch.exp(a_cs))
    y = (y_diag + y_off).reshape(bs, l, h, p)[:, :l0]
    return y.to(x.dtype), s


def ssd_ref_plain(x, dt, a, b, c, initial_state=None):
    """The sequential recurrence, token by token: the exact oracle."""
    bs, l, h, p = x.shape
    n = b.shape[-1]
    s = (torch.zeros((bs, h, n, p), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    ys = []
    for t in range(l):
        ys_t, s = ssd_decode_plain(x[:, t], dt[:, t], a, b[:, t], c[:, t], s)
        ys.append(ys_t.float())
    return torch.stack(ys, dim=1).to(x.dtype), s


def ssd_decode_plain(x, dt, a, b, c, state):
    """One SSD step. x: (B, H, P); dt: (B, H); b, c: (B, N); state
    (B, H, N, P) -> (y (B, H, P) in x's dtype, new state float32)."""
    decay = torch.exp(dt.float() * a.float())
    update = torch.einsum("bh,bn,bhp->bhnp", dt.float(), b.float(),
                          x.float())
    state = state.float() * decay[..., None, None] + update
    y = torch.einsum("bn,bhnp->bhp", c.float(), state)
    return y.to(x.dtype), state


def ssd_decode_masked_plain(x, dt, a, b, c, state, mask):
    """``ssd_decode_plain`` IN PLACE on the rows in ``mask`` (B,) bool:
    ``state`` (B, H, N, P) float32 advances there, keeps its other rows
    bit for bit, and is returned; y is 0 on the other rows. The plain
    version of the kernel's masked form."""
    y, new = ssd_decode_plain(x, dt, a, b, c, state)
    state.copy_(torch.where(mask[:, None, None, None], new, state))
    return torch.where(mask[:, None, None], y, torch.zeros_like(y)), state


def ssd_decode_cuda(x, dt, a, b, c, state, mask=None):
    """Launch the decode update's kernel. x: (B, H, P) and b, c: (B, N) in
    one dtype (float32 or bfloat16), each row's values contiguous (views
    with a row stride are read where they lie); dt: (B, H) and a: (H,)
    float32; state (B, H, N, P) float32, contiguous. Without ``mask`` every
    row steps into a fresh state; with ``mask`` (B,) bool the rows in it
    step IN PLACE in ``state``, the others are neither read nor written
    and get y = 0. Returns (y (B, H, P) in x's dtype, the new state).
    (N, P) must be one of ``BUILT_SHAPES``."""
    global decode_launches
    bs, h, p = x.shape
    n = b.shape[-1]
    operands = dict(state=state, dt=dt, a=a)
    if mask is not None:
        operands["mask"] = mask
    build.check_operands("ssd_decode", None, **operands)
    build.check_no_grad("ssd_decode", x=x, b=b, c=c)
    if any(t.device != state.device for t in (x, b, c)):
        raise ValueError("ssd_decode: operands must share one CUDA device")
    if (tuple(state.shape) != (bs, h, n, p) or tuple(dt.shape) != (bs, h)
            or tuple(a.shape) != (h,) or tuple(b.shape) != (bs, n)
            or c.shape != b.shape):
        raise ValueError(f"bad shapes: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}, state "
                         f"{tuple(state.shape)}")
    if mask is not None and (mask.dtype != torch.bool
                             or tuple(mask.shape) != (bs,)):
        raise ValueError(f"ssd_decode: mask must be ({bs},) bool, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if (n, p) not in BUILT_SHAPES:
        raise ValueError(f"ssd_decode: (N, P) = {(n, p)} not built "
                         f"{BUILT_SHAPES}")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError("x, b and c must share one dtype")
    if any(t.dtype != torch.float32 for t in (state, dt, a)):
        raise ValueError("state, dt and a must be float32")
    if x.stride()[1:] != (p, 1) or b.stride(-1) != 1 or c.stride(-1) != 1:
        raise ValueError("ssd_decode: each row of x, b and c must be "
                         "contiguous")
    build.check_aligned("ssd_decode", state=state)   # 16-byte loads
    y = torch.empty((bs, h, p), dtype=x.dtype, device=x.device)
    out = state if mask is not None else torch.empty_like(state)
    fn = build.function("ssd_decode")
    err = fn(y.data_ptr(), out.data_ptr(), state.data_ptr(), x.data_ptr(),
             dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
             0 if mask is None else mask.data_ptr(), bs, h, p, n,
             x.stride(0), b.stride(0), c.stride(0),
             build.dtype_code(x.dtype), build.stream_of(x))
    build.check(err, "ssd_decode")
    decode_launches += 1
    return y, out


def ssd_scan_cuda(x, dt, a, b, c, chunk: int, initial_state=None):
    """Launch the CUDA kernel. x: (B, L, H, P) and b, c: (B, L, N) in one
    dtype (float32 or bfloat16); dt: (B, L, H) and a: (H,) float32;
    initial_state: None (zeros) or (B, H, N, P) float32. (N, P) must be
    one of ``BUILT_SHAPES``; ``min(chunk, L)`` at most ``MAX_CHUNK``."""
    global launches
    bs, l, h, p = x.shape
    n = b.shape[-1]
    operands = dict(x=x, dt=dt, a=a, b=b, c=c)
    if initial_state is not None:
        operands["initial_state"] = initial_state
    build.check_operands("ssd_scan", None, **operands)
    if (tuple(dt.shape) != (bs, l, h) or tuple(a.shape) != (h,)
            or tuple(b.shape) != (bs, l, n) or c.shape != b.shape
            or (initial_state is not None
                and tuple(initial_state.shape) != (bs, h, n, p))):
        raise ValueError(f"bad shapes: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}")
    if (n, p) not in BUILT_SHAPES:
        raise ValueError(f"ssd_scan: (N, P) = {(n, p)} not built "
                         f"{BUILT_SHAPES}")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError("x, b and c must share one dtype")
    if x.dtype == torch.bfloat16:  # the tensor-core kernel copies 16 B
        build.check_aligned("ssd_scan", x=x, b=b, c=c)
    floats = [dt, a] + ([initial_state] if initial_state is not None else [])
    if any(t.dtype != torch.float32 for t in floats):
        raise ValueError("dt, a and initial_state must be float32")
    if l < 1 or chunk < 1:
        raise ValueError(f"ssd_scan: L {l} and chunk {chunk} must be >= 1")
    cl = min(chunk, l)
    if cl > MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {cl} above {MAX_CHUNK}")
    y = torch.empty_like(x)
    state = torch.empty((bs, h, n, p), dtype=torch.float32, device=x.device)
    fn = build.function("ssd_scan")
    err = fn(y.data_ptr(), state.data_ptr(), x.data_ptr(), dt.data_ptr(),
             a.data_ptr(), b.data_ptr(), c.data_ptr(),
             0 if initial_state is None else initial_state.data_ptr(),
             bs, l, h, p, n, cl, build.dtype_code(x.dtype),
             build.stream_of(x))
    build.check(err, "ssd_scan")
    launches += 1
    return y, state


class _SsdVjp(torch.autograd.Function):
    """``scan`` (the kernel, or a plain version in the tests) forward;
    autograd through ``ssd_chunked_plain`` backward."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, initial_state, chunk, scan):
        ctx.save_for_backward(x, dt, a, b, c, initial_state)
        ctx.chunk = chunk
        # an output the loss does not reach (training discards the final
        # state) brings None, and its branch of the recomputation is left
        # out rather than fed zeros
        ctx.set_materialize_grads(False)
        return scan(x, dt, a, b, c, chunk, initial_state)

    @staticmethod
    def backward(ctx, dy, dstate):
        *saved, s0 = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        with torch.enable_grad():
            outs = ssd_chunked_plain(*inputs, ctx.chunk, s0)
        outs = [(o, g) for o, g in zip(outs, (dy, dstate)) if g is not None]
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(
            [o for o, _ in outs], wanted, [g for _, g in outs],
            allow_unused=True) if outs and wanted else ())
        return (*[next(grads) if n else None for n in needs], None, None,
                None)


def ssd_vjp(x, dt, a, b, c, chunk: int, initial_state=None, *, scan=None):
    """The SSD scan differentiable in x, dt, a, b and c: (y, final_state)
    as ``ssd_scan_cuda`` gives them, computed by ``scan`` (default:
    ``ssd_scan_cuda``, which runs with grad mode off inside the Function),
    and the gradients of ``ssd_chunked_plain`` at the same inputs. A
    gradient the loss does not send to an output (the final state, in
    training) counts as zeros. ``initial_state`` is a constant: one that
    requires grad raises."""
    if initial_state is not None and initial_state.requires_grad:
        raise NotImplementedError(
            "ssd_vjp: no gradient of the initial state (no training path "
            "passes one)")
    return _SsdVjp.apply(x, dt, a, b, c, initial_state, chunk,
                         scan or ssd_scan_cuda)
