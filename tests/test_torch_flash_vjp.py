"""The port's flash VJP (``repro_torch.kernels.flash_vjp``) against the JAX
package's (``repro.kernels.flash_vjp``) on the CPU: the same numpy inputs
go through both, and the plain route's output, log-sum-exp and
gradients must agree within atol 1e-4 (the JAX test's tolerance,
``tests/test_kernels.py``). Covered: causal, a window, GQA 4/2 and MHA,
non-causal Sk != S, the ``q_offset`` slices of context-parallel attention,
and ``layers.big_attention`` under autograd at S 128 (``attention_dense``)
and S 2048 (the flash VJP) against JAX ``big_attention``. Also the grad
guard every CUDA wrapper runs (``build.check_no_grad``), on CPU tensors.
The CUDA route's checks are gpu-marked in ``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_vjp as JV  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_vjp as TV  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

ATOL = 1e-4

# (b, sq, sk, h, kv, d, causal, window, chunk_q, chunk_k)
CASES = {
    "causal_gqa": (2, 128, 128, 4, 2, 64, True, 0, 64, 64),
    "causal_mha": (2, 128, 128, 4, 4, 64, True, 0, 64, 32),
    "window": (2, 128, 128, 4, 2, 64, True, 32, 64, 64),
    "noncausal_cross": (2, 64, 192, 4, 2, 64, False, 0, 32, 64),
    "single_chunk": (1, 96, 96, 2, 1, 32, True, 0, 512, 512),
}


def _inputs(seed, b, sq, sk, h, kv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d), np.float32)
    k = rng.standard_normal((b, sk, kv, d), np.float32)
    v = rng.standard_normal((b, sk, kv, d), np.float32)
    ct = rng.standard_normal((b, sq, h, d), np.float32)
    return q, k, v, ct


def _jax_run(q, k, v, ct, **kw):
    def f(q, k, v):
        return (JV.flash_attention_vjp(q, k, v, **kw) * ct).sum()
    out = JV.flash_attention_vjp(q, k, v, **kw)
    return [np.asarray(x) for x in
            (out, *jax.grad(f, argnums=(0, 1, 2))(q, k, v))]


def _torch_run(q, k, v, ct, **kw):
    xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = TV.flash_attention_vjp(*xs, **kw)
    (out * torch.tensor(ct)).sum().backward()
    return [out.detach().numpy()] + [x.grad.numpy() for x in xs]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_flash_vjp_matches_jax(name):
    b, sq, sk, h, kv, d, causal, window, cq, ck = CASES[name]
    q, k, v, ct = _inputs(0, b, sq, sk, h, kv, d)
    kw = dict(causal=causal, window=window, chunk_q=cq, chunk_k=ck)
    for want, got, what in zip(_jax_run(q, k, v, ct, **kw),
                               _torch_run(q, k, v, ct, **kw),
                               ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_lse_matches_jax(name):
    """``flash_fwd_plain``'s lse is ``_fwd_impl``'s (JAX repeats the KV
    heads first; the port reads them grouped)."""
    b, sq, sk, h, kv, d, causal, window, cq, ck = CASES[name]
    q, k, v, _ = _inputs(1, b, sq, sk, h, kv, d)
    cq, ck = min(cq, sq), min(ck, sk)
    kr, vr = (np.repeat(x, h // kv, axis=2) for x in (k, v))
    jout, jlse = JV._fwd_impl(q, kr, vr, causal, window, cq, ck)
    tout, tlse = TV.flash_fwd_plain(*(torch.tensor(x) for x in (q, k, v)),
                                    causal=causal, window=window,
                                    chunk_q=cq, chunk_k=ck)
    assert tlse.shape == (b, h, sq) and tlse.dtype == torch.float32
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=ATOL)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL)


@pytest.mark.parametrize("lo", [0, 64, 128])
def test_plain_flash_vjp_q_offset_slices_match_jax(lo):
    """The context-parallel building block of ``tests/test_kernels.py``:
    a query slice with ``q_offset`` against the full keys, output and
    gradients against JAX's."""
    q, k, v, ct = _inputs(2, 1, 256, 256, 2, 2, 64)
    kw = dict(causal=True, chunk_q=64, chunk_k=64, q_offset=lo)
    for want, got, what in zip(
            _jax_run(q[:, lo:], k, v, ct[:, lo:], **kw),
            _torch_run(q[:, lo:], k, v, ct[:, lo:], **kw),
            ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=what)


def test_plain_route_handles_ragged_chunks():
    """Lengths that are no multiple of the chunk (the JAX function asserts
    that they are): the plain route's last chunks are short, and it equals
    the one-chunk run."""
    q, k, v, ct = _inputs(3, 1, 100, 100, 4, 2, 32)
    whole = _torch_run(q, k, v, ct, causal=True, chunk_q=512, chunk_k=512)
    ragged = _torch_run(q, k, v, ct, causal=True, chunk_q=48, chunk_k=40)
    for a, b in zip(whole, ragged):
        np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("s", [128, 2048])
def test_big_attention_gradient_matches_jax(s):
    """``layers.big_attention`` under autograd against JAX
    ``big_attention``'s gradient: ``attention_dense`` at S 128, the flash
    VJP (chunks of 512) at S 2048, narrow heads."""
    q, k, v, ct = _inputs(4, 1, s, s, 4, 2, 16)

    def jf(q, k, v):
        return (JL.big_attention(q, k, v, causal=True) * ct).sum()

    jout = JL.big_attention(q, k, v, causal=True)
    jg = jax.grad(jf, argnums=(0, 1, 2))(q, k, v)
    xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = TL.big_attention(*xs, causal=True)
    assert out.grad_fn is not None
    (out * torch.tensor(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=ATOL)
    for x, g, what in zip(xs, jg, ("dq", "dk", "dv")):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), atol=ATOL,
                                   err_msg=what)


def test_big_attention_without_grad_is_the_serving_path():
    """Outside autograd ``big_attention`` is the kernel dispatch it was:
    the plain version on the CPU, no graph."""
    q, k, v, _ = _inputs(5, 1, 64, 64, 4, 2, 16)
    xs = [torch.tensor(x) for x in (q, k, v)]
    out = TL.big_attention(*xs, causal=True)
    assert out.grad_fn is None
    with torch.no_grad():
        ys = [x.clone().requires_grad_(True) for x in xs]
        assert TL.big_attention(*ys, causal=True).grad_fn is None


def test_check_no_grad_raises_only_under_grad_mode():
    """The guard of every CUDA wrapper: an operand that requires grad
    under grad mode raises (the kernel's output would carry no gradient);
    under ``torch.no_grad()``, or with no such operand, it passes."""
    a = torch.zeros(3)
    b = torch.zeros(3, requires_grad=True)
    build.check_no_grad("flash_attention", q=a, k=a)
    with pytest.raises(RuntimeError, match="flash_attention.*gradient"):
        build.check_no_grad("flash_attention", q=a, k=b)
    with torch.no_grad():
        build.check_no_grad("flash_attention", q=a, k=b)
    with pytest.raises(RuntimeError, match="gradient"):
        build.check_operands("decode_attention", 64, q=b)


def test_cuda_wrappers_all_run_the_guard():
    """Each of the six kernels' wrappers runs ``check_operands`` (and so
    the guard) before it touches its operands: a CPU tensor that requires
    grad is refused for its gradient first."""
    from repro_torch.kernels import (chunk_attention, decode_attention,
                                     flash_attention, paged_attention,
                                     ssd_scan)
    t = torch.zeros(1, 8, 2, 64, requires_grad=True)
    i32 = torch.zeros(1, dtype=torch.int32)
    calls = [
        lambda: flash_attention.flash_attention_cuda(t, t, t),
        lambda: flash_attention.segment_flash_attention_cuda(
            t, t, t, torch.zeros(8, dtype=torch.int32)),
        lambda: decode_attention.decode_attention_cuda(t[:, 0], t, t, i32),
        lambda: paged_attention.paged_decode_attention_cuda(
            t[:, 0], t, t, i32[:, None], i32),
        lambda: chunk_attention.paged_chunk_attention_cuda(
            t, t, t, t, t, i32[:, None], i32, i32),
        lambda: ssd_scan.ssd_scan_cuda(t, t[..., 0], t[0, 0, :, 0], t[..., 0],
                                       t[..., 0], 8),
        lambda: TV.flash_attention_bwd_cuda(t, t, t, t, t, t[..., 0]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="gradient"):
            call()
