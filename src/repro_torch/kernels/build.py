"""Build the port's CUDA kernels and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (``-gencode arch=compute_90a,code=sm_90a``, no
PyTorch headers, so a build takes seconds). All sources build in parallel
— one ``nvcc`` process each, started together — at the first launch of any
kernel, into ``_build/<hash>/`` next to this file, where ``<hash>`` covers
every source and header under ``csrc/`` plus the compiler flags; a changed
source therefore builds into a fresh directory. ``_build/`` is listed in
``.gitignore``.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine that has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = ("paged_attention", "flash_attention", "chunk_attention",
           "decode_attention", "ssd_scan", "flash_backward")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")

# C argument kinds of the entry points; ctypes needs them declared,
# or it passes every pointer as a 32-bit int
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "paged_decode_attention":
        (_P,) * 7 + (_I,) * 9 + (_F, _P),
    "segment_flash_attention":
        (_P,) * 5 + (_I,) * 7 + (_F, _P),
    "paged_chunk_attention":
        (_P,) * 9 + (_I,) * 9 + (_F, _P),
    "decode_attention":
        (_P,) * 6 + (_I,) * 8 + (_F, _P),
    "flash_attention":
        (_P,) * 5 + (_I,) * 9 + (_F, _P),
    "ssd_scan":
        (_P,) * 8 + (_I,) * 7 + (_P,),
    "flash_attention_bwd":
        (_P,) * 10 + (_I,) * 9 + (_F, _P),
}
ENTRY_LIBRARY = {
    "paged_decode_attention": "paged_attention",
    "segment_flash_attention": "flash_attention",
    "paged_chunk_attention": "chunk_attention",
    "decode_attention": "decode_attention",
    "flash_attention": "flash_attention",
    "ssd_scan": "ssd_scan",
    "flash_attention_bwd": "flash_backward",
}


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def _cuda_tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    default = Path("/usr/local/cuda/bin") / name
    if default.exists():
        return str(default)
    raise RuntimeError(f"{name} not found: it comes with the CUDA toolkit")


def build_all() -> Path:
    """Build every missing library, all ``nvcc`` runs in parallel. Each
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    goes to ``<name>.log`` beside its library. Raises on any failure."""
    out_dir = build_dir()
    missing = [n for n in SOURCES if not (out_dir / f"{n}.so").exists()]
    if not missing:
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _cuda_tool("nvcc")
    procs = {}
    for name in missing:
        tmp = out_dir / f"{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out_dir / f"{name}.so")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out_dir


def sass_count(source: str, opcode: str) -> Dict[str, int]:
    """How many instructions of ``opcode`` (e.g. ``HMMA``) the built
    library of ``source`` holds, by mangled kernel name, from
    ``cuobjdump -sass``."""
    text = subprocess.run(
        [_cuda_tool("cuobjdump"), "-sass",
         str(build_all() / f"{source}.so")],
        capture_output=True, text=True, check=True).stdout
    counts: Dict[str, int] = {}
    name = None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and f" {opcode}" in line:
            counts[name] += 1
    return counts


def build_logs() -> Dict[str, str]:
    """The compiler output of the current build, by source name."""
    out_dir = build_dir()
    return {n: (out_dir / f"{n}.log").read_text() for n in SOURCES
            if (out_dir / f"{n}.log").exists()}


@functools.lru_cache(maxsize=None)
def function(entry: str):
    """The C entry point ``entry``, built and loaded on first use, with its
    argument types declared and ``int`` (a ``cudaError_t``) as result."""
    lib = ctypes.CDLL(str(build_all() / f"{ENTRY_LIBRARY[entry]}.so"))
    fn = getattr(lib, entry)
    fn.argtypes = list(SIGNATURES[entry])
    fn.restype = ctypes.c_int
    return fn


def check(err: int, entry: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")


def dtype_code(dtype) -> int:
    """The kernels' element type code: 0 = float32, 1 = bfloat16."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise ValueError(f"the CUDA kernels take float32 or bfloat16, "
                         f"not {dtype}")
    return codes[dtype]


# the head dims each attention source dispatches (its extern "C" entry):
# 112 is zamba2-7b's shared attention; the chunk kernel is not on that
# family's path (it has no ``prefill_chunk``)
HEAD_DIMS = (64, 128, 112)
CHUNK_HEAD_DIMS = (64, 128)
# the flash backward (training): 64 and 128 only
BWD_HEAD_DIMS = (64, 128)


def check_no_grad(entry: str, **tensors) -> None:
    """Raise when grad mode is on and an operand requires grad: a kernel
    writes a fresh tensor through a raw pointer, so its output would carry
    no ``grad_fn`` and the operands' gradients would be lost without a
    word. The training path's attention goes through
    ``flash_vjp.flash_attention_vjp``, whose autograd Function launches
    the kernels with grad mode off."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors.values()):
        raise RuntimeError(
            f"{entry}: an operand requires grad, and the kernel's output "
            f"would carry no gradient; run it under torch.no_grad(), or "
            f"train through repro_torch.kernels.flash_vjp."
            f"flash_attention_vjp")


def check_operands(entry: str, head_dim: Optional[int], *,
                   head_dims=HEAD_DIMS, **tensors) -> None:
    """Raise unless every operand is a contiguous tensor on one CUDA device
    and the head dimension (``None``: no attention heads) is one of
    ``head_dims``, those the entry's kernel is built for, and unless no
    operand would lose its gradient (``check_no_grad``)."""
    check_no_grad(entry, **tensors)
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{entry}: operands must share one CUDA device, "
                         f"got {sorted(str(d) for d in devices)}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{entry}: {name} must be contiguous")
    if head_dim is not None and head_dim not in head_dims:
        raise ValueError(f"{entry}: head_dim {head_dim} not built "
                         f"{tuple(head_dims)}")


def check_aligned(entry: str, **tensors) -> None:
    """Raise unless every operand starts on a 16-byte boundary: kernels
    that read their operands as 16-byte vectors (``uint4`` loads,
    ``cp.async``) need it, and a contiguous view at another offset has
    not."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{entry}: {name} must start on a 16-byte "
                             f"boundary")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
