"""Device and dtype resolution shared by the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU: ``device=None``
means the current CUDA device, and raises where there is none — the port
never carries on quietly on the CPU.
"""
from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on a GPU unless device='cpu' "
            "is passed explicitly")
    return dev


def dtype_of(name) -> torch.dtype:
    """torch dtype for a config dtype name (or a torch dtype itself)."""
    if isinstance(name, torch.dtype):
        return name
    return DTYPES[str(name)]
