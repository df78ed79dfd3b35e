"""Checkpoints in the JAX package's file format (``training/checkpoint.py``
there): one msgpack map from each leaf's ``/``-joined key path to
``{"dtype": str, "shape": [int, ...], "data": bytes}``, with the keys in
the order ``jax.tree_util`` flattens nested dictionaries (sorted at every
level). A bfloat16 leaf is written as its raw bytes under dtype
``"bfloat16"``, as the JAX package writes one.

The port carries its own small msgpack codec (maps, strings, binaries,
arrays and unsigned integers: what the format holds), not the ``msgpack``
package. Its encodings are those ``msgpack.packb`` picks (the shortest
form of each), so a file written here is byte for byte the JAX package's.
"""
from __future__ import annotations

import os
import struct
from typing import Any, BinaryIO

import numpy as np
import torch

from repro_torch.training.optimizer import flatten, unflatten

_NP_DTYPES = {torch.float32: "float32", torch.float16: "float16",
              torch.bfloat16: "bfloat16", torch.int32: "int32",
              torch.int64: "int64", torch.uint8: "uint8",
              torch.bool: "bool"}


# --------------------------------------------------------------------------
# msgpack: the subset the format uses
# --------------------------------------------------------------------------
def _head(n: int, fix: int, fix_max: int, codes) -> bytes:
    """The header of a sized item: a fix form up to ``fix_max``, else the
    8-, 16- or 32-bit length forms in ``codes`` (None where the type has
    none)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (0xff, 0xffff, 0xffffffff)):
        if code is not None and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack item of {n} entries or bytes is too large")


def _uint(n: int) -> bytes:
    if n < 0:
        raise ValueError("the codec writes unsigned integers only")
    if n <= 0x7f:
        return bytes([n])
    for code, fmt, limit in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                             (0xce, ">I", 0xffffffff),
                             (0xcf, ">Q", 0xffffffffffffffff)):
        if n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"{n} does not fit 64 bits")


def _str(s: str) -> bytes:
    b = s.encode()
    return _head(len(b), 0xa0, 31, (0xd9, 0xda, 0xdb)) + b


def _bin_head(n: int) -> bytes:
    return _head(n, None, 0, (0xc4, 0xc5, 0xc6))


def _map_head(n: int) -> bytes:
    return _head(n, 0x80, 15, (None, 0xde, 0xdf))


def _array_head(n: int) -> bytes:
    return _head(n, 0x90, 15, (None, 0xdc, 0xdd))


class _Reader:
    def __init__(self, buf: bytes):
        self.buf, self.pos = memoryview(buf), 0

    def take(self, n: int):
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def length(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        c = self.take(1)[0]
        if c <= 0x7f:
            return c
        if 0x80 <= c <= 0x8f:
            return self._map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return [self.read() for _ in range(c & 0x0f)]
        if 0xa0 <= c <= 0xbf:
            return bytes(self.take(c & 0x1f)).decode()
        sized = {0xc4: (">B", bytes), 0xc5: (">H", bytes),
                 0xc6: (">I", bytes), 0xd9: (">B", str),
                 0xda: (">H", str), 0xdb: (">I", str)}
        if c in sized:
            fmt, kind = sized[c]
            raw = bytes(self.take(self.length(fmt)))
            return raw if kind is bytes else raw.decode()
        uints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q"}
        if c in uints:
            return self.length(uints[c])
        if c in (0xdc, 0xdd):
            return [self.read() for _ in
                    range(self.length(">H" if c == 0xdc else ">I"))]
        if c in (0xde, 0xdf):
            return self._map(self.length(">H" if c == 0xde else ">I"))
        raise ValueError(f"msgpack type 0x{c:02x} is not in the format")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


# --------------------------------------------------------------------------
# the checkpoint format
# --------------------------------------------------------------------------
def _key(path) -> str:
    return "/".join(str(k) for k in path)


def _leaf_bytes(t: torch.Tensor):
    """(dtype name, shape, raw bytes) of a tensor, on the host."""
    t = t.detach().contiguous().cpu()
    if t.dtype not in _NP_DTYPES:
        raise ValueError(f"no checkpoint dtype for {t.dtype}")
    name = _NP_DTYPES[t.dtype]
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return name, list(t.shape), raw.numpy().tobytes()


def _write(f: BinaryIO, tree) -> None:
    leaves = flatten(tree)
    f.write(_map_head(len(leaves)))
    for path, leaf in leaves:
        name, shape, data = _leaf_bytes(leaf)
        f.write(_str(_key(path)))
        f.write(_map_head(3))
        f.write(_str("dtype") + _str(name))
        f.write(_str("shape") + _array_head(len(shape))
                + b"".join(_uint(n) for n in shape))
        f.write(_str("data") + _bin_head(len(data)))
        f.write(data)


def save(path: str, tree: Any) -> None:
    """Write ``tree`` (nested dictionaries of tensors) to ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        _write(f, tree)


def _tensor(rec: dict) -> torch.Tensor:
    shape = [int(n) for n in rec["shape"]]
    if rec["dtype"] == "bfloat16":
        arr = np.frombuffer(rec["data"], dtype=np.int16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    arr = np.frombuffer(rec["data"], dtype=rec["dtype"]).reshape(shape)
    return torch.from_numpy(arr.copy())


def load(path: str, like: Any) -> Any:
    """Restore the file at ``path`` into the structure of ``like``: each
    leaf takes the file's values, checked against ``like``'s shape, on
    ``like``'s device in ``like``'s dtype."""
    with open(path, "rb") as f:
        flat = _Reader(f.read()).read()

    def restore(keys, sub):
        key = _key(keys)
        t = _tensor(flat[key])
        if tuple(t.shape) != tuple(sub.shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)} in the file, "
                             f"{tuple(sub.shape)} expected")
        return t.to(device=sub.device, dtype=sub.dtype)

    return unflatten((keys, restore(keys, x)) for keys, x in flatten(like))
