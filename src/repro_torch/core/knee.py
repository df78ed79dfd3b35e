"""The paper's analytical DNN-parallelism model (§4.3, Eqs. 1–6).

A DNN is a sequence of kernels K_1..K_max whose parallelizable work N_i
decays linearly (Eq. 1); execution time of each kernel is bounded by
min(S, N_i) compute units (Eq. 2); memory stalls scale with data size and
allocated units (Eq. 3); serialized overheads accumulate per kernel (Eq. 4);
total time is Eq. 5. The most efficient allocation maximizes work per unit
time per unit ("utility" 1/(E_t·S)), located via the first-order derivative
(Eq. 6).

This module is hardware-agnostic (units = SMs on GPU, chips on TPU) and
numpy only; ``tests/test_torch_core.py`` holds it equal to the JAX
package's copy, which is validated against the paper's own simulation
results (Fig. 4a/4b).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class AnalyticalDNN:
    """Paper Table 4 notation."""
    kmax: int = 50              # number of kernels
    p: int = 40                 # concurrent ops of the 1st kernel (per batch item)
    b: int = 1                  # batch size
    t_p: float = 40.0           # time per parallel op
    t_np: float = 10.0          # serialized (launch) time per kernel
    mem_bw_per_unit: float = 0.0   # M: Eq. 3's per-unit bandwidth (0 = ignore)
    data_per_kernel: float = 0.0   # d_i (constant across kernels for simplicity)
    repetitions: int = 1           # R_i
    # sub-knee contention: with far fewer units than inherent parallelism,
    # wave quantization/cache thrash make the slowdown super-linear — the
    # "exponential increase" the paper measures in Fig. 2 at low GPU%.
    contention: float = 0.25

    # Eq. 1 — parallelizable ops per kernel, decaying to ~0 at K_max
    def parallel_ops(self) -> np.ndarray:
        n1 = self.p * self.b
        dec = n1 / self.kmax
        n = n1 - dec * np.arange(self.kmax)
        return np.maximum(n, 1.0)

    # Eqs. 2–5 — total execution time given S allocated units
    def execution_time(self, s: int | np.ndarray) -> np.ndarray:
        s = np.asarray(s, dtype=np.float64)
        n = self.parallel_ops()                                   # (K,)
        w = n * self.t_p                                          # W_i
        su = np.maximum(s, 1.0)
        eff = np.maximum(1.0, np.minimum(su[..., None], n[None, :]))
        # Eq. 2 plus the sub-knee superlinear contention factor
        factor = 1.0 + self.contention * np.maximum(
            0.0, (n[None, :] - su[..., None]) / su[..., None])
        e_par = (w[None, :] / eff * factor).sum(-1) * self.repetitions
        if self.mem_bw_per_unit > 0:
            # Eq. 3 verbatim: E_m = d_i·S/M — memory stalls GROW with the
            # allocation (per-unit bandwidth share contention)
            e_m = self.data_per_kernel * su / self.mem_bw_per_unit
        else:
            e_m = 0.0
        # Eq. 4 (one launch per *batched* kernel, not per item — deviation
        # from the paper's b× factor, recorded in DESIGN.md §7)
        w_se = self.kmax * self.repetitions * (self.t_np + e_m)
        return w_se + e_par                                       # Eq. 5

    # Eq. 6 — utility and its derivative
    def utility(self, s) -> np.ndarray:
        s = np.asarray(s, dtype=np.float64)
        return 1.0 / (self.execution_time(s) * np.maximum(s, 1))

    def derivative_curve(self, s_range: Sequence[int]) -> np.ndarray:
        """d/dS of inverse latency — the curve the paper plots in Fig. 4b."""
        s = np.asarray(s_range, dtype=np.float64)
        inv = 1.0 / self.execution_time(s)
        return np.gradient(inv, s)

    def knee(self, s_max: int = 128) -> int:
        """Most efficient allocation: the maximum of the first derivative
        of inverse latency (paper Fig. 4b / Fig. 6)."""
        s = np.arange(1, s_max + 1)
        return int(s[np.argmax(self.derivative_curve(s))])


def knee_of_latency(latency_fn, fractions: Sequence[float],
                    rel_tol: float = 0.05) -> float:
    """Generic knee finder for a measured/derived latency curve.

    The knee is the smallest allocation whose latency is within ``rel_tol``
    of the best achievable latency — matching the paper's definition
    ("latency remains unchanged above the knee").
    """
    lats = np.asarray([latency_fn(f) for f in fractions], dtype=np.float64)
    best = lats.min()
    for f, lat in zip(fractions, lats):
        if lat <= best * (1 + rel_tol):
            return float(f)
    return float(fractions[-1])


def knee_binary_search(latency_fn, fractions: Sequence[float],
                       rel_tol: float = 0.05) -> float:
    """§3.3's online procedure for an unprofiled model: start at a nominal
    allocation and binary-search the knee from live latency readings."""
    fr = sorted(fractions)
    lo, hi = 0, len(fr) - 1
    best = latency_fn(fr[-1])
    while lo < hi:
        mid = (lo + hi) // 2
        if latency_fn(fr[mid]) <= best * (1 + rel_tol):
            hi = mid
        else:
            lo = mid + 1
    return float(fr[lo])
