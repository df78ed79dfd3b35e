"""Optimal (batch, chip-fraction) via the paper's Efficacy metric (§5).

  η = Throughput / (Latency · GPU%)          (Eq. 7)
    = b / (f_L(p, b)² · p)                   (Eq. 9)

subject to 1 <= b <= MaxBatch (Eq. 10), f_L + C <= SLO (Eq. 11, C = batch
assembly time = b/request_rate) and f_L <= SLO/2 (Eq. 12).

The paper solves this with MATLAB ``fmincon``; the decision lattice is tiny
(the hardware's allocation levels × ~10 batch levels) so exhaustive search
is *exact*. Levels and totals come from the latency model's hardware.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.latency_model import LatencyModel

BATCH_LEVELS = (1, 2, 4, 8, 12, 16, 24, 32, 48, 64)


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    batch: int
    chips: int
    frac: float
    latency: float
    throughput: float
    efficacy: float
    feasible: bool


def efficacy(batch: int, latency: float, frac: float) -> float:
    if latency <= 0 or frac <= 0:
        return 0.0
    return batch / (latency ** 2 * frac)                      # Eq. 9


def feasible(latency: float, batch: int, slo: float,
             request_rate: float) -> bool:
    assembly = batch / request_rate if request_rate > 0 else 0.0
    return (latency + assembly <= slo) and (latency <= slo / 2)   # Eqs. 11–12


def optimize(lm: LatencyModel, *, slo: float, request_rate: float,
             max_batch: int = 64,
             chip_levels: Optional[Sequence[int]] = None,
             batch_levels: Sequence[int] = BATCH_LEVELS,
             total_chips: Optional[int] = None) -> OperatingPoint:
    """Exhaustive search of the (batch, chips) lattice for max efficacy.

    In addition to the paper's Eqs. 10-12 we require queueing stability
    (service rate b/f_L >= arrival rate) whenever a sustainable point
    exists — without it the "optimal" engine can be overrun at high rates.
    ``chip_levels``/``total_chips`` default to ``lm.hw``'s levels and
    units. Raises ``ValueError`` when no allocation holds the model.
    """
    chip_levels = chip_levels or lm.hw.levels
    total_chips = total_chips or lm.hw.chips_per_pod
    best: Optional[OperatingPoint] = None
    best_unsust: Optional[OperatingPoint] = None
    fallback: Optional[OperatingPoint] = None
    for b in batch_levels:
        if b > max_batch:
            continue
        for c in chip_levels:
            lat = lm.latency(c, b)
            if not np.isfinite(lat):
                continue
            frac = c / total_chips
            pt = OperatingPoint(
                batch=b, chips=c, frac=frac, latency=lat,
                throughput=b / lat, efficacy=efficacy(b, lat, frac),
                feasible=feasible(lat, b, slo, request_rate))
            sustainable = (request_rate <= 0) or (b / lat >= request_rate)
            if pt.feasible and sustainable and (
                    best is None or pt.efficacy > best.efficacy):
                best = pt
            if pt.feasible and (best_unsust is None
                                or pt.efficacy > best_unsust.efficacy):
                best_unsust = pt
            if fallback is None or pt.throughput > fallback.throughput:
                fallback = pt
    if best is not None:
        return best
    if best_unsust is not None:
        return best_unsust
    if fallback is None:
        raise ValueError(f"{lm.cfg.name}: no allocation of {lm.hw.name} "
                         f"holds the model")
    # nothing feasible: best-effort max-throughput point, flagged infeasible
    return fallback


def efficacy_surface(lm: LatencyModel, *,
                     chip_levels: Optional[Sequence[int]] = None,
                     batch_levels: Sequence[int] = BATCH_LEVELS,
                     total_chips: Optional[int] = None) -> np.ndarray:
    """(len(batch_levels), len(chip_levels)) η grid — paper Fig. 7."""
    chip_levels = chip_levels or lm.hw.levels
    total_chips = total_chips or lm.hw.chips_per_pod
    grid = np.zeros((len(batch_levels), len(chip_levels)))
    for i, b in enumerate(batch_levels):
        for j, c in enumerate(chip_levels):
            grid[i, j] = efficacy(b, lm.latency(c, b), c / total_chips)
    return grid
