"""Baseline multiplexing policies the paper compares against (§6.3/§7):

  * ``TemporalPolicy``      — pure temporal sharing, whole device per model,
                              time slices ∝ SLO, Clipper/Nexus-style
                              adaptive batching.
  * ``FixedBatchMPSPolicy`` — uncontrolled spatial sharing (default MPS):
                              every model runs when it has work, fixed
                              batch 16, interference dilates latency; the
                              device divides evenly, in multiples of the
                              smallest level.
  * ``GSLICEPolicy``        — static spatial partitions at (normalized)
                              knee fractions, adaptive batching, no
                              temporal scheduling; a slice below the
                              smallest level gets the smallest level.
  * ``TritonPolicy``        — Triton-like: temporal occupancy with dynamic
                              batching, EDF model pick.
  * ``MaxMinPolicy``        — max-min fair spatial allocation (smallest
                              demand first).
  * ``MaxThroughputPolicy`` — packs runs by predicted throughput/chip,
                              fairness-blind.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.scheduler.base import chips_for_frac, running_models
from repro_torch.core.simulator import RunRequest


class TemporalPolicy:
    name = "temporal"

    def __init__(self, profiles, max_batch: int = 16):
        self.max_batch = max_batch
        total_slo = sum(p.slo for p in profiles.values())
        self._order = sorted(profiles, key=lambda n: profiles[n].slo)
        self._idx = 0

    def plan(self, now: float, sim) -> List[RunRequest]:
        if sim.running:
            return []
        total = sim.sim.total_chips
        for _ in range(len(self._order)):
            name = self._order[self._idx % len(self._order)]
            self._idx += 1
            prof = sim.profiles[name]
            q = sim.queues[name]
            if len(q) == 0:
                continue
            # adaptive batching (Clipper/Nexus): largest batch meeting SLO/2
            b = prof.feasible_batch_for(prof.slo / 2, total, len(q))
            b = max(1, min(b, self.max_batch))
            return [RunRequest(name, total, b)]
        return []


class FixedBatchMPSPolicy:
    name = "fixed_batch_mps"

    def __init__(self, profiles, batch: int = 16, interference: float = 0.15):
        self.batch = batch
        self.interference = interference

    def plan(self, now: float, sim) -> List[RunRequest]:
        out = []
        active = running_models(sim)
        waiting = [n for n in sim.profiles
                   if n not in active and len(sim.queues[n]) > 0]
        k = len(active) + len(waiting)
        if k == 0:
            return []
        total = sim.sim.total_chips
        step = max(p.hw.step for p in sim.profiles.values())
        share = max(step, total // max(k, 1) // step * step)
        dilation = 1.0 + self.interference * max(0, k - 1)
        for n in waiting:
            prof = sim.profiles[n]
            chips = max(share, prof.min_chips())
            out.append(RunRequest(n, chips, self.batch,
                                  dilation=dilation, oversubscribe=True))
        return out


class GSLICEPolicy:
    name = "gslice"

    def __init__(self, profiles, max_batch: int = 16):
        self.max_batch = max_batch
        total_knee = sum(p.knee_frac for p in profiles.values())
        scale = min(1.0, 1.0 / total_knee) if total_knee > 0 else 1.0
        # static partition, normalized when over-committed (paper's GSLICE
        # critique: each model may get less than its knee)
        self.partition: Dict[str, int] = {}
        for n, p in profiles.items():
            self.partition[n] = max(p.hw.step,
                                    chips_for_frac(p.knee_frac * scale, p.hw))

    def plan(self, now: float, sim) -> List[RunRequest]:
        out = []
        active = running_models(sim)
        for n, prof in sim.profiles.items():
            if n in active or len(sim.queues[n]) == 0:
                continue
            chips = self.partition[n]
            if prof.min_chips() > chips:
                # model cannot even fit its slice — GSLICE failure mode
                chips = prof.min_chips()
            b = prof.feasible_batch_for(prof.slo / 2, chips, len(sim.queues[n]))
            b = max(1, min(b, self.max_batch))
            out.append(RunRequest(n, chips, b))
        return out


class TritonPolicy:
    name = "triton"

    def __init__(self, profiles, max_batch: int = 16):
        self.max_batch = max_batch

    def plan(self, now: float, sim) -> List[RunRequest]:
        if sim.running:
            return []
        # EDF over models with work; dynamic batcher takes what's queued
        cands = [(sim.queues[n].oldest_deadline(), n)
                 for n in sim.profiles if len(sim.queues[n]) > 0]
        if not cands:
            return []
        _, name = min(cands)
        prof = sim.profiles[name]
        b = min(len(sim.queues[name]), self.max_batch)
        return [RunRequest(name, sim.sim.total_chips, max(1, b))]


class MaxMinPolicy:
    """Max-min fair spatial schedule: maximize the placement of the
    smallest demand first (paper §6.3, [9])."""
    name = "maxmin"

    def __init__(self, profiles, max_batch: int = 16):
        self.max_batch = max_batch

    def plan(self, now: float, sim) -> List[RunRequest]:
        out = []
        active = running_models(sim)
        free = sim.free_frac(now)
        total = sim.sim.total_chips
        # smallest knee demand first
        for n in sorted(sim.profiles, key=lambda n: sim.profiles[n].knee_chips):
            if n in active or len(sim.queues[n]) == 0:
                continue
            prof = sim.profiles[n]
            chips = max(prof.knee_chips, prof.min_chips())
            if chips / total <= free + 1e-9:
                b = prof.feasible_batch_for(prof.slo / 2, chips,
                                            len(sim.queues[n]))
                b = max(1, min(b, self.max_batch))
                out.append(RunRequest(n, chips, b))
                free -= chips / total
        return out


class MaxThroughputPolicy:
    """Packs whatever maximizes aggregate predicted throughput — the
    fairness-blind upper bound of paper Fig. 10."""
    name = "max_throughput"

    def __init__(self, profiles, max_batch: int = 16):
        self.max_batch = max_batch

    def plan(self, now: float, sim) -> List[RunRequest]:
        out = []
        active = set(running_models(sim))
        free = sim.free_frac(now)
        total = sim.sim.total_chips
        cands = []
        for n, prof in sim.profiles.items():
            if n in active or len(sim.queues[n]) == 0:
                continue
            chips = max(prof.opt_chips, prof.min_chips())
            b = min(len(sim.queues[n]), prof.opt_batch, self.max_batch)
            thr_per_chip = b / prof.latency(chips, b) / chips
            cands.append((-thr_per_chip, n, chips, b))
        for _, n, chips, b in sorted(cands):
            if chips / total <= free + 1e-9:
                out.append(RunRequest(n, chips, max(1, b)))
                free -= chips / total
        return out
