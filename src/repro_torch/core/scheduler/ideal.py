"""The paper's *ideal* spatio-temporal scheduler (§6.2): a theoretical
slot-quantized schedule at per-kernel granularity with free preemption,
exact per-kernel knee knowledge, and instantaneous allocation changes.

Any real non-preemptive system under-utilizes relative to this bound;
paper Fig. 9d shows D-STACK reaching ~86% utilization vs ~95% ideal and
>90% of its throughput.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from repro_torch.core.profiles import ModelProfile
from repro_torch.serving.request import (Request, RequestGenerator,
                                         RequestQueue)
from repro_torch.core.simulator import ModelMetrics, SimResult


@dataclasses.dataclass
class Kernel:
    knee_frac: float           # allocation at which it saturates
    remaining: float           # seconds of work at-or-above the knee


@dataclasses.dataclass
class Job:
    model: str
    deadline: float
    kernels: List[Kernel]
    requests: List[Request]

    @property
    def done(self) -> bool:
        return not self.kernels


def best_operating_point(prof: ModelProfile, max_batch: int = 16):
    """The ideal scheduler knows each model's most unit-efficient feasible
    point: minimize unit-seconds per request s.t. latency <= SLO/2."""
    best = None
    for b in (1, 2, 4, 8, 16, 32, 64):
        if b > max_batch:
            continue
        for c in prof.hw.levels:
            lat = prof.latency(c, b, multiplexed=False)
            if not math.isfinite(lat) or lat > prof.slo / 2:
                continue
            cost = lat * c / b                       # chip-seconds / request
            if best is None or cost < best[0]:
                best = (cost, b, c, lat)
    if best is None:       # SLO unreachable: fall back to knee/batch-16
        b = max_batch
        c = prof.knee_chips
        return b, c, prof.latency(c, b, multiplexed=False)
    return best[1], best[2], best[3]


def kernel_decomposition(prof: ModelProfile, batch: int, chips: int,
                         runtime: float, kmax: int = 24) -> List[Kernel]:
    """Split a model run into kernels with decaying parallelism (paper
    Eq. 1 / Fig. 5): early kernels demand more than the operating-point
    allocation, the long tail demands less — mirroring the Mobilenet
    NVPROF analysis."""
    per = runtime / kmax
    base = chips / prof.hw.chips_per_pod
    kernels = []
    for i in range(kmax):
        # decaying N_i: frac from 2·base down to 0.1·base
        frac = base * (2.0 - 1.9 * i / max(kmax - 1, 1))
        kernels.append(Kernel(knee_frac=min(max(frac, 0.004), 1.0),
                              remaining=per))
    return kernels


class IdealSimulator:
    """Slot-stepped preemptive packing (exhaustive within-slot greedy)."""

    def __init__(self, profiles: Dict[str, ModelProfile],
                 generators: Sequence[RequestGenerator],
                 duration: float = 10.0, slot: float = 1e-4,
                 max_batch: int = 16, drain: bool = False,
                 op_mode: str = "knee"):
        self.profiles = profiles
        self.generators = list(generators)
        self.duration = duration
        self.slot = slot
        self.max_batch = max_batch
        self.drain = drain
        if op_mode == "efficient":
            self._op = {n: best_operating_point(p, max_batch)
                        for n, p in profiles.items()}
        else:
            # paper Fig. 9d setting: same knee/batch operating point as the
            # non-preemptive schedulers — isolates the *scheduling* gain
            self._op = {
                n: (max_batch, p.knee_chips,
                    p.latency(p.knee_chips, max_batch, multiplexed=False))
                for n, p in profiles.items()}

    def run(self) -> SimResult:
        arrivals: List[Request] = []
        for g in self.generators:
            arrivals.extend(g.until(self.duration))
        arrivals.sort(key=lambda r: r.arrival)
        ai = 0
        queues = {n: RequestQueue(n, p.slo) for n, p in self.profiles.items()}
        jobs: Dict[str, Optional[Job]] = {n: None for n in self.profiles}
        metrics = {n: ModelMetrics() for n in self.profiles}
        util_area = 0.0
        t = 0.0
        makespan = 0.0
        n_slots = int(math.ceil(self.duration / self.slot))
        max_slots = n_slots * 4 if self.drain else n_slots

        for si in range(max_slots):
            t = si * self.slot
            while ai < len(arrivals) and arrivals[ai].arrival <= t:
                queues[arrivals[ai].model].push(arrivals[ai]); ai += 1
            # start jobs for idle models with work
            for n, prof in self.profiles.items():
                if jobs[n] is None and len(queues[n]) > 0:
                    b_opt, c_opt, _ = self._op[n]
                    batch = queues[n].pop_batch(
                        b_opt, t, drop_expired=not self.drain)
                    if batch:
                        runtime = prof.latency(c_opt, len(batch),
                                               multiplexed=False)
                        jobs[n] = Job(
                            model=n,
                            deadline=min(r.deadline for r in batch),
                            kernels=kernel_decomposition(
                                prof, len(batch), c_opt, runtime),
                            requests=batch)
                        metrics[n].runs += 1
            # pack this slot: EDF order, grant knee% where possible,
            # partial allocation for the first kernel that doesn't fit
            order = sorted((j for j in jobs.values() if j is not None),
                           key=lambda j: j.deadline)
            cap = 1.0
            for job in order:
                k = job.kernels[0]
                grant = min(k.knee_frac, cap)
                if grant <= 1e-9:
                    continue
                cap -= grant
                speed = min(1.0, grant / k.knee_frac)
                k.remaining -= self.slot * speed
                metrics[job.model].runtime += self.slot
                if k.remaining <= 1e-12:
                    job.kernels.pop(0)
            util_area += (1.0 - cap) * self.slot
            # completions
            for n, job in list(jobs.items()):
                if job is not None and job.done:
                    queues[n].complete(job.requests, t + self.slot)
                    metrics[n].completed += len(job.requests)
                    jobs[n] = None
                    makespan = max(makespan, t + self.slot)
            if self.drain and ai >= len(arrivals) \
                    and all(j is None for j in jobs.values()) \
                    and all(len(q) == 0 for q in queues.values()):
                break

        duration = makespan if self.drain else self.duration
        for n, q in queues.items():
            metrics[n].violated = q.violated + len(q)
        return SimResult(duration=duration or 1e-9,
                         utilization=util_area / (duration or 1e-9),
                         per_model=metrics, makespan=makespan)
