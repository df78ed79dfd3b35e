"""Discrete-event serving simulator — the control plane testbed.

The simulator owns virtual time; run durations come from each model's
roofline latency function (``ModelProfile.latency``). Scheduler policies
(``repro_torch.core.scheduler``) decide, at every event (arrival burst, run
completion, session boundary), which (model, chips, batch) runs to start —
with the invariant that aggregate allocated fraction never exceeds 1.0
(paper: "the GPU must not be over-subscribed"), except for policies that
explicitly model uncontrolled sharing (Fixed-Batch MPS). Allocations are
counted in the hardware's units (``chips``: GPU percent on the H100).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Sequence

from repro_torch.core.eventloop import LoopConfig, run_event_loop
from repro_torch.core.profiles import ModelProfile
from repro_torch.serving.request import (Request, RequestGenerator,
                                         RequestQueue)


@dataclasses.dataclass
class RunRequest:
    model: str
    chips: int
    batch: int
    dilation: float = 1.0           # >1 models interference (FB-MPS only)
    oversubscribe: bool = False


@dataclasses.dataclass
class Run:
    model: str
    chips: int
    frac: float
    batch: int
    start: float
    end: float
    requests: List[Request]


@dataclasses.dataclass
class SimConfig:
    duration: float = 10.0
    total_chips: Optional[int] = None   # None -> the profiles' hardware
    drain: bool = False             # run until all work completes (Table 1)
    drop_expired: bool = True
    dispatch_gap: float = 100e-6    # engine-switch gap (paper §1: <100 µs)
    max_time: float = 600.0
    # horizon up to which rate-based generators materialize arrivals; None
    # -> ``duration``. Drain runs with rate generators MUST set this (or a
    # nonzero duration): the pre-fix behavior materialized arrivals up to
    # t=0 and silently simulated an empty workload.
    arrival_horizon: Optional[float] = None


@dataclasses.dataclass
class ModelMetrics:
    completed: int = 0
    violated: int = 0
    runtime: float = 0.0
    runs: int = 0

    def throughput(self, duration: float) -> float:
        return self.completed / duration if duration > 0 else 0.0


@dataclasses.dataclass
class SimResult:
    duration: float
    utilization: float
    per_model: Dict[str, ModelMetrics]
    makespan: float

    @property
    def total_completed(self) -> int:
        return sum(m.completed for m in self.per_model.values())

    @property
    def total_violated(self) -> int:
        return sum(m.violated for m in self.per_model.values())

    def throughput(self, model: Optional[str] = None) -> float:
        if model:
            return self.per_model[model].throughput(self.duration)
        return self.total_completed / self.duration


class Simulator:
    def __init__(self, profiles: Dict[str, ModelProfile], policy,
                 generators: Sequence[RequestGenerator],
                 sim: Optional[SimConfig] = None):
        self.profiles = profiles
        self.policy = policy
        self.sim = sim or SimConfig()
        if self.sim.total_chips is None:
            self.sim = dataclasses.replace(self.sim, total_chips=max(
                (p.hw.chips_per_pod for p in profiles.values()), default=1))
        # latencies untracked: SimResult never reads them, and production
        # rates complete 10^5-10^6 requests per run
        self.queues: Dict[str, RequestQueue] = {
            name: RequestQueue(name, p.slo, track_latency=False)
            for name, p in profiles.items()}
        self.generators = list(generators)
        # Hot-path state: runs live in a dict keyed by a start sequence
        # number, completions in a min-heap of (end, seq), and the
        # allocated / knee-credited fractions are maintained incrementally
        # — each event is O(log n) instead of the O(n) full scans that made
        # fig9/fig11 at full scale O(n^2) overall.
        self._running: Dict[int, Run] = {}
        self._end_heap: List = []
        self._run_seq = 0
        self._alloc_frac = 0.0      # sum of frac over in-flight runs
        self._busy_knee = 0.0       # sum of min(frac, knee_frac)
        self.metrics: Dict[str, ModelMetrics] = {
            name: ModelMetrics() for name in profiles}
        self._util_area = 0.0
        self._last_t = 0.0
        self._makespan = 0.0

    # ------------------------------------------------------------------
    @property
    def running(self) -> List[Run]:
        """Snapshot of in-flight runs (list view kept for policies/tests)."""
        return list(self._running.values())

    def free_frac(self, now: float) -> float:
        # completions are drained before every planning point, so the
        # incremental accumulator is exact here
        return 1.0 - self._alloc_frac

    def _advance(self, t: float) -> None:
        # paper §6.1: utilization credits each model only up to its knee —
        # allocation beyond the knee is waste, not utilization
        self._util_area += min(self._busy_knee, 1.0) * (t - self._last_t)
        self._last_t = t

    def _start_runs(self, now: float, reqs: List[RunRequest]) -> None:
        for rr in reqs:
            prof = self.profiles[rr.model]
            q = self.queues[rr.model]
            batch = q.pop_batch(rr.batch, now, self.sim.drop_expired)
            if not batch:
                continue
            frac = rr.chips / self.sim.total_chips
            if not rr.oversubscribe and frac > self.free_frac(now) + 1e-9:
                for req in batch:       # shouldn't happen: put back
                    q.push(req)
                continue
            lat = prof.latency(rr.chips, len(batch)) * rr.dilation
            run = Run(rr.model, rr.chips, frac, len(batch), now,
                      now + lat + self.sim.dispatch_gap, batch)
            seq = self._run_seq
            self._run_seq += 1
            self._running[seq] = run
            heapq.heappush(self._end_heap, (run.end, seq))
            self._alloc_frac += frac
            self._busy_knee += min(frac, prof.knee_frac)
            m = self.metrics[rr.model]
            m.runs += 1
            m.runtime += lat

    def _pop_done(self, now: float, epsilon: float = 1e-12) -> List[Run]:
        done = []
        while self._end_heap and self._end_heap[0][0] <= now + epsilon:
            _, seq = heapq.heappop(self._end_heap)
            run = self._running.pop(seq)
            self._alloc_frac -= run.frac
            self._busy_knee -= min(run.frac,
                                   self.profiles[run.model].knee_frac)
            done.append(run)
        if not self._running:           # re-zero: no float-drift build-up
            self._alloc_frac = 0.0
            self._busy_knee = 0.0
        return done

    def _finish(self, run: Run, now: float) -> None:
        q = self.queues[run.model]
        q.complete(run.requests, now)
        m = self.metrics[run.model]
        m.completed += len(run.requests)
        m.violated = q.violated
        self._makespan = max(self._makespan, now)

    # ----------------------------------------- EventLoopHooks (core loop)
    # The arrival / epsilon / cutoff / drain semantics live ONCE in
    # ``repro_torch.core.eventloop`` — the same skeleton drives the real-engine
    # Controller, so the two planes cannot drift. These hooks are the
    # analytic machinery the skeleton calls into.
    def deliver(self, req: Request) -> None:
        self.queues[req.model].push(req)

    def next_completion(self) -> float:
        return self._end_heap[0][0] if self._end_heap else math.inf

    def next_wakeup(self, now: float) -> float:
        return (self.policy.next_wakeup(now)
                if hasattr(self.policy, "next_wakeup") else math.inf)

    def advance(self, t: float) -> None:
        self._advance(t)

    def fire(self, now: float, epsilon: float = 1e-12) -> int:
        # completions (heap pop + incremental accumulator update); atomic
        # analytic runs dispatch nothing real, so the event cost is 0
        for r in self._pop_done(now, epsilon):
            self._finish(r, now)
        return 0

    def plan(self, now: float) -> None:
        reqs = self.policy.plan(now, self)
        if reqs:
            self._start_runs(now, reqs)

    def drained(self) -> bool:
        return (not self._running
                and all(len(q) == 0 for q in self.queues.values()))

    # ------------------------------------------------------------------
    def run(self) -> SimResult:
        sim = self.sim
        run_event_loop(
            LoopConfig(duration=sim.duration, drain=sim.drain,
                       max_time=sim.max_time,
                       arrival_horizon=sim.arrival_horizon),
            self.generators, self)
        duration = (self._makespan if sim.drain else sim.duration) or 1e-9
        for name, q in self.queues.items():
            self.metrics[name].violated = q.violated + len(q)  # unserved count
        return SimResult(
            duration=duration,
            utilization=self._util_area / duration,
            per_model=self.metrics,
            makespan=self._makespan)
