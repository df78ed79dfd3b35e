"""Controller: the serving loop that lets a Policy drive the EnginePool —
a copy of the JAX package's ``repro.serving.controller`` over the port's
pool.

Discrete-event execution (paper §6): the controller owns a virtual clock;
events are request arrivals, engine decode steps, and policy session
wakeups. At every event it drains arrivals into the per-model queues, steps
the engines whose next decode is due (each step is ONE real dispatch — a
CUDA graph replay on the card — over all of that engine's slots), and asks
the policy to ``plan``
against the pool's SchedView — translating each ``RunRequest`` into an
admission on a pre-built standby engine via ``EnginePool.admit``.

Every data-plane action under this loop routes through the declarative
plan API (``repro_torch.serving.plan``): admissions and topups are StepPlans
built by the model's ``StepPlanner`` (one shared admission gate — page
horizon, SLO expiry, head reservation) and decode steps execute as
``StepPlan(decodes=...)``, so the pool plane and the tick plane
(``TickServer``) cannot diverge in engine semantics. Pools built with
``lazy_kv=True`` additionally reserve pages lazily and preempt-and-
requeue on ``OutOfPages`` mid-run (``preemptions``/``requeues`` in
``PoolMetrics``).

Virtual time advances by the profile roofline latency of each run at its
*granted* allocation, so SLO accounting, session boundaries, and policy
comparisons are deterministic and paper-comparable on any host —
while the data plane underneath executes the real slot-batched decode hot
path. Wall-clock time of the whole schedule is reported alongside.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.eventloop import LoopConfig, run_event_loop
from repro_torch.serving.metrics import PoolResult
from repro_torch.serving.pool import EnginePool
from repro_torch.serving.request import Request, RequestGenerator


@dataclasses.dataclass
class ControllerConfig:
    duration: float = 1.0           # virtual seconds (ignored when drain)
    gen_len: int = 4                # default decode tokens per request —
                                    # a request's own n_tokens overrides it
    drain: bool = False             # run until all queued work completes
    drop_expired: bool = True
    # mid-run re-admission: when ragged n_tokens budgets free a run's slot
    # early, refill it from the queue without waiting for the run (or the
    # policy). Uniform-budget workloads never trip it (no early frees).
    topup: bool = True
    # horizon up to which rate generators materialize arrivals; None ->
    # ``duration`` (drain runs MUST set one of them, like the simulator)
    arrival_horizon: Optional[float] = None
    max_steps: int = 500_000        # safety valve on real dispatches
    # virtual-time backstop (mirrors SimConfig.max_time): bounds drain
    # runs where a policy keeps waking but nothing is ever admitted
    max_time: float = 600.0


class Controller:
    def __init__(self, pool: EnginePool, policy,
                 generators: Sequence[RequestGenerator],
                 cfg: Optional[ControllerConfig] = None, on_plan=None):
        self.pool = pool
        self.policy = policy
        self.generators = list(generators)
        self.cfg = cfg or ControllerConfig()
        # scripting hook f(now, pool), called at every planning point
        # BEFORE topup/policy — the chaos harness drives pool-plane
        # cancellations and fault scheduling through it
        self.on_plan = on_plan
        # conformance hooks (tests/bench): peak allocation, invariant flag,
        # and the cumulative served count at every completion event
        self.max_alloc = 0.0
        self.oversubscribed = False
        self.served_timeline: List[Tuple[float, int]] = []
        self._makespan = 0.0
        self._heap: List[Tuple[float, int]] = []  # (next decode time, seq)
        self._last_served = 0

    @property
    def telemetry(self):
        """The pool's telemetry plane (read by the core event loop)."""
        return self.pool.telemetry

    # ------------------------------------------------------------------
    def _plan(self, now: float, heap: List[Tuple[float, int]]) -> None:
        for rr in self.policy.plan(now, self.pool) or []:
            run = self.pool.admit(rr, now, self.cfg.gen_len,
                                  self.cfg.drop_expired)
            if run is None:
                continue
            heapq.heappush(heap, (run.next_time, run.seq))
            # the pool maintains the aggregate incrementally — one source
            # of truth for the oversubscription invariant
            alloc = 1.0 - self.pool.free_frac(now)
            self.max_alloc = max(self.max_alloc, alloc)
            if not rr.oversubscribe and alloc > 1.0 + 1e-6:
                self.oversubscribed = True

    def _total_served(self) -> int:
        return sum(q.completed for q in self.pool.queues.values())

    # ----------------------------------------- EventLoopHooks (core loop)
    # The loop semantics live ONCE in ``repro_torch.core.eventloop`` — the same
    # skeleton drives the analytic Simulator, so the two planes cannot
    # drift. These hooks are the real-engine machinery inside the events.
    def deliver(self, req: Request) -> None:
        self.pool.push(req)

    def next_completion(self) -> float:
        return self._heap[0][0] if self._heap else math.inf

    def next_wakeup(self, now: float) -> float:
        return (self.policy.next_wakeup(now)
                if hasattr(self.policy, "next_wakeup") else math.inf)

    def advance(self, t: float) -> None:
        self.pool.advance_time(t)

    def fire(self, now: float, epsilon: float = 1e-12) -> int:
        steps = 0
        while self._heap and self._heap[0][0] <= now + epsilon:
            _, seq = heapq.heappop(self._heap)
            run = self.pool._runs.get(seq)
            if run is None:
                continue
            finished = self.pool.step_run(run, now)  # real dispatch
            steps += 1
            served = self._total_served()
            if served != self._last_served:     # ragged: slots complete
                self._last_served = served      # mid-run, not only at ends
                self._makespan = max(self._makespan, now)
                self.served_timeline.append((now, served))
            if not finished:
                heapq.heappush(self._heap, (run.next_time, seq))
        return steps

    def plan(self, now: float) -> None:
        if self.on_plan is not None:
            self.on_plan(now, self.pool)
        if self.cfg.topup:
            # continuous batching across run boundaries: refill slots that
            # ragged budgets freed early before asking the policy (the run
            # keeps its heap entry; only its contents grow)
            for run in self.pool.running:
                self.pool.topup(run, now, self.cfg.gen_len,
                                self.cfg.drop_expired)
        self._plan(now, self._heap)

    def drained(self) -> bool:
        return (not self.pool.running
                and all(len(q) == 0 for q in self.pool.queues.values()))

    # ------------------------------------------------------------------
    def run(self) -> PoolResult:
        cfg = self.cfg
        self._heap = []
        self._last_served = self._total_served()
        wall0 = time.perf_counter()
        out = run_event_loop(
            LoopConfig(duration=cfg.duration, drain=cfg.drain,
                       max_time=cfg.max_time,
                       arrival_horizon=cfg.arrival_horizon,
                       max_events=cfg.max_steps),
            self.generators, self)
        # a truncated non-drain run is normalized by the virtual time it
        # actually covered, not the full cfg.duration — and flagged, so it
        # can never masquerade as a complete measurement
        if cfg.drain:
            duration = self._makespan
        else:
            duration = (min(out.now, cfg.duration) if out.truncated
                        else cfg.duration)
        wall = time.perf_counter() - wall0
        res = self.pool.snapshot(getattr(self.policy, "name", "?"),
                                 duration or 1e-9, wall, out.events)
        res.truncated = out.truncated
        return res


# --------------------------------------------------------------------------
# convenience entry points (the thin-wrapper API used by launch/serve)
# --------------------------------------------------------------------------
def make_generators(pool: EnginePool, rate: float, *, seed0: int = 0,
                    slo_scale: float = 1.0,
                    gen_tokens=None) -> List[RequestGenerator]:
    """One deterministic arrival stream per hosted model (sorted order so
    seeds are stable across runs and policies). ``gen_tokens``: None keeps
    every request on the controller's uniform ``gen_len``; an int or a
    (lo, hi) range stamps per-request ragged token budgets."""
    return [RequestGenerator(n, rate, pool.profiles[n].slo * slo_scale,
                             seed=seed0 + i, gen_tokens=gen_tokens)
            for i, n in enumerate(sorted(pool.profiles))]


def run_policy(pool: EnginePool, policy_name: str, *, rate: float,
               duration: float, gen_len: int = 4, seed0: int = 0,
               drain: bool = False, drop_expired: bool = True,
               slo_scale: float = 1.0, gen_tokens=None, topup: bool = True,
               policy_kwargs: Optional[Dict] = None) -> PoolResult:
    """Reset the pool, build the named policy over its profiles, and serve
    one deterministic workload through the real engines. ``gen_tokens``
    (int or (lo, hi)) makes the workload ragged: each request carries its
    own decode budget, slots free early, and the controller tops runs up
    mid-flight."""
    from repro_torch.core.scheduler import POLICIES

    pool.reset()
    policy = POLICIES[policy_name](pool.profiles, **(policy_kwargs or {}))
    gens = make_generators(pool, rate, seed0=seed0, slo_scale=slo_scale,
                           gen_tokens=gen_tokens)
    cfg = ControllerConfig(duration=duration, gen_len=gen_len, drain=drain,
                           drop_expired=drop_expired, topup=topup,
                           arrival_horizon=duration if drain else None)
    return Controller(pool, policy, gens, cfg).run()
