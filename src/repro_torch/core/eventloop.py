"""Shared discrete-event loop skeleton for every serving control plane.

The analytic simulator (``repro_torch.core.simulator``: atomic
completions), the real-engine controller (``repro_torch.serving.
controller``: per-token dispatch events) and
``repro_torch.serving.plan.TickServer`` (step-plan ticks: one
StepPlan built and executed per due tick) used to each own — or would
each have grown — a ~30-line event loop with identical arrival-pop /
epsilon / cutoff / drain semantics and different machinery inside the
events. Duplicated semantics meant they could drift — a horizon or drain
fix applied to one loop and not the others silently changes what the
planes measure. This module owns the semantics once; the planes plug in
their machinery through ``EventLoopHooks``.

Loop contract (identical for both planes):

* arrivals are materialized up front over ``arrival_horizon`` (default:
  ``duration``) via ``request.materialize_arrivals`` — drain runs with
  rate-based generators must set a horizon, enforced there;
* time jumps to the earliest of (next completion, next arrival, next
  policy wakeup); accumulators advance BEFORE events at the new time fire;
* arrivals within ``epsilon`` of ``now`` are delivered before completions
  fire, and ``plan`` runs after every event batch (including once at t=0);
* a non-drain run cut at ``duration`` advances accumulators exactly to the
  cutoff; a drain run exits when arrivals are exhausted and the plane
  reports itself drained;
* backstops: ``max_time`` (virtual) and ``max_events`` (real dispatches)
  stop the loop BEFORE the offending event and flag the outcome
  ``truncated`` so a partial run can never masquerade as a complete one.
  The ``max_time`` boundary is INCLUSIVE — an event exactly AT max_time
  fires; only events strictly past it truncate — and truncation advances
  accumulators to the backstop (like the duration cutoff), so
  ``out.now`` always equals the window the integrals cover.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Protocol, Sequence

from repro_torch.serving.request import materialize_arrivals


@dataclasses.dataclass
class LoopConfig:
    duration: float
    drain: bool = False
    max_time: float = 600.0
    arrival_horizon: Optional[float] = None
    epsilon: float = 1e-12
    max_events: Optional[int] = None     # cap on Σ fire() costs (None = ∞)


@dataclasses.dataclass
class LoopOutcome:
    now: float = 0.0          # virtual time the loop actually covered
    events: int = 0           # Σ fire() return values (real dispatches)
    truncated: bool = False   # a backstop fired — partial measurement


class EventLoopHooks(Protocol):
    """What a control plane plugs into the shared loop."""

    def deliver(self, req) -> None:
        """An arrival reached its queue."""

    def next_completion(self) -> float:
        """Virtual time of the earliest pending completion (inf if none)."""

    def next_wakeup(self, now: float) -> float:
        """Earliest policy wakeup (inf if the policy has none)."""

    def advance(self, t: float) -> None:
        """Accumulate integrals (utilization/occupancy) up to ``t``."""

    def fire(self, now: float, epsilon: float) -> int:
        """Process every completion due at <= now + epsilon (the loop's
        one epsilon — the same tolerance arrivals are delivered with);
        return how many capped events (real dispatches) that cost — 0 for
        analytic planes."""

    def plan(self, now: float) -> None:
        """Let the policy start new work against the current state."""

    def drained(self) -> bool:
        """Nothing running and every queue empty (drain-mode exit)."""


def run_event_loop(cfg: LoopConfig, generators: Sequence,
                   hooks: EventLoopHooks) -> LoopOutcome:
    horizon = (cfg.arrival_horizon if cfg.arrival_horizon is not None
               else cfg.duration)
    arrivals = materialize_arrivals(generators, horizon, drain=cfg.drain)
    out = LoopOutcome()
    ai = 0
    now = 0.0
    # optional telemetry plane on the hooks object (Controller/TickServer
    # expose the one attached to their pool/planner): arrival instants on
    # the per-model queue tracks. None = zero-cost.
    tel = getattr(hooks, "telemetry", None)
    while ai < len(arrivals) and arrivals[ai].arrival <= now:
        if tel is not None:
            tel.request_event(arrivals[ai].model, "arrival",
                              rid=arrivals[ai].rid)
        hooks.deliver(arrivals[ai])
        ai += 1
    hooks.plan(now)

    while True:
        if cfg.max_events is not None and out.events >= cfg.max_events:
            out.truncated = True
            break
        if cfg.drain and ai >= len(arrivals) and hooks.drained():
            break
        t = min(hooks.next_completion(),
                arrivals[ai].arrival if ai < len(arrivals) else math.inf,
                hooks.next_wakeup(now))
        if math.isinf(t):
            break
        if t > cfg.max_time:
            # backstop boundary is INCLUSIVE: an event exactly AT max_time
            # fires (this branch only trips for t strictly past it), and
            # truncation advances accumulators to the backstop — like the
            # duration cutoff below — so partial integrals cover exactly
            # the window reported in out.now (regression-tested in
            # tests/test_paged_kv.py::test_event_loop_max_time_boundary)
            if cfg.max_time > now:
                hooks.advance(cfg.max_time)
                now = cfg.max_time
            out.truncated = True
            break
        if not cfg.drain and t > cfg.duration:
            hooks.advance(cfg.duration)
            now = cfg.duration
            break
        hooks.advance(t)
        now = t
        while ai < len(arrivals) and arrivals[ai].arrival <= now + cfg.epsilon:
            if tel is not None:
                tel.request_event(arrivals[ai].model, "arrival",
                                  rid=arrivals[ai].rid)
            hooks.deliver(arrivals[ai])
            ai += 1
        out.events += hooks.fire(now, cfg.epsilon)
        hooks.plan(now)

    out.now = now
    return out
