"""Deterministic fault injection for the serving plane.

At millions-of-users scale the dominant serving events are not the happy
path: clients disconnect, deadlines blow, pools overload, and the runtime
throws transient dispatch/allocation errors. The failure half of the
serving plane (``repro_torch.serving.plan``) exists to
absorb those events without leaking KV pages or stalling the tick loop —
and the only way to trust that is to inject the events on a seeded,
reproducible schedule and assert the invariants afterwards (the chaos
suite of the JAX package, ``tests/test_chaos.py``).

``FaultInjector`` is that schedule. It is attached at three sites:

* **dispatch** (``InferenceEngine.execute``): raises ``TransientFault``
  before the plan mutates anything, modeling a transient runtime error a
  retry can absorb. The engine retries up to ``retry_limit`` times with
  exponential backoff (``EngineStats.engine_retries``); exhausted retries
  raise ``EngineFault`` — the control planes' engine-reset signal.
* **alloc** (``PageAllocator.alloc``): raises ``OutOfPages`` spuriously,
  modeling transient allocator failure. Every caller already treats
  ``OutOfPages`` as an all-or-nothing admission/growth signal, so an
  injected one degrades to a deferred admission or a preemption — never
  a partial allocation.
* **stuck** (``TickServer.fire``): the tick's dispatch "hangs" and the
  watchdog kills it — engine slot state must be treated as lost. The
  server runs the engine-reset path: every resident recompute-requeues
  (riding the preemption machinery, so surviving greedy streams are
  unchanged) and the page-pool conservation audit runs before serving
  resumes.

The rng is consumed once per armed site per roll, so a fixed seed plus a
fixed workload reproduces the exact fault schedule; ``max_faults`` bounds
the total so chaos runs provably drain.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.serving.kv_cache import OutOfPages


class TransientFault(RuntimeError):
    """An injected fault the dispatch site is expected to retry."""


class EngineFault(RuntimeError):
    """Retries exhausted (or the dispatch was killed mid-flight): engine
    slot state must be considered lost. Control planes recover by engine
    reset — free every slot, audit page conservation, and recompute-
    requeue the residents."""


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Seeded fault schedule. Rates are per-roll probabilities at each
    site; ``max_faults`` caps the total injected across all sites so a
    chaos run is guaranteed to drain once the schedule is spent."""
    seed: int = 0
    dispatch_rate: float = 0.0     # P(TransientFault) per execute attempt
    alloc_rate: float = 0.0        # P(spurious OutOfPages) per page alloc
    stuck_rate: float = 0.0        # P(watchdog-killed tick) per tick
    max_faults: Optional[int] = None


class FaultInjector:
    """One seeded rng driving every armed site. Sites with a zero rate
    never consume the rng, so enabling one fault class does not perturb
    another's schedule for the same seed."""

    def __init__(self, cfg: Optional[FaultConfig] = None, **kw):
        self.cfg = cfg or FaultConfig(**kw)
        self._rng = np.random.default_rng(self.cfg.seed)
        self.injected: Dict[str, int] = {"dispatch": 0, "alloc": 0,
                                         "stuck": 0}

    @property
    def total(self) -> int:
        return sum(self.injected.values())

    def _roll(self, rate: float, site: str) -> bool:
        if rate <= 0.0:
            return False
        if (self.cfg.max_faults is not None
                and self.total >= self.cfg.max_faults):
            return False
        if float(self._rng.random()) >= rate:
            return False
        self.injected[site] += 1
        return True

    def maybe_fault(self, site: str) -> None:
        """Raise the site's fault type if the schedule says so.
        ``dispatch`` raises ``TransientFault`` (retryable); ``alloc``
        raises ``OutOfPages`` (the signal every allocation path already
        handles all-or-nothing)."""
        if site == "dispatch" and self._roll(self.cfg.dispatch_rate,
                                             "dispatch"):
            raise TransientFault(
                f"injected dispatch fault #{self.injected['dispatch']}")
        if site == "alloc" and self._roll(self.cfg.alloc_rate, "alloc"):
            raise OutOfPages(
                f"injected allocator fault #{self.injected['alloc']}")

    def stuck(self) -> bool:
        """True when this tick's dispatch should be treated as hung
        (killed by the watchdog — the caller runs the reset path)."""
        return self._roll(self.cfg.stuck_rate, "stuck")
