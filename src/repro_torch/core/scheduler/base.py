"""Scheduler policy protocol + shared helpers."""
from __future__ import annotations

import math
from typing import Any, Dict, List, Protocol, runtime_checkable

from repro_torch.core.simulator import RunRequest


@runtime_checkable
class SchedView(Protocol):
    """What a ``Policy`` may observe at a planning point — the adapter
    between the control plane's policy objects and whichever data plane is
    underneath. Both the analytic ``repro_torch.core.simulator.Simulator``
    and the real-engine ``repro_torch.serving.pool.EnginePool`` implement
    this, so the same policy instances drive either without modification:

      profiles    name -> ModelProfile (latency fn, knee, SLO, operating pt)
      queues      name -> RequestQueue (len, oldest_deadline)
      running     in-flight runs; each exposes at least ``.model``/``.frac``
      free_frac   1 - aggregate allocated fraction at ``now``
      sim         capacity config: ``.total_chips`` (units) and
                  ``.dispatch_gap``
    """

    profiles: Dict[str, Any]
    queues: Dict[str, Any]
    sim: Any

    @property
    def running(self) -> List[Any]: ...

    def free_frac(self, now: float) -> float: ...


@runtime_checkable
class PageView(Protocol):
    """What the tick-granular ``repro_torch.serving.plan.StepPlanner`` may
    observe of a data plane's KV-memory state when building a
    ``StepPlan`` — the page-pool leg of the scheduler/data-plane
    boundary, as ``SchedView`` is the capacity leg. Implemented by
    ``repro_torch.serving.engine.InferenceEngine``; an unpaged plane (ring
    slots, pure-SSM state) reports ``paged == False`` with zero pages
    and fully-backed slots, so planners never branch on architecture:

      paged                 whether KV memory is the admission gate
      page_size             tokens per page (meaningful when paged)
      free_pages/total_pages   pool headroom (0 when unpaged)
      free_slots/slot_len      batch-lane headroom and per-lane horizon
      slot_pos(slot)           tokens written to a resident lane
      reserved_tokens(slot)    horizon its pages currently cover (grows
                               lazily under PlannerConfig.lazy)
      slot_page_count(slot)    pages the lane owns (0 when unpaged)
      kv_pages_needed(tokens)  page arithmetic for an admission horizon
    """

    paged: bool
    page_size: int
    slot_len: int

    @property
    def free_pages(self) -> int: ...

    @property
    def total_pages(self) -> int: ...

    @property
    def free_slots(self) -> int: ...

    def slot_pos(self, slot: int) -> int: ...

    def reserved_tokens(self, slot: int) -> int: ...

    def slot_page_count(self, slot: int) -> int: ...

    def kv_pages_needed(self, tokens: int) -> int: ...


class Policy(Protocol):
    name: str

    def plan(self, now: float, sim: SchedView) -> List[RunRequest]:
        ...

    def next_wakeup(self, now: float) -> float:
        return math.inf


def chips_for_frac(frac: float, hw) -> int:
    """The largest allocation level of ``hw`` (a ``Hardware``) <=
    frac·units, or 0 when none is (on a pod of power-of-two levels: the
    largest power-of-two sub-mesh; on the H100: a multiple of 10%)."""
    return hw.level_at_most(frac * hw.chips_per_pod)


def running_models(sim) -> set:
    return {r.model for r in sim.running}


def speculation_worthwhile(decode_batch: int,
                           knee_batch: "int | None") -> bool:
    """Acceptance-independent speculation gate: drafting pays only while
    decode is MEMORY-bound — below the roofline knee, a verify dispatch
    over k+1 tokens streams the same weights/KV bytes as the single-token
    step it replaces, so the extra FLOPs are free. At or past the knee
    the accelerator is compute-bound and verification FLOPs displace
    decode FLOPs one-for-one (speculation can only break even, and loses
    whenever a draft is rejected). ``knee_batch`` is the decode batch
    size at the knee — the same knee D-STACK's scheduler derives per
    model from its latency profile (§3.1) — or None to always speculate
    (CPU-scale tests, where the knee is not meaningful)."""
    if knee_batch is None:
        return True
    return int(decode_batch) < int(knee_batch)
