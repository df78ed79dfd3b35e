"""Policy-driven engine pool: D-STACK's control plane over real engines.

This module is the serving control plane the paper builds in §6 — a copy
of the JAX package's ``repro.serving.pool`` — realized over the port's
graphed data plane (``repro_torch.serving.engine``) instead of the
analytic simulator. Component → paper map:

* **StandbyAllocation / ModelHost** — §3.2 + §6.1.2. On GPUs, one model at
  one GPU% is a CUDA-MPS process with a fixed thread percentage; here it is
  one ``InferenceEngine`` labelled with one allocation (``alloc_chips``:
  GPU percent on the H100). A host keeps one *standby* engine per
  candidate allocation (all sharing one set of weights), each with its own
  slots and CUDA graphs, captured once up front by ``warmup`` — so a
  policy's allocation decision *selects a pre-built engine*; re-allocation
  is an engine switch, never a capture (the paper's fast re-allocation
  story, and the port's acceptance bar of zero captures while serving).
  The granted allocation sets the run's modelled latency; it does not
  restrict which SMs run the work (no MPS partition yet).

* **EnginePool (a SchedView)** — the policy↔data-plane adapter. The same
  ``plan(now, view)`` that drives ``repro_torch.core.simulator.Simulator``
  drives this pool: it exposes ``profiles`` / ``queues`` / ``running`` /
  ``free_frac`` / ``sim.total_chips``, and enforces the §6 invariant that
  aggregate allocated fraction never exceeds 1.0 (except for policies
  that explicitly model uncontrolled sharing, e.g. Fixed-Batch MPS).

* **Admission (``admit``)** — §6.1 + Eq. 11/12. The policy sizes each run's
  batch with ``ModelProfile.feasible_batch_for`` (largest batch whose
  assembly + inference fits the SLO budget); admission additionally caps it
  to the chosen engine's free KV-cache slots, prefills each request into a
  slot mid-stream (continuous batching), and charges the model's runtime
  scoreboard — the quantity D-STACK's fair opportunistic pass (§6.1.1)
  equalizes.

* **PoolMetrics** (``repro_torch.serving.metrics``) — §7/Fig. 10 reporting:
  per-model throughput, completion-latency p50/p99, SLO violations
  (dropped *and* late-but-served), runtime shares and their Jain fairness
  index, and allocation occupancy.

Time is virtual (discrete-event, from the profile's roofline latency at
the *granted* allocation) while every admission and decode step is a real
dispatch (a CUDA graph replay on the card) — so policy comparisons are
deterministic and SLO-meaningful on any host, yet exercise the true
engine hot path end to end. The serving loop lives in
``repro_torch.serving.controller``.

The radix prompt cache (``prefix_cache=True``), cross-model speculative
decoding (``enable_speculation``) and the telemetry plane
(``attach_telemetry``) run as in the JAX pool.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.hardware import H100, local_gpu
from repro_torch.core.profiles import ModelProfile, build_profile
from repro_torch.core.simulator import RunRequest
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.faults import EngineFault
from repro_torch.serving.kv_cache import OutOfPages
from repro_torch.serving.metrics import ModelPoolMetrics, PoolResult
from repro_torch.serving.plan import (PlannerConfig, StepPlan, StepPlanner,
                                      preemption_key)
from repro_torch.serving.request import Request, RequestQueue


@dataclasses.dataclass(frozen=True)
class PoolCaps:
    """Capacity config — the ``view.sim`` leg of the SchedView protocol."""
    total_chips: int
    dispatch_gap: float = 100e-6


@dataclasses.dataclass
class StandbyAllocation:
    """One pre-built (allocation, engine) pair for a hosted model."""
    chips: int
    n_slots: int
    engine: InferenceEngine


class ModelHost:
    """One hosted model: shared weights + standby engines keyed by
    allocation."""

    def __init__(self, cfg, api, params, profile: ModelProfile,
                 allocations: Dict[int, StandbyAllocation],
                 prompt_len: int = 8):
        self.cfg = cfg
        self.api = api
        self.params = params
        self.profile = profile
        self.allocations = allocations
        self.prompt_len = prompt_len
        self._prompt = None

    def prompt_batch(self) -> Dict[str, torch.Tensor]:
        """Deterministic single-request prompt (fixed shape: one
        packed-prefill bucket per admission size for the whole workload),
        with an encoder model's stub frames (seed 0). It stays in host
        memory: the engine packs each admission on the host and copies it
        to the device once."""
        if self._prompt is None:
            b = {"tokens": torch.ones((1, self.prompt_len),
                                      dtype=torch.int32)}
            if self.cfg.has_encoder:
                from repro_torch.serving import modality
                b["enc_embeds"] = modality.audio_frames(self.cfg, 1)
            self._prompt = b
        return self._prompt

    def engines(self) -> List[InferenceEngine]:
        return [a.engine for a in self.allocations.values()]


@dataclasses.dataclass
class PoolRun:
    """One in-flight (model, allocation, batch) run — the pool analogue of
    ``simulator.Run``; policies see ``.model`` and ``.frac``."""
    seq: int
    model: str
    req_chips: int             # what the policy asked for (units)
    chips: int                 # granted (largest standby allocation <= ask)
    frac: float
    batch: int
    engine: InferenceEngine
    slots: Dict[int, Request]
    remaining: Dict[int, int]  # decode tokens left per slot (ragged budgets)
    latency: float             # modeled total run latency at the grant
    step_cost: float           # latency / max budget — virtual cost per step
    start: float
    next_time: float
    # a slot finished before the run did (ragged per-request n_tokens) —
    # the gate for mid-run re-admission (``topup``): uniform-budget runs
    # never trip it, so they behave exactly as before paging
    freed_early: bool = False


class EnginePool:
    """A pool of slot engines that any ``Policy`` can drive (SchedView)."""

    def __init__(self, hosts: Dict[str, ModelHost],
                 caps: Optional[PoolCaps] = None, lazy_kv: bool = False,
                 planner_config: Optional[PlannerConfig] = None,
                 prefix_cache: bool = False):
        self.hosts = hosts
        self.profiles: Dict[str, ModelProfile] = {
            n: h.profile for n, h in hosts.items()}
        total = max(p.hw.chips_per_pod for p in self.profiles.values())
        self.sim = caps or PoolCaps(total_chips=total)
        # lazy KV reservation: admission claims pages for the prompt only
        # (not the whole prompt+budget horizon) and decode grows
        # page-by-page; when the pool runs dry mid-run a resident chosen
        # by the slack-aware victim rule is preempted and requeued
        # (counters in ModelPoolMetrics). The default keeps the
        # deadlock-free up-front reservation.
        self.lazy_kv = lazy_kv
        # base PlannerConfig for every per-model planner (load-shed
        # watermarks, victim rule, ...); `lazy` is overridden by lazy_kv
        # and `prefix_cache` by the pool-level knob below
        self._planner_config = planner_config or PlannerConfig()
        # radix prompt cache: attach one PrefixCache per CAPABLE standby
        # engine (dense transformers; families whose per-row state
        # exceeds pages + pos — SSM — skip and serve exactly as before).
        # Admissions then alias cached prefixes and complete their tails
        # by eager teacher-forced catch-up (``admission_plan``/
        # ``catchup_prefill``).
        self.prefix_cache = prefix_cache
        if prefix_cache:
            for host in hosts.values():
                for eng in host.engines():
                    if eng.prefix_cache_capable():
                        eng.enable_prefix_cache()
        self.queues: Dict[str, RequestQueue] = {}
        self._runs: Dict[int, PoolRun] = {}
        self._metrics: Dict[str, ModelPoolMetrics] = {}
        self._planners: Dict[str, StepPlanner] = {}
        self._seq = 0
        self._alloc_frac = 0.0
        self._occ_area = 0.0
        self._page_area = 0.0
        self._last_t = 0.0
        # telemetry plane (attach_telemetry): shared across every engine
        # and per-model planner; reset() re-propagates it to the fresh
        # planners. None = disabled (zero-cost attribute checks).
        self.telemetry = None
        self.reset()

    # ------------------------------------------------- SchedView protocol
    @property
    def running(self) -> List[PoolRun]:
        return list(self._runs.values())

    def free_frac(self, now: float) -> float:
        return 1.0 - self._alloc_frac

    # --------------------------------------------------------- lifecycle
    def reset(self) -> None:
        """Fresh queues/metrics/clock; engines keep their captured
        graphs (reuse the pool across policies without re-warming)."""
        self.queues = {n: RequestQueue(n, p.slo)
                       for n, p in self.profiles.items()}
        self._metrics = {n: ModelPoolMetrics() for n in self.profiles}
        # one StepPlanner per hosted model: the single admission gate
        # (page horizon, SLO expiry, blocked-on-memory accounting, head
        # reservation/aging) admit AND topup route through
        self._planners = {
            n: StepPlanner(config=dataclasses.replace(
                self._planner_config, lazy=self.lazy_kv,
                prefix_cache=self.prefix_cache),
                metrics=self._metrics[n])
            for n in self.profiles}
        for p in self._planners.values():
            p.telemetry = self.telemetry
        self._runs.clear()
        self._seq = 0
        self._alloc_frac = 0.0
        self._occ_area = 0.0
        self._page_area = 0.0
        self._last_t = 0.0
        for host in self.hosts.values():
            for eng in host.engines():
                eng.release_all_slots()     # frees draft twins too
                eng.reset_stats()
                if eng._draft is not None:
                    eng._draft.reset_stats()

    def attach_telemetry(self, tel) -> None:
        """Arm (or with None, disarm) one shared ``Telemetry`` plane
        across the pool: every standby engine (timed, traced dispatches)
        and every per-model planner (lifecycle instants). Survives
        ``reset()`` — run_policy's reset re-propagates it — so attach
        once, serve many policies. Attach after warmup, like
        ``attach_faults``."""
        self.telemetry = tel
        for p in self._planners.values():
            p.telemetry = tel
        for host in self.hosts.values():
            for eng in host.engines():
                eng.attach_telemetry(tel)
                if eng._draft is not None:
                    eng._draft.attach_telemetry(tel)

    def warmup(self) -> None:
        """Capture every standby engine's admission-prefill + slot-step
        graphs once, up front — after this, serving captures nothing.
        Admission goes through ``insert_many`` (one packed prefill per
        admission batch), whose graphs key on the packed-token bucket:
        every batch size the engine can page is warmed, covering each
        bucket a serve-time admission can produce. The warm inserts use a
        1-token budget: the graphs are identical for every budget, and 1
        is the smallest page footprint — a pool deliberately built with
        fewer pages than one slot maximum (the oversubscription knob)
        warms exactly the batch sizes it can ever admit."""
        from repro_torch.serving.engine import _packed_bucket, _pow2_at_least
        for host in self.hosts.values():
            for eng in host.engines():
                min_pages = eng.pages_needed(host.prompt_len, 1)
                warmed = set()
                for k in range(1, eng.n_slots + 1):
                    if eng.paged and k * min_pages > eng.total_pages:
                        break
                    # graphs key on the (packed-token bucket, segment
                    # bucket) pair, not the batch size: k values sharing
                    # both capture nothing new, so only O(log) of them run
                    bucket = (_packed_bucket(k * host.prompt_len),
                              _pow2_at_least(k))
                    if bucket in warmed:
                        continue
                    warmed.add(bucket)
                    slots = eng.insert_many(
                        [host.prompt_batch()] * k, n_tokens=[1] * k)
                    eng.step()
                    for slot in slots:
                        eng.free(slot)
                if eng.paged and self.lazy_kv:
                    # lazy pools also grow pages (block-table row
                    # updates) while serving — cross a page boundary once
                    # here, as the JAX pool warms that executable
                    need = eng.pages_needed(host.prompt_len,
                                            eng.page_size + 1)
                    if need <= eng.total_pages:
                        slot = eng.insert(host.prompt_batch(), n_tokens=1,
                                          reserve_tokens=host.prompt_len + 1)
                        eng.grow_slot(
                            slot, host.prompt_len + eng.page_size + 1)
                        eng.free(slot)
                # prefix-cache hit admissions dispatch two more
                # executables (COW page copy, table-row alias write) —
                # build them on dead state up front
                eng.warm_prefix_ops()
        self.reset()

    def enable_speculation(self, target: str, draft: str,
                           spec_k: int = 4) -> int:
        """Cross-model speculative decoding over the pool: pair every
        spec-capable standby engine of ``target`` with a fresh ring-slot
        draft engine built from ``draft``'s weights (one per standby —
        identity slot pairing needs a twin per engine). Raises if the
        vocabularies differ (token ids must mean the same thing to
        drafter and verifier); incapable standbys are skipped.
        ``step_run`` then speculates on eligible slots. Returns how many
        standby engines were paired."""
        t_host, d_host = self.hosts[target], self.hosts[draft]
        paired = 0
        for alloc in t_host.allocations.values():
            eng = alloc.engine
            if not eng.spec_capable():
                continue
            d_eng = InferenceEngine(
                d_host.api, d_host.params, cache_len=eng.slot_len,
                alloc_chips=alloc.chips).init_slots(
                    eng.n_slots, paged=False)
            eng.attach_draft(d_eng, spec_k)
            if self.telemetry is not None:
                d_eng.attach_telemetry(self.telemetry)
            paired += 1
        return paired

    def jit_cache_sizes(self) -> Dict[str, int]:
        """Every standby engine's executables (captured graphs on the
        card), keyed ``model/<units>ch/<kind>`` as in the JAX pool."""
        out: Dict[str, int] = {}
        for n, host in self.hosts.items():
            for alloc in host.allocations.values():
                for k, v in alloc.engine.jit_cache_sizes().items():
                    out[f"{n}/{alloc.chips}ch/{k}"] = v
        return out

    # ----------------------------------------------------------- serving
    def push(self, req: Request) -> None:
        """Accept one arrival — or shed it (terminal, fail fast) when the
        model's load-shed watermarks are crossed: queue depth against
        ``shed_queue_depth``, pool-wide page occupancy against
        ``shed_page_frac`` (both None by default — no shedding)."""
        q = self.queues[req.model]
        planner = self._planners[req.model]
        used, total = self.page_usage()
        frac = used / total if total else 0.0
        if planner.should_shed(queue_len=len(q), page_frac=frac):
            q.shed_request(req)
            if self.telemetry is not None:
                self.telemetry.request_event(req.model, "shed", rid=req.rid)
            return
        q.push(req)
        if self.telemetry is not None:
            self.telemetry.request_event(req.model, "queued", rid=req.rid)

    def cancel(self, model: str, rid: int, now: float = 0.0) -> bool:
        """Client cancellation at the pool plane: a queued request is
        removed immediately; a resident one frees its slot and pages NOW
        (the Cancel event) and its run continues with the remaining
        slots. Returns False for unknown/terminal rids."""
        del now
        q = self.queues.get(model)
        if q is None:
            return False
        if q.cancel(rid) is not None:
            if self.telemetry is not None:
                self.telemetry.request_event(model, "cancel", rid=rid)
            return True
        for run in self._runs.values():
            if run.model != model:
                continue
            for slot, req in list(run.slots.items()):
                if req.rid == rid:
                    run.slots.pop(slot)
                    run.remaining.pop(slot, None)
                    run.engine.free(slot)
                    run.freed_early = True    # topup may refill the slot
                    q.mark_cancelled(req)
                    if self.telemetry is not None:
                        self.telemetry.request_event(model, "cancel",
                                                     rid=rid, slot=slot)
                    return True
        return False

    def page_usage(self) -> tuple:
        """(pages in use, servable pages) — the KV-memory analogue of
        allocation occupancy. Pages in use sum over every standby engine,
        but the denominator counts each model's LARGEST standby pool only:
        at most one standby per model serves at a time, so summing all of
        them would cap the reported occupancy at 1/n_standbys even with
        the active pool fully allocated."""
        used = total = 0
        for host in self.hosts.values():
            total += max((e.total_pages for e in host.engines()), default=0)
            used += sum(e.total_pages - e.free_pages for e in host.engines())
        return used, total

    def advance_time(self, t: float) -> None:
        """Accumulate allocation + page occupancy up to ``t`` (controller
        owns the clock and calls this before moving ``now`` forward)."""
        dt = t - self._last_t
        self._occ_area += min(self._alloc_frac, 1.0) * dt
        used, total = self.page_usage()
        if total:
            self._page_area += (used / total) * dt
        self._last_t = t

    def _pop_admissible(self, model: str, eng: InferenceEngine,
                        max_batch: int, now: float, gen_len: int,
                        drop_expired: bool) -> List:
        """Pop up to ``max_batch`` requests the engine can actually back —
        a thin shim over the model's ``StepPlanner.select_admissible``,
        the single admission gate ``admit`` AND ``topup`` share: a free
        slot plus pages for each request's reserved horizon (whole prompt
        + n_tokens budget, or prompt-only under ``lazy_kv``), requests
        the pool cannot back re-queued and counted in
        ``blocked_on_memory`` once over their lifetime, and a
        page-blocked FIFO head accruing an aging page reservation that
        bypassing smaller requests cannot spend (the ROADMAP
        anti-starvation follow-on; the SLO-expiry bound on a bypassed
        request is unchanged and still regression-tested). Returns
        [(request, token budget)], in queue order."""
        return self._planners[model].select_admissible(
            eng, self.queues[model], self.hosts[model].prompt_len,
            max_batch, now, gen_len, drop_expired)

    def admit(self, rr: RunRequest, now: float, gen_len: int,
              drop_expired: bool = True) -> Optional[PoolRun]:
        """Translate one policy ``RunRequest`` into an engine run.

        Grants the largest standby allocation <= the requested units (the
        hardware's level quantization; the latency cost of the rounding is
        charged to the run), caps the batch to the engine's
        free slots, prefills each admitted request into a slot, and books
        the allocation. When the ask is below every standby engine, the
        smallest pre-built one runs instead IF it fits free capacity — a
        real system can only run allocations it has engines for
        (GSLICE's over-committed partitions depend on this). The granted
        units are what is booked, and every divergence from the policy's
        own ledger stays visible: ``alloc_upgrades`` counts fallbacks to a
        bigger-than-asked engine, ``alloc_downgrades`` counts runs granted
        fewer units than asked (quantization between standby points, or
        capacity pressure) whose latency exceeds what the policy budgeted.
        Returns None when nothing could start (model already running, no
        queue, no slots, or no capacity)."""
        host = self.hosts.get(rr.model)
        if host is None:
            return None
        if any(r.model == rr.model for r in self._runs.values()):
            # one run per model at a time. Also load-bearing for budget
            # accounting: engines belong to one model, so this guarantees
            # at most one run per ENGINE — engine.step() advances every
            # active slot's generated counter, which is only correct while
            # all of an engine's slots belong to the same run (+ topups).
            return None
        q = self.queues[rr.model]
        if len(q) == 0:
            return None
        total = self.sim.total_chips
        free = self.free_frac(now)
        fitting = sorted((c for c in host.allocations if c <= rr.chips),
                         reverse=True)
        upgraded = not fitting
        cands = fitting or [min(host.allocations)]
        alloc = None
        for c in cands:
            if rr.oversubscribe or c / total <= free + 1e-9:
                alloc = host.allocations[c]
                break
        downgraded = (alloc is not None and not upgraded
                      and alloc.chips < min(rr.chips, total))
        if alloc is None or alloc.engine.free_slots == 0:
            return None
        eng = alloc.engine
        kept = self._pop_admissible(rr.model, eng, rr.batch, now, gen_len,
                                    drop_expired)
        if not kept:
            return None
        prof = self.profiles[rr.model]
        lat = prof.latency(alloc.chips, len(kept)) * rr.dilation
        gen_max = max(b for _, b in kept)
        run = PoolRun(
            seq=self._seq, model=rr.model, req_chips=rr.chips,
            chips=alloc.chips, frac=alloc.chips / total,
            batch=len(kept), engine=eng, slots={}, remaining={},
            latency=lat, step_cost=lat / gen_max, start=now,
            next_time=now + self.sim.dispatch_gap + lat / gen_max)
        # the admission is a StepPlan of whole-prompt first chunks: the
        # engine executes it as ONE packed prefill dispatch with each
        # segment's K/V scattered straight into its slot's pages
        plan = self._planners[rr.model].admission_plan(
            [host.prompt_batch()] * len(kept), kept, eng=eng)
        try:
            sres = eng.execute(plan)
        except EngineFault:
            # the fault fired BEFORE the plan mutated anything, so any
            # alias chunks still hold their match-time pins — return
            # them or recover()'s page-conservation audit trips
            self._release_plan_pins(eng, plan)
            self._engine_reset(rr.model, eng, kept)
            return None
        if sres.admission_failed:
            # transient/injected allocator failure: insert_many rolled
            # back all-or-nothing — alias admissions that DID land roll
            # back here too (all-or-nothing at the pool grain), then
            # requeue and let a later plan retry
            for slot in sres.admitted.values():
                eng.free(slot)
            for req, _ in kept:
                q.push(req)
            return None
        self._finish_aliases(host, eng, plan, sres)
        for req, budget in kept:
            slot = sres.admitted.get(req.rid)
            if slot is None:
                # an individual alias admission ran out of fresh tail
                # pages (its pins already went back to the cache):
                # requeue just that request
                q.push(req)
                continue
            run.slots[slot] = req
            run.remaining[slot] = budget
            if self.telemetry is not None:
                self.telemetry.request_event(rr.model, "admitted",
                                             rid=req.rid, slot=slot,
                                             chips=alloc.chips)
        if not run.slots:
            return None
        run.batch = len(run.slots)
        m = self._metrics[rr.model]
        self._seq += 1
        self._runs[run.seq] = run
        self._alloc_frac += run.frac
        m.runs += 1
        m.alloc_upgrades += int(upgraded)
        m.alloc_downgrades += int(downgraded)
        m.runtime += lat
        m.chip_seconds += alloc.chips * lat
        return run

    def topup(self, run: PoolRun, now: float, gen_len: int,
              drop_expired: bool = True) -> int:
        """Mid-run re-admission: refill slots that ragged budgets freed
        early, without waiting for the run (or the policy) — continuous
        batching at the pool level. Refills never grow the run past its
        admit-time batch: that batch is what the policy sized against the
        SLO (Eq. 11/12) and what ``step_cost`` was derived from, so the
        run's concurrency — and its modeled per-step latency — stay
        honest. The span the new requests add is what is charged to the
        model's runtime/chip-seconds ledger (the paper's fairness
        currency) — concurrent tokens are not double-billed."""
        if not run.freed_early or run.model not in self.queues:
            return 0
        host = self.hosts[run.model]
        eng = run.engine
        refill = min(eng.free_slots, run.batch - len(run.remaining))
        if len(self.queues[run.model]) == 0 or refill <= 0:
            return 0
        before = max(run.remaining.values(), default=0)
        kept = self._pop_admissible(run.model, eng, refill, now,
                                    gen_len, drop_expired)
        if kept:
            plan = self._planners[run.model].admission_plan(
                [host.prompt_batch()] * len(kept), kept, eng=eng)
            try:
                sres = eng.execute(plan)
            except EngineFault:
                self._release_plan_pins(eng, plan)
                self._engine_reset(run.model, eng, kept)
                return 0
            if sres.admission_failed:
                for slot in sres.admitted.values():
                    eng.free(slot)
                for req, _ in kept:
                    self.queues[run.model].push(req)
                return 0
            self._finish_aliases(host, eng, plan, sres)
            admitted = 0
            for req, budget in kept:
                slot = sres.admitted.get(req.rid)
                if slot is None:
                    self.queues[run.model].push(req)
                    continue
                admitted += 1
                run.slots[slot] = req
                run.remaining[slot] = budget
                if self.telemetry is not None:
                    self.telemetry.request_event(run.model, "admitted",
                                                 rid=req.rid, slot=slot,
                                                 chips=run.chips)
            if not admitted:
                return 0
            m = self._metrics[run.model]
            extension = max(0, max(run.remaining.values()) - before)
            m.topups += admitted
            m.runtime += extension * run.step_cost
            m.chip_seconds += run.chips * extension * run.step_cost
            run.latency += extension * run.step_cost
        return len(kept)

    def _preempt_victim(self, run: PoolRun, now: float) -> None:
        """Evict one of this run's residents: its pages free, its request
        requeues (prompt re-prefills from scratch on re-admission — the
        vLLM recompute-preemption discipline; greedy decode keeps the
        restarted stream identical). The victim is chosen by the shared
        ``preemption_key`` — most SLO slack per unit of sunk recompute
        work (``PlannerConfig.victim="newest"`` restores the legacy
        latest-arrival rule), the same rule the tick plane's
        ``StepPlanner._pick_victim`` applies."""
        eng = run.engine
        mode = self._planner_config.victim
        victim = max(
            run.slots.items(),
            key=lambda kv: preemption_key(kv[1], eng.slot_pos(kv[0]), now,
                                          mode) + (kv[0],))[0]
        req = run.slots.pop(victim)
        run.remaining.pop(victim, None)
        run.engine.free(victim)
        run.freed_early = True           # topup may refill the freed slot
        req.reset_stream()               # recompute restarts the stream
        self.queues[run.model].push(req)
        m = self._metrics[run.model]
        m.preemptions += 1
        m.requeues += 1
        if self.telemetry is not None:
            self.telemetry.request_event(run.model, "preempt",
                                         rid=req.rid, slot=victim)

    @staticmethod
    def _release_plan_pins(eng: InferenceEngine, plan) -> None:
        """Return every alias chunk's match-time pins after an execute
        that never ran (``EngineFault`` fires before the plan mutates
        anything) — without this the reset's page-conservation audit
        (free == total after the cache flush) trips."""
        if eng.prefix_cache is None:
            return
        for c in plan.admissions:
            if c.alias is not None:
                eng.prefix_cache.release_hit(c.alias)

    def _finish_aliases(self, host: ModelHost, eng: InferenceEngine,
                        plan, sres) -> None:
        """Pool-plane completion of prefix-cache admissions: aliased
        slots catch up their uncovered prompt tail eagerly (teacher-
        forced through the warm slot step — the pool has no per-tick
        forced phase to spread them over), then every admitted slot
        registers its full prompt pages in the cache (``insert``
        dedupes shared prefixes, so repeats retain nothing new)."""
        cache = eng.prefix_cache
        if cache is None:
            return
        toks = [int(t) for t in
                np.asarray(host.prompt_batch()["tokens"])[0]]
        hits = {c.rid: c.alias for c in plan.admissions
                if c.alias is not None}
        n_full = host.prompt_len // eng.page_size
        for rid, slot in sres.admitted.items():
            hit = hits.get(rid)
            if hit is not None:
                eng.catchup_prefill(slot, toks, hit.covered)
            if n_full >= 1:
                cache.insert(toks[:n_full * eng.page_size],
                             eng.slot_pages(slot)[:n_full])

    def _engine_reset(self, model: str, eng: InferenceEngine,
                      kept=None) -> None:
        """Pool half of the engine-reset path (``EngineFault``: retries
        exhausted). Device slot state is unknown, so every request that
        was in flight on the engine — the batch being admitted (``kept``)
        and any resident run — recompute-requeues, the run's allocation
        releases, and the engine resets (all slots freed, page-
        conservation audit). Stale controller heap entries for dropped
        runs are ignored by ``Controller.fire`` (missing seq)."""
        q = self.queues[model]
        m = self._metrics[model]
        for req, _ in kept or []:
            req.reset_stream()
            q.push(req)
            m.requeues += 1
        for seq, run in list(self._runs.items()):
            if run.engine is eng:
                for req in run.slots.values():
                    req.reset_stream()
                    q.push(req)
                    m.requeues += 1
                del self._runs[seq]
                self._alloc_frac -= run.frac
        if not self._runs:
            self._alloc_frac = 0.0
        eng.recover()

    def step_run(self, run: PoolRun, now: float) -> bool:
        """One REAL decode dispatch for all of this run's slots (executed
        as a StepPlan, like every other data-plane entry). The engine's
        done flags (per-request token budgets) say which slots finished:
        their requests complete NOW — mid-run, at ragged times — and
        their pages return to the pool immediately. Under ``lazy_kv``
        the decode first grows each slot's page horizon to cover its
        next write; an ``OutOfPages`` there preempts the slack-aware
        victim (pages freed, request requeued) and retries. An
        ``EngineFault`` from the dispatch (transient-fault retries
        exhausted) resets the engine: the whole run recompute-requeues
        and the allocation releases. True when the run finished and its
        allocation was released."""
        eng = run.engine
        if self.lazy_kv and eng.paged:
            while run.remaining:
                try:
                    eng.ensure_decode_room(sorted(run.remaining))
                    break
                except OutOfPages:
                    self._preempt_victim(run, now)
            if not run.remaining:
                del self._runs[run.seq]
                self._alloc_frac -= run.frac
                if not self._runs:
                    self._alloc_frac = 0.0
                return True
        decode_slots = sorted(run.remaining)
        spec_entries: List = []
        if eng._draft is not None and eng.spec_k > 0:
            # pool-plane speculation: a slot speculates while its draft
            # twin is in lockstep, or — right after admission, before any
            # decode — by initializing the twin from the model's (shared)
            # prompt. Mid-stream desync cannot re-init here (the pool does
            # not record per-slot token streams), so such slots just
            # decode plainly.
            host = self.hosts[run.model]
            prompt = None
            for slot in list(decode_slots):
                rem = run.remaining[slot]
                pos = eng.slot_pos(slot)
                k = min(eng.spec_k, rem - 1, eng.slot_len - 1 - pos)
                if k < 1:
                    continue
                init = None
                if not eng.draft_synced(slot):
                    if pos != host.prompt_len:
                        continue
                    if prompt is None:
                        prompt = [int(t) for t in np.asarray(
                            host.prompt_batch()["tokens"])[0]]
                    init = prompt
                if self.lazy_kv and eng.paged:
                    while k >= 1:       # degrade k on page pressure,
                        try:            # never preempt for speculation
                            eng.grow_slot(slot, pos + k + 1)
                            break
                        except OutOfPages:
                            k -= 1
                    if k < 1:
                        continue
                spec_entries.append((slot, k, init))
                decode_slots.remove(slot)
        try:
            res = eng.execute(StepPlan(decodes=decode_slots,
                                       spec=spec_entries))
        except EngineFault:
            self._engine_reset(run.model, eng)
            return True
        emitted = dict(res.spec_tokens)
        for slot in res.tokens:
            emitted.setdefault(slot, []).append(res.tokens[slot])
        for slot, toks in emitted.items():
            req = run.slots.get(slot)
            if req is not None:
                if req.first_token < 0:
                    req.first_token = now
                    if self.telemetry is not None:
                        self.telemetry.request_event(
                            run.model, "first_token", rid=req.rid)
                req.tokens_out += len(toks)
        owned_emit = sum(len(t) for s, t in emitted.items()
                         if s in run.slots)
        done = res.done
        completed: List[Request] = []
        for slot in done:
            req = run.slots.pop(slot, None)
            if req is None:
                continue                  # not this run's slot (warm state)
            run.engine.free(slot)
            run.remaining.pop(slot, None)
            completed.append(req)
        for slot in run.remaining:
            run.remaining[slot] -= len(emitted.get(slot, (None,)))
        self._metrics[run.model].tokens += owned_emit
        if completed:
            self.queues[run.model].complete(completed, now)
            if self.telemetry is not None:
                for req in completed:
                    self.telemetry.request_event(run.model, "complete",
                                                 rid=req.rid)
            if run.remaining:
                run.freed_early = True
        if not run.remaining:
            del self._runs[run.seq]
            self._alloc_frac -= run.frac
            if not self._runs:        # re-zero: no float-drift build-up
                self._alloc_frac = 0.0
            return True
        run.next_time = now + run.step_cost
        return False

    def snapshot(self, policy: str, duration: float, wall_s: float,
                 steps: int) -> PoolResult:
        """Fold queue-level SLO accounting into the per-model metrics.
        Requests still queued at the end count as violations, and requests
        still decoding in KV slots are reported as ``abandoned`` — both
        mirror the simulator's accounting (which likewise neither
        completes nor violates in-flight work at the cutoff), but nothing
        disappears without a trace."""
        in_flight: Dict[str, int] = {n: 0 for n in self.queues}
        for run in self._runs.values():
            in_flight[run.model] += len(run.slots)
        per: Dict[str, ModelPoolMetrics] = {}
        for n, q in self.queues.items():
            m = self._metrics[n]
            m.completed = q.completed
            m.violated = q.violated + len(q)
            m.dropped = q.dropped
            m.late = q.late
            m.abandoned = in_flight[n]
            m.cancelled = q.cancelled
            m.deadline_aborted = q.deadline_aborted
            m.shed = q.shed
            m.engine_retries = sum(e.stats.engine_retries
                                   for e in self.hosts[n].engines())
            m.engine_resets = sum(e.stats.engine_resets
                                  for e in self.hosts[n].engines())
            m.prefix_hits = sum(e.stats.prefix_hits
                                for e in self.hosts[n].engines())
            m.prefix_hit_tokens = sum(e.stats.prefix_hit_tokens
                                      for e in self.hosts[n].engines())
            m.cow_copies = sum(e.stats.cow_copies
                               for e in self.hosts[n].engines())
            m.draft_tokens = sum(e.stats.draft_tokens
                                 for e in self.hosts[n].engines())
            m.accepted_tokens = sum(e.stats.accepted_tokens
                                    for e in self.hosts[n].engines())
            m.spec_rounds = sum(e.stats.spec_rounds
                                for e in self.hosts[n].engines())
            m.rollbacks = sum(e.stats.rollbacks
                              for e in self.hosts[n].engines())
            m.latencies = list(q.latencies)
            m.ttfts = list(q.ttfts)
            m.tbts = list(q.tbts)
            per[n] = m
        duration = duration or 1e-9
        return PoolResult(policy=policy, duration=duration, wall_s=wall_s,
                          per_model=per, occupancy=self._occ_area / duration,
                          page_occupancy=self._page_area / duration,
                          steps=steps)


# --------------------------------------------------------------------------
# construction
# --------------------------------------------------------------------------
def default_allocations(profile: ModelProfile) -> List[int]:
    """Standby allocation candidates for one model, all levels of its
    hardware: its efficacy-optimal allocation and its knee (§5) — the two
    operating points D-STACK's dynamic adaptation moves between — plus,
    when knee and opt sit far apart, the middle level between them
    (§6.1.2: the dynamic fair pass then has a standby to *partially*
    shrink onto instead of jumping the whole way to the knee; on
    power-of-two levels, the geometric mid point), plus the whole device,
    because temporal / Triton-style baselines schedule whole-accelerator
    runs and must get the latency they budgeted for, not a
    silently-downgraded share."""
    levels = profile.hw.levels
    lo, hi = sorted((profile.opt_chips, profile.knee_chips))
    allocs = {lo, hi, profile.hw.chips_per_pod}
    if hi >= 4 * lo:
        mid = levels[(levels.index(lo) + levels.index(hi) + 1) // 2]
        allocs.add(min(hi, max(lo, mid)))
    return sorted(allocs)


def build_host(name: str, *, profile: Optional[ModelProfile] = None,
               allocations: Optional[Sequence[int]] = None,
               base_slots: int = 4, cache_len: int = 32,
               prompt_len: int = 8, seed: int = 0,
               request_rate: float = 500.0, reduced: bool = True,
               paged: bool = True, page_size: int = 8,
               total_pages: Optional[int] = None, device=None,
               dtype=torch.float32, params=None) -> ModelHost:
    """Build one hosted model: weights once, one standby engine per
    allocation. Every standby hosts the same ``base_slots`` KV slots so
    batch capacity is identical across allocations — what the policy's
    allocation changes is the run's (modeled) latency, not how much it
    can batch, which isolates the spatial-allocation effect the paper
    studies. The engines share the weights; each has its own slots and
    graphs.

    ``device`` defaults to the CUDA device (raises where there is none
    unless ``device="cpu"`` is passed); ``dtype`` is the weights' type;
    ``params`` carries given weights instead of random ones from
    ``seed`` (e.g. the JAX package's, through
    ``repro_torch.models.weights.params_from_numpy``). Without
    ``profile`` the model is profiled on ``local_gpu()`` (the ``H100``
    model with the card's SM count and memory) on a CUDA device, else on
    ``H100``.

    ``base_slots`` / ``page_size`` / ``total_pages`` are the per-model
    capacity knobs: ``total_pages`` defaults to ``base_slots * cache_len /
    page_size`` (ring-equivalent bytes); passing fewer pages than that —
    or more slots over the same pages — is how a host oversubscribes KV
    memory and lets the page pool, not the slot count, gate admission."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg = get_config(name)
    if reduced:
        cfg = cfg.reduced()
    api = build_model(cfg, device)
    if profile is None:
        hw = local_gpu(api.device) if api.device.type == "cuda" else H100
        profile = build_profile(name, request_rate=request_rate, hw=hw)
    if params is None:
        gen = torch.Generator(device=api.device).manual_seed(seed)
        params = api.init(gen, dtype)
    if paged and api.paged_keys and prompt_len >= cache_len:
        raise ValueError(
            f"{name}: prompt_len {prompt_len} leaves no decode room in a "
            f"{cache_len}-token paged slot — every admission would be "
            f"refused (paged slots never evict; raise cache_len)")
    chip_opts = sorted(set(allocations or default_allocations(profile)))
    standby: Dict[int, StandbyAllocation] = {}
    for chips in chip_opts:
        eng = InferenceEngine(api, params, cache_len=cache_len,
                              alloc_chips=chips).init_slots(
            base_slots, paged=paged, page_size=page_size,
            total_pages=total_pages)
        standby[chips] = StandbyAllocation(chips, base_slots, eng)
    return ModelHost(cfg, api, params, profile, standby,
                     prompt_len=prompt_len)


def build_pool(names: Sequence[str], *, request_rate: float = 500.0,
               base_slots: int = 4, cache_len: int = 32, prompt_len: int = 8,
               allocations: Optional[Dict[str, Sequence[int]]] = None,
               caps: Optional[PoolCaps] = None, warm: bool = True,
               reduced: bool = True, paged: bool = True, page_size: int = 8,
               slots: Optional[Dict[str, int]] = None,
               pages: Optional[Dict[str, int]] = None,
               lazy_kv: bool = False,
               planner_config: Optional[PlannerConfig] = None,
               prefix_cache: bool = False, device=None,
               dtype=torch.float32) -> EnginePool:
    """Build an EnginePool over (by default reduced) real models and (by
    default) warm every standby engine so the measured run captures
    nothing. ``device``/``dtype`` as in ``build_host``.
    ``slots`` / ``pages`` override slot count / usable page count per
    model name (the ROADMAP "per-model tuning" knobs — e.g. give a
    p50-lagging model more slots without re-sizing every host);
    ``lazy_kv`` switches admission to prompt-only page reservation with
    decode-time growth and preempt-and-requeue on ``OutOfPages``;
    ``planner_config`` seeds every per-model planner (load-shed
    watermarks, victim rule — its ``lazy`` field is overridden by
    ``lazy_kv``); ``prefix_cache`` attaches a radix prompt cache to
    every capable standby engine (incapable families skip gracefully)
    and its hit-admission executables are warmed with everything
    else."""
    hosts: Dict[str, ModelHost] = {}
    for i, name in enumerate(names):
        host = build_host(
            name, allocations=(allocations or {}).get(name),
            base_slots=(slots or {}).get(name, base_slots),
            cache_len=cache_len, prompt_len=prompt_len, seed=i,
            request_rate=request_rate, reduced=reduced, paged=paged,
            page_size=page_size, total_pages=(pages or {}).get(name),
            device=device, dtype=dtype)
        hosts[host.profile.name] = host
    pool = EnginePool(hosts, caps=caps, lazy_kv=lazy_kv,
                      planner_config=planner_config,
                      prefix_cache=prefix_cache)
    if warm:
        pool.warmup()
    return pool
