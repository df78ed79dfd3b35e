"""Declarative step-plan serving: ONE ``StepPlan`` per tick — a copy of
the JAX package's ``repro.serving.plan`` driving the port's engine.

  * ``StepPlanner`` observes the queue and the engine's page/slot state
    and emits a ``StepPlan`` — admissions (as ``PrefillChunk``s), decode
    slots, preemptions, frees, cancels and lazy page grows — once per
    tick;
  * ``InferenceEngine.execute(plan)`` runs it in at most three dispatches:
    one packed prefill (all first chunks), one incremental chunk dispatch
    (all continuations) and one decode step (all decoding slots);
  * ``StepResult`` reports what happened (tokens per slot, done slots,
    rid→slot bindings) and ``StepPlanner.observe`` folds it back into
    queue/metrics state.

Chunked prefill (``PlannerConfig.chunk_tokens``) caps the prefill tokens
per tick; page preemption (``PlannerConfig.lazy``) reserves pages for the
tokens written so far, grows them as decode proceeds, and preempts and
requeues a resident when the pool runs dry — the requeued prompt
re-prefills from scratch, so greedy streams are unchanged. Cancels,
deadline aborts, load shedding and injected faults
(``repro_torch.serving.faults``) follow the JAX package's rules.

``EnginePool.admit`` and ``EnginePool.topup`` (``repro_torch.serving.
pool``) route their shared admission logic through
``StepPlanner.select_admissible`` and execute the whole-prompt plan
``admission_plan`` builds.

The radix prompt cache (``PlannerConfig.prefix_cache``) turns an
admission whose prompt starts with a cached prefix into an alias
admission (no prefill for the covered tokens) whose uncovered tail rides
the decode dispatch as teacher-forced tokens (``StepPlan.forced``);
speculative decoding (``PlannerConfig.spec_k``, an engine with a draft
attached) moves decoding slots onto draft/verify rounds
(``StepPlan.spec``). The telemetry plane (``repro_torch.serving.
telemetry``), when attached, receives every lifecycle instant; detached,
each hook is a single attribute check. The planner takes the JAX
package's decisions everywhere, so both packages build the same plan
from the same state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.faults import EngineFault
from repro_torch.serving.metrics import ModelPoolMetrics
from repro_torch.serving.request import Request, RequestQueue


@dataclasses.dataclass(frozen=True)
class PrefillChunk:
    """One tick's worth of prefill for one request.

    ``start == 0`` chunks carry no slot: the engine claims one and runs
    them through the packed ragged prefill (one dispatch for all first
    chunks in the plan). ``start > 0`` chunks name the slot that is
    mid-prefill; ``batch`` then holds the FULL prefix up to the chunk's
    end, and they advance through one shared incremental chunk dispatch
    (one dispatch for all continuations in the plan). ``final``
    marks the chunk that completes the prompt — its last-token logits
    seed the first generated token, exactly as a one-shot prefill's last
    logits would."""
    rid: int
    batch: Any                         # token pytree for THIS chunk (B=1)
    start: int                         # absolute prompt offset
    length: int                        # tokens in this chunk
    final: bool
    slot: Optional[int] = None         # None -> engine claims a slot
    n_tokens: Optional[int] = None     # decode budget (first chunk only)
    # KV horizon (tokens) to reserve pages for NOW (first chunk only).
    # None = the legacy up-front reservation (prompt + budget); the lazy
    # planner passes just the chunk's own tokens and grows later.
    reserve_tokens: Optional[int] = None
    # prefix-cache hit (``PrefixHit``) backing a zero-dispatch alias
    # admission: instead of prefilling, the engine aliases the hit's
    # pages into the new slot's block table (plus at most one COW page
    # copy) and the uncovered tail arrives via ``StepPlan.forced``
    # teacher-forced catch-up. First chunks only (``slot is None``);
    # ``length == 0`` — no prefill tokens are computed for the chunk.
    alias: Optional[Any] = None


@dataclasses.dataclass
class StepPlan:
    """Everything one engine does this tick, decided up front.

    Execution order inside ``InferenceEngine.execute`` is fixed —
    frees → cancels → preemptions → grows → admissions (first chunks,
    one packed prefill) → continuations (one packed recompute prefill)
    → decodes (one step) — so a planner can project page availability
    exactly: pages released by frees/cancels/preemptions are usable by
    this same plan's grows/admissions."""
    admissions: List[PrefillChunk] = dataclasses.field(default_factory=list)
    decodes: List[int] = dataclasses.field(default_factory=list)
    preemptions: List[int] = dataclasses.field(default_factory=list)
    frees: List[int] = dataclasses.field(default_factory=list)
    # lifecycle Cancel events: slots whose requests terminated this tick
    # (client cancel or deadline abort) — executed exactly like frees
    # (pages back to the pool, table row to the null page) but kept
    # separate so accounting and tests can tell completion from abort
    cancels: List[int] = dataclasses.field(default_factory=list)
    # lazy page growth: extend slot's page horizon to cover >= tokens
    grows: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    # teacher-forced catch-up: (slot, prompt token) pairs riding THE
    # decode dispatch — an aliased admission consumes its uncovered
    # prompt tail one token per tick, writing exactly the K/V a prefill
    # would write there, with zero extra dispatches. Forced outputs
    # never reach ``StepResult.tokens`` (nothing was generated)
    forced: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    # speculative decoding: (slot, k, init_tokens-or-None)
    # rounds replacing plain decode steps for those slots — the engine's
    # paired draft proposes k tokens and ONE incremental chunk dispatch
    # verifies them all. ``init_tokens`` is the slot's full written
    # history (prompt + emitted prefix), present only when the draft
    # twin must be (re)admitted; None while the pair is in lockstep
    spec: List[Tuple[int, int, Optional[List[int]]]] = dataclasses.field(
        default_factory=list)

    @property
    def empty(self) -> bool:
        return not (self.admissions or self.decodes or self.preemptions
                    or self.frees or self.cancels or self.grows
                    or self.forced or self.spec)


@dataclasses.dataclass
class StepResult:
    """What ``execute`` actually did: sampled tokens per DECODED slot,
    slots whose budgets are now exhausted, rid→slot bindings for this
    plan's first-chunk admissions, and the dispatch count (the bounded-
    dispatch invariant: <= 3 model dispatches per tick).

    Failure feedback (injected or genuine allocator trouble):
    ``failed_grows`` lists slots whose lazy page growth failed — they
    were neither chunked nor decoded this tick and the planner must
    recompute-requeue them; ``admission_failed`` means the whole
    first-chunk batch rolled back all-or-nothing (no slot touched) and
    the staged requests must requeue."""
    tokens: Dict[int, int] = dataclasses.field(default_factory=dict)
    done: List[int] = dataclasses.field(default_factory=list)
    admitted: Dict[int, int] = dataclasses.field(default_factory=dict)
    dispatches: int = 0
    failed_grows: List[int] = dataclasses.field(default_factory=list)
    admission_failed: bool = False
    # speculative rounds: the 1..k+1 tokens each spec slot emitted this
    # tick (accepted drafts + the verify dispatch's bonus token), in
    # stream order — the multi-token sibling of ``tokens``
    spec_tokens: Dict[int, List[int]] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class PlannerConfig:
    # prompt tokens prefilled per tick across ALL requests; 0 = unchunked
    # (every admission prefills its whole prompt in its first chunk)
    chunk_tokens: int = 0
    # lazy page reservation + preempt-and-requeue on OutOfPages; False =
    # the legacy deadlock-free up-front prompt+budget reservation
    lazy: bool = False
    gen_len: int = 4                   # default decode budget (n_tokens=0)
    drop_expired: bool = True
    # page reservation with aging for the page-blocked FIFO head (the
    # ROADMAP anti-starvation follow-on): the head's reservation ratchets
    # up to its need as pages free, and bypassing smaller requests cannot
    # spend reserved pages
    head_reservation: bool = True
    # deadline aborts: evict residents whose SLO deadline has passed (the
    # same page-freeing Cancel event a client cancel emits). Off by
    # default — the legacy planes only police deadlines at the queue
    # (drop_expired) and at completion (late)
    deadline_aborts: bool = False
    # load-shed watermarks (graceful degradation): refuse NEW submissions
    # when the queue is already this deep / the page pool this full —
    # fail fast at admission instead of timing out resident. None = never
    shed_queue_depth: Optional[int] = None
    shed_page_frac: Optional[float] = None     # in-use fraction, 0..1
    # OutOfPages victim policy: "slack" scores residents by SLO slack per
    # unit of sunk recompute work (see preemption_key); "newest" is the
    # legacy latest-arrival rule
    victim: str = "slack"
    # radix prompt cache (needs an engine with ``enable_prefix_cache()``
    # attached): admissions matching a cached prefix alias its pages
    # instead of prefilling them, finished prompts register their full
    # pages, and cold cache nodes are evicted BEFORE any resident is
    # preempted when pages run short
    prefix_cache: bool = False
    # hit-quality floor: a hit must cover >= 1 full page AND >= this
    # fraction of the prompt, else it counts as a miss (the uncovered
    # tail advances one teacher-forced token per tick, so low-coverage
    # hits trade little prefill for a long serialized catch-up)
    prefix_min_frac: float = 0.5
    # speculative decoding (needs ``engine.attach_draft``): draft up to
    # spec_k tokens per decoding slot per tick and verify them in one
    # incremental chunk dispatch. 0 = off
    spec_k: int = 0
    # decode-batch knee ABOVE which speculation is withheld (the
    # accelerator is compute-bound there and verify FLOPs displace
    # decode FLOPs — see ``core.scheduler.speculation_worthwhile``).
    # None = always worthwhile (CPU-scale tests)
    spec_knee_batch: Optional[int] = None
    # acceptance-rate gate: withhold speculation while the trailing
    # acceptance EMA sits below this floor (a chronically-wrong draft
    # burns a dispatch per round for nothing), except on every
    # ``spec_probe_every``-th eligible tick — the probe that lets the
    # EMA recover when the workload turns draftable again
    spec_min_accept: float = 0.0
    spec_probe_every: int = 16
    # tiered, tenant-fair admission: tier name -> weight
    # (higher admits first; e.g. {"interactive": 4, "standard": 2,
    # "batch": 1}). None = strict FIFO (every existing plane). Within a
    # tier, the least-served tenant admits first (a DWRR-style deficit
    # over admitted service, DARIS arXiv:2504.08795), so one tenant's
    # burst cannot monopolize admission against another's stream
    tiers: Optional[Dict[str, float]] = None
    # anti-starvation bound for the LOWEST tier: once its oldest waiting
    # request has been bypassed by this many higher-tier admissions, it
    # outranks everything on the next pick — so a batch request admits
    # after at most tier_bypass_limit higher-tier admissions once it is
    # the tier's oldest (plus the page/SLO gates every admission faces)
    tier_bypass_limit: int = 8


class TieredAdmission:
    """Weighted-tier, tenant-fair admission ordering.

    Replaces the admission scans' strict-FIFO pop with a keyed pick
    (``RequestQueue.pop_pick``): higher-weight tiers admit first; within
    a tier the tenant with the greatest service deficit (least admitted
    prompt+budget tokens, deficit-round-robin style) wins; arrival then
    rid break remaining ties, so a single-tenant single-tier queue
    degenerates to exact FIFO.

    Anti-starvation bound: the LOWEST tier's oldest waiting request
    tracks how many higher-tier admissions bypassed it; at
    ``bypass_limit`` it outranks every other request on the next pick.
    A batch-tier request that reaches "oldest in tier" therefore admits
    after at most ``bypass_limit`` further higher-tier admissions —
    subject only to the same page/SLO gates every admission faces
    (asserted by ``test_lowest_tier_starvation_bound``).

    Per-tenant charges are renormalized after every admission so the
    least-served tenant still WAITING reads 0: values stay bounded, a
    tenant never seen before reads 0 (the fair default for newcomers),
    and a tenant served while another waits keeps a positive charge —
    so the waiting tenant wins the next same-tier pick."""

    def __init__(self, tiers: Dict[str, float], *,
                 default_tier: str = "standard", bypass_limit: int = 8):
        if not tiers:
            raise ValueError("TieredAdmission needs at least one tier")
        self.tiers = dict(tiers)
        self.default_tier = (default_tier if default_tier in self.tiers
                             else min(self.tiers, key=self.tiers.get))
        self.bypass_limit = max(1, int(bypass_limit))
        self.deficit: Dict[str, float] = {}
        self._lowest = min(self.tiers, key=self.tiers.get)
        self._low_head: Optional[int] = None     # rid of the tier's oldest
        self._low_bypassed = 0

    def weight(self, req: Request) -> float:
        w = self.tiers.get(req.tier)
        return w if w is not None else self.tiers[self.default_tier]

    def _starving(self, req: Request) -> bool:
        return (req.rid == self._low_head
                and self._low_bypassed >= self.bypass_limit)

    def key(self):
        """Pick key for ``RequestQueue.pop_pick`` — lowest wins."""
        def k(req: Request):
            return (0 if self._starving(req) else 1,
                    -self.weight(req),
                    self.deficit.get(req.tenant, 0.0),
                    req.arrival, req.rid)
        return k

    def admitted(self, req: Request, cost: float, waiting) -> None:
        """Record an actual admission: charge the tenant's deficit by the
        admitted service (prompt + decode budget tokens) and advance the
        lowest tier's bypass counter against ``waiting`` (requests still
        queued after this pick)."""
        t = req.tenant
        self.deficit[t] = self.deficit.get(t, 0.0) + float(cost)
        # renormalize against the least-served tenant STILL WAITING (an
        # unseen waiting tenant reads 0): relative order among waiting
        # tenants is preserved, charges stay bounded, and a tenant that
        # has been served while another waits keeps its positive charge
        # until the other catches up
        waiting_tenants = {r.tenant for r in waiting}
        if waiting_tenants:
            lo = min(self.deficit.get(w, 0.0) for w in waiting_tenants)
            if lo > 0.0:
                for k in self.deficit:
                    self.deficit[k] = max(0.0, self.deficit[k] - lo)
        low = [r for r in waiting if (r.tier if r.tier in self.tiers
                                      else self.default_tier) == self._lowest]
        if not low:
            self._low_head, self._low_bypassed = None, 0
            return
        head = min(low, key=lambda r: (r.arrival, r.rid))
        if head.rid != self._low_head:
            self._low_head, self._low_bypassed = head.rid, 0
        tier = req.tier if req.tier in self.tiers else self.default_tier
        if tier != self._lowest:
            self._low_bypassed += 1


@dataclasses.dataclass
class _Resident:
    """Planner-side state for one occupied slot."""
    req: Request
    batch: Any                         # full prompt pytree (B=1)
    prompt_len: int
    done: int                          # prompt tokens prefilled so far
    budget: int                        # decode-token budget
    prefilling: bool                   # True until the final chunk ran
    # teacher-forced catch-up (aliased admissions): a ``forced`` resident
    # consumes prompt[done] one token per tick via ``StepPlan.forced``
    # until the prompt completes — it never takes continuation chunks
    forced: bool = False
    host_tokens: Optional[List[int]] = None   # prompt as host ints (lazy)
    # pinned PrefixHit while STAGED only: the engine consumes the pins at
    # alias admission (or releases them itself on OutOfPages), so observe
    # clears this on both outcomes; recover() releases it when execute
    # never ran (fault-before-mutation / stuck tick)
    alias: Any = None
    registered: bool = False           # prompt pages inserted in the cache
    # speculation seed: argmax over the full prompt (the pending token
    # right after prefill, never itself emitted) — captured ONCE from
    # the device before the first decode so the planner can rebuild the
    # slot's written history for draft (re)admission
    seed_tok: Optional[int] = None


def preemption_key(req: Request, sunk_tokens: int, now: float,
                   mode: str = "slack") -> Tuple:
    """Victim-ordering key for OutOfPages preemption — HIGHEST wins.

    ``slack`` prefers the resident with the most SLO slack per unit of
    sunk work: score = (deadline − now) / (1 + tokens already written).
    A resident with slack to spare and little invested work is the
    cheapest to recompute and the likeliest to still meet its deadline
    after re-admission (DARIS-style slack-aware eviction); a nearly-due
    or deeply-prefilled resident is protected. Infinite/absent SLOs map
    to a huge finite slack so the ratio still discriminates on sunk
    work, which also makes ``slack`` degrade to least-sunk-first (≈ the
    newest resident) on SLO-free workloads. ``newest`` is the legacy
    latest-arrival rule. Callers append the slot id for a deterministic
    tie-break."""
    if mode == "newest":
        return (0.0, req.arrival)
    slack = req.deadline - now
    if not math.isfinite(slack):
        slack = 1e18
    return (slack / (1.0 + max(0, int(sunk_tokens))), req.arrival)


def _prompt_tokens(batch) -> int:
    return int(batch["tokens"].shape[1])


def _chunk_batch(batch, stop: int):
    """Truncate a prompt pytree to its first ``stop`` tokens. Every
    chunk — first or continuation — carries the FULL prefix up to its
    end plus the non-token inputs (``enc_embeds``): the engine's chunk
    executor recomputes the prefix (packed prefill) and rewrites its
    already-written positions with bit-identical values."""
    if stop >= batch["tokens"].shape[1]:
        return batch
    out = dict(batch)
    out["tokens"] = batch["tokens"][:, :stop]
    return out


class StepPlanner:
    """Builds one ``StepPlan`` per tick from (policy knobs + queue +
    engine page/slot view), and folds ``StepResult``s back into
    queue/metrics state.

    Two usage modes share the same admission gate:

    * **tick plane** (bound engine + queue): ``submit`` requests with
      host prompt arrays, then ``build`` → ``engine.execute`` →
      ``observe`` once per tick (``serve_ticks``).
    * **pool plane** (``EnginePool``): one planner per hosted model;
      ``admit``/``topup`` call ``select_admissible`` (the single
      admission gate — KV pages, SLO expiry, head reservation) against
      whichever standby engine the policy granted, and execute the
      resulting whole-prompt plan.
    """

    def __init__(self, engine=None, queue: Optional[RequestQueue] = None,
                 config: Optional[PlannerConfig] = None,
                 metrics: Optional[ModelPoolMetrics] = None):
        self.engine = engine
        self.queue = queue
        self.config = config or PlannerConfig()
        self.metrics = metrics if metrics is not None else ModelPoolMetrics()
        self._resident: Dict[int, _Resident] = {}
        self._staged: List[_Resident] = []    # admissions awaiting a slot
        self._to_free: List[int] = []
        self._prompts: Dict[int, Any] = {}    # rid -> prompt pytree
        self._blocked_rids: set = set()
        # head reservation: (rid of the page-blocked FIFO head, pages
        # ratcheted for it so far)
        self._resv_rid: Optional[int] = None
        self._resv_pages: int = 0
        # per-request emitted tokens (tick plane); preemption clears a
        # stream — the restarted request re-emits from scratch
        self.streams: Dict[int, List[int]] = {}
        # rids cancelled while in flight (resident or staged): the next
        # build() emits their Cancel event; a cancelled rid caught at a
        # requeue point (preemption, failed admission, engine reset)
        # terminates there instead of re-entering the queue
        self._cancelled: set = set()
        self._now = 0.0                    # last build() time (victim keys)
        # speculation feedback: trailing acceptance-rate EMA (optimistic
        # start — the first rounds measure it), eligible-tick counter
        # (drives the probe cadence), and the k planned per spec slot
        # this tick (observe turns emitted counts into acceptance rates)
        self._spec_accept_ema = 1.0
        self._spec_ticks = 0
        self._spec_planned: Dict[int, int] = {}
        # telemetry plane (repro_torch.serving.telemetry.Telemetry), set by
        # EnginePool.attach_telemetry or directly by the tick plane;
        # None = zero-cost (one attribute check per lifecycle event)
        self.telemetry = None
        # tiered, tenant-fair admission (None = strict FIFO, the exact
        # legacy pop order — every existing plane takes this branch)
        self.admission = (TieredAdmission(
            self.config.tiers, bypass_limit=self.config.tier_bypass_limit)
            if self.config.tiers else None)

    def _tel_event(self, name: str, req: Request, **args) -> None:
        tel = self.telemetry
        if tel is not None:
            tel.request_event(req.model, name, rid=req.rid, **args)

    # ------------------------------------------------------- tick plane
    def submit(self, req: Request, batch) -> bool:
        """Enqueue a request with its real prompt (token pytree, B=1).
        Returns False when the request was load-shed at admission (the
        ``PlannerConfig`` watermarks — queue depth / page occupancy —
        are crossed): it terminates immediately with state ``shed``
        rather than queueing toward a certain timeout."""
        self.streams.setdefault(req.rid, [])
        if self.should_shed():
            self.queue.shed_request(req)
            self.metrics.shed = self.queue.shed
            self._tel_event("shed", req)
            return False
        self.queue.push(req)
        self._tel_event("queued", req)
        self._prompts[req.rid] = batch
        return True

    def should_shed(self, queue_len: Optional[int] = None,
                    page_frac: Optional[float] = None) -> bool:
        """Backpressure gate: True when either load-shed watermark is
        crossed. Callers without a bound queue/engine (the pool plane)
        pass explicit measurements."""
        cfg = self.config
        if cfg.shed_queue_depth is not None:
            if queue_len is None:
                queue_len = len(self.queue) if self.queue is not None else 0
            if queue_len >= cfg.shed_queue_depth:
                return True
        if cfg.shed_page_frac is not None:
            if page_frac is None:
                eng = self.engine
                if (eng is None or not getattr(eng, "paged", False)
                        or eng.total_pages <= 0):
                    page_frac = 0.0
                else:
                    page_frac = 1.0 - eng.free_pages / eng.total_pages
            if page_frac >= cfg.shed_page_frac:
                return True
        return False

    def cancel(self, rid: int) -> bool:
        """Client cancellation (disconnect). A still-queued request is
        removed immediately; a resident or staged one is marked and the
        next ``build`` emits its Cancel event — the slot's pages free
        before that plan grows or admits, and mid-chunked-prefill
        residents are no special case (their partial pages free the same
        way). Returns False for unknown or already-terminal rids."""
        if self.queue is not None and self.queue.cancel(rid) is not None:
            self._prompts.pop(rid, None)
            self.metrics.cancelled = self.queue.cancelled
            return True
        live = {r.req.rid for r in self._resident.values()}
        live.update(r.req.rid for r in self._staged)
        if rid in live:
            self._cancelled.add(rid)
            return True
        return False

    def busy(self) -> bool:
        return bool(self._resident or self._staged or self._to_free
                    or (self.queue is not None and len(self.queue)))

    def _budget_of(self, req: Request, prompt_len: int) -> int:
        eng = self.engine
        want = req.n_tokens if req.n_tokens > 0 else self.config.gen_len
        room = max(1, eng.slot_len - prompt_len)
        return max(1, min(int(want), room))

    def _pages_for(self, tokens: int) -> int:
        return self.engine.kv_pages_needed(tokens)

    def _grow_cost(self, slot: int, upto: int) -> int:
        """New pages needed to extend ``slot``'s horizon to ``upto``."""
        eng = self.engine
        if not eng.paged:
            return 0
        have = eng.reserved_tokens(slot)
        if upto <= have:
            return 0
        return self._pages_for(upto) - self._pages_for(max(1, have))

    def _pick_victim(self, excluded: set) -> Optional[int]:
        """Victim for OutOfPages preemption / stall-breaking, by
        ``PlannerConfig.victim``: ``slack`` (default) scores residents
        by SLO slack per unit of sunk recompute work — see
        ``preemption_key`` — so a nearly-due or deeply-prefilled
        resident is protected; ``newest`` preserves the legacy
        latest-arrival rule. Ties break on (arrival, slot id) so the
        choice is deterministic."""
        eng = self.engine
        cands = []
        for slot, r in self._resident.items():
            if slot in excluded:
                continue
            sunk = eng.slot_pos(slot) if eng is not None else r.done
            cands.append(preemption_key(r.req, sunk, self._now,
                                        self.config.victim) + (slot,))
        if not cands:
            return None
        return max(cands)[-1]

    # ---------------------------------------------------- prefix cache
    def _pcache(self):
        """The engine's prefix cache when BOTH the config flag and the
        engine attachment agree; None disables every cache path (the
        pool plane's unbound planners pass the engine explicitly)."""
        eng = self.engine
        if not self.config.prefix_cache or eng is None:
            return None
        return eng.prefix_cache

    @staticmethod
    def _host_tokens(r: _Resident) -> List[int]:
        if r.host_tokens is None:
            r.host_tokens = [int(t)
                             for t in np.asarray(r.batch["tokens"])[0]]
        return r.host_tokens

    def _min_covered(self, eng, prompt_len: int) -> int:
        """Hit-quality floor for ``PrefixCache.match`` (see
        ``PlannerConfig.prefix_min_frac``)."""
        return max(eng.page_size,
                   int(math.ceil(self.config.prefix_min_frac * prompt_len)))

    def _evict_cache(self, need: int, pages_avail: int) -> int:
        """Evict cold radix nodes to cover ``need`` pages BEFORE any
        resident is preempted: a cached-but-unreferenced prefix page is
        strictly cheaper to reclaim than a resident's recompute-requeue.
        Returns the updated availability projection."""
        cache = self._pcache()
        if cache is None or need <= pages_avail:
            return pages_avail
        freed = cache.evict(need - pages_avail)
        if freed:
            eng = self.engine
            if eng.telemetry is not None:
                eng.telemetry.instant(eng.telemetry.engine_track(eng),
                                      "prefix_evict", pages=freed)
        return pages_avail + freed

    def _register_prompts(self) -> None:
        """Insert finished prompts' full pages into the prefix cache —
        once per resident, only after its prompt is COMPLETE. That
        timing is the safety argument for read-only aliasing: chunk
        recompute (which rewrites prompt positions) is over, and every
        later write — decode or a dead masked write — lands at
        ``pos >= prompt_len``, past the registered pages."""
        cache = self._pcache()
        eng = self.engine
        if cache is None or not eng.paged:
            return
        ps = eng.page_size
        for slot, r in self._resident.items():
            if r.prefilling or r.registered:
                continue
            r.registered = True
            n_full = r.prompt_len // ps
            if n_full < 1:
                continue
            toks = self._host_tokens(r)
            cache.insert(toks[:n_full * ps], eng.slot_pages(slot)[:n_full])
            # concurrent same-prefix prefills double-filled pages the
            # cache could not yet serve: repoint this row at the
            # canonical pages (bit-identical content) and free its
            # duplicates — zero-cost when nothing matches
            eng.dedup_slot_prefix(slot, toks, n_full)

    def build(self, now: float) -> StepPlan:
        """Emit this tick's plan. Mutates planner bookkeeping under the
        assumption the plan WILL be executed (the tick loop always does:
        build → execute → observe)."""
        eng, q, cfg = self.engine, self.queue, self.config
        self._now = now
        plan = StepPlan()
        plan.frees = list(self._to_free)
        self._to_free = []

        # -- phase 0: lifecycle events. Client cancels and (when enabled)
        # deadline aborts terminate residents via plan.cancels — the same
        # page-freeing event, whatever phase the victim was in: a
        # mid-chunked-prefill resident's partial pages free exactly like
        # a decoder's. Accounting is terminal here (the queue's per-cause
        # counters); nothing requeues.
        for slot, r in sorted(self._resident.items()):
            if r.req.rid in self._cancelled:
                self._terminate(slot, r, plan, cancelled=True)
            elif cfg.deadline_aborts and now > r.req.deadline:
                self._terminate(slot, r, plan, cancelled=False)

        freed = set(plan.frees) | set(plan.cancels)
        # page/slot projection: execution frees/cancels/preempts before
        # it grows/admits, so released pages count as available
        pages_avail = eng.free_pages + sum(
            eng.slot_page_count(s) for s in plan.frees) + sum(
            eng.slot_page_count(s) for s in plan.cancels)
        slots_avail = eng.free_slots + len(plan.frees) + len(plan.cancels)
        # decode set snapshot BEFORE this tick's final chunks flip flags
        decodes = [s for s, r in sorted(self._resident.items())
                   if not r.prefilling and s not in freed]

        # -- phase A: decode page growth (lazy), preempting on shortage
        victims: set = set()
        for slot in list(decodes):
            if slot in victims:
                continue
            # next decode writes at pos = written tokens; cover it
            upto = min(eng.slot_pos(slot) + 1, eng.slot_len)
            need = self._grow_cost(slot, upto)
            pages_avail = self._evict_cache(need, pages_avail)
            while need > pages_avail:
                v = self._pick_victim(excluded=victims | freed)
                if v is None:
                    break
                victims.add(v)
                pages_avail += eng.slot_page_count(v)
                pages_avail += self._preempt(v, plan, now)
                if v == slot:
                    need = 0
                    break
            if slot in victims:
                continue
            if upto > eng.reserved_tokens(slot):
                # always recorded, even at zero page cost: the horizon
                # bookkeeping must advance with the physical coverage
                plan.grows.append((slot, upto))
                pages_avail -= need

        # -- phase A': teacher-forced catch-up for aliased admissions.
        # Each forced resident consumes ONE uncovered prompt token this
        # tick, riding the decode dispatch — zero extra dispatches. Its
        # page need is exactly a decode's (the forced write lands at
        # slot_pos), competing through the same evict-then-preempt
        # ladder; a failed grow requeues it like any decode's would.
        for slot, r in sorted(self._resident.items()):
            if (not r.forced or slot in victims or slot in freed
                    or slot not in self._resident):
                continue
            upto = min(eng.slot_pos(slot) + 1, eng.slot_len)
            need = self._grow_cost(slot, upto)
            pages_avail = self._evict_cache(need, pages_avail)
            while need > pages_avail:
                v = self._pick_victim(excluded=victims | freed)
                if v is None:
                    break
                victims.add(v)
                pages_avail += eng.slot_page_count(v)
                pages_avail += self._preempt(v, plan, now)
                if v == slot:
                    need = 0
                    break
            if slot in victims:
                continue
            if upto > eng.reserved_tokens(slot):
                plan.grows.append((slot, upto))
                pages_avail -= need
            toks = self._host_tokens(r)
            plan.forced.append((slot, toks[r.done]))
            r.done += 1
            if r.done >= r.prompt_len:
                # the final forced step's logits seed the first sampled
                # token exactly as a one-shot prefill's last logits
                # would — decodable from the NEXT tick's snapshot
                r.prefilling = False
                r.forced = False

        decodes = [s for s in decodes if s not in victims]
        slots_avail += len(victims)

        # -- phase A_spec: move eligible decode slots onto speculative
        # rounds. Gated on the roofline knee (speculate while decode is
        # memory-bound; see ``speculation_worthwhile``) and on the
        # trailing acceptance EMA with periodic probes. A spec slot's
        # page horizon widens from pos+1 to pos+k+1 (the verify chunk
        # writes k+1 positions); on page shortage k degrades instead of
        # preempting anyone — speculation is an optimization and must
        # never evict a resident to fund itself.
        self._spec_planned = {}
        pages_avail = self._plan_spec(plan, decodes, pages_avail)

        # -- phase B: continuation chunks for in-flight prefills, oldest
        # request first (finish what is resident before admitting more).
        # Each selected continuation advances by a full ``chunk_tokens``
        # quantum of NEW tokens, and the budget is charged the whole
        # RECOMPUTED row (prefix + chunk) — the work the dispatch
        # actually does — so per-tick prefill cost stays bounded by
        # ~max(chunk_tokens, longest prefix + quantum); the oldest
        # continuation always proceeds even when its row alone exceeds
        # the budget (liveness — without it a long prompt could never
        # finish).
        budget_left = cfg.chunk_tokens if cfg.chunk_tokens > 0 else math.inf
        quantum = cfg.chunk_tokens if cfg.chunk_tokens > 0 else math.inf
        inflight = sorted(
            ((r.req.arrival, r.req.rid, slot) for slot, r in
             self._resident.items()
             if r.prefilling and not r.forced
             and slot not in victims and slot not in freed))
        first_cont = True
        for _, _, slot in inflight:
            if budget_left <= 0:
                break
            r = self._resident[slot]
            c = int(min(r.prompt_len - r.done, quantum))
            if not first_cont and r.done + c > budget_left:
                continue                   # next tick
            if eng.paged:
                # shrink the chunk to what the page pool can back — the
                # cap counts the slot's PHYSICAL coverage (whole pages,
                # including slack past the reserved horizon in its last
                # page), so a zero-page-cost continuation is never
                # skipped; a zero-token chunk just waits for pages
                pages_avail = self._evict_cache(
                    self._grow_cost(slot, r.done + c), pages_avail)
                while c > 0:
                    need = self._grow_cost(slot, r.done + c)
                    if need <= pages_avail:
                        break
                    cap = (eng.slot_page_count(slot) + pages_avail) * \
                        eng.page_size - r.done
                    c = int(min(c - 1, max(0, cap)))
                if c <= 0:
                    continue
                if r.done + c > eng.reserved_tokens(slot):
                    plan.grows.append((slot, r.done + c))
                    pages_avail -= self._grow_cost(slot, r.done + c)
            final = (r.done + c) == r.prompt_len
            plan.admissions.append(PrefillChunk(
                rid=r.req.rid, batch=_chunk_batch(r.batch, r.done + c),
                start=r.done, length=c, final=final, slot=slot))
            budget_left -= r.done + c
            r.done += c
            if final:
                r.prefilling = False       # decodable from the NEXT tick
            first_cont = False

        # -- phase C: admissions (first chunks) from the queue
        if q is not None:
            kept = self._scan_queue(
                eng, q, now, max_batch=slots_avail,
                pages_avail=pages_avail, budget_left=budget_left)
            for req, batch, budget, c, reserve, hit, toks in kept:
                p = _prompt_tokens(batch)
                if hit is not None:
                    # prefix-cache hit: zero-cost leading chunk — no
                    # prefill tokens computed, no chunk budget charged.
                    # The uncovered tail teacher-forces from next tick
                    plan.admissions.append(PrefillChunk(
                        rid=req.rid, batch=batch, start=0, length=0,
                        final=False, n_tokens=budget,
                        reserve_tokens=reserve, alias=hit))
                    self._staged.append(_Resident(
                        req=req, batch=batch, prompt_len=p,
                        done=hit.covered, budget=budget, prefilling=True,
                        forced=True, host_tokens=toks, alias=hit))
                    self._tel_event("prefix_hit", req, covered=hit.covered,
                                    cow=hit.cow_src is not None)
                    continue
                final = c == p
                plan.admissions.append(PrefillChunk(
                    rid=req.rid, batch=_chunk_batch(batch, c),
                    start=0, length=c, final=final,
                    n_tokens=budget, reserve_tokens=reserve))
                self._staged.append(_Resident(
                    req=req, batch=batch, prompt_len=p,
                    done=c, budget=budget, prefilling=not final,
                    host_tokens=toks))

        plan.decodes = decodes
        # stall-breaker: every resident is page-starved mid-prefill and
        # nothing can free pages (no decodes, no admissions) — preempt the
        # newest resident so the oldest can make progress next tick
        if plan.empty and self._resident:
            v = self._pick_victim(excluded=set())
            if v is not None:
                self._preempt(v, plan, now)
        return plan

    def _plan_spec(self, plan: StepPlan, decodes: List[int],
                   pages_avail: int) -> int:
        """Phase A_spec: convert eligible ``decodes`` entries into
        ``plan.spec`` rounds (mutates ``decodes`` in place), widening
        their grow horizons to cover the verify chunk. Returns the
        updated page-availability projection."""
        eng, cfg = self.engine, self.config
        if (cfg.spec_k <= 0 or not decodes or eng is None
                or getattr(eng, "_draft", None) is None):
            return pages_avail
        from repro_torch.core.scheduler.base import speculation_worthwhile
        if not speculation_worthwhile(len(decodes), cfg.spec_knee_batch):
            return pages_avail
        self._spec_ticks += 1
        probe = (self._spec_ticks % max(1, cfg.spec_probe_every)) == 0
        if self._spec_accept_ema < cfg.spec_min_accept and not probe:
            return pages_avail
        for slot in list(decodes):
            r = self._resident.get(slot)
            if r is None:
                continue
            pos = eng.slot_pos(slot)
            # k is capped so the round can never overshoot the request's
            # budget (emits <= budget_left tokens) or the slot's pages
            # (writes k+1 positions, all < slot_len); budget_left == 1
            # degenerates to a plain decode step
            budget_left = r.budget - r.req.tokens_out
            k = min(cfg.spec_k, budget_left - 1, eng.slot_len - 1 - pos)
            if k < 1:
                continue
            synced = eng.draft_synced(slot)
            if not synced and r.seed_tok is None:
                continue            # history unknown: cannot init a draft
            if eng.paged:
                base = self._grow_cost(slot, pos + 1)
                delta = self._grow_cost(slot, pos + k + 1) - base
                pages_avail = self._evict_cache(delta, pages_avail)
                while k >= 1 and (self._grow_cost(slot, pos + k + 1)
                                  - base) > pages_avail:
                    k -= 1          # degrade, never preempt, to fit
                if k < 1:
                    continue
                delta = self._grow_cost(slot, pos + k + 1) - base
                if pos + k + 1 > eng.reserved_tokens(slot):
                    # widen (or introduce) the slot's grow; phase A
                    # already charged ``base`` for its pos+1 entry
                    plan.grows = [(s, u) for s, u in plan.grows
                                  if s != slot]
                    plan.grows.append((slot, pos + k + 1))
                    pages_avail -= delta
            init: Optional[List[int]] = None
            if not synced:
                st = self.streams[r.req.rid]
                toks = self._host_tokens(r)
                init = toks[:r.prompt_len] + (
                    [r.seed_tok] + st[:-1] if st else [])
            plan.spec.append((slot, k, init))
            decodes.remove(slot)
            self._spec_planned[slot] = k
        return pages_avail

    def _preempt(self, slot: int, plan: StepPlan, now: float) -> int:
        """Evict ``slot``: pages free, request requeues, prompt restarts
        on re-admission (vLLM recompute preemption — greedy decode makes
        the restarted stream identical to an uninterrupted one). Any
        action this plan already holds for the slot — a decode, a grow, a
        continuation chunk — is scrubbed: execution frees the slot before
        it would run them. Returns the pages the scrubbed grows had been
        charged, so the caller's availability projection can re-credit
        them (they will never be allocated)."""
        r = self._resident.pop(slot)
        plan.preemptions.append(slot)
        if slot in plan.decodes:
            plan.decodes.remove(slot)
        credit = sum(self._grow_cost(s, u) for s, u in plan.grows
                     if s == slot)
        plan.grows = [(s, u) for s, u in plan.grows if s != slot]
        plan.admissions = [c for c in plan.admissions if c.slot != slot]
        plan.forced = [(s, t) for s, t in plan.forced if s != slot]
        plan.spec = [e for e in plan.spec if e[0] != slot]
        self._spec_planned.pop(slot, None)
        self.metrics.preemptions += 1
        self._tel_event("preempt", r.req, slot=slot)
        self._requeue(r.req)
        return credit

    def _terminate(self, slot: int, r: _Resident, plan: StepPlan, *,
                   cancelled: bool) -> None:
        """Emit a Cancel event for a resident and account its terminal
        cause (client ``cancelled`` or ``deadline_aborted``)."""
        plan.cancels.append(slot)
        self._resident.pop(slot)
        rid = r.req.rid
        self._cancelled.discard(rid)
        self._prompts.pop(rid, None)
        if self.queue is not None:
            if cancelled:
                self.queue.mark_cancelled(r.req)
            else:
                self.queue.abort_deadline(r.req)
        self._tel_event("cancel" if cancelled else "deadline_abort",
                        r.req, slot=slot)

    def _requeue(self, req: Request) -> None:
        """Recompute-requeue: the stream restarts from scratch on
        re-admission (greedy decode makes the replay bit-exact). A rid
        cancelled while it was in flight terminates here instead of
        re-entering the queue — cancellation wins over recovery."""
        rid = req.rid
        self.streams[rid] = []
        req.reset_stream()        # recompute discards streaming progress
        if rid in self._cancelled:
            self._cancelled.discard(rid)
            self._prompts.pop(rid, None)
            if self.queue is not None:
                self.queue.mark_cancelled(req)
            return
        if self.queue is not None:
            self.queue.push(req)
        self.metrics.requeues += 1
        self._tel_event("requeue", req)

    def recover(self, now: float) -> int:
        """Planner half of the engine-reset path (retries exhausted or a
        stuck tick): device slot state is unknown, so drop ALL of it and
        rebuild by recompute. Every resident and staged request requeues
        for a from-scratch re-prefill — the preemption discipline, so
        surviving greedy streams are unchanged — while cancelled rids
        terminate instead; the engine frees every slot and the page-
        conservation audit runs before serving resumes. Returns how many
        requests were requeued or terminated."""
        del now
        n = 0
        for slot, r in sorted(self._resident.items()):
            self._requeue(r.req)
            n += 1
        self._resident.clear()
        pcache = (self.engine.prefix_cache
                  if self.engine is not None else None)
        for r in self._staged:
            # staged alias pins were never consumed (EngineFault fires
            # before the plan mutates anything; a stuck tick never
            # executed) — return them so the engine-reset page audit
            # (free == total after the cache flush) holds
            if r.alias is not None and pcache is not None:
                pcache.release_hit(r.alias)
                r.alias = None
            self._requeue(r.req)
            n += 1
        self._staged = []
        # pending frees are for slots already popped from _resident; the
        # engine-wide release below covers them
        self._to_free = []
        if self.engine is not None:
            self.engine.recover()
        return n

    def _pop_next(self, q, now, drop_expired: bool) -> Optional[Request]:
        """The one queue pop both admission scans share: strict FIFO
        without tiers (``pop_batch(1)`` exactly — bit-identical legacy
        order), else the tiered/tenant-fair keyed pick."""
        adm = self.admission
        if adm is None:
            got = q.pop_batch(1, now, drop_expired)
            return got[0] if got else None
        return q.pop_pick(now, drop_expired, key=adm.key())

    def _note_admitted(self, req: Request, cost: float, q,
                       blocked) -> None:
        """Tiered-admission bookkeeping for a KEPT request: charge the
        tenant and advance the lowest tier's bypass counter over
        everything still waiting (queued + page-blocked this scan)."""
        if self.admission is not None:
            self._tel_event("tier_admit", req, tier=req.tier,
                            tenant=req.tenant)
            self.admission.admitted(
                req, cost, list(q) + list(blocked))

    def _scan_queue(self, eng, q, now, *, max_batch, pages_avail,
                    budget_left) -> List[Tuple]:
        """Tick-plane admission scan: pops requests the projected pages /
        slots / chunk budget can back. Returns
        [(req, batch, budget, first_chunk_len, reserve_tokens, hit,
        host_tokens)] — ``hit`` is a pinned ``PrefixHit`` for alias
        admissions (None otherwise; ``host_tokens`` likewise only
        materialized when the prefix cache looked at the prompt)."""
        cfg = self.config
        cache = self._pcache()
        kept: List[Tuple] = []
        blocked: List[Request] = []
        is_head = True
        while len(kept) < max_batch and budget_left > 0 and len(q):
            req = self._pop_next(q, now, cfg.drop_expired)
            if req is None:
                break
            batch = self._prompts[req.rid]
            p = _prompt_tokens(batch)
            # cannot ever fit — drop loudly rather than spin forever
            # (paged slots need decode room past the prompt; ring slots
            # hold at most slot_len prompt tokens for a packed insert)
            prompt_cap = eng.slot_len - 1 if eng.paged else eng.slot_len
            if p > prompt_cap:
                q.violated += 1
                q.dropped += 1
                self._prompts.pop(req.rid, None)
                is_head = False
                continue
            budget = self._budget_of(req, p)
            if eng.paged and self._pages_for(
                    min(p + budget, eng.slot_len)) > eng.total_pages:
                # full residency exceeds the whole pool: not completable
                # even with every other sequence preempted — drop loudly
                q.violated += 1
                q.dropped += 1
                self._prompts.pop(req.rid, None)
                is_head = False
                continue
            c = int(min(p, budget_left, max(1, eng.slot_len - 1)))
            reserve: Optional[int] = None
            hit = None
            toks: Optional[List[int]] = None
            if cache is not None and eng.paged:
                toks = [int(t) for t in np.asarray(batch["tokens"])[0]]
                hit = cache.match(toks, max_covered=p - 1,
                                  min_covered=self._min_covered(eng, p))
            if eng.paged:
                if hit is not None:
                    # pages for the FRESH tail only: the hit's covered
                    # pages alias at zero page cost (a refcount bump,
                    # not an allocation)
                    horizon = (hit.covered + 1 if cfg.lazy
                               else min(p + budget, eng.slot_len))
                    need = self._pages_for(horizon) - len(hit.pages)
                else:
                    horizon = c if cfg.lazy else min(p + budget,
                                                     eng.slot_len)
                    need = self._pages_for(horizon)
                reserve = horizon
                pages_avail = self._evict_cache(need, pages_avail)
                left = self._page_gate(req, is_head, need, pages_avail)
                if left is None:
                    if hit is not None:
                        # pins return to the cache; the request retries
                        # (and re-matches) on a later scan
                        cache.release_hit(hit)
                        hit = None
                    blocked.append(req)
                    is_head = False
                    continue
                pages_avail = left
            if hit is not None:
                kept.append((req, batch, budget, 0, reserve, hit, toks))
            else:
                kept.append((req, batch, budget, c, reserve, None, toks))
                budget_left -= c
            self._note_admitted(req, p + budget, q, blocked)
            is_head = False
        for req in blocked:
            q.push(req)
        return kept

    # -------------------------------------------- head reservation/aging
    def _page_gate(self, req: Request, is_head: bool, need: int,
                   pages_left: int) -> Optional[int]:
        """The one page-admission gate both scan loops share: checks
        ``need`` against the reservable pages (head reservation/aging
        applied), counts a first-time block in ``blocked_on_memory``,
        and clears a reservation its holder just spent. Returns the new
        pages_left, or None when the request is blocked — keeping this
        in one place is what stops the pool gate and the tick gate from
        drifting."""
        avail = self._reservable(req, is_head, need, pages_left)
        if need > avail:
            if req.rid not in self._blocked_rids:
                self._blocked_rids.add(req.rid)
                self.metrics.blocked_on_memory += 1
            return None
        if req.rid == self._resv_rid:
            self._resv_rid, self._resv_pages = None, 0
        return pages_left - need

    def _reservable(self, req: Request, is_head: bool, need: int,
                    pages_avail: int) -> int:
        """Pages ``req`` may draw on. The FIFO head, when page-blocked,
        accumulates a page reservation that AGES — one page per planning
        scan it stays blocked — and bypassing requests see ``pages_avail``
        minus that reservation. Early on, smaller requests still bypass
        the blocked head (the packing-over-strict-FIFO throughput choice
        is preserved); as the head waits, freed pages increasingly pool
        up for it instead of being re-snatched by an endless stream of
        small requests. The bound from
        ``test_pop_admissible_bypass_is_bounded_by_slo_expiry`` still
        holds — the SLO-expiry backstop is unchanged — but with
        reservation the head typically admits long before it."""
        if not self.config.head_reservation:
            return pages_avail
        if is_head:
            if self._resv_rid is not None and self._resv_rid != req.rid:
                # the reserved request is no longer the head — admitted,
                # expired, or dropped. The reservation is head-scoped:
                # clear it, or its pages would be withheld from every
                # later admission forever
                self._resv_rid, self._resv_pages = None, 0
            if need <= pages_avail:
                # head fits: clear any reservation it accrued
                if self._resv_rid == req.rid:
                    self._resv_rid, self._resv_pages = None, 0
                return pages_avail
            if self._resv_rid != req.rid:
                self._resv_rid, self._resv_pages = req.rid, 0
            self._resv_pages = min(need, self._resv_pages + 1)
            return pages_avail
        if self._resv_rid is None:
            return pages_avail
        return max(0, pages_avail - self._resv_pages)

    # --------------------------------------------------------- feedback
    def observe(self, res: StepResult, now: float) -> List[Request]:
        """Fold one tick's ``StepResult`` back: bind admitted slots,
        record emitted tokens, complete exhausted requests (their slots
        free at the NEXT tick's plan). Returns the completed requests.

        Failure feedback: slots whose lazy grow failed
        (``failed_grows``) recompute-requeue — their slot frees at the
        next tick's plan; a failed admission batch
        (``admission_failed``, all-or-nothing rollback) requeues every
        staged request. Neither loses a request — previously a staged
        rid missing from ``admitted`` silently vanished."""
        for slot in res.failed_grows:
            r = self._resident.pop(slot, None)
            if r is None:
                continue
            self._to_free.append(slot)
            self.metrics.preemptions += 1
            self._requeue(r.req)
        for r in self._staged:
            slot = res.admitted.get(r.req.rid)
            # the engine settled every executed alias either way: an
            # admitted hit's pins now live in the slot's row; a failed
            # one's pins went back via release_hit. Neither is ours to
            # release any more (recover() handles never-executed plans)
            r.alias = None
            if slot is not None:
                self._resident[slot] = r
                self._tel_event("admitted", r.req, slot=slot)
            else:
                self._requeue(r.req)
        self._staged = []
        self._register_prompts()
        eng = self.engine
        if (self.config.spec_k > 0 and eng is not None
                and getattr(eng, "_draft", None) is not None):
            # capture each resident's SEED token (the prefill's argmax,
            # consumed by the first decode step but never emitted) once,
            # before its first decode — it is the one generated token
            # the streams don't record, and rebuilding a draft twin's
            # history after a desync needs it
            for slot, r in self._resident.items():
                if (not r.prefilling and r.seed_tok is None
                        and not self.streams[r.req.rid]):
                    r.seed_tok = eng.host_last_token(slot)
        for slot, toks in res.spec_tokens.items():
            r = self._resident.get(slot)
            if r is None:
                continue
            req = r.req
            if req.first_token < 0:
                req.first_token = now
                self._tel_event("first_token", req)
            req.tokens_out += len(toks)
            self.streams[req.rid].extend(toks)
            if req.tenant:
                tt = self.metrics.tenant_tokens
                tt[req.tenant] = tt.get(req.tenant, 0) + len(toks)
            k = self._spec_planned.pop(slot, None)
            if k:
                # toks = accepted draft tokens + the verify bonus, so
                # acceptance rate for the round is (len-1)/k
                self._spec_accept_ema = (0.9 * self._spec_accept_ema
                                         + 0.1 * (len(toks) - 1) / k)
        for slot, tok in res.tokens.items():
            r = self._resident.get(slot)
            if r is not None:
                req = r.req
                if req.first_token < 0:
                    req.first_token = now
                    self._tel_event("first_token", req)
                req.tokens_out += 1
                self.streams[req.rid].append(tok)
                if req.tenant:
                    tt = self.metrics.tenant_tokens
                    tt[req.tenant] = tt.get(req.tenant, 0) + 1
        completed: List[Request] = []
        for slot in res.done:
            r = self._resident.pop(slot, None)
            if r is None:
                continue
            self._to_free.append(slot)
            completed.append(r.req)
            # completed rids never re-admit: reclaim the prompt arrays
            # (streams stay — they are the tick plane's output surface)
            self._prompts.pop(r.req.rid, None)
        if completed and self.queue is not None:
            self.queue.complete(completed, now)
        for req in completed:
            self._tel_event("complete", req)
        if self.queue is not None:
            # the queue's per-cause counters are the accounting source of
            # truth; the metrics mirror them for PoolResult surfacing
            m = self.metrics
            m.cancelled = self.queue.cancelled
            m.deadline_aborted = self.queue.deadline_aborted
            m.shed = self.queue.shed
        self._reclaim_prompts()
        return completed

    def _reclaim_prompts(self) -> None:
        """Drop prompt arrays for rids no longer live anywhere (queued,
        resident, or staged) — requests SLO-expired inside ``pop_batch``
        would otherwise pin their token arrays forever. Amortized: only
        runs when the map has clearly outgrown the live set."""
        prompts = self._prompts
        if not prompts:
            return
        live_n = (len(self._resident) + len(self._staged)
                  + (len(self.queue) if self.queue is not None else 0))
        if len(prompts) <= max(64, 2 * live_n):
            return
        live = {r.req.rid for r in self._resident.values()}
        live.update(r.req.rid for r in self._staged)
        if self.queue is not None:
            live.update(self.queue.rids())
        for rid in [k for k in prompts if k not in live]:
            del prompts[rid]

    # ---------------------------------------------------- pool admission
    def select_admissible(self, eng, q, prompt_len: int, max_batch: int,
                          now: float, gen_len: int,
                          drop_expired: bool = True
                          ) -> List[Tuple[Request, int]]:
        """The single admission gate ``EnginePool.admit`` AND ``topup``
        share: pop up to ``max_batch`` requests the engine can back — a
        free slot and pages for each request's reserved horizon (whole
        prompt + n_tokens budget, or just the prompt under
        ``PlannerConfig.lazy``). With ``PlannerConfig.tiers`` set, the
        pop order is the tiered/tenant-fair pick (``TieredAdmission``)
        instead of strict FIFO — every gate below is unchanged.
        Requests the pool cannot back go
        straight back to the queue, counted in ``blocked_on_memory``
        once over their lifetime; a page-blocked FIFO head accrues an
        aging page reservation that bypassing smaller requests cannot
        spend (anti-starvation). Returns [(request, token budget)] in
        queue order — except that with the prefix cache on, kept
        requests whose prompts are HOT in the radix cache (a read-only
        ``PrefixCache.peek`` covers at least the ``prefix_min_frac``
        floor) stable-sort ahead of cold ones: a hot admission aliases
        pages instead of prefilling, so serving it first spends strictly
        less of the pool. Pop order — and with it the head-reservation /
        aging anti-starvation contract — is unchanged; only the order
        WITHIN the admitted batch moves."""
        lazy = self.config.lazy
        gen_len = max(1, gen_len)
        room = max(1, eng.slot_len - prompt_len)
        cap = min(max_batch, eng.free_slots)
        pages_left = eng.free_pages
        kept: List[Tuple[Request, int]] = []
        blocked: List[Request] = []
        is_head = True
        # scan deeper than the cap: page-blocked requests must not consume
        # batch quota, or admissible requests behind them under-fill the
        # run in exactly the page-constrained regime paging targets.
        # Blocked requests are re-pushed only AFTER the scan, so the pop
        # can never retrieve the same request twice.
        while len(kept) < cap and len(q):
            req = self._pop_next(q, now, drop_expired)
            if req is None:
                break                       # remainder all expired
            budget = max(1, req.n_tokens if req.n_tokens > 0 else gen_len)
            if eng.paged:
                budget = min(budget, room)
                full = eng.kv_pages_needed(
                    min(prompt_len + budget, eng.slot_len))
                if full > eng.total_pages:
                    # full residency exceeds the whole pool: never
                    # completable — under lazy reservation it would
                    # admit and then preempt-requeue-thrash forever.
                    # Drop loudly instead (same guard as the tick plane)
                    q.violated += 1
                    q.dropped += 1
                    is_head = False
                    continue
                horizon = prompt_len + 1 if lazy else prompt_len + budget
                need = eng.kv_pages_needed(min(horizon, eng.slot_len))
                left = self._page_gate(req, is_head, need, pages_left)
                if left is None:
                    blocked.append(req)
                    is_head = False
                    continue
                pages_left = left
            kept.append((req, budget))
            self._note_admitted(req, prompt_len + budget, q, blocked)
            is_head = False
        for req in blocked:
            q.push(req)
        cache = (getattr(eng, "prefix_cache", None)
                 if self.config.prefix_cache else None)
        if cache is not None and eng.paged and len(kept) > 1:
            # hit-aware ordering: peek is strictly read-only (no clock
            # tick, no LRU touch, no pins) so probing here cannot
            # perturb eviction order or leak references
            floor = self._min_covered(eng, prompt_len)
            hot = []
            for req, _ in kept:
                batch = self._prompts.get(req.rid)
                toks = (None if batch is None else
                        [int(t) for t in np.asarray(batch["tokens"])[0]])
                hot.append(toks is not None and cache.peek(
                    toks, max_covered=prompt_len - 1) >= floor)
            if any(hot) and not all(hot):
                kept = ([rb for rb, h in zip(kept, hot) if h]
                        + [rb for rb, h in zip(kept, hot) if not h])
        return kept

    def admission_plan(self, batches: Sequence[Any],
                       kept: Sequence[Tuple[Request, int]],
                       eng=None) -> StepPlan:
        """Wrap a ``select_admissible`` result as a whole-prompt plan
        (the unchunked admission the pool plane runs). With ``eng``
        passed and the prefix cache on, prompts matching a cached prefix
        become zero-dispatch alias admissions — the pool completes their
        uncovered tail eagerly via ``InferenceEngine.catchup_prefill``
        right after the plan executes (the pool plane has no per-tick
        forced phase to ride)."""
        cache = (eng.prefix_cache
                 if eng is not None and self.config.prefix_cache else None)
        plan = StepPlan()
        for batch, (req, budget) in zip(batches, kept):
            p = _prompt_tokens(batch)
            hit = None
            if cache is not None and eng.paged:
                toks = [int(t) for t in np.asarray(batch["tokens"])[0]]
                hit = cache.match(toks, max_covered=p - 1,
                                  min_covered=self._min_covered(eng, p))
            if hit is not None:
                plan.admissions.append(PrefillChunk(
                    rid=req.rid, batch=batch, start=0, length=0,
                    final=False, n_tokens=budget,
                    reserve_tokens=(hit.covered + 1) if self.config.lazy
                    else None,
                    alias=hit))
                continue
            plan.admissions.append(PrefillChunk(
                rid=req.rid, batch=batch, start=0, length=p, final=True,
                n_tokens=budget,
                reserve_tokens=(p + 1) if self.config.lazy else None))
        return plan


# --------------------------------------------------------------------------
# tick serving loop (EventLoopHooks over the shared core event loop)
# --------------------------------------------------------------------------
class TickServer:
    """Drives one (engine, planner) pair through the shared discrete-event
    loop (``repro_torch.core.eventloop``): arrivals land in the planner's
    queue, and each due tick builds one plan, executes it, and observes the
    result. Virtual time advances ``tick_dt`` per tick; wall time per tick
    is recorded with the decode tokens it emitted, which is exactly the
    time-between-tokens series ``bench_decode --chunked-prefill``
    reports p99 over.

    Fault handling: an attached ``FaultInjector`` (``faults``) can mark a
    tick stuck — the dispatch "hung" and the watchdog killed it — and
    ``execute`` can escalate persistent transient faults to
    ``EngineFault``; both run the same recovery: engine reset +
    recompute-requeue of every resident (``recoveries``/``stuck_ticks``
    count them). ``on_tick`` is a scripting hook ``f(server, now)``
    called before each tick's plan — the chaos suite drives cancellations
    through it. ``stall_limit`` arms a no-progress watchdog: that many
    consecutive ticks with an empty result force a recovery rather than
    spinning forever."""

    def __init__(self, planner: StepPlanner, prompt_fn,
                 tick_dt: float = 1e-3, faults=None, on_tick=None,
                 stall_limit: Optional[int] = None):
        self.planner = planner
        self.prompt_fn = prompt_fn
        self.tick_dt = tick_dt
        self.faults = faults
        self.on_tick = on_tick
        self.stall_limit = stall_limit
        self.ticks = 0
        self.dispatches = 0
        self.peak_resident = 0
        self.stuck_ticks = 0
        self.recoveries = 0            # engine resets (stuck + EngineFault)
        self._no_progress = 0
        # engines persist across servers (warm executables); report fault
        # stats as deltas from this serve's start
        self._retries0 = planner.engine.stats.engine_retries
        self._resets0 = planner.engine.stats.engine_resets
        # (wall seconds, decode tokens emitted) per executed tick
        self.tick_walls: List[Tuple[float, int]] = []
        self._next_tick = 0.0
        q = planner.queue
        self._track = (f"tick/{q.model}" if q is not None
                       else f"tick/{planner.engine.cfg.name}")

    @property
    def telemetry(self):
        """The planner's telemetry plane (read by the core event loop)."""
        return self.planner.telemetry

    # ----------------------------------------------------- EventLoopHooks
    def deliver(self, req: Request) -> None:
        self.planner.submit(req, self.prompt_fn(req))

    def next_completion(self) -> float:
        return self._next_tick if self.planner.busy() else math.inf

    def next_wakeup(self, now: float) -> float:
        return math.inf

    def advance(self, t: float) -> None:
        pass

    def _mirror_fault_stats(self) -> None:
        stats = self.planner.engine.stats
        m = self.planner.metrics
        m.engine_retries = stats.engine_retries - self._retries0
        m.engine_resets = stats.engine_resets - self._resets0

    def _recover(self, now: float) -> None:
        self.recoveries += 1
        self.planner.recover(now)
        self._mirror_fault_stats()

    def fire(self, now: float, epsilon: float = 1e-12) -> int:
        if not self.planner.busy():
            return 0
        tel = self.planner.telemetry
        if tel is None or tel.trace is None:
            return self._fire(now, None)
        # one span per executed tick on the server's own track; the
        # engine's execute/dispatch spans nest on the engine track
        with tel.trace.span(self._track, "tick", tick=self.ticks):
            return self._fire(now, tel.trace)

    def _fire(self, now: float, trace) -> int:
        import time as _time
        # the tick always reschedules, whatever happens below — a faulted
        # tick that forgot to advance _next_tick would spin the loop at
        # one instant until the max_events backstop
        self._next_tick = now + self.tick_dt
        if self.on_tick is not None:
            self.on_tick(self, now)
        if trace is None:
            plan = self.planner.build(now)
        else:
            with trace.span(self._track, "plan"):
                plan = self.planner.build(now)
        eng = self.planner.engine
        if self.faults is not None and self.faults.stuck():
            # watchdog-killed tick: the plan's bookkeeping was already
            # mutated, but recovery drops ALL in-flight state (residents
            # requeue, engine releases every slot), so the half-built
            # tick leaves no trace
            self.stuck_ticks += 1
            self._recover(now)
            return 1
        t0 = _time.perf_counter()
        try:
            res = eng.execute(plan)
        except EngineFault:
            self._recover(now)
            return 1
        wall = _time.perf_counter() - t0
        if trace is None:
            self.planner.observe(res, now)
        else:
            s = trace.now()
            self.planner.observe(res, now)
            trace.complete(self._track, "observe", s, trace.now() - s,
                           cat="host")
        self.ticks += 1
        self.dispatches += res.dispatches
        self.peak_resident = max(self.peak_resident,
                                 eng.n_slots - eng.free_slots)
        self.tick_walls.append((wall, len(res.tokens)))
        self._mirror_fault_stats()
        progress = bool(res.tokens or res.done or res.admitted
                        or res.failed_grows or plan.admissions
                        or plan.forced or plan.frees or plan.cancels
                        or plan.preemptions)
        if progress:
            self._no_progress = 0
        elif self.stall_limit is not None:
            self._no_progress += 1
            if self._no_progress >= self.stall_limit:
                # the loop is live but the plane is wedged (should be
                # impossible — the planner's stall-breaker preempts
                # first); reset rather than spin forever
                self._recover(now)
                self._no_progress = 0
        return 1

    def plan(self, now: float) -> None:
        if self._next_tick <= now and self.planner.busy():
            self._next_tick = now + self.tick_dt

    def drained(self) -> bool:
        return not self.planner.busy()


def serve_ticks(planner: StepPlanner, requests: Sequence[Request],
                prompt_fn, *, max_ticks: int = 100_000, faults=None,
                on_tick=None, stall_limit: Optional[int] = None
                ) -> TickServer:
    """Convenience entry point: serve ``requests`` (arrivals honored in
    virtual tick time) to completion through the plan API. Returns the
    ``TickServer`` whose ``planner.streams`` holds every request's
    emitted tokens and whose ``tick_walls`` holds the TBT series.
    ``faults``/``on_tick``/``stall_limit`` pass through to the server —
    the chaos harness's entry point."""
    from repro_torch.core.eventloop import LoopConfig, run_event_loop

    server = TickServer(planner, prompt_fn, faults=faults, on_tick=on_tick,
                        stall_limit=stall_limit)

    class _Listed:
        """Adapter: materialize_arrivals expects generator-likes."""
        rate = 0.0

        def __init__(self, reqs):
            self._reqs = list(reqs)

        def until(self, t_end):
            out = [r for r in self._reqs if r.arrival < t_end]
            self._reqs = [r for r in self._reqs if r.arrival >= t_end]
            return out

    horizon = max((r.arrival for r in requests), default=0.0) + 1e-6
    out = run_event_loop(
        LoopConfig(duration=horizon, drain=True, arrival_horizon=horizon,
                   max_time=math.inf, max_events=max_ticks),
        [_Listed(requests)], server)
    server.truncated = out.truncated
    return server
