"""Inference requests and SLO-aware batch assembly.

Mirrors the paper's workload model (§5/§7): requests arrive for a named
model at some rate; the batcher assembles up to ``batch_size`` requests, and
the scheduler must finish ``assembly + inference`` within the SLO (paper
Eq. 11), keeping inference itself under SLO/2 (Eq. 12).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional


@dataclasses.dataclass(order=True)
class Request:
    arrival: float
    rid: int = dataclasses.field(compare=False)
    model: str = dataclasses.field(compare=False)
    slo: float = dataclasses.field(compare=False)          # seconds
    # decode tokens this request wants. 0 means "scheduler default"
    # (ControllerConfig.gen_len); a positive value is honored as the
    # slot's per-request token budget — mixed values make runs ragged,
    # free slots early, and shrink the pages the request pins.
    n_tokens: int = dataclasses.field(compare=False, default=0)
    # prompt tokens this request carries. 0 means "caller default" (the
    # pool plane's uniform host prompt_len); a positive value lets the
    # tick plane (repro_torch.serving.plan) synthesize per-request prompt
    # lengths — long prompts are what chunked prefill splits across ticks.
    prompt_len: int = dataclasses.field(compare=False, default=0)
    # lifecycle terminal cause:
    #   pending -> completed | cancelled | deadline_aborted | shed
    # "pending" covers queued/resident/requeued — a request has no
    # intermediate persisted state because preemption and engine resets
    # recompute from scratch. The queue's per-cause counters (not this
    # field) are the accounting source of truth; state is introspection.
    state: str = dataclasses.field(compare=False, default="pending")
    # streaming progress: virtual time the FIRST decode token was
    # observed (-1.0 = none yet) and tokens emitted so far. Reset on
    # every requeue (preemption / failed grow / engine reset) — recompute
    # discards emitted tokens, so TTFT is the time to the first token of
    # the attempt that actually completed, matching what a streaming
    # client replaying the stream would see.
    first_token: float = dataclasses.field(compare=False, default=-1.0)
    tokens_out: int = dataclasses.field(compare=False, default=0)
    # multi-tenant serving: the submitting tenant ("" = the
    # single-tenant planes, which never read it) and the priority tier.
    # Tier names are free-form; the planner's TieredAdmission maps them
    # to weights (interactive > standard > batch by default) and falls
    # back to the default tier's weight for unknown names.
    tenant: str = dataclasses.field(compare=False, default="")
    tier: str = dataclasses.field(compare=False, default="standard")
    # virtual/wall time the request completed (-1.0 = not completed) —
    # lets post-hoc analysis (the traffic bench's per-tier SLO
    # attainment) join finish vs deadline without replaying counters.
    finish: float = dataclasses.field(compare=False, default=-1.0)

    @property
    def deadline(self) -> float:
        return self.arrival + self.slo

    def reset_stream(self) -> None:
        """Forget streaming progress on requeue-for-recompute."""
        self.first_token = -1.0
        self.tokens_out = 0


class RequestQueue:
    """Per-model FIFO with SLO accounting."""

    def __init__(self, model: str, slo: float, track_latency: bool = True):
        self.model = model
        self.slo = slo
        self.track_latency = track_latency
        self._q: List[Request] = []
        self.completed = 0
        self.violated = 0      # dropped + late + aborted + shed
        self.dropped = 0       # expired before ever being scheduled
        self.late = 0          # served, but finished past the deadline
        # per-cause terminal counters: with `completed` and
        # `dropped` these partition every request that ever entered the
        # serving plane — the chaos suite asserts they sum to offered load
        self.cancelled = 0         # client cancel (not an SLO violation)
        self.deadline_aborted = 0  # evicted while resident, past deadline
        self.shed = 0              # refused at admission (overload)
        # arrival -> completion latency of every SERVED request — feeds
        # p50/p99 reporting (paper §7 tables). O(completed) memory, so the
        # analytic simulator (which never reads it) opts out.
        self.latencies: List[float] = []
        # TTFT (arrival → first token) per terminal cause, and mean
        # time-between-tokens for completed requests — the streaming
        # latency figures end-to-end latency hides (a chunked-prefill win
        # shows up here, not in `latencies`). Same track_latency opt-out.
        self.ttft_by_cause: Dict[str, List[float]] = {}
        self.tbts: List[float] = []

    def push(self, req: Request) -> None:
        # (re-)entering the queue always discards streaming progress:
        # requeued requests recompute from scratch, and test harnesses
        # re-serve the same Request objects across runs
        req.reset_stream()
        heapq.heappush(self._q, req)

    def __len__(self) -> int:
        return len(self._q)

    def oldest_deadline(self, default: float = float("inf")) -> float:
        return self._q[0].deadline if self._q else default

    def rids(self) -> set:
        """Rids currently queued — lets callers holding per-rid side
        state (the StepPlanner's prompt arrays) reclaim entries whose
        requests were dropped inside ``pop_batch``."""
        return {r.rid for r in self._q}

    def pop_batch(self, max_batch: int, now: float,
                  drop_expired: bool = True) -> List[Request]:
        """Pop up to ``max_batch`` requests; count already-expired as violations."""
        batch: List[Request] = []
        while self._q and len(batch) < max_batch:
            req = heapq.heappop(self._q)
            if drop_expired and req.deadline < now:
                req.state = "deadline_aborted"
                self.dropped += 1
                self.violated += 1
                continue
            batch.append(req)
        return batch

    def pop_pick(self, now: float, drop_expired: bool = True,
                 key=None) -> Optional[Request]:
        """Pop ONE request chosen by ``key`` (lowest key wins) instead of
        strict FIFO — the tiered-admission hook. Expired
        requests are dropped with the same accounting as ``pop_batch``
        regardless of key. ``key=None`` degenerates to ``pop_batch(1)``
        exactly (heap order: arrival). The keyed pick is an O(n) scan
        plus the same swap-with-last removal ``cancel`` uses — admission
        scans pop a handful per tick, so n stays small."""
        if key is None:
            got = self.pop_batch(1, now, drop_expired)
            return got[0] if got else None
        while self._q:
            best = min(range(len(self._q)), key=lambda i: key(self._q[i]))
            req = self._q[best]
            last = self._q.pop()
            if best < len(self._q):
                self._q[best] = last
                heapq.heapify(self._q)
            if drop_expired and req.deadline < now:
                req.state = "deadline_aborted"
                self.dropped += 1
                self.violated += 1
                continue
            return req
        return None

    def __iter__(self):
        """Iterate queued requests (heap order, NOT sorted) — read-only
        introspection for admission policies (starvation tracking)."""
        return iter(self._q)

    @property
    def ttfts(self) -> List[float]:
        """TTFT samples of COMPLETED requests (the headline figure)."""
        return self.ttft_by_cause.get("completed", [])

    def _record_ttft(self, cause: str, req: Request) -> None:
        if self.track_latency and req.first_token >= req.arrival:
            self.ttft_by_cause.setdefault(cause, []).append(
                req.first_token - req.arrival)

    # ------------------------------------------- lifecycle terminal causes
    def cancel(self, rid: int) -> Optional[Request]:
        """Remove a still-QUEUED request by rid (client disconnect before
        admission). Returns the request, or None if the rid is not queued
        — resident requests are cancelled through the planner/pool, which
        must also free their pages."""
        for i, r in enumerate(self._q):
            if r.rid == rid:
                last = self._q.pop()
                if i < len(self._q):
                    self._q[i] = last
                    heapq.heapify(self._q)
                self.mark_cancelled(r)
                return r
        return None

    def mark_cancelled(self, req: Request) -> None:
        """Terminal accounting for a client cancel. Not an SLO violation:
        the client walked away, the system didn't fail it."""
        req.state = "cancelled"
        self.cancelled += 1
        self._record_ttft("cancelled", req)

    def abort_deadline(self, req: Request) -> None:
        """Terminal accounting for a resident evicted past its deadline —
        an SLO violation (the system held it too long)."""
        req.state = "deadline_aborted"
        self.deadline_aborted += 1
        self.violated += 1
        self._record_ttft("deadline_aborted", req)

    def shed_request(self, req: Request) -> None:
        """Terminal accounting for a request refused at admission under
        overload — counted as a violation (the system couldn't serve it)
        but cheap: it failed fast instead of timing out resident."""
        req.state = "shed"
        self.shed += 1
        self.violated += 1

    def complete(self, batch: List[Request], finish_time: float) -> None:
        """Record served requests: completion latency (arrival→complete)
        always, and a violation for every late-but-served completion —
        serving a request past its deadline is an SLO miss just like
        dropping it (paper Eq. 11 counts end-to-end latency)."""
        for req in batch:
            req.state = "completed"
            req.finish = finish_time
            self.completed += 1
            if self.track_latency:
                self.latencies.append(finish_time - req.arrival)
                self._record_ttft("completed", req)
                if req.tokens_out > 1 and req.first_token >= 0:
                    self.tbts.append((finish_time - req.first_token)
                                     / (req.tokens_out - 1))
            if finish_time > req.deadline:
                self.late += 1
                self.violated += 1

    def latency_quantile(self, q: float,
                         default: float = float("nan")) -> float:
        """Nearest-rank quantile of served completion latencies (q in
        [0, 1]); ``default`` when nothing completed yet."""
        from repro_torch.serving.metrics import percentile
        return percentile(self.latencies, q, default)


def materialize_arrivals(generators, horizon: float,
                         drain: bool = False) -> List[Request]:
    """Materialize every generator's arrivals in [0, horizon), sorted.

    Shared by the analytic simulator and the engine-pool controller so
    drain/horizon semantics cannot diverge: a drain run over rate-based
    generators that produced no arrivals is an error (the pre-fix
    simulator silently simulated an empty workload)."""
    arrivals: List[Request] = []
    for g in generators:
        arrivals.extend(g.until(max(horizon, 1e-9)))
    if drain and not arrivals and any(
            getattr(g, "rate", 0) > 0 for g in generators):
        raise ValueError(
            "drain=True with rate-based generators produced no arrivals; "
            "set arrival_horizon (or duration) > 0")
    arrivals.sort(key=lambda r: r.arrival)
    return arrivals


class RequestGenerator:
    """Deterministic arrival stream (uniform-jittered, like the paper §6.3).

    ``gen_tokens`` stamps each request's decode budget (``n_tokens``): an
    int for a uniform workload, a ``(lo, hi)`` pair for a mixed-length
    stream (budget drawn uniformly, inclusive, from the same seeded rng as
    the arrival jitter — fully reproducible), or None to leave requests on
    the scheduler default. ``prompt_tokens`` stamps ``prompt_len`` the
    same way — per-request prompt lengths are what make chunked prefill
    (``repro_torch.serving.plan``) and packed ragged prefill earn their keep."""

    def __init__(self, model: str, rate_per_s: float, slo: float,
                 seed: int = 0, gen_tokens=None, prompt_tokens=None):
        import numpy as np
        self.model = model
        self.rate = rate_per_s
        self.slo = slo
        self.gen_tokens = gen_tokens
        self.prompt_tokens = prompt_tokens
        self._rng = np.random.default_rng(seed)
        self._next_id = 0
        self._t = 0.0

    def _draw(self, spec) -> int:
        if spec is None:
            return 0
        if isinstance(spec, int):
            return max(1, spec)
        lo, hi = spec
        return int(self._rng.integers(max(1, lo), max(1, hi) + 1))

    def _draw_tokens(self) -> int:
        return self._draw(self.gen_tokens)

    def until(self, t_end: float) -> List[Request]:
        """All requests arriving in [current position, t_end)."""
        out: List[Request] = []
        if self.rate <= 0:
            self._t = t_end
            return out
        mean_gap = 1.0 / self.rate
        while True:
            # uniformly-distributed inter-arrival in [0.5, 1.5]·mean (paper §6.3)
            gap = mean_gap * self._rng.uniform(0.5, 1.5)
            if self._t + gap >= t_end:
                self._t = t_end
                break
            self._t += gap
            out.append(Request(arrival=self._t, rid=self._next_id,
                               model=self.model, slo=self.slo,
                               n_tokens=self._draw_tokens(),
                               prompt_len=self._draw(self.prompt_tokens)))
            self._next_id += 1
        return out

    def set_rate(self, rate_per_s: float) -> None:
        self.rate = rate_per_s
