"""Unified serving metrics for the engine pool (paper §7 reporting).

One ``PoolResult`` per (policy, workload) run carries everything the
paper's comparison tables need: per-model throughput, completion-latency
p50/p99, SLO violations (dropped + late-but-served), GPU runtime shares,
the Jain fairness index over those shares (§6.3 / Fig. 10), and the
pool's allocation occupancy (the real-engine analogue of the simulator's
knee-credited utilization)."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence


def jain_index(values: Sequence[float]) -> float:
    """Jain's fairness index (Σx)² / (n·Σx²) over non-negative shares:
    1.0 when all shares are equal, 1/n when one consumer has everything.
    Empty or all-zero input is vacuously fair (1.0)."""
    vals = [max(0.0, float(v)) for v in values]
    n = len(vals)
    ss = sum(v * v for v in vals)
    if n == 0 or ss <= 0.0:
        return 1.0
    tot = sum(vals)
    return (tot * tot) / (n * ss)


def percentile(xs: Sequence[float], q: float,
               default: float = float("nan")) -> float:
    """Nearest-rank percentile (q in [0, 1]) of ``xs``."""
    if not xs:
        return default
    s = sorted(xs)
    idx = min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))
    return s[idx]


@dataclasses.dataclass
class ModelPoolMetrics:
    """Per-model accounting over one pool run."""
    completed: int = 0
    violated: int = 0          # dropped-expired + late-but-served + queued
    dropped: int = 0
    late: int = 0
    # admitted into KV slots but still decoding when the run was cut off
    # at duration — counted in neither completed nor violated (mirrors the
    # simulator's accounting) but reported so they can't vanish silently
    abandoned: int = 0
    runs: int = 0
    # allocation-quantization divergences from the policy's own ledger
    # (see EnginePool.admit): upgrades ran the smallest pre-built engine
    # because no standby was <= the ask (more chips than budgeted);
    # downgrades got fewer chips than asked (slower than budgeted)
    alloc_upgrades: int = 0
    alloc_downgrades: int = 0
    # paged-KV admission accounting: requests refused at least once
    # because the page pool (KV memory), not slot count or chips,
    # couldn't back their prompt + n_tokens horizon (counted once per
    # request, however many planning cycles it sat blocked); and requests
    # inserted into a running run's early-freed slots (mid-run
    # re-admission)
    blocked_on_memory: int = 0
    topups: int = 0
    # lazy page reservation (StepPlanner): residents evicted because the
    # page pool ran dry mid-decode/mid-prefill (their pages freed), and
    # their requests pushed straight back to the queue for a
    # from-scratch re-prefill on re-admission (vLLM-style recompute
    # preemption). Every preemption requeues immediately, so the two
    # counters track together; a requeued request that then expires is
    # additionally counted dropped/violated like any other
    preemptions: int = 0
    requeues: int = 0
    # per-cause terminal counters. With completed/dropped these
    # partition every request the plane ever accepted or refused:
    #   cancelled        — client cancel, queued or resident (no violation)
    #   deadline_aborted — evicted while resident, past SLO deadline
    #   shed             — refused at admission (load-shed watermarks)
    # Mirrored from RequestQueue (the accounting source of truth) at
    # snapshot/observe time, never incremented here directly.
    cancelled: int = 0
    deadline_aborted: int = 0
    shed: int = 0
    # fault-tolerance accounting, mirrored from EngineStats: transient
    # dispatch faults absorbed by retry, and full engine resets (retries
    # exhausted or stuck tick) that recompute-requeued the residents
    engine_retries: int = 0
    engine_resets: int = 0
    # radix prompt cache, mirrored from EngineStats: admissions
    # whose prefix aliased cached pages instead of prefilling, the prompt
    # tokens those hits skipped, and copy-on-write page copies for hits
    # that diverged mid-page
    prefix_hits: int = 0
    prefix_hit_tokens: int = 0
    cow_copies: int = 0
    # speculative decoding, mirrored from EngineStats: draft
    # tokens proposed, draft tokens the target accepted, verify rounds
    # dispatched, and rounds that rolled at least one token back
    draft_tokens: int = 0
    accepted_tokens: int = 0
    spec_rounds: int = 0
    rollbacks: int = 0
    runtime: float = 0.0       # virtual busy seconds (Σ run latencies)
    chip_seconds: float = 0.0  # allocation-weighted: Σ chips·latency
    tokens: int = 0
    latencies: List[float] = dataclasses.field(default_factory=list)
    # streaming latency views, mirrored from RequestQueue like latencies:
    # TTFT (arrival → first token) of completed requests, and mean
    # time-between-tokens per completed request — the figures that make
    # chunked-prefill TBT wins visible in PoolResult
    ttfts: List[float] = dataclasses.field(default_factory=list)
    tbts: List[float] = dataclasses.field(default_factory=list)
    # multi-tenant serving: decode tokens served per tenant,
    # populated by the planner's observe only for requests that carry a
    # tenant label — single-tenant planes pay nothing. Jain over these
    # values is the per-tenant fairness figure the gateway bench reports.
    tenant_tokens: Dict[str, int] = dataclasses.field(default_factory=dict)

    def throughput(self, duration: float) -> float:
        return self.completed / duration if duration > 0 else 0.0

    def tenant_fairness(self) -> float:
        """Jain index over per-tenant served decode tokens (1.0 when no
        tenant labels were seen — vacuously fair)."""
        return jain_index(list(self.tenant_tokens.values()))

    @property
    def p50(self) -> float:
        return percentile(self.latencies, 0.50)

    @property
    def p99(self) -> float:
        return percentile(self.latencies, 0.99)

    @property
    def ttft_p50(self) -> float:
        return percentile(self.ttfts, 0.50)

    @property
    def ttft_p99(self) -> float:
        return percentile(self.ttfts, 0.99)

    @property
    def tbt_p50(self) -> float:
        return percentile(self.tbts, 0.50)

    @property
    def tbt_p99(self) -> float:
        return percentile(self.tbts, 0.99)


@dataclasses.dataclass
class PoolResult:
    policy: str
    duration: float            # virtual seconds the schedule spans
    wall_s: float              # host wall-clock spent executing it
    per_model: Dict[str, ModelPoolMetrics]
    occupancy: float           # ∫ min(alloc_frac, 1) dt / duration
    # ∫ (KV pages in use / usable pages) dt / duration — how hard the
    # paged cache memory is actually working (0.0 for unpaged pools)
    page_occupancy: float = 0.0
    steps: int = 0             # real engine decode dispatches issued
    truncated: bool = False    # hit a controller backstop (max_steps /
                               # max_time) — metrics cover a partial run

    @property
    def total_tokens(self) -> int:
        return sum(m.tokens for m in self.per_model.values())

    @property
    def total_completed(self) -> int:
        return sum(m.completed for m in self.per_model.values())

    @property
    def total_violated(self) -> int:
        return sum(m.violated for m in self.per_model.values())

    def throughput(self, model: Optional[str] = None) -> float:
        if model:
            return self.per_model[model].throughput(self.duration)
        return self.total_completed / self.duration if self.duration else 0.0

    def fairness(self, key: str = "runtime") -> float:
        """Jain index over per-model shares — ``runtime`` (the paper's
        Fig. 10 measure: accelerator time each model received) or
        ``chip_seconds`` (allocation-weighted) or ``completed``."""
        return jain_index([getattr(m, key) for m in self.per_model.values()])

    # ------------------------------------------------------------- display
    def table_rows(self) -> List[str]:
        rows = [
            f"{self.policy:16s} thr={self.throughput():8.1f}/s "
            f"tok/s={self.total_tokens / self.duration:9.0f} "
            f"viol={self.total_violated:5d} "
            f"jain={self.fairness():.3f} occ={self.occupancy:.3f} "
            f"pages={self.page_occupancy:.3f} "
            f"steps={self.steps} wall={self.wall_s:.2f}s"
            + (" [TRUNCATED]" if self.truncated else "")]
        for n, m in sorted(self.per_model.items()):
            rows.append(
                f"    {n:26s} served={m.completed:5d} viol={m.violated:4d} "
                f"p50={m.p50 * 1e3:7.2f}ms p99={m.p99 * 1e3:7.2f}ms "
                f"runtime={m.runtime * 1e3:8.2f}ms runs={m.runs}"
                + (f" ttft_p50={m.ttft_p50 * 1e3:.2f}ms"
                   f" ttft_p99={m.ttft_p99 * 1e3:.2f}ms"
                   if m.ttfts else "")
                + (f" tbt_p50={m.tbt_p50 * 1e3:.2f}ms" if m.tbts else "")
                + (f" alloc_up={m.alloc_upgrades}"
                   if m.alloc_upgrades else "")
                + (f" alloc_down={m.alloc_downgrades}"
                   if m.alloc_downgrades else "")
                + (f" mem_blocked={m.blocked_on_memory}"
                   if m.blocked_on_memory else "")
                + (f" topups={m.topups}" if m.topups else "")
                + (f" preempt={m.preemptions}/{m.requeues}"
                   if m.preemptions else "")
                + (f" abandoned={m.abandoned}" if m.abandoned else "")
                + (f" cancelled={m.cancelled}" if m.cancelled else "")
                + (f" aborted={m.deadline_aborted}"
                   if m.deadline_aborted else "")
                + (f" shed={m.shed}" if m.shed else "")
                + (f" retries={m.engine_retries}"
                   if m.engine_retries else "")
                + (f" resets={m.engine_resets}" if m.engine_resets else "")
                + (f" pfx_hits={m.prefix_hits}({m.prefix_hit_tokens}tok)"
                   if m.prefix_hits else "")
                + (f" cow={m.cow_copies}" if m.cow_copies else "")
                + (f" spec={m.accepted_tokens}/{m.draft_tokens}"
                   f"({m.spec_rounds}r,{m.rollbacks}rb)"
                   if m.spec_rounds else ""))
        return rows
