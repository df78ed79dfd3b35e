"""Production traffic scenarios: seeded arrival traces with SLO tiers
and tenant mixes — a copy of the JAX package's ``repro.serving.traffic``
(numpy only).

The serving planes below the gateway consume ``Request`` lists; this
module generates them the way production traffic actually arrives —
Poisson at steady state, diurnally modulated over long horizons,
heavy-tailed in size, and bursty per tenant ("Batching or
Multi-Tenancy?", arXiv:2308.13803, is the trade-off these traces
reproduce). Every generator is a pure function of its seed: the same
``(scenario, seed, horizon, rate)`` tuple yields byte-identical traces,
which is what lets the gateway bench compare admission policies at
EXACTLY equal offered load and the chaos suite replay runs bit-exactly.

Requests are stamped with a tier (``interactive``/``standard``/
``batch`` — each mapping to an SLO class scaled by ``slo_unit``) and a
tenant drawn from a weighted mix. ``synth_prompts`` turns a trace into
the per-rid prompt dicts (host numpy) the tick plane wants, seeded per rid so a
request's prompt is independent of which scenario drew it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.request import Request

# tier -> (admission weight, SLO in slo_unit multiples). The weights
# feed PlannerConfig.tiers; the SLO classes are deliberately an order
# of magnitude apart — interactive wants its tokens now, batch is
# throughput-only.
TIER_WEIGHTS: Dict[str, float] = {
    "interactive": 4.0, "standard": 2.0, "batch": 1.0}
TIER_SLO_UNITS: Dict[str, float] = {
    "interactive": 40.0, "standard": 150.0, "batch": 1500.0}


@dataclasses.dataclass
class TrafficConfig:
    """Knobs shared by every scenario generator."""
    model: str
    duration: float = 1.0              # arrival horizon (virtual seconds)
    rate: float = 60.0                 # mean arrivals per second
    seed: int = 0
    # (tenant, weight) mix — each arrival draws its tenant from this
    tenants: Tuple[Tuple[str, float], ...] = (
        ("acme", 1.0), ("globex", 1.0))
    # (tier, probability) mix — must cover TIER_SLO_UNITS keys only
    tier_mix: Tuple[Tuple[str, float], ...] = (
        ("interactive", 0.3), ("standard", 0.5), ("batch", 0.2))
    # one SLO "unit" in seconds: tier SLO = TIER_SLO_UNITS[tier] * unit.
    # Default calibrates to the tick planes' 1ms tick_dt
    slo_unit: float = 1e-3
    prompt_tokens: Tuple[int, int] = (4, 12)    # uniform, inclusive
    gen_tokens: Tuple[int, int] = (3, 8)
    rid0: int = 0                      # first rid (traces concatenate)


def _stamp(cfg: TrafficConfig, rng, t: float, rid: int, *,
           tier: Optional[str] = None, tenant: Optional[str] = None,
           prompt_len: Optional[int] = None,
           n_tokens: Optional[int] = None) -> Request:
    if tier is None:
        names = [n for n, _ in cfg.tier_mix]
        probs = np.asarray([w for _, w in cfg.tier_mix], float)
        tier = names[int(rng.choice(len(names), p=probs / probs.sum()))]
    if tenant is None:
        names = [n for n, _ in cfg.tenants]
        probs = np.asarray([w for _, w in cfg.tenants], float)
        tenant = names[int(rng.choice(len(names), p=probs / probs.sum()))]
    lo, hi = cfg.prompt_tokens
    p = int(rng.integers(lo, hi + 1)) if prompt_len is None else prompt_len
    lo, hi = cfg.gen_tokens
    n = int(rng.integers(lo, hi + 1)) if n_tokens is None else n_tokens
    return Request(arrival=float(t), rid=rid, model=cfg.model,
                   slo=TIER_SLO_UNITS[tier] * cfg.slo_unit,
                   n_tokens=max(1, n), prompt_len=max(1, p),
                   tier=tier, tenant=tenant)


def _finish(reqs: List[Request], rid0: int) -> List[Request]:
    """Sort by arrival and assign consecutive rids in arrival order —
    the rid IS the arrival index, which keeps per-rid prompt synthesis
    and stream bookkeeping stable across policy comparisons."""
    reqs.sort(key=lambda r: r.arrival)
    for i, r in enumerate(reqs):
        r.rid = rid0 + i
    return reqs


def poisson_trace(cfg: TrafficConfig) -> List[Request]:
    """Homogeneous Poisson arrivals: exponential inter-arrival gaps at
    ``cfg.rate`` — the steady-state baseline every queueing result
    assumes."""
    rng = np.random.default_rng(cfg.seed)
    reqs: List[Request] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / cfg.rate))
        if t >= cfg.duration:
            break
        reqs.append(_stamp(cfg, rng, t, 0))
    return _finish(reqs, cfg.rid0)


def diurnal_trace(cfg: TrafficConfig, *, period: Optional[float] = None,
                  amplitude: float = 0.8) -> List[Request]:
    """Nonhomogeneous Poisson with a sinusoidal day/night rate:
    rate(t) = rate * (1 + amplitude * sin(2*pi*t/period)), generated by
    thinning against the peak rate (Lewis & Shedler) so the trace is a
    true Poisson process at every instant. ``period`` defaults to the
    horizon (one full "day" per run)."""
    if not 0.0 <= amplitude <= 1.0:
        raise ValueError("amplitude must be in [0, 1]")
    period = cfg.duration if period is None else period
    rng = np.random.default_rng(cfg.seed)
    peak = cfg.rate * (1.0 + amplitude)
    reqs: List[Request] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / peak))
        if t >= cfg.duration:
            break
        rate_t = cfg.rate * (1.0 + amplitude * math.sin(
            2.0 * math.pi * t / period))
        if rng.uniform() * peak <= rate_t:
            reqs.append(_stamp(cfg, rng, t, 0))
    return _finish(reqs, cfg.rid0)


def heavy_tailed_trace(cfg: TrafficConfig, *,
                       alpha: float = 1.5) -> List[Request]:
    """Poisson arrivals whose prompt and decode lengths are Pareto
    (shape ``alpha``, clamped to the configured ranges): most requests
    are small, a heavy tail is large — the regime where chunked prefill
    and per-request budgets earn their keep."""
    rng = np.random.default_rng(cfg.seed)

    def pareto(lo: int, hi: int) -> int:
        x = lo * (1.0 + rng.pareto(alpha))
        return int(min(hi, max(lo, x)))

    reqs: List[Request] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / cfg.rate))
        if t >= cfg.duration:
            break
        reqs.append(_stamp(
            cfg, rng, t, 0,
            prompt_len=pareto(*cfg.prompt_tokens),
            n_tokens=pareto(*cfg.gen_tokens)))
    return _finish(reqs, cfg.rid0)


def burst_trace(cfg: TrafficConfig, *, burst_start: Optional[float] = None,
                burst_frac: float = 0.25, burst_mult: float = 6.0,
                burst_tenant: Optional[str] = None,
                burst_tier: str = "batch") -> List[Request]:
    """The mixed-SLO burst scenario the gateway bench's acceptance
    criterion runs: background Poisson traffic with the configured
    tier/tenant mixes, plus a window of ``burst_mult`` x extra arrivals
    all from ONE tenant at ONE (low) tier — the "one tenant floods the
    queue with batch work" pattern tiered, tenant-fair admission exists
    to absorb. Under strict FIFO the flood queues ahead of every
    later-arriving interactive request; under tiers it cannot."""
    rng = np.random.default_rng(cfg.seed)
    if burst_tenant is None:
        burst_tenant = cfg.tenants[-1][0]
    burst_start = (cfg.duration * 0.25 if burst_start is None
                   else burst_start)
    burst_end = burst_start + cfg.duration * burst_frac
    reqs: List[Request] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / cfg.rate))
        if t >= cfg.duration:
            break
        reqs.append(_stamp(cfg, rng, t, 0))
    t = burst_start
    burst_rate = cfg.rate * (burst_mult - 1.0)
    while True:
        t += float(rng.exponential(1.0 / burst_rate))
        if t >= burst_end:
            break
        reqs.append(_stamp(cfg, rng, t, 0, tier=burst_tier,
                           tenant=burst_tenant))
    return _finish(reqs, cfg.rid0)


SCENARIOS = {
    "poisson": poisson_trace,
    "diurnal": diurnal_trace,
    "heavy_tailed": heavy_tailed_trace,
    "burst": burst_trace,
}


def make_scenario(name: str, cfg: TrafficConfig, **kw) -> List[Request]:
    """Generate a named scenario trace. Unknown names raise with the
    available set — the bench's CLI surface."""
    try:
        gen = SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; one of {sorted(SCENARIOS)}")
    return gen(cfg, **kw)


def synth_prompts(requests: Sequence[Request], vocab: int,
                  seed: int = 0) -> Dict[int, Any]:
    """Per-rid prompt pytrees for a trace: rid ``r`` draws
    ``prompt_len`` tokens from ``default_rng(seed + rid)`` — a request's
    prompt depends only on its rid, never on the scenario or policy, so
    two runs over the same trace feed bit-identical inputs."""
    out: Dict[int, Any] = {}
    for r in requests:
        rng = np.random.default_rng(seed + r.rid)
        toks = rng.integers(0, vocab, size=(1, max(1, r.prompt_len)),
                            dtype=np.int32)
        out[r.rid] = {"tokens": toks}
    return out


def offered_by(requests: Sequence[Request], attr: str) -> Dict[str, int]:
    """Offered-load histogram by ``tier`` or ``tenant`` — the
    denominator for per-class SLO attainment."""
    out: Dict[str, int] = {}
    for r in requests:
        k = getattr(r, attr)
        out[k] = out.get(k, 0) + 1
    return out


def attainment_by(requests: Sequence[Request],
                  attr: str) -> Dict[str, float]:
    """Fraction of each class's offered requests that completed ON TIME
    (state ``completed`` and ``finish <= deadline``). Sheds, aborts,
    cancels, and late completions all count against the class — this is
    goodput per class, not throughput."""
    offered = offered_by(requests, attr)
    ontime: Dict[str, int] = {}
    for r in requests:
        if r.state == "completed" and 0 <= r.finish <= r.deadline:
            k = getattr(r, attr)
            ontime[k] = ontime.get(k, 0) + 1
    return {k: ontime.get(k, 0) / n for k, n in offered.items() if n}
