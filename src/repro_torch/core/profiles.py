"""Per-model serving profiles — the paper's Table 6 for the 10-arch zoo.

A profile bundles everything the scheduler needs about one hosted model:
the roofline latency function f_L(units, batch), the knee allocation, the
SLO, and the efficacy-optimal (batch, units) operating point, on one
``Hardware`` (default ``H100``: units are GPU percent). SLOs follow
the paper's construction (§6.1): latency-critical models get 25 ms,
mid-size 50 ms, compute-heavy 100/200 ms — all ≥ 2·f_L(knee, b_opt) so a
feasible operating point exists (Eq. 12).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import efficacy as eff
from repro_torch.core.hardware import H100, Hardware
from repro_torch.core.latency_model import LatencyModel

# paper-style SLO classes (seconds)
DEFAULT_SLOS = {
    "qwen2-0.5b": 0.025,
    "whisper-small": 0.025,
    "mamba2-1.3b": 0.025,
    "olmo-1b": 0.025,
    "granite-moe-3b-a800m": 0.050,
    "deepseek-7b": 0.050,
    "phi3.5-moe-42b-a6.6b": 0.100,
    "yi-9b": 0.100,
    "zamba2-7b": 0.100,
    "chameleon-34b": 0.200,
}


@dataclasses.dataclass
class ModelProfile:
    name: str
    cfg: ModelConfig
    lm: LatencyModel
    slo: float
    knee_chips: int
    opt_batch: int
    opt_chips: int
    max_batch: int = 64
    hw: Hardware = H100

    @property
    def knee_frac(self) -> float:
        return self.knee_chips / self.hw.chips_per_pod

    @property
    def opt_frac(self) -> float:
        return self.opt_chips / self.hw.chips_per_pod

    def latency(self, chips: int, batch: int, multiplexed: bool = True) -> float:
        lat = self.lm.latency(chips, batch)
        if multiplexed:
            lat *= 1.0 + self.hw.multiplex_dilation
        return lat

    def runtime(self, batch: Optional[int] = None,
                chips: Optional[int] = None) -> float:
        """Paper Table 6 'Runtime': latency at the chosen operating point."""
        return self.latency(chips or self.opt_chips, batch or self.opt_batch)

    def min_chips(self, batch: Optional[int] = None) -> int:
        return self.lm.min_chips_to_fit(batch or self.opt_batch)

    def feasible_batch_for(self, budget_s: float, chips: int,
                           queue_len: int) -> int:
        """Largest batch <= queue_len finishing within ``budget_s``."""
        best = 0
        for b in range(1, min(self.max_batch, max(queue_len, 0)) + 1):
            if self.latency(chips, b) <= budget_s:
                best = b
            else:
                break
        return best


def build_profile(name: str, *, mode: str = "prefill", seq: int = 128,
                  slo: Optional[float] = None,
                  request_rate: float = 500.0,
                  hw: Hardware = H100) -> ModelProfile:
    """Raises ``ValueError`` when no allocation of ``hw`` holds the model
    (on the H100: more weights than one card's memory)."""
    cfg = get_config(name)
    lm = LatencyModel(cfg, mode=mode, seq=seq, hw=hw)
    slo = slo if slo is not None else DEFAULT_SLOS.get(cfg.name, 0.1)
    knee = lm.knee_chips(16)
    pt = eff.optimize(lm, slo=slo, request_rate=request_rate)
    # paper §5: pick from the high-efficacy region, then over-provision 5-10%
    opt_chips = pt.chips
    levels = hw.levels
    idx = levels.index(opt_chips) if opt_chips in levels else None
    if pt.feasible and idx is not None and idx + 1 < len(levels):
        # one level of headroom if it still fits the knee budget
        if levels[idx + 1] <= max(knee, opt_chips):
            opt_chips = levels[idx + 1]
    return ModelProfile(
        name=cfg.name, cfg=cfg, lm=lm, slo=slo, knee_chips=knee,
        opt_batch=pt.batch, opt_chips=opt_chips, hw=hw)


def default_zoo(names: Optional[Sequence[str]] = None,
                rates: Optional[Dict[str, float]] = None,
                hw: Hardware = H100) -> Dict[str, ModelProfile]:
    names = list(names or ARCHS.keys())
    out = {}
    for n in names:
        rate = (rates or {}).get(n, 500.0)
        prof = build_profile(n, request_rate=rate, hw=hw)
        out[prof.name] = prof
    return out
