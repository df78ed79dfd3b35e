"""D-STACK: dynamic, fair, opportunistic spatio-temporal scheduling (§6).

Faithful mechanics:
  * **Sessions** — period = largest SLO among hosted models; a model with
    SLO_i must be scheduled ≥ session/SLO_i times per session (§6.1).
  * **EDF mandatory pass** — models whose oldest queued deadline is at risk
    start first, at their efficacy-optimal allocation (reduced toward the
    min-fit if capacity is short — "D-STACK can schedule a model below its
    knee, albeit with higher latency").
  * **Fair opportunistic pass** — leftover capacity backfills inactive
    models, prioritized by a scoreboard of least GPU runtime over the last
    ``window`` sessions (proportional-fairness, CFS-like); batch is sized
    to the time budget (feasible_batch_for).
  * **No oversubscription** — aggregate allocated fraction ≤ 1 always;
    every allocation is a level of the hardware.
  * Runs are never preempted; consecutive runs of the tightest-SLO model
    are spread as far apart as its SLO allows to open room for long runs.
"""
from __future__ import annotations

import math
from typing import Dict, List

from repro_torch.core.scheduler.base import running_models
from repro_torch.core.simulator import RunRequest


class DStackPolicy:
    name = "dstack"

    def __init__(self, profiles, max_batch: int = 16, window: int = 10,
                 slack: float = 1.25):
        self.max_batch = max_batch
        self.window = window
        self.slack = slack
        self.session = max(p.slo for p in profiles.values())
        self._session_idx = -1
        # scoreboard: runtime per model over the last `window` sessions
        self._score: Dict[str, List[float]] = {n: [0.0] for n in profiles}
        self._last_start: Dict[str, float] = {n: -math.inf for n in profiles}

    # ------------------------------------------------------------ helpers
    def _roll_session(self, now: float) -> None:
        idx = int(now / self.session)
        while self._session_idx < idx:
            self._session_idx += 1
            for hist in self._score.values():
                hist.append(0.0)
                if len(hist) > self.window:
                    hist.pop(0)

    def _runtime_score(self, name: str) -> float:
        return sum(self._score[name])

    def next_wakeup(self, now: float) -> float:
        return (int(now / self.session) + 1) * self.session

    def _want_chips(self, prof, queue_len: int) -> int:
        """Dynamic adaptation (§6.1.2): scale toward the knee under queue
        pressure; stay at the efficacy optimum when keeping up."""
        if queue_len > 4 * max(prof.opt_batch, 1):
            return max(prof.opt_chips, prof.knee_chips)
        if queue_len > 2 * max(prof.opt_batch, 1):
            return min(max(prof.opt_chips * 2, prof.opt_chips),
                       max(prof.knee_chips, prof.opt_chips))
        return prof.opt_chips

    def _fit_chips(self, prof, want: int, free_chips: int,
                   total: int) -> int:
        """Largest level of the model's hardware <= min(want, free, all
        units), >= min fit (0 when there is none)."""
        c = prof.hw.level_at_most(min(want, free_chips, total))
        return c if c and c >= prof.min_chips() else 0

    # ---------------------------------------------------------------- plan
    def plan(self, now: float, sim) -> List[RunRequest]:
        self._roll_session(now)
        out: List[RunRequest] = []
        active = running_models(sim)
        total = sim.sim.total_chips
        free_chips = int(round(sim.free_frac(now) * total))

        # ---- mandatory pass: EDF over models with deadline pressure
        cands = []
        for n, prof in sim.profiles.items():
            if n in active or len(sim.queues[n]) == 0:
                continue
            ddl = sim.queues[n].oldest_deadline()
            runtime = prof.runtime()
            urgent = ddl <= now + self.slack * runtime + sim.sim.dispatch_gap
            cands.append((ddl, n, urgent))
        cands.sort()

        started = set()
        for ddl, n, urgent in cands:
            if not urgent:
                continue
            prof = sim.profiles[n]
            want = self._want_chips(prof, len(sim.queues[n]))
            chips = self._fit_chips(prof, want, free_chips, total)
            if chips == 0:
                continue
            budget = max(ddl - now, prof.slo / 2)
            b = prof.feasible_batch_for(budget, chips, len(sim.queues[n]))
            b = max(1, min(b if b else 1, self.max_batch))
            out.append(RunRequest(n, chips, b))
            free_chips -= chips
            started.add(n)
            self._book(n, prof.latency(chips, b), now)

        # ---- opportunistic pass: fairness-ordered backfill
        avail = [(self._runtime_score(n), n) for _, n, _ in cands
                 if n not in started]
        avail.sort()
        for _, n in avail:
            prof = sim.profiles[n]
            want = self._want_chips(prof, len(sim.queues[n]))
            chips = self._fit_chips(prof, want, free_chips, total)
            if chips == 0:
                continue
            # budget: must clear before this model's own deadline AND leave
            # the tightest-SLO model room for its next mandatory run
            budget = min(prof.slo / 2,
                         sim.queues[n].oldest_deadline() - now)
            b = prof.feasible_batch_for(budget, chips, len(sim.queues[n]))
            if b < 1:
                continue
            b = min(b, self.max_batch)
            out.append(RunRequest(n, chips, b))
            free_chips -= chips
            self._book(n, prof.latency(chips, b), now)
        return out

    def _book(self, name: str, runtime: float, now: float) -> None:
        self._score[name][-1] += runtime
        self._last_start[name] = now
