"""Multi-pod cluster serving (paper §7.1, Fig. 12).

Three deployment modes over ``n_pods`` pods:
  * ``exclusive``  — one model per pod (the paper's 1-GPU-per-DNN baseline),
  * ``temporal``   — every model on every pod, temporal sharing per pod,
  * ``dstack``     — every model on every pod, D-STACK per pod.
Requests are routed to the least-loaded eligible pod (shortest queue+work).

The JAX package's ``repro.core.cluster``. A pod is one ``Simulator`` of
``SimConfig(duration=...)`` whose ``total_chips`` defaults to the
profiles' hardware: on ``H100`` profiles a pod is one card of 100
GPU-percent units (the JAX package's default pod is 256 chips).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core.profiles import ModelProfile
from repro_torch.core.scheduler import DStackPolicy, TemporalPolicy
from repro_torch.core.simulator import SimConfig, SimResult, Simulator
from repro_torch.serving.request import Request, RequestGenerator


@dataclasses.dataclass
class ClusterResult:
    per_pod: List[SimResult]

    @property
    def total_throughput(self) -> float:
        return sum(r.throughput() for r in self.per_pod)

    def model_throughput(self, name: str) -> float:
        return sum(r.per_model[name].throughput(r.duration)
                   for r in self.per_pod if name in r.per_model)

    @property
    def utilization(self) -> float:
        return sum(r.utilization for r in self.per_pod) / len(self.per_pod)

    @property
    def total_violated(self) -> int:
        return sum(r.total_violated for r in self.per_pod)


class _Replay:
    """Feeds a pre-routed arrival list through the generator interface."""

    def __init__(self, requests: List[Request]):
        self._reqs = sorted(requests, key=lambda r: r.arrival)

    def until(self, t_end: float) -> List[Request]:
        out = [r for r in self._reqs if r.arrival < t_end]
        self._reqs = [r for r in self._reqs if r.arrival >= t_end]
        return out


def run_cluster(profiles: Dict[str, ModelProfile],
                generators: Sequence[RequestGenerator],
                mode: str = "dstack", n_pods: int = 4,
                duration: float = 10.0,
                sim_cfg: Optional[SimConfig] = None) -> ClusterResult:
    sim_cfg = sim_cfg or SimConfig(duration=duration)
    names = list(profiles)
    arrivals: List[Request] = []
    for g in generators:
        arrivals.extend(g.until(duration))
    arrivals.sort(key=lambda r: r.arrival)

    if mode == "exclusive":
        pod_models = [[names[i % len(names)]] for i in range(n_pods)]
    else:
        pod_models = [names for _ in range(n_pods)]

    # least-loaded routing: track outstanding work routed per pod
    load = [0.0] * n_pods
    routed: List[List[Request]] = [[] for _ in range(n_pods)]
    for req in arrivals:
        eligible = [i for i in range(n_pods) if req.model in pod_models[i]]
        tgt = min(eligible, key=lambda i: load[i])
        routed[tgt].append(req)
        load[tgt] += profiles[req.model].runtime() / max(
            profiles[req.model].opt_batch, 1)

    results = []
    for i in range(n_pods):
        profs = {n: profiles[n] for n in pod_models[i]}
        if mode == "dstack":
            policy = DStackPolicy(profs)
        else:
            policy = TemporalPolicy(profs)
        sim = Simulator(profs, policy, [_Replay(routed[i])],
                        dataclasses.replace(sim_cfg))
        results.append(sim.run())
    return ClusterResult(per_pod=results)
