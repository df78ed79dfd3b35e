"""The port's multi-pod cluster (``repro_torch.core.cluster``, paper §7.1,
Fig. 12) against the JAX package's ``repro.core.cluster`` on the CPU.

* At the v5e's field values (the JAX ``V5E`` plus the chip levels and
  tensor-parallel terms its latency model keeps in code) and the same
  ``sim_cfg``, every mode's ``ClusterResult`` equals the JAX one pod for
  pod: completed, violated and run counts exactly, runtimes and
  utilization to 1e-12 relative.
* ``tests/test_system.py``'s claim, ``dstack`` above 1.3x ``exclusive``
  and ``temporal``, at the v5e's field values; on the port's default
  hardware, the H100, ``dstack`` stays above 1.3x ``temporal`` and below
  ``exclusive`` (every knee of the mix is 90-100 GPU percent).
* On ``H100`` profiles each pod is one card of 100 GPU-percent units
  (``SimConfig.total_chips`` defaults to the profiles' hardware, where
  the JAX package's default pod is 256 chips).
"""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.core import cluster as jax_cluster  # noqa: E402
from repro.core import profiles as jax_profiles  # noqa: E402
from repro.core.hardware import V5E  # noqa: E402
from repro.core.latency_model import CHIP_LEVELS  # noqa: E402
from repro.core.simulator import SimConfig as JaxSimConfig  # noqa: E402
from repro.serving.request import RequestGenerator as JaxGen  # noqa: E402
from repro_torch.core import cluster  # noqa: E402
from repro_torch.core import profiles  # noqa: E402
from repro_torch.core.hardware import H100, Hardware  # noqa: E402
from repro_torch.core.simulator import SimConfig  # noqa: E402
from repro_torch.serving.request import RequestGenerator  # noqa: E402

# tests/test_system.py's four-model mix
C4 = ["qwen2-0.5b", "mamba2-1.3b", "deepseek-7b", "yi-9b"]
MODES = ("exclusive", "temporal", "dstack")
V5E_FIELDS = Hardware(**dataclasses.asdict(V5E), levels=CHIP_LEVELS,
                      tp_cap=32, tp_shard_width=512, hop_latency=1e-6)
REL = 1e-12


def _close(a, b):
    return a == b or abs(a - b) <= REL * max(abs(a), abs(b))


def _profiles(rate, hw=H100):
    return {n: profiles.build_profile(n, request_rate=rate, hw=hw)
            for n in C4}


def _gens(profs, rate, gen=RequestGenerator):
    return [gen(n, rate, profs[n].slo, seed=i) for i, n in enumerate(profs)]


@pytest.mark.parametrize("mode", MODES)
def test_cluster_result_equals_jax_at_v5e_fields(mode):
    rate = 3000.0
    jprofs = {n: jax_profiles.build_profile(n, request_rate=rate)
              for n in C4}
    want = jax_cluster.run_cluster(
        jprofs, _gens(jprofs, rate, JaxGen), mode=mode, n_pods=4,
        duration=0.3, sim_cfg=JaxSimConfig(duration=0.3))
    tprofs = _profiles(rate, V5E_FIELDS)
    got = cluster.run_cluster(tprofs, _gens(tprofs, rate), mode=mode,
                              n_pods=4, duration=0.3,
                              sim_cfg=SimConfig(duration=0.3))
    assert len(got.per_pod) == len(want.per_pod) == 4
    for a, b in zip(want.per_pod, got.per_pod):
        assert set(b.per_model) == set(a.per_model)
        for n, ma in a.per_model.items():
            mb = b.per_model[n]
            assert (mb.completed, mb.violated, mb.runs) == \
                (ma.completed, ma.violated, ma.runs), (mode, n)
            assert _close(mb.runtime, ma.runtime)
        assert _close(b.utilization, a.utilization)
        assert (b.makespan, b.duration) == (a.makespan, a.duration)
    assert want.total_throughput > 0
    assert _close(got.total_throughput, want.total_throughput)
    assert got.total_violated == want.total_violated
    assert _close(got.utilization, want.utilization)
    for n in C4:
        assert _close(got.model_throughput(n), want.model_throughput(n))


def _throughputs(hw, rate=8000.0):
    out = {}
    for mode in MODES:
        profs = _profiles(rate, hw)
        out[mode] = cluster.run_cluster(profs, _gens(profs, rate),
                                        mode=mode, n_pods=4,
                                        duration=1.0).total_throughput
    return out


def test_cluster_dstack_beats_exclusive_and_temporal_at_v5e_fields():
    """``tests/test_system.py:100`` (§7.1, Fig. 12's ordering) on the
    hardware it is stated for."""
    out = _throughputs(V5E_FIELDS)
    assert out["dstack"] > 1.3 * out["temporal"]
    assert out["dstack"] > 1.3 * out["exclusive"]


def test_cluster_dstack_beats_temporal_on_h100():
    """On the port's default hardware D-STACK still serves more than 1.3x
    temporal sharing per card. It does not beat one card per model
    (``exclusive``) there: the H100 latency model puts every knee of the
    mix at 90-100 GPU percent, so four models on one card cannot run side
    by side at their knees (``PERF.md`` §6)."""
    out = _throughputs(H100)
    assert out["dstack"] > 1.3 * out["temporal"]
    assert out["exclusive"] > out["dstack"]


def test_h100_pod_is_one_card_of_100_units(monkeypatch):
    """Each pod's simulator plans over 100 GPU-percent units: the port's
    ``SimConfig`` leaves ``total_chips`` to the profiles' hardware."""
    seen = []
    real = cluster.Simulator

    class Spy(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.append(self.sim.total_chips)

    monkeypatch.setattr(cluster, "Simulator", Spy)
    profs = _profiles(2000.0)
    assert SimConfig().total_chips is None
    assert JaxSimConfig().total_chips == 256
    res = cluster.run_cluster(profs, _gens(profs, 2000.0), mode="dstack",
                              n_pods=3, duration=0.2)
    assert seen == [H100.chips_per_pod] * 3 == [100] * 3
    assert len(res.per_pod) == 3 and res.total_throughput > 0
    assert 0.0 < res.utilization <= 1.0


def test_exclusive_pods_host_one_model_each():
    profs = _profiles(2000.0)
    res = cluster.run_cluster(profs, _gens(profs, 2000.0), mode="exclusive",
                              n_pods=4, duration=0.2)
    assert [sorted(r.per_model) for r in res.per_pod] == \
        [[n] for n in C4]
