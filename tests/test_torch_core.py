"""The port's control plane (``repro_torch.core``) against the JAX
package's on the CPU, and its H100 properties.

Parity: a ``Hardware`` carrying the TPU v5e's field values (the JAX
``V5E`` plus the power-of-two chip levels and the tensor-parallel terms
the JAX model keeps in code) must reproduce the JAX package's numbers
over all ten archs — ``LatencyModel`` latencies, costs and knees at every
batch level and mode, ``efficacy.optimize``'s operating point and
surface, ``build_profile``'s fields, the analytical knee model, and a
``Simulator`` run of each of the seven policies plus ``IdealSimulator``
on the same seeded trace (relative tolerance 1e-12; counts exact).

H100: units are GPU percent; every allocation a policy grants is one of
``H100.levels``, latency does not rise with units up to the knee, the
knee is at most 100, and the cases of ``tests/test_{scheduler,
efficacy,knee,latency_model}.py`` that do not depend on the v5e's
numbers hold on the H100 too.
"""
import dataclasses
import math

import numpy as np
import pytest

pytest.importorskip("torch")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.core import efficacy as jax_eff  # noqa: E402
from repro.core import knee as jax_knee  # noqa: E402
from repro.core import profiles as jax_profiles  # noqa: E402
from repro.core.hardware import V5E  # noqa: E402
from repro.core.latency_model import CHIP_LEVELS  # noqa: E402
from repro.core.latency_model import CostOverride as JaxOverride  # noqa
from repro.core.latency_model import LatencyModel as JaxLM  # noqa: E402
from repro.core.scheduler import POLICIES as JAX_POLICIES  # noqa: E402
from repro.core.scheduler import IdealSimulator as JaxIdeal  # noqa: E402
from repro.core.simulator import SimConfig as JaxSimConfig  # noqa: E402
from repro.core.simulator import Simulator as JaxSimulator  # noqa: E402
from repro.serving.request import RequestGenerator as JaxGen  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core import efficacy as eff  # noqa: E402
from repro_torch.core import knee  # noqa: E402
from repro_torch.core import profiles  # noqa: E402
from repro_torch.core.hardware import H100, Hardware  # noqa: E402
from repro_torch.core.latency_model import CostOverride  # noqa: E402
from repro_torch.core.latency_model import LatencyModel  # noqa: E402
from repro_torch.core.scheduler import (POLICIES, IdealSimulator,  # noqa
                                        chips_for_frac)
from repro_torch.core.simulator import SimConfig, Simulator  # noqa: E402
from repro_torch.serving.pool import default_allocations  # noqa: E402
from repro_torch.serving.request import Request, RequestGenerator  # noqa

# the JAX model's v5e: its Hardware fields, its chip levels, and the
# tensor-parallel terms its LatencyModel keeps in code (TP cap 32, 512 of
# the widest dim per chip, 1 µs per ring hop)
V5E_FIELDS = Hardware(**dataclasses.asdict(V5E), levels=CHIP_LEVELS,
                      tp_cap=32, tp_shard_width=512, hop_latency=1e-6)
REL = 1e-12
MODES = [("prefill", 128), ("decode", 4096), ("train", 4096)]
# the archs one 80 GB card holds (phi3.5-moe: 84 GB of bf16 weights)
H100_ARCHS = sorted(n for n in ARCHS if n != "phi3.5-moe-42b-a6.6b")


def _close(a, b):
    return a == b or abs(a - b) <= REL * max(abs(a), abs(b))


# ------------------------------------------------------- parity at v5e
def test_configs_equal_the_jax_zoo_in_order():
    assert list(ARCHS) == list(JAX_ARCHS)
    for n, cfg in ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JAX_ARCHS[n])


@pytest.mark.parametrize("mode,seq", MODES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_latency_model_equals_jax(arch, mode, seq):
    j = JaxLM(JAX_ARCHS[arch], mode=mode, seq=seq)
    p = LatencyModel(get_config(arch), mode=mode, seq=seq, hw=V5E_FIELDS)
    for b in eff.BATCH_LEVELS:
        assert p.costs(b) == j.costs(b)
        assert p.min_chips_to_fit(b) == j.min_chips_to_fit(b)
        for c in CHIP_LEVELS:
            assert _close(p.latency(c, b), j.latency(c, b)), (b, c)
            assert p.usable_chips(c, b) == j.usable_chips(c, b)
        assert p.knee_chips(b) == j.knee_chips(b)
        assert np.array_equal(p.utility_curve(b), j.utility_curve(b))
    assert p.max_useful_chips() == j.max_useful_chips()
    assert p.knee_frac(16) == j.knee_frac(16)


def test_cost_override_equals_jax():
    kw = dict(flops=1e12, hbm_bytes=1e9, ar_bytes=1e8, a2a_bytes=2e7,
              batch=8)
    j = JaxLM(JAX_ARCHS["olmo-1b"], override=JaxOverride(**kw))
    p = LatencyModel(get_config("olmo-1b"), hw=V5E_FIELDS,
                     override=CostOverride(**kw))
    for b in (1, 16):
        assert p.costs(b) == j.costs(b)
        for c in CHIP_LEVELS:
            assert _close(p.latency(c, b), j.latency(c, b))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_efficacy_and_profile_equal_jax(arch):
    j = JaxLM(JAX_ARCHS[arch])
    p = LatencyModel(get_config(arch), hw=V5E_FIELDS)
    for slo, rate in [(0.025, 500.0), (0.05, 4000.0), (0.2, 50.0),
                      (0.0005, 100.0)]:
        a = jax_eff.optimize(j, slo=slo, request_rate=rate)
        b = eff.optimize(p, slo=slo, request_rate=rate)
        assert (b.batch, b.chips, b.feasible) == (a.batch, a.chips,
                                                  a.feasible)
        for f in ("frac", "latency", "throughput", "efficacy"):
            assert _close(getattr(b, f), getattr(a, f)), f
    assert np.array_equal(eff.efficacy_surface(p),
                          jax_eff.efficacy_surface(j))
    jp = jax_profiles.build_profile(arch)
    pp = profiles.build_profile(arch, hw=V5E_FIELDS)
    for f in ("name", "slo", "knee_chips", "opt_batch", "opt_chips",
              "max_batch", "knee_frac", "opt_frac"):
        assert getattr(pp, f) == getattr(jp, f), f
    for c in (1, 8, 256):
        assert _close(pp.latency(c, 4), jp.latency(c, 4))
        assert pp.feasible_batch_for(pp.slo / 2, c, 40) == \
            jp.feasible_batch_for(jp.slo / 2, c, 40)
    assert _close(pp.runtime(), jp.runtime())
    assert pp.min_chips() == jp.min_chips()


@pytest.mark.parametrize("p,b,mem", [(20, 1, 0.0), (40, 1, 50.0),
                                     (60, 2, 50.0), (10, 4, 0.0)])
def test_analytical_knee_equals_jax(p, b, mem):
    kw = dict(p=p, b=b, mem_bw_per_unit=mem, data_per_kernel=100.0)
    j, t = jax_knee.AnalyticalDNN(**kw), knee.AnalyticalDNN(**kw)
    s = np.arange(1, 129)
    assert np.array_equal(t.execution_time(s), j.execution_time(s))
    assert np.array_equal(t.utility(s), j.utility(s))
    assert np.array_equal(t.derivative_curve(s), j.derivative_curve(s))
    assert t.knee() == j.knee()
    lat = lambda f: 1.0 / f + 0.1 * p    # noqa: E731
    fr = [i / 16 for i in range(1, 17)]
    for tol in (0.0001, 0.05, 10.0):
        assert knee.knee_of_latency(lat, fr, tol) == \
            jax_knee.knee_of_latency(lat, fr, tol)
        assert knee.knee_binary_search(lat, fr, tol) == \
            jax_knee.knee_binary_search(lat, fr, tol)


def _zoos(rate=500.0):
    return (jax_profiles.default_zoo(rates=dict.fromkeys(JAX_ARCHS, rate)),
            profiles.default_zoo(rates=dict.fromkeys(ARCHS, rate),
                                 hw=V5E_FIELDS))


def _same_result(a, b):
    assert set(a.per_model) == set(b.per_model)
    for n, ma in a.per_model.items():
        mb = b.per_model[n]
        assert (mb.completed, mb.violated, mb.runs) == \
            (ma.completed, ma.violated, ma.runs), n
        assert _close(mb.runtime, ma.runtime), n
    assert _close(b.utilization, a.utilization)
    assert (b.makespan, b.duration) == (a.makespan, a.duration)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_simulator_policy_equals_jax(policy):
    """All ten archs at 500 requests/s each, 0.3 virtual seconds."""
    jz, tz = _zoos()
    ja = JaxSimulator(jz, JAX_POLICIES[policy](jz),
                      [JaxGen(n, 500.0, jz[n].slo, seed=i)
                       for i, n in enumerate(jz)],
                      JaxSimConfig(duration=0.3)).run()
    tb = Simulator(tz, POLICIES[policy](tz),
                   [RequestGenerator(n, 500.0, tz[n].slo, seed=i)
                    for i, n in enumerate(tz)],
                   SimConfig(duration=0.3)).run()
    assert ja.total_completed > 0
    _same_result(ja, tb)


@pytest.mark.parametrize("op_mode", ["knee", "efficient"])
def test_ideal_simulator_equals_jax(op_mode):
    jz, tz = _zoos()
    ja = JaxIdeal(jz, [JaxGen(n, 500.0, jz[n].slo, seed=i)
                       for i, n in enumerate(jz)],
                  duration=0.2, op_mode=op_mode).run()
    tb = IdealSimulator(tz, [RequestGenerator(n, 500.0, tz[n].slo, seed=i)
                             for i, n in enumerate(tz)],
                        duration=0.2, op_mode=op_mode).run()
    assert ja.total_completed > 0
    _same_result(ja, tb)


def test_chips_for_frac_equals_jax_on_pow2_levels():
    from repro.core.scheduler import chips_for_frac as jax_cff
    for total in (8, 16, 64, 256):
        hw = dataclasses.replace(
            V5E_FIELDS, chips_per_pod=total,
            levels=tuple(c for c in CHIP_LEVELS if c <= total))
        for frac in np.linspace(0.0, 1.0, 41):
            assert chips_for_frac(frac, hw) == jax_cff(frac, total)


# --------------------------------------------------------------- H100
def _h100_profiles(names, rate=2000.0):
    return {n: profiles.build_profile(n, request_rate=rate) for n in names}


def test_h100_hardware_units_are_gpu_percent():
    assert H100.chips_per_pod == 100 and H100.levels[-1] == 100
    # uncontrolled sharing floors to multiples of the smallest level:
    # every such multiple must itself be a level
    assert H100.levels == tuple(range(H100.step, 101, H100.step))
    assert H100.sm_count == 132 and H100.hbm_bytes == 80e9
    assert H100.peak_flops * 100 == pytest.approx(989e12)
    assert H100.hbm_bw * 100 == pytest.approx(3.35e12)
    # no inter-chip term is on
    assert (H100.ici_bw, H100.tp_cap, H100.hop_latency) == (0.0, 1, 0.0)


@pytest.mark.parametrize("mode,seq", MODES[:2])
@pytest.mark.parametrize("arch", H100_ARCHS)
def test_h100_latency_falls_to_the_knee(arch, mode, seq):
    lm = LatencyModel(get_config(arch), mode=mode, seq=seq)
    assert lm.min_chips_to_fit() == 1
    for b in eff.BATCH_LEVELS:
        k = lm.knee_chips(b)
        assert k in H100.levels and k <= 100
        lats = [lm.latency(c, b) for c in H100.levels if c <= k]
        if not all(map(math.isfinite, lats)):
            continue                       # the KV outgrew the card
        assert all(y <= x for x, y in zip(lats, lats[1:])), (b, lats)
        # a share of one device never searches tensor-parallel widths
        assert list(lm._tp_candidates(100)) == [1]


def test_h100_refuses_a_model_no_card_holds():
    lm = LatencyModel(get_config("phi3.5-moe-42b-a6.6b"))
    assert lm.min_chips_to_fit() == math.inf
    assert lm.latency(100, 1) == math.inf
    with pytest.raises(ValueError, match="no allocation"):
        profiles.build_profile("phi3.5-moe-42b-a6.6b")


def test_h100_parallelism_clamp_counts_ctas():
    """Decode at batch <= 64 fills one row tile: olmo-1b's widest product
    (d_ff 8192) gives 64 CTAs of 128 columns, 49% of 132 SMs — memory and
    compute stop scaling there, so the decode knee sits at 50%."""
    lm = LatencyModel(get_config("olmo-1b"), mode="decode", seq=1024)
    assert lm.usable_chips(100, 16) == math.ceil(64 * 100 / 132)
    assert lm.usable_chips(30, 16) == 30
    assert lm.knee_chips(16) == 50
    assert lm.latency(50, 16) == lm.latency(100, 16)
    # prefill of 16 x 128 tokens fills every SM
    assert LatencyModel(get_config("olmo-1b")).usable_chips(100, 16) == 100


def _granted(profs, policy, duration=0.5, rate=2000.0):
    """Run ``policy`` over ``profs`` in the simulator and return every
    allocation it granted (and the result)."""
    pol = POLICIES[policy](profs)
    asks = []
    plan = pol.plan

    def spy(now, view):
        out = plan(now, view)
        asks.extend(rr.chips for rr in out)
        return out

    pol.plan = spy
    gens = [RequestGenerator(n, rate, p.slo, seed=i)
            for i, (n, p) in enumerate(profs.items())]
    res = Simulator(profs, pol, gens, SimConfig(duration=duration)).run()
    return asks, res


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_h100_every_allocation_is_a_level(policy):
    profs = _h100_profiles(H100_ARCHS)
    asks, res = _granted(profs, policy)
    assert asks and set(asks) <= set(H100.levels), sorted(set(asks))
    assert 0.0 <= res.utilization <= 1.0 + 1e-9
    for p in profs.values():
        allocs = default_allocations(p)
        assert 100 in allocs and set(allocs) <= set(H100.levels)
        assert p.knee_chips <= 100 and p.opt_chips in H100.levels


def test_h100_requests_below_the_smallest_level():
    """chips_for_frac finds no level below 10%; GSLICE then grants the
    smallest level (its max(1, ·) on a pod), and fixed-batch MPS divides
    the card in multiples of it."""
    assert chips_for_frac(0.05, H100) == 0
    assert chips_for_frac(0.35, H100) == 30
    assert chips_for_frac(1.0, H100) == 100
    profs = _h100_profiles(H100_ARCHS)
    tiny = {n: dataclasses.replace(p, knee_chips=10)
            for n, p in profs.items()}    # knees sum to 90%: no rescale
    assert set(POLICIES["gslice"](tiny).partition.values()) == {10}
    crowded = {n: dataclasses.replace(p, knee_chips=100)
               for n, p in profs.items()}
    part = POLICIES["gslice"](crowded).partition
    assert set(part.values()) == {10}      # 100/9 = 11% each -> 10%
    eleven = {f"{n}#{i}": p for i, (n, p) in enumerate(
        list(profs.items()) + list(profs.items())[:2])}
    pol = POLICIES["fixed_batch_mps"](eleven)

    class View:
        profiles = eleven
        queues = {n: [0] for n in eleven}
        running = []
        sim = SimConfig(total_chips=100)

    out = pol.plan(0.0, View)
    assert len(out) == 11 and {rr.chips for rr in out} == {10}


# mirrored cases of tests/test_{scheduler,efficacy,latency_model}.py
@pytest.mark.parametrize("policy", ["temporal", "gslice", "triton",
                                    "maxmin", "max_throughput", "dstack"])
def test_h100_no_oversubscription(policy):
    profs = _h100_profiles(["qwen2-0.5b", "mamba2-1.3b", "deepseek-7b",
                            "yi-9b"])
    peak = []
    pol = POLICIES[policy](profs)

    class Watch(Simulator):
        def _start_runs(self, now, reqs):
            super()._start_runs(now, reqs)
            peak.append(sum(r.frac for r in self.running))

    gens = [RequestGenerator(n, 2000.0, p.slo, seed=i)
            for i, (n, p) in enumerate(profs.items())]
    res = Watch(profs, pol, gens, SimConfig(duration=1.0)).run()
    assert max(peak) <= 1.0 + 1e-6
    assert res.total_completed > 0


def test_h100_dstack_serves_every_model_and_temporal_one_at_a_time():
    names = ["qwen2-0.5b", "mamba2-1.3b", "deepseek-7b", "yi-9b"]
    profs = _h100_profiles(names, rate=4000.0)
    _, res = _granted(profs, "dstack", duration=1.0, rate=4000.0)
    for n, m in res.per_model.items():
        assert m.completed > 0 and m.runtime > 0, n
    conc = []

    class Watch(Simulator):
        def _start_runs(self, now, reqs):
            super()._start_runs(now, reqs)
            conc.append(len(self.running))

    profs = _h100_profiles(names)
    gens = [RequestGenerator(n, 2000.0, p.slo, seed=i)
            for i, (n, p) in enumerate(profs.items())]
    Watch(profs, POLICIES["temporal"](profs), gens,
          SimConfig(duration=0.5)).run()
    assert max(conc) == 1


def test_h100_drain_and_ideal():
    names = ["qwen2-0.5b", "mamba2-1.3b", "deepseek-7b", "yi-9b"]
    profs = _h100_profiles(names)

    class Burst:
        def __init__(self, model, n, slo):
            self.reqs = [Request(0.0, i, model, slo) for i in range(n)]

        def until(self, t):
            r, self.reqs = self.reqs, []
            return r

    res = Simulator(profs, POLICIES["dstack"](profs),
                    [Burst(n, 100, profs[n].slo) for n in profs],
                    SimConfig(drain=True, drop_expired=False,
                              duration=0)).run()
    assert res.total_completed == 400 and res.makespan > 0
    gens = [RequestGenerator(n, 2000.0, p.slo, seed=i)
            for i, (n, p) in enumerate(profs.items())]
    ideal = IdealSimulator(profs, gens, duration=0.5).run()
    assert 0.0 < ideal.utilization <= 1.0 + 1e-9
    assert ideal.total_completed > 0


def test_h100_efficacy_optimum_is_exhaustive_and_feasible():
    lm = LatencyModel(get_config("olmo-1b"))
    slo, rate = 0.05, 500
    pt = eff.optimize(lm, slo=slo, request_rate=rate)
    assert pt.feasible and pt.chips in H100.levels
    assert pt.latency <= slo / 2 + 1e-12
    assert pt.latency + pt.batch / rate <= slo + 1e-12
    best = 0.0
    for b in eff.BATCH_LEVELS:
        for c in H100.levels:
            lat = lm.latency(c, b)
            if eff.feasible(lat, b, slo, rate) and b / lat >= rate:
                best = max(best, eff.efficacy(b, lat, c / 100))
    assert pt.efficacy == pytest.approx(best)
    assert pt.frac == pt.chips / 100
    assert eff.efficacy_surface(lm).shape == (len(eff.BATCH_LEVELS),
                                              len(H100.levels))
    assert not eff.optimize(LatencyModel(get_config("chameleon-34b")),
                            slo=0.0005, request_rate=100).feasible


def test_h100_decode_memory_bound_and_ssm_knee():
    lm = LatencyModel(get_config("deepseek-7b"), mode="decode", seq=4096)
    flops, hbm, _, a2a = lm.costs(8)
    assert hbm / H100.hbm_bw > flops / H100.peak_flops
    k_ssm = LatencyModel(get_config("mamba2-1.3b"), mode="decode",
                         seq=32768).knee_chips(32)
    k_dense = LatencyModel(get_config("yi-9b"), mode="decode",
                           seq=32768).knee_chips(32)
    assert k_ssm <= k_dense


@settings(max_examples=20, deadline=None)
@given(batch=st.integers(min_value=1, max_value=64),
       units=st.sampled_from(H100.levels),
       arch=st.sampled_from(H100_ARCHS))
def test_h100_property_latency_positive_finite(batch, units, arch):
    lm = LatencyModel(get_config(arch), mode="prefill", seq=128)
    lat = lm.latency(units, batch)
    assert lat > 0 and math.isfinite(lat)
    assert lm.throughput(units, batch) > 0
    assert lm.latency(units, batch) >= lm.latency(100, batch) - 1e-15
