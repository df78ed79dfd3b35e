"""The four-model pool (``bench_pool``'s ``MODELS_FULL``: the quick trio
plus whisper-small) on the port's control plane against the JAX
package's, on the CPU: reduced configs, two slots of 32 tokens, the
JAX pool's weights carried across and planning on a ``Hardware`` with
the v5e's field values, as ``tests/test_torch_pool.py`` holds the trio.
The pools' whisper prompts carry the same stub frames — the JAX
package's ``modality.audio_frames`` (torch's generator draws other
numbers). Under ``dstack`` and ``temporal`` both pools make the same
admissions (model, requested and granted units, batch, request ids),
serve every model and count the same served, violated and dropped
requests, with no new executable while serving.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.hardware import V5E  # noqa: E402
from repro.core.latency_model import CHIP_LEVELS  # noqa: E402
from repro.serving.controller import run_policy as jax_run_policy  # noqa
from repro.serving.pool import build_pool as jax_build_pool  # noqa: E402
from repro_torch.core.hardware import Hardware  # noqa: E402
from repro_torch.core.profiles import build_profile  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402
from repro_torch.serving.controller import run_policy  # noqa: E402
from repro_torch.serving.pool import EnginePool, build_host  # noqa: E402

MODELS_FULL = ["qwen2-0.5b", "olmo-1b", "mamba2-1.3b", "whisper-small"]
RATE = 1500.0
DURATION = 0.03
GEN_LEN = 3
V5E_FIELDS = Hardware(**dataclasses.asdict(V5E), levels=CHIP_LEVELS,
                      tp_cap=32, tp_shard_width=512, hop_latency=1e-6)


@pytest.fixture(scope="module")
def pools():
    """(JAX pool, port pool) over ``MODELS_FULL`` with the same weights
    and the same whisper frames."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jpool = jax_build_pool(MODELS_FULL, request_rate=RATE, base_slots=2,
                           cache_len=32)
    hosts = {}
    for i, name in enumerate(MODELS_FULL):
        jhost = jpool.hosts[name]
        params = params_from_numpy(
            jhost.cfg, jax.tree.map(np.asarray, jhost.params), "cpu")
        profile = build_profile(name, request_rate=RATE, hw=V5E_FIELDS)
        host = build_host(name, profile=profile, base_slots=2, cache_len=32,
                          seed=i, device="cpu", params=params)
        assert sorted(host.allocations) == sorted(jhost.allocations)
        own = host.prompt_batch()
        if host.cfg.has_encoder:
            assert tuple(own["enc_embeds"].shape) == (
                1, host.cfg.encoder_seq, host.cfg.d_model)
            host._prompt = dict(own, enc_embeds=torch.from_numpy(np.array(
                jhost.prompt_batch()["enc_embeds"], np.float32)))
        hosts[name] = host
    ppool = EnginePool(hosts)
    ppool.warmup()
    yield jpool, ppool
    torch.set_num_threads(n)


def _recorded(pool):
    """Every admission ``pool`` makes: (model, requested units, granted
    units, batch, request ids)."""
    log = []
    admit = pool.admit

    def spy(rr, now, gen_len, drop_expired=True):
        run = admit(rr, now, gen_len, drop_expired)
        if run is not None:
            log.append((rr.model, rr.chips, run.chips, run.batch,
                        sorted(r.rid for r in run.slots.values())))
        return run

    pool.admit = spy
    return log


@pytest.mark.parametrize("policy", ["dstack", "temporal"])
def test_four_model_pool_equals_jax(pools, policy):
    jpool, ppool = pools
    logs = [_recorded(p) for p in pools]
    caches = [p.jit_cache_sizes() for p in pools]
    try:
        ja = jax_run_policy(jpool, policy, rate=RATE, duration=DURATION,
                            gen_len=GEN_LEN)
        pb = run_policy(ppool, policy, rate=RATE, duration=DURATION,
                        gen_len=GEN_LEN)
    finally:
        for p in pools:
            del p.admit
    assert logs[0] and logs[1] == logs[0]
    assert {a[0] for a in logs[1]} == set(MODELS_FULL)
    for n, m in ja.per_model.items():
        got = pb.per_model[n]
        assert (got.completed, got.violated, got.dropped) == \
            (m.completed, m.violated, m.dropped), n
        assert got.completed > 0, n
    assert (pb.duration, pb.steps) == (ja.duration, ja.steps)
    assert [p.jit_cache_sizes() for p in pools] == caches
    engines = ppool.hosts["whisper-small"].engines()
    assert sum(e.stats.packed_prefills for e in engines) > 0
