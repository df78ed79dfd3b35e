"""The port's sampled decoding against the JAX package's, on the CPU.

The JAX sampler draws ``jax.random.categorical``: the arg-max of Gumbel
noise from a key plus the filtered logits. The port draws its noise from
a ``torch.Generator`` in one function, ``layers.gumbel_noise``; these
tests substitute the JAX package's own draws for it (``_JaxNoise``: the
key split once per draw, as the JAX engine splits ``_slot_rng`` per slot
step and ``rng`` per ``pick`` in ``generate``), so the same seeded inputs
must give the same tokens:

* ``top_k_top_p_filter`` masks what the JAX filter masks, and
  ``sample_logits`` picks what the JAX sampler picks from the same noise
  (``tests/test_decode_path.py``'s sampling cases);
* a sampled slot serve (``init_slots(sampling=, rng_seed=)``) through
  ``serve_ticks`` and a sampled ``generate`` (and ``generate_eager``'s
  ``categorical`` branch) equal the JAX engine's streams on the same
  weights (``tests/test_paged_kv.py``'s sampled slot case);
* one executable per sampling config, keyed as the JAX engine keys it;
* on the port's own noise: the same seed repeats a stream, another seed
  changes it, ``temperature=0`` and ``top_k=1`` are the greedy stream,
  and a sampling engine is not ``spec_capable`` (the pool's
  ``enable_speculation`` skips it).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.serving import plan as jax_plan  # noqa: E402
from repro.serving import request as jax_request  # noqa: E402
from repro.serving.engine import InferenceEngine as JaxEngine  # noqa
from repro.serving.engine import SamplingParams as JaxSampling  # noqa
from repro.serving.engine import make_engine as jax_make_engine  # noqa
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402
from repro_torch.serving import plan as port_plan  # noqa: E402
from repro_torch.serving import request as port_request  # noqa: E402
from repro_torch.serving.engine import (InferenceEngine,  # noqa: E402
                                        SamplingParams)
from repro_torch.serving.pool import EnginePool, ModelHost  # noqa: E402
from repro_torch.serving.pool import StandbyAllocation  # noqa: E402

CACHE_LEN = 32
N_SLOTS = 4
PAGE = 8
MODEL = "olmo-1b"
NUCLEUS = dict(temperature=0.8, top_k=50, top_p=0.95)
FILTERS = [(0, 1.0), (5, 1.0), (0, 0.9), (50, 0.95), (1, 1.0), (0, 0.0)]


class _JaxNoise:
    """A stand-in for ``layers.gumbel_noise``: the JAX package's Gumbel
    draws, the key split once per draw."""

    def __init__(self, seed: int):
        self.key = jax.random.PRNGKey(seed)
        self.calls = 0

    def __call__(self, generator, shape):
        self.key, sub = jax.random.split(self.key)
        self.calls += 1
        return torch.from_numpy(np.array(
            jax.random.gumbel(sub, tuple(shape), jnp.float32)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(config, JAX engine, port engine) on the same weights; each test
    sets the slots it needs."""
    jeng = jax_make_engine(jax_config(MODEL).reduced(), cache_len=CACHE_LEN)
    cfg = get_config(MODEL).reduced()
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jeng.params),
                               device="cpu")
    peng = InferenceEngine(build_model(cfg, device="cpu"), params,
                           cache_len=CACHE_LEN)
    return cfg, jeng, peng


def _logits(seed, rows=6, vocab=300):
    return np.random.default_rng(seed).normal(
        0.0, 3.0, (rows, vocab)).astype(np.float32)


def _workload(cfg, seed=7, n=6):
    rng = np.random.default_rng(seed)
    spec = [(i, int(rng.integers(3, 20)), int(rng.integers(2, 8)))
            for i in range(n)]
    prompts = {i: np.random.default_rng(1000 + i).integers(
        1, cfg.vocab_size, size=(1, p)).astype(np.int32) for i, p, _ in spec}
    return spec, prompts


def _serve(side, cfg, eng, spec, prompts, **planner_kw):
    plan, request = ((jax_plan, jax_request) if side == "jax"
                     else (port_plan, port_request))
    wrap = jnp.asarray if side == "jax" else (lambda a: a)
    eng.release_all_slots()
    eng.reset_stats()
    reqs = [request.Request(arrival=0.0, rid=i, model=cfg.name, slo=1e9,
                            n_tokens=nt, prompt_len=p) for i, p, nt in spec]
    planner = plan.StepPlanner(eng, request.RequestQueue(cfg.name, slo=1e9),
                               plan.PlannerConfig(gen_len=4, **planner_kw))
    srv = plan.serve_ticks(planner, reqs,
                           lambda r: {"tokens": wrap(prompts[r.rid])},
                           stall_limit=50)
    assert not srv.truncated
    assert eng.free_pages == eng.total_pages
    return {r: tuple(t) for r, t in planner.streams.items()}


# ------------------------------------------------------------ the sampler
@pytest.mark.parametrize("top_k,top_p", FILTERS)
def test_filter_masks_what_jax_masks(top_k, top_p):
    lg = _logits(top_k * 10 + int(top_p * 100))
    want = np.asarray(JL.top_k_top_p_filter(jnp.asarray(lg), top_k=top_k,
                                            top_p=top_p))
    got = L.top_k_top_p_filter(torch.from_numpy(lg), top_k=top_k,
                               top_p=top_p).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    np.testing.assert_array_equal(got[got > -1e29], want[want > -1e29])
    # the arg-max always survives
    assert (got[np.arange(len(lg)), lg.argmax(-1)] > -1e29).all()


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.0, 1.6])
@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (50, 0.95), (3, 0.5)])
def test_sample_logits_picks_what_jax_picks(monkeypatch, temperature,
                                            top_k, top_p):
    lg = _logits(11, rows=8, vocab=512)
    noise = _JaxNoise(5)
    monkeypatch.setattr(L, "gumbel_noise", noise)
    got = L.sample_logits(None, torch.from_numpy(lg),
                          temperature=temperature, top_k=top_k, top_p=top_p)
    want = JL.sample_logits(jax.random.split(jax.random.PRNGKey(5))[1],
                            jnp.asarray(lg), temperature=temperature,
                            top_k=top_k, top_p=top_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert noise.calls == (0 if temperature <= 0 else 1)


def test_port_noise_is_gumbel_and_seeded():
    """The port's own draw: standard Gumbel (mean = Euler's gamma,
    variance pi^2 / 6) from its generator, the same for the same seed."""
    def draw(seed):
        return L.gumbel_noise(torch.Generator().manual_seed(seed),
                              (64, 4096))
    a = draw(0)
    assert torch.equal(a, draw(0)) and not torch.equal(a, draw(1))
    assert a.dtype == torch.float32 and torch.isfinite(a).all()
    assert abs(a.mean().item() - 0.5772) < 0.01
    assert abs(a.var().item() - np.pi ** 2 / 6) < 0.03


# -------------------------------------------------- the engine against JAX
@pytest.mark.parametrize("chunk_tokens", [0, 3])
@pytest.mark.parametrize("paged", [True, False])
def test_sampled_slot_serve_equals_jax(monkeypatch, pair, chunk_tokens,
                                       paged):
    cfg, jeng, peng = pair
    jeng.init_slots(N_SLOTS, paged=paged, page_size=PAGE,
                    sampling=JaxSampling(**NUCLEUS), rng_seed=3)
    peng.init_slots(N_SLOTS, paged=paged, page_size=PAGE,
                    sampling=SamplingParams(**NUCLEUS), rng_seed=3)
    spec, prompts = _workload(cfg)
    want = _serve("jax", cfg, jeng, spec, prompts, chunk_tokens=chunk_tokens)
    noise = _JaxNoise(3)
    monkeypatch.setattr(L, "gumbel_noise", noise)
    got = _serve("port", cfg, peng, spec, prompts, chunk_tokens=chunk_tokens)
    assert got == want
    assert noise.calls == peng.stats.decode_steps
    assert dataclasses.asdict(peng.stats) == dataclasses.asdict(jeng.stats)
    assert all(0 <= t < cfg.vocab_size for s in got.values() for t in s)


@pytest.mark.parametrize("n_new", [5, 13])
def test_sampled_generate_equals_jax(monkeypatch, pair, n_new):
    """``generate``'s ``pick``: every token sampled, the first included,
    surplus tokens of the power-of-two scan dropped; and
    ``generate_eager``'s ``categorical`` on the raw logits after an
    arg-max first token."""
    cfg, jeng, peng = pair
    tokens = np.random.default_rng(2).integers(
        1, cfg.vocab_size, (3, 21)).astype(np.int32)
    want = jeng.generate({"tokens": jnp.asarray(tokens)}, n_new,
                         rng=jax.random.PRNGKey(4),
                         sampling=JaxSampling(**NUCLEUS))
    noise = _JaxNoise(4)
    monkeypatch.setattr(L, "gumbel_noise", noise)
    got = peng.generate({"tokens": tokens}, n_new, rng=4,
                        sampling=SamplingParams(**NUCLEUS))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert noise.calls == 1 + (1 << (n_new - 1).bit_length())
    want = jeng.generate_eager({"tokens": jnp.asarray(tokens)}, n_new,
                               greedy=False, rng=jax.random.PRNGKey(5))
    monkeypatch.setattr(L, "gumbel_noise", _JaxNoise(5))
    got = peng.generate_eager({"tokens": tokens}, n_new, greedy=False, rng=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_one_executable_per_sampling_config_as_jax_keys(pair):
    """``slot_step`` and ``generate`` are keyed by the sampling config as
    the JAX engine keys them: a second config adds one entry, a repeat
    adds none (fresh engines on the module's weights, so the counts start
    at 0)."""
    cfg, jpair, ppair = pair
    jeng = JaxEngine(jpair.api, jpair.params, cache_len=CACHE_LEN)
    peng = InferenceEngine(ppair.api, ppair.params, cache_len=CACHE_LEN)
    spec, prompts = _workload(cfg, n=3)
    tokens = np.random.default_rng(2).integers(
        1, cfg.vocab_size, (2, 9)).astype(np.int32)
    configs = [None, NUCLEUS, dict(temperature=1.0, top_k=1), NUCLEUS]
    jcounts, pkeys = [], []
    for conf in configs:
        jeng.init_slots(N_SLOTS, page_size=PAGE,
                        sampling=conf and JaxSampling(**conf))
        peng.init_slots(N_SLOTS, page_size=PAGE,
                        sampling=conf and SamplingParams(**conf))
        _serve("jax", cfg, jeng, spec, prompts)
        _serve("port", cfg, peng, spec, prompts)
        jcounts.append(jeng.jit_cache_sizes()["slot_step"])
        pkeys.append(list(peng._graphs.entries["slot_step"]))
        jeng.generate({"tokens": jnp.asarray(tokens)}, 3,
                      sampling=conf and JaxSampling(**conf))
        peng.generate({"tokens": tokens}, 3,
                      sampling=conf and SamplingParams(**conf))
    # the port drops its slot executables with the slots they bind; the
    # JAX engine keeps one per config ever used
    assert pkeys == [[None if c is None else SamplingParams(**c)]
                     for c in configs]
    assert jcounts == [1, 2, 3, 3]
    assert sorted(map(repr, jeng._slot_step_jit)) == sorted(
        repr(None if c is None else JaxSampling(**c)) for c in configs[:3])
    # generate: one entry per (shape, sampling), as the JAX scan's keys
    assert peng.jit_cache_sizes()["generate"] == \
        jeng.jit_cache_sizes()["generate"] == 3
    assert {k[-1] for k in peng._graphs.entries["generate"]} == {
        None, SamplingParams(**NUCLEUS),
        SamplingParams(temperature=1.0, top_k=1)}


# ------------------------------------------------------ the port's own noise
def _own_serve(cfg, peng, sampling, seed, paged=True):
    peng.init_slots(N_SLOTS, paged=paged, page_size=PAGE, sampling=sampling,
                    rng_seed=seed)
    spec, prompts = _workload(cfg, seed=9, n=6)
    return _serve("port", cfg, peng, spec, prompts, chunk_tokens=3)


def test_same_seed_repeats_other_seed_differs(pair):
    cfg, _, peng = pair
    sp = SamplingParams(**NUCLEUS)
    a = _own_serve(cfg, peng, sp, 0)
    assert _own_serve(cfg, peng, sp, 0) == a
    assert _own_serve(cfg, peng, sp, 1) != a
    assert all(0 <= t < cfg.vocab_size for s in a.values() for t in s)
    tokens = np.random.default_rng(3).integers(
        1, cfg.vocab_size, (4, 11)).astype(np.int32)
    g = [peng.generate({"tokens": tokens}, 9, rng=r, sampling=sp)
         for r in (7, 7, 8)]
    assert torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2])


@pytest.mark.parametrize("conf", [dict(temperature=0.0),
                                  dict(temperature=0.8, top_k=1)])
def test_degenerate_sampling_is_greedy(pair, conf):
    """``temperature=0`` and ``top_k=1`` leave one choice: the greedy
    streams, in the slot serve and in ``generate``."""
    cfg, _, peng = pair
    assert _own_serve(cfg, peng, SamplingParams(**conf), 5) == \
        _own_serve(cfg, peng, None, 0)
    tokens = np.random.default_rng(3).integers(
        1, cfg.vocab_size, (4, 11)).astype(np.int32)
    assert torch.equal(
        peng.generate({"tokens": tokens}, 6,
                      sampling=SamplingParams(**conf)),
        peng.generate({"tokens": tokens}, 6))


def test_sampling_engine_is_not_spec_capable(pair):
    """Draft/verify equivalence is an arg-max identity: a sampling engine
    refuses a draft, and the pool's ``enable_speculation`` skips it."""
    cfg, _, peng = pair
    api = peng.api
    greedy = InferenceEngine(api, peng.params, cache_len=CACHE_LEN,
                             alloc_chips=50).init_slots(2, page_size=PAGE)
    sampled = InferenceEngine(api, peng.params, cache_len=CACHE_LEN,
                              alloc_chips=100).init_slots(
        2, page_size=PAGE, sampling=SamplingParams(**NUCLEUS))
    assert greedy.spec_capable() and not sampled.spec_capable()
    with pytest.raises(ValueError, match="greedy"):
        sampled.attach_draft(InferenceEngine(
            api, peng.params, cache_len=CACHE_LEN).init_slots(
                2, paged=False), spec_k=2)
    from repro_torch.core.profiles import build_profile
    host = ModelHost(cfg, api, peng.params, build_profile(MODEL),
                     {50: StandbyAllocation(50, 2, greedy),
                      100: StandbyAllocation(100, 2, sampled)},
                     prompt_len=8)
    pool = EnginePool({MODEL: host})
    assert pool.enable_speculation(MODEL, MODEL, spec_k=2) == 1
    assert greedy._draft is not None and sampled._draft is None
