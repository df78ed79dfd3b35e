"""The port's radix prompt cache (``repro_torch.serving.prefix_cache`` and
the engine's and planner's prefix-cache paths) against the JAX package's,
on the CPU.

* Every test of ``tests/test_prefix_cache.py``, case for case, on the
  port: the tree over a bare ``PageAllocator`` (longest-prefix match at
  page granularity, pins, dedup and splits, copy-on-write sources, the
  hit-quality floor, LRU eviction that skips row-shared leaves, the
  read-only ``peek``, flush), and the serves on a reduced olmo-1b paged
  engine (4 slots of 32 tokens, pages of 8): cache-on streams equal to
  cache-off with fewer prefill tokens and no new executable, chunked
  admissions beside hits, eviction before preemption, ``recover``
  keeping the hot subtree, same-tick dedup, hit-aware admission order,
  and the SSM family's refusal.
* Against the JAX package, on the same weights: the reference's
  shared-prefix workload served cache off and on through ``serve_ticks``
  (whole-prompt and chunked admission) gives the same greedy streams,
  the same ``EngineStats`` (prefix hits, hit tokens, COW copies, forced
  catch-up tokens, dedup pages included), the same page placement after
  ``release_all_slots`` and the same ``jit_cache_sizes()`` counts,
  ``copy_page`` and ``alias_slot`` included; a random sequence of tree
  operations leaves both trees, and both allocators, in the same state;
  and the pool plane with ``prefix_cache=True`` makes the JAX pool's
  admissions with the same counters.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.serving import plan as jax_plan  # noqa: E402
from repro.serving import request as jax_request  # noqa: E402
from repro.serving.engine import make_engine as jax_make_engine  # noqa
from repro.serving.kv_cache import PageAllocator as JaxAllocator  # noqa
from repro.serving.prefix_cache import PrefixCache as JaxCache  # noqa
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402
from repro_torch.serving.engine import make_engine  # noqa: E402
from repro_torch.serving.kv_cache import PageAllocator  # noqa: E402
from repro_torch.serving.plan import (PlannerConfig,  # noqa: E402
                                      StepPlanner, serve_ticks)
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: E402
from repro_torch.serving.request import Request, RequestQueue  # noqa: E402

CACHE_LEN = 32
N_SLOTS = 4
PAGE = 8
MODEL = "olmo-1b"
# the executables both packages count per engine, by the JAX engine's
# names. Not ``alias_slot``: the JAX engine jits the module-level
# ``_alias_slot``, whose trace cache every JAX engine of the process
# shares, so its count depends on the other engines that ran; the JAX
# engine is held to tracing it anew in no serve, the port to one entry.
SHARED_KINDS = ("packed_prefill", "chunk_prefill", "slot_step",
                "copy_page")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced engines' ops are tiny: one intra-op thread serves them
    as fast, and keeps this module from oversubscribing the cores that
    parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# tree unit tests: PrefixCache over a bare allocator, no engine
# ---------------------------------------------------------------------------
def _tree(num_pages=12, ps=4):
    a = PageAllocator(num_pages)
    return a, PrefixCache(a, ps)


def _toks(*vals):
    return list(vals)


def test_match_on_empty_tree_is_miss():
    a, c = _tree()
    assert c.match([1, 2, 3, 4, 5]) is None
    assert c.stats.misses == 1 and c.stats.hits == 0
    assert a.free_pages == 12
    c.check_invariants()


def test_insert_match_pin_release_roundtrip():
    a, c = _tree(ps=4)
    pages = a.alloc(2)                    # the "registering row" owns these
    c.insert(_toks(1, 2, 3, 4, 5, 6, 7, 8), pages)
    assert c.held_pages == 2
    assert all(a.refcount(p) == 2 for p in pages)   # row + tree
    hit = c.match(_toks(1, 2, 3, 4, 5, 6, 7, 8, 9, 9), max_covered=9)
    assert hit is not None and hit.covered == 8
    assert hit.pages == tuple(pages) and hit.cow_src is None
    assert all(a.refcount(p) == 3 for p in pages)   # + match pin
    c.release_hit(hit)
    assert all(a.refcount(p) == 2 for p in pages)
    # registering row frees; the tree's hold keeps the pages resident
    assert a.release(pages) == 0
    assert all(a.refcount(p) == 1 for p in pages)
    c.check_invariants()


def test_insert_dedupes_and_splits_at_page_boundary():
    a, c = _tree(ps=4)
    p1 = a.alloc(3)
    base = _toks(1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12)
    assert c.insert(base, p1) == 3
    # identical prefix: nothing new retained
    p2 = a.alloc(3)
    assert c.insert(base, p2) == 0
    a.free(p2)
    # diverge after page 2: the edge splits at the boundary and both
    # suffixes stay matchable
    p3 = a.alloc(3)
    other = _toks(1, 2, 3, 4, 5, 6, 7, 8, 90, 91, 92, 93)
    assert c.insert(other, p3) == 1       # only the divergent page is new
    assert c.held_pages == 4
    h1 = c.match(base + [99])
    h2 = c.match(other + [99])
    assert h1.covered == 12 and h1.pages == tuple(p1)
    assert h2.covered == 12 and h2.pages == (p1[0], p1[1], p3[2])
    c.release_hit(h1)
    c.release_hit(h2)
    c.check_invariants()
    # p3's first two pages were never retained by the tree
    assert a.release(p3[:2]) == 2


def test_partial_page_match_returns_cow_source():
    a, c = _tree(ps=4)
    pages = a.alloc(2)
    c.insert(_toks(1, 2, 3, 4, 5, 6, 7, 8), pages)
    # diverges inside page 2 after two tokens: page 1 aliased, page 2 COW
    hit = c.match(_toks(1, 2, 3, 4, 5, 6, 70, 71, 72))
    assert hit.covered == 6
    assert hit.pages == (pages[0],) and hit.cow_src == pages[1]
    assert a.refcount(pages[0]) == 3      # row + tree + pin
    assert a.refcount(pages[1]) == 3      # row + tree + COW pin
    c.release_hit(hit)
    assert c.stats.cow_hits == 1
    c.check_invariants()


def test_min_covered_floor_rejects_and_pins_nothing():
    a, c = _tree(ps=4)
    pages = a.alloc(1)
    c.insert(_toks(1, 2, 3, 4), pages)
    refs = {p: a.refcount(p) for p in pages}
    assert c.match(_toks(1, 2, 3, 4, 5), min_covered=5) is None
    assert c.stats.misses == 1 and c.stats.hits == 0
    assert {p: a.refcount(p) for p in pages} == refs
    # at the floor it is a hit again
    hit = c.match(_toks(1, 2, 3, 4, 5), min_covered=4)
    assert hit is not None and hit.covered == 4
    c.release_hit(hit)


def test_evict_lru_skips_row_shared_leaves():
    a, c = _tree(num_pages=12, ps=4)
    p_cold = a.alloc(1)
    c.insert(_toks(1, 2, 3, 4), p_cold)          # colder (inserted first)
    p_warm = a.alloc(1)
    c.insert(_toks(9, 9, 9, 9), p_warm)
    # the cold leaf is still row-shared: evicting it would free nothing,
    # so eviction must take the warmer but freeable leaf instead
    a.release(p_warm)                             # row gone, tree ref only
    assert c.evict(1) == 1
    assert c.stats.evictions == 1 and c.stats.evicted_pages == 1
    hit = c.match(_toks(1, 2, 3, 4))
    assert hit is not None                        # cold leaf survived
    c.release_hit(hit)
    # once the row releases, the leaf becomes a victim and actually frees
    a.release(p_cold)
    assert c.evict(1) == 1
    assert c.held_pages == 0
    assert a.free_pages == 12
    c.check_invariants()


def test_peek_is_read_only_and_page_granular():
    """``peek`` reports the whole-page covered length like ``match``
    would, but is strictly read-only: no clock tick, no LRU touch, no
    stats, no pins."""
    a, c = _tree(ps=4)
    pages = a.alloc(2)
    c.insert(_toks(1, 2, 3, 4, 5, 6, 7, 8), pages)
    child = next(iter(c._root.children.values()))
    clock, lu = c._clock, child.last_used
    stats = dataclasses.replace(c.stats)
    refs = {p: a.refcount(p) for p in pages}
    assert c.peek(_toks(1, 2, 3, 4, 5, 6, 7, 8, 9)) == 8
    assert c.peek(_toks(1, 2, 3, 4, 5, 6, 7, 8)) == 8
    # max_covered truncates to whole pages, like match's page walk
    assert c.peek(_toks(1, 2, 3, 4, 5, 6, 7, 8), max_covered=7) == 4
    # mid-page divergence: only the whole matching page counts
    assert c.peek(_toks(1, 2, 3, 4, 5, 6, 70, 71)) == 4
    assert c.peek(_toks(9, 9, 9, 9)) == 0
    assert c.peek(_toks(1, 2)) == 0               # shorter than a page
    assert c._clock == clock and child.last_used == lu
    assert c.stats == stats
    assert {p: a.refcount(p) for p in pages} == refs
    c.check_invariants()


def test_flush_releases_every_hold():
    a, c = _tree(ps=4)
    p1, p2 = a.alloc(2), a.alloc(1)
    c.insert(_toks(1, 2, 3, 4, 5, 6, 7, 8), p1)
    c.insert(_toks(7, 7, 7, 7), p2)
    a.release(p1)
    a.release(p2)                                 # rows gone, tree holds 3
    assert a.free_pages == 9
    assert c.flush() == 3
    assert a.free_pages == 12 and c.held_pages == 0
    assert c.match(_toks(1, 2, 3, 4, 5)) is None
    c.check_invariants()


def _tree_state(a, c):
    def walk(node):
        return [(k, node.children[k].tokens, node.children[k].pages,
                 node.children[k].last_used, walk(node.children[k]))
                for k in node.children]
    return (walk(c._root), c._clock, c.held_pages,
            dataclasses.asdict(c.stats), a.free_pages,
            [a.refcount(p) for p in range(1, a.num_pages + 1)])


def test_random_tree_operations_equal_jax():
    """A seeded random sequence of inserts, matches, peeks, releases,
    evictions, retains and flushes on both packages' trees: every call
    returns the same result and leaves both trees and allocators in the
    same state."""
    rng = np.random.default_rng(0)
    sides = [(JaxAllocator(40), JaxCache), (PageAllocator(40), PrefixCache)]
    sides = [(a, cls(a, 4)) for a, cls in sides]
    heads = [list(rng.integers(1, 5, size=12)) for _ in range(3)]
    rows, hits = [[], []], [[], []]
    for _ in range(150):
        op = int(rng.integers(0, 8))
        head = heads[int(rng.integers(0, 3))][:int(rng.integers(4, 13))]
        toks = [int(t) for t in head] + [
            int(t) for t in rng.integers(1, 5, size=int(rng.integers(0, 6)))]
        n_pages = int(rng.integers(1, 4))
        whole = (toks + [1] * 12)[:4 * n_pages]
        arg = int(rng.integers(1, 9))
        out = []
        for i, (a, c) in enumerate(sides):
            got = None
            if op == 0 and a.can_alloc(n_pages):
                pages = a.alloc(n_pages)
                rows[i].append(pages)
                got = c.insert(whole, pages)
            elif op == 1:
                got = c.match(toks, max_covered=len(toks) - 1,
                              min_covered=arg)
                if got is not None:
                    hits[i].append(got)
            elif op == 2:
                got = c.peek(toks), c.canonical_pages(toks)
            elif op == 3 and hits[i]:
                c.release_hit(hits[i].pop(0))
            elif op == 4 and rows[i]:
                got = a.release(rows[i].pop(0))
            elif op == 5:
                got = c.evict(arg % 4)
            elif op == 6:
                got = c.retain_recent(2 * arg)
            elif op == 7 and not hits[i]:
                got = c.flush()
            if dataclasses.is_dataclass(got):      # a PrefixHit
                got = dataclasses.astuple(got)
            out.append(got)
            c.check_invariants()
        assert out[1] == out[0], op
        assert _tree_state(*sides[1]) == _tree_state(*sides[0])


# ---------------------------------------------------------------------------
# serving tests: one warmed dense engine per package, cache on vs off
# ---------------------------------------------------------------------------
def _pair(pages=None, graphs_cache=True, model=MODEL):
    """(cfg, JAX engine, port engine) on the same weights, both with a
    warmed prefix cache."""
    jeng = jax_make_engine(jax_config(model).reduced(),
                           cache_len=CACHE_LEN).init_slots(
        N_SLOTS, paged=True, page_size=PAGE, total_pages=pages)
    cfg = get_config(model).reduced()
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jeng.params),
                               device="cpu")
    peng = InferenceEngine(build_model(cfg, device="cpu"), params,
                           cache_len=CACHE_LEN).init_slots(
        N_SLOTS, paged=True, page_size=PAGE, total_pages=pages)
    for eng in (jeng, peng):
        assert eng.prefix_cache_capable()
        eng.enable_prefix_cache()
        eng.warm_prefix_ops()
    return cfg, jeng, peng


@pytest.fixture(scope="module")
def engines():
    """A (JAX, port) pair that serves only the parity cases, so both
    engines meet the same buckets in the same order."""
    return _pair()


@pytest.fixture(scope="module")
def engine():
    """The port engine the reference's serving cases run on."""
    cfg, _, peng = _pair()
    return cfg, peng


def _shared_workload(cfg, seed, n, template_lens=(20, 8), budgets=(3, 7)):
    """The reference's heavy-tailed shared-prefix stream (host arrays);
    template length 20 is not a page multiple, so some hits diverge
    mid-page and exercise COW."""
    rng = np.random.default_rng(seed)
    temps = [rng.integers(1, cfg.vocab_size, size=s).astype(np.int32)
             for s in template_lens]
    reqs, prompts = [], {}
    for i in range(n):
        t = temps[int(rng.integers(0, len(temps)))]
        tail = rng.integers(1, cfg.vocab_size,
                            size=int(rng.integers(2, 6))).astype(np.int32)
        toks = np.concatenate([t, tail])
        reqs.append(Request(arrival=0.0, rid=i, model=cfg.name, slo=1e9,
                            n_tokens=int(rng.integers(*budgets)),
                            prompt_len=len(toks)))
        prompts[i] = toks[None, :]
    return reqs, prompts


def _serve(cfg, eng, reqs, prompts, *, prefix_cache=False, side="port",
           **planner_kw):
    """Serve to drain on one package's engine (the reference test's
    ``_serve``). Returns (streams, stats, planner, server)."""
    plan, request = ((jax_plan, jax_request) if side == "jax"
                     else (None, None))
    eng.release_all_slots()               # frees rows AND flushes the cache
    eng.reset_stats()
    if side == "jax":
        reqs = [jax_request.Request(**{f.name: getattr(r, f.name)
                                       for f in dataclasses.fields(r)
                                       if f.init}) for r in reqs]
        planner = plan.StepPlanner(
            eng, request.RequestQueue(cfg.name, slo=1e9),
            plan.PlannerConfig(gen_len=4, prefix_cache=prefix_cache,
                               **planner_kw))
        srv = plan.serve_ticks(
            planner, reqs, lambda r: {"tokens": jnp.asarray(prompts[r.rid])},
            stall_limit=50)
    else:
        for r in reqs:
            r.state = "pending"
        planner = StepPlanner(eng, RequestQueue(cfg.name, slo=1e9),
                              PlannerConfig(gen_len=4,
                                            prefix_cache=prefix_cache,
                                            **planner_kw))
        srv = serve_ticks(planner, reqs, lambda r: {"tokens": prompts[r.rid]},
                          stall_limit=50)
    assert not srv.truncated
    # drain invariant under sharing: every page is either free or held
    # by the cache, and the full refcount audit passes
    held = eng.prefix_cache.held_pages if eng.prefix_cache else 0
    assert eng.free_pages + held == eng.total_pages
    eng.check_page_invariants()
    if eng.prefix_cache:
        eng.prefix_cache.check_invariants()
    streams = {r: tuple(t) for r, t in planner.streams.items()}
    return streams, dataclasses.replace(eng.stats), planner, srv


def test_serve_bit_exact_with_fewer_prefill_tokens(engine):
    """Cache-on greedy streams equal cache-off while admission prefill
    tokens drop, hits/COW/teacher-forced counters surface, and no
    executable is added."""
    cfg, eng = engine
    reqs, prompts = _shared_workload(cfg, seed=3, n=10)
    base, st_off, _, _ = _serve(cfg, eng, reqs, prompts)
    jit_before = eng.jit_cache_sizes()
    got, st_on, planner, _ = _serve(cfg, eng, reqs, prompts,
                                    prefix_cache=True)
    assert got == base
    assert st_on.prefill_tokens < st_off.prefill_tokens
    assert st_on.prefix_hits > 0
    assert st_on.prefix_hit_tokens > 0
    assert st_on.cow_copies > 0           # template 20 diverges mid-page
    assert st_on.forced_catchup_tokens > 0
    assert eng.jit_cache_sizes() == jit_before, "prefix cache recompiled"


def test_chunked_admission_unaffected_by_hits(engine):
    """Hits ride whole-prompt-style admission (zero-cost leading chunk +
    teacher-forced tail); chunked prefill for misses coexists and the
    streams still match the cache-off chunked run."""
    cfg, eng = engine
    reqs, prompts = _shared_workload(cfg, seed=11, n=8)
    base, _, _, _ = _serve(cfg, eng, reqs, prompts, chunk_tokens=3)
    got, st_on, _, _ = _serve(cfg, eng, reqs, prompts, chunk_tokens=3,
                              prefix_cache=True)
    assert got == base
    assert st_on.prefix_hits > 0


def _distinct_workload(cfg):
    rng = np.random.default_rng(5)
    reqs, prompts = [], {}
    for i in range(8):
        toks = rng.integers(1, cfg.vocab_size, size=22).astype(np.int32)
        reqs.append(Request(arrival=0.0, rid=i, model=cfg.name, slo=1e9,
                            n_tokens=4, prompt_len=len(toks)))
        prompts[i] = toks[None, :]
    return reqs, prompts


def test_cold_cache_evicted_before_preemption(engine):
    """Page pressure from new admissions evicts cold radix nodes first;
    no live resident is preempted while the cache can still pay."""
    cfg, eng = engine
    # distinct long prompts: every admission misses, registrations pile
    # pages into the cache, later waves must reclaim them to admit
    reqs, prompts = _distinct_workload(cfg)
    base, _, _, _ = _serve(cfg, eng, reqs, prompts)
    got, _, planner, _ = _serve(cfg, eng, reqs, prompts, prefix_cache=True)
    assert got == base
    assert eng.prefix_cache.stats.evictions > 0, \
        "page pressure never evicted the cache"
    assert planner.metrics.preemptions == 0, \
        "resident preempted while cold cache pages were available"


def test_recover_persists_hot_nodes_and_conserves_pages(engine):
    """``recover()`` keeps the hot radix subtree (``retain_recent``)
    instead of flushing, and its conservation audit accounts the
    survivors: free + cache-held == total. A stale tree (everything past
    ``prefix_hot_window``) still prunes to nothing."""
    cfg, eng = engine
    reqs, prompts = _shared_workload(cfg, seed=17, n=6)
    _serve(cfg, eng, reqs, prompts, prefix_cache=True)
    held = eng.prefix_cache.held_pages
    assert held > 0                           # registrations persist
    eng.recover()
    # recently-used nodes survive the reset; every non-cache page is free
    assert eng.prefix_cache.held_pages > 0
    assert (eng.free_pages + eng.prefix_cache.held_pages
            == eng.total_pages)
    eng.check_page_invariants()
    # a fresh serve over the same templates HITS the persisted nodes
    hits_before = eng.prefix_cache.stats.hits
    planner = StepPlanner(eng, RequestQueue(cfg.name, slo=1e9),
                          PlannerConfig(gen_len=4, prefix_cache=True))
    reqs2, prompts2 = _shared_workload(cfg, seed=17, n=4)
    serve_ticks(planner, reqs2, lambda r: {"tokens": prompts2[r.rid]},
                stall_limit=50)
    assert eng.prefix_cache.stats.hits > hits_before, \
        "persisted nodes never served a hit after recovery"
    # ...and an engine whose cache went cold prunes it all at recover()
    eng.prefix_cache._clock += eng.prefix_hot_window + 1
    eng.recover()
    assert eng.prefix_cache.held_pages == 0
    assert eng.free_pages == eng.total_pages
    eng.release_all_slots()


def _dedup_workload(cfg):
    rng = np.random.default_rng(29)
    shared = rng.integers(1, cfg.vocab_size, size=16).astype(np.int32)
    reqs, prompts = [], {}
    for i in range(3):
        tail = rng.integers(1, cfg.vocab_size, size=3 + i).astype(np.int32)
        toks = np.concatenate([shared, tail])
        reqs.append(Request(arrival=0.0, rid=i, model=cfg.name, slo=1e9,
                            n_tokens=4, prompt_len=len(toks)))
        prompts[i] = toks[None, :]
    return reqs, prompts


def test_same_tick_shared_prefills_dedup_to_canonical_pages(engine):
    """Identical-prefix prompts admitted in the SAME tick all prefill,
    but at registration the later rows' leading full pages are
    repointed onto the first registrant's canonical pages and the
    duplicates freed, with streams equal to the cache-off run."""
    cfg, eng = engine
    reqs, prompts = _dedup_workload(cfg)
    base, st_off, _, _ = _serve(cfg, eng, reqs, prompts)
    assert st_off.dedup_pages == 0        # counter is cache-gated
    jit_before = eng.jit_cache_sizes()
    got, st_on, _, _ = _serve(cfg, eng, reqs, prompts, prefix_cache=True)
    assert got == base
    # 16 shared tokens = 2 full pages; the 2nd and 3rd registrants each
    # release their duplicate pair when repointed onto the canonical pair
    assert st_on.dedup_pages == 4
    assert eng.jit_cache_sizes() == jit_before    # repoint never compiles


def test_select_admissible_prefers_cache_hot_prefixes(engine):
    """With the cache on, the admission gate stable-sorts cache-HOT
    requests (read-only ``peek`` covers the ``prefix_min_frac`` floor)
    ahead of cold ones within the admitted batch; pop order is
    unchanged."""
    cfg, eng = engine
    rng = np.random.default_rng(21)
    temp = rng.integers(1, cfg.vocab_size, size=16).astype(np.int32)

    def prompt(tail_seed, hot):
        r2 = np.random.default_rng(tail_seed)
        head = temp if hot else r2.integers(
            1, cfg.vocab_size, size=16).astype(np.int32)
        tail = r2.integers(1, cfg.vocab_size, size=4).astype(np.int32)
        return {"tokens": np.concatenate([head, tail])[None, :]}

    # warm: one served templated request registers temp's 2 full pages
    warm = [Request(arrival=0.0, rid=0, model=cfg.name, slo=1e9,
                    n_tokens=2, prompt_len=20)]
    _serve(cfg, eng, warm, {0: prompt(100, hot=True)["tokens"]},
           prefix_cache=True)
    assert eng.prefix_cache.held_pages >= 2
    stats = dataclasses.replace(eng.prefix_cache.stats)

    # fresh planner over the warm engine: cold, hot, cold, hot
    q = RequestQueue(cfg.name, slo=1e9)
    planner = StepPlanner(eng, q, PlannerConfig(gen_len=4,
                                                prefix_cache=True))
    order = [(1, False), (2, True), (3, False), (4, True)]
    for rid, hot in order:
        planner.submit(Request(arrival=0.0, rid=rid, model=cfg.name,
                               slo=1e9, n_tokens=2, prompt_len=20),
                       prompt(200 + rid, hot))
    kept = planner.select_admissible(eng, q, prompt_len=20, max_batch=4,
                                     now=0.0, gen_len=4)
    assert [r.rid for r, _ in kept] == [2, 4, 1, 3]
    assert len(q) == 0                    # pop order / quota unchanged
    # the probe was read-only: no hit/miss/pin accounting moved
    assert eng.prefix_cache.stats == stats
    eng.prefix_cache.check_invariants()


def test_incapable_family_refuses_cache():
    """SSM state folds the whole prefix into non-shareable per-row state:
    the engine refuses loudly; best-effort callers (the pool) gate on
    ``prefix_cache_capable`` instead."""
    cfg = get_config("mamba2-1.3b").reduced()
    eng = make_engine(cfg, cache_len=16, device="cpu").init_slots(
        2, paged=True, page_size=8)
    assert not eng.prefix_cache_capable()
    with pytest.raises(ValueError, match="prefix cache"):
        eng.enable_prefix_cache()
    assert eng.prefix_cache is None
    eng.warm_prefix_ops()                     # no-op without a cache


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
def _placement(eng):
    """Page placement after ``release_all_slots``: the free list, and
    the tree's pages (empty after the flush)."""
    eng.release_all_slots()
    return (list(eng._kv.allocator._free), eng.prefix_cache.held_pages)


def _assert_serves_equal(cfg, jeng, peng, reqs, prompts, **kw):
    a = _serve(cfg, jeng, reqs, prompts, side="jax", **kw)
    b = _serve(cfg, peng, reqs, prompts, **kw)
    assert b[0] == a[0], "port streams differ from the JAX package's"
    assert dataclasses.asdict(b[1]) == dataclasses.asdict(a[1])
    assert dataclasses.asdict(b[2].metrics) == dataclasses.asdict(
        a[2].metrics)
    assert (b[3].ticks, b[3].dispatches) == (a[3].ticks, a[3].dispatches)
    return a, b


@pytest.mark.parametrize("chunk_tokens", [0, 3])
def test_shared_prefix_serve_equals_jax(engines, chunk_tokens):
    """The reference's shared-prefix workload cache off, then on: the
    same streams, counters and dispatches as the JAX engine, the same
    page placement, and the same executables."""
    cfg, jeng, peng = engines
    alias = jeng.jit_cache_sizes()["alias_slot"]
    reqs, prompts = _shared_workload(cfg, seed=3, n=10)
    _assert_serves_equal(cfg, jeng, peng, reqs, prompts,
                         chunk_tokens=chunk_tokens)
    _, b = _assert_serves_equal(cfg, jeng, peng, reqs, prompts,
                                chunk_tokens=chunk_tokens, prefix_cache=True)
    st = b[1]
    assert st.prefix_hits and st.cow_copies and st.forced_catchup_tokens
    got = {k: v for k, v in peng.jit_cache_sizes().items()
           if k in SHARED_KINDS}
    want = {k: jeng.jit_cache_sizes().get(k, 0) for k in got}
    assert got == want
    assert got["copy_page"] == 1
    assert peng.jit_cache_sizes()["alias_slot"] == 1
    assert jeng.jit_cache_sizes()["alias_slot"] == alias
    assert set(peng._graphs.entries["chunk_prefill"]) == set(
        jeng._chunk_prefill_jit)
    assert _placement(peng) == _placement(jeng)


def test_moe_prefix_cache_serve_equals_jax():
    """granite-moe reduced: the experts keep the prefix cache (pages plus
    ``pos`` hold a row's whole state) and, not being ``chunk_capable``,
    catch a hit up by forced tokens through the slot step. Cache off and
    on, the port serves the JAX engine's streams, counters and hits."""
    cfg, jeng, peng = _pair(model="granite-moe-3b-a800m")
    assert not peng.chunk_capable()
    reqs, prompts = _shared_workload(cfg, seed=3, n=10)
    _assert_serves_equal(cfg, jeng, peng, reqs, prompts)
    _, b = _assert_serves_equal(cfg, jeng, peng, reqs, prompts,
                                prefix_cache=True)
    st = b[1]
    assert st.prefix_hits and st.forced_catchup_tokens
    assert st.incr_chunks == 0
    assert dataclasses.asdict(peng.prefix_cache.stats) == \
        dataclasses.asdict(jeng.prefix_cache.stats)


def test_eviction_and_dedup_serves_equal_jax(engines):
    """The eviction and dedup workloads: the same streams and counters
    (``dedup_pages`` included) and the same evictions as the JAX
    engine."""
    cfg, jeng, peng = engines
    for reqs, prompts in (_distinct_workload(cfg), _dedup_workload(cfg)):
        _assert_serves_equal(cfg, jeng, peng, reqs, prompts,
                             prefix_cache=True)
        assert dataclasses.asdict(peng.prefix_cache.stats) == \
            dataclasses.asdict(jeng.prefix_cache.stats)
        assert _placement(peng) == _placement(jeng)


def test_pool_prefix_cache_equals_jax():
    """The pool plane with ``prefix_cache=True``: admissions alias the
    shared prompt and catch up eagerly; the port's pool makes the JAX
    pool's admissions with the same prefix counters."""
    from repro.serving.controller import run_policy as jax_run_policy
    from repro.serving.pool import build_pool as jax_build_pool
    from repro_torch.core.hardware import Hardware
    from repro_torch.core.profiles import build_profile
    from repro_torch.serving.controller import run_policy
    from repro_torch.serving.pool import EnginePool, build_host
    from repro.core.hardware import V5E
    from repro.core.latency_model import CHIP_LEVELS
    hw = Hardware(**dataclasses.asdict(V5E), levels=CHIP_LEVELS, tp_cap=32,
                  tp_shard_width=512, hop_latency=1e-6)
    names, rate = ["olmo-1b"], 1500.0
    jpool = jax_build_pool(names, request_rate=rate, base_slots=2,
                           cache_len=32, prompt_len=12, prefix_cache=True)
    hosts = {}
    for name in names:
        jh = jpool.hosts[name]
        params = params_from_numpy(jh.cfg, jax.tree.map(np.asarray,
                                                        jh.params), "cpu")
        hosts[name] = build_host(
            name, profile=build_profile(name, request_rate=rate, hw=hw),
            base_slots=2, cache_len=32, prompt_len=12, device="cpu",
            params=params)
    ppool = EnginePool(hosts, prefix_cache=True)
    ppool.warmup()
    caches = [p.jit_cache_sizes() for p in (jpool, ppool)]
    ja = jax_run_policy(jpool, "dstack", rate=rate, duration=0.03,
                        gen_len=3)
    pb = run_policy(ppool, "dstack", rate=rate, duration=0.03, gen_len=3)
    for n, m in ja.per_model.items():
        got = pb.per_model[n]
        assert (got.completed, got.violated, got.dropped,
                got.prefix_hits, got.prefix_hit_tokens) == \
            (m.completed, m.violated, m.dropped, m.prefix_hits,
             m.prefix_hit_tokens), n
        assert got.prefix_hits > 0
    assert ppool.jit_cache_sizes() == caches[1]
    assert jpool.jit_cache_sizes() == caches[0]
    kinds = {k.rsplit("/", 1)[1] for k in ppool.jit_cache_sizes()}
    assert {"copy_page", "alias_slot"} <= kinds
