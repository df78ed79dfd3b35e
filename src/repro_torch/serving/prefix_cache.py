"""Radix prompt cache: prefix sharing over paged KV with copy-on-write — a
copy of the JAX package's ``repro.serving.prefix_cache`` over the port's
page allocator.

At serving scale most prompts share a system prefix and chat turns share
conversation history, yet a plain admission re-prefills every token — the
largest avoidable FLOP cost in the plane. The paged layout makes
sharing a *table-aliasing* exercise: K/V for a token prefix lives in whole
pages, so a new request whose prompt starts with an already-resident
prefix can point its leading block-table entries at those pages and skip
the covered tokens' prefill entirely.

This module is the host-side index that makes any admission able to hit
any cached prefix (the SGLang RadixAttention idea): a radix tree over
token sequences, keyed at **page granularity**.

* Node keys are token runs whose length is a multiple of ``page_size``;
  each node carries the physical page per key page. An edge is indexed by
  its first page of tokens, so lookup walks whole pages.
* ``match`` returns the longest cached prefix of a prompt: fully matched
  pages are aliased read-only into the new row (refcount++ per holder),
  and a *partially* matched page becomes a copy-on-write source — the
  engine copies it into a fresh page with one static-shape dispatch and
  the row diverges there.
* ``insert`` registers a finished prefill's full prompt pages, splitting
  nodes at page boundaries where prompts diverge. The cache holds ONE
  reference per held page (``PageAllocator.share``), so registered pages
  survive the registering row's free — that persistence is the cache.
* ``evict`` releases cold leaves (LRU by a deterministic logical clock)
  until enough pages actually return to the pool; the planner calls it
  before preempting live residents, which is how cold cache competes
  with running work for the page budget.

Everything here is host-side Python over ``PageAllocator`` refcounts —
no device state. Determinism: the logical clock ticks once per cache
operation, dict iteration is insertion-ordered, and ties break on node
creation order, so a seeded replay (a pool reset — engine
``release_all_slots`` — flushes the cache and re-sorts the free list)
reproduces identical page placement. Engine ``recover`` is gentler: it
keeps the HOT subtree (``retain_recent``) so a mid-run fault does not
forfeit the warmed working set, and the recovery audit accounts the
survivors (free + held == total).

Safety argument for read-only aliasing: a hit row starts at
``pos = covered``, so every subsequent write — decode, teacher-forced
catch-up, or a masked-off row's dead write — lands at positions
``>= covered``, i.e. in the row's own COW/fresh pages, never in an
aliased page. Stale K/V beyond ``covered`` inside a COW'd page is never
read (attention masks by ``pos``) and is overwritten in order by the
forced catch-up steps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.kv_cache import PageAllocator


@dataclasses.dataclass(frozen=True)
class PrefixHit:
    """One match result. The caller owns one PINNED reference per page in
    ``pages`` and (when set) on ``cow_src`` — either consume them by
    adopting the pages into a row (``PagedKVCache.alloc_alias`` plus the
    engine's page copy) or return them via ``release_hit``."""
    covered: int                    # prompt tokens covered (full + partial)
    pages: Tuple[int, ...]          # fully matched pages, aliased read-only
    cow_src: Optional[int] = None   # partially matched page to copy, if any


@dataclasses.dataclass
class PrefixCacheStats:
    hits: int = 0
    misses: int = 0
    hit_tokens: int = 0             # prompt tokens covered by hits
    cow_hits: int = 0               # hits that ended on a partial page
    inserts: int = 0
    inserted_pages: int = 0         # new pages retained by the tree
    evictions: int = 0              # nodes evicted
    evicted_pages: int = 0          # pages that actually returned to pool


class _Node:
    """One radix edge: a token run (multiple of page_size) + its pages."""
    __slots__ = ("tokens", "pages", "children", "last_used", "order")

    def __init__(self, tokens: Tuple[int, ...], pages: List[int],
                 clock: int, order: int):
        self.tokens = tokens
        self.pages = pages
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = clock
        self.order = order          # creation order: deterministic LRU ties

    @property
    def n_pages(self) -> int:
        return len(self.pages)


def _lcp(a: Sequence[int], b: Sequence[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class PrefixCache:
    """Host-side radix tree over token prefixes at page granularity."""

    def __init__(self, allocator: PageAllocator, page_size: int):
        self.allocator = allocator
        self.page_size = int(page_size)
        self.stats = PrefixCacheStats()
        self._root = _Node((), [], clock=0, order=0)
        self._clock = 0
        self._order = 0
        self.held_pages = 0         # pages the tree holds one reference on

    # -------------------------------------------------------------- lookup
    def match(self, tokens: Sequence[int],
              max_covered: Optional[int] = None,
              min_covered: int = 1) -> Optional[PrefixHit]:
        """Longest cached prefix of ``tokens``, capped at ``max_covered``
        (admissions cap at prompt_len - 1 so at least one real token is
        left to re-derive the first sampled token). A match shorter than
        ``min_covered`` counts as a miss and pins nothing — the planner's
        hit-quality floor (a short alias saves little prefill but still
        serializes its tail through teacher-forced catch-up). Pins every
        returned page — see ``PrefixHit``. Returns None on a miss."""
        toks = [int(t) for t in tokens]
        limit = len(toks) if max_covered is None else min(len(toks),
                                                          int(max_covered))
        ps = self.page_size
        self._clock += 1
        node = self._root
        shared: List[int] = []
        covered = 0
        cow: Optional[int] = None
        while cow is None:
            rem = limit - covered
            if rem < 1:
                break
            first = tuple(toks[covered:covered + ps]) if rem >= ps else None
            child = node.children.get(first) if first is not None else None
            if child is None:
                # no whole-page edge: the best we can do is a partial match
                # against some child's first page — the COW candidate
                best_len, best_child = 0, None
                for key, cand in node.children.items():
                    j = _lcp(toks[covered:covered + min(rem, ps)], key)
                    if j > best_len:
                        best_len, best_child = j, cand
                if best_child is not None:
                    cow = best_child.pages[0]
                    covered += best_len
                    best_child.last_used = self._clock
                break
            child.last_used = self._clock
            descended = True
            for i in range(child.n_pages):
                rem = limit - covered
                page_toks = child.tokens[i * ps:(i + 1) * ps]
                if rem >= ps and tuple(toks[covered:covered + ps]) == \
                        page_toks:
                    shared.append(child.pages[i])
                    covered += ps
                    continue
                j = _lcp(toks[covered:covered + min(rem, ps)], page_toks)
                if j > 0:
                    cow = child.pages[i]
                    covered += j
                descended = False
                break
            if not descended:
                break
            node = child
        if covered < max(1, int(min_covered)):
            self.stats.misses += 1
            return None
        self.allocator.share(shared)
        if cow is not None:
            self.allocator.share([cow])
            self.stats.cow_hits += 1
        self.stats.hits += 1
        self.stats.hit_tokens += covered
        return PrefixHit(covered=covered, pages=tuple(shared), cow_src=cow)

    def peek(self, tokens: Sequence[int],
             max_covered: Optional[int] = None) -> int:
        """How many leading tokens of ``tokens`` the cache could cover,
        WITHOUT acting on it: no clock tick, no LRU touch, no stats, no
        pins. The planner's hit-aware admission ordering probes every
        queued candidate with this — a probe that mutated recency would
        let the act of *considering* a request keep its prefix warm, and
        a probe that pinned would leak references for requests that are
        then not admitted. Whole-page walk only (partial COW pages count
        toward ``match`` coverage but not here): the ordering heuristic
        cares about pages it can alias for free."""
        toks = [int(t) for t in tokens]
        limit = len(toks) if max_covered is None else min(len(toks),
                                                          int(max_covered))
        ps = self.page_size
        node = self._root
        covered = 0
        while limit - covered >= ps:
            child = node.children.get(tuple(toks[covered:covered + ps]))
            if child is None:
                break
            matched = 0
            for i in range(child.n_pages):
                if (limit - covered >= ps
                        and tuple(toks[covered:covered + ps])
                        == child.tokens[i * ps:(i + 1) * ps]):
                    covered += ps
                    matched += 1
                else:
                    break
            if matched < child.n_pages:
                break
            node = child
        return covered

    def canonical_pages(self, tokens: Sequence[int]) -> List[int]:
        """Physical pages the tree holds for the whole-page prefix of
        ``tokens`` — strictly read-only, like ``peek`` (no clock tick,
        no LRU touch, no stats, no pins). Right after an ``insert``
        these are the CANONICAL pages for that prefix: existing nodes
        keep their original pages on duplicate inserts, so a row that
        just registered can compare its own pages against this walk and
        repoint at the originals (cross-request dedup — see
        ``InferenceEngine.dedup_slot_prefix``)."""
        toks = [int(t) for t in tokens]
        ps = self.page_size
        node = self._root
        out: List[int] = []
        covered = 0
        while len(toks) - covered >= ps:
            child = node.children.get(tuple(toks[covered:covered + ps]))
            if child is None:
                break
            matched = 0
            for i in range(child.n_pages):
                if (len(toks) - covered >= ps
                        and tuple(toks[covered:covered + ps])
                        == child.tokens[i * ps:(i + 1) * ps]):
                    out.append(child.pages[i])
                    covered += ps
                    matched += 1
                else:
                    break
            if matched < child.n_pages:
                break
            node = child
        return out

    def release_hit(self, hit: PrefixHit) -> None:
        """Return an unconsumed hit's pins (admission failed or was
        abandoned before the alias landed)."""
        self.allocator.release(list(hit.pages))
        if hit.cow_src is not None:
            self.allocator.release([hit.cow_src])

    # ---------------------------------------------------------- registration
    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Register a finished prefill: ``tokens`` must be a whole number
        of pages and ``pages`` their physical locations (the registering
        row keeps its own references; the tree takes one more per page it
        retains). Existing matching nodes keep their pages — duplicate
        prefixes cost nothing. Returns how many new pages the tree
        retained."""
        toks = tuple(int(t) for t in tokens)
        ps = self.page_size
        if len(toks) % ps != 0 or len(toks) // ps != len(pages):
            raise ValueError(
                f"insert needs whole pages: {len(toks)} tokens, "
                f"{len(pages)} pages at page_size {ps}")
        if not pages:
            return 0
        self._clock += 1
        self.stats.inserts += 1
        node = self._root
        i = 0                        # page index into toks/pages
        n = len(pages)
        retained = 0
        while i < n:
            first = tuple(toks[i * ps:(i + 1) * ps])
            child = node.children.get(first)
            if child is None:
                tail_toks = toks[i * ps:n * ps]
                tail_pages = list(pages[i:])
                self.allocator.share(tail_pages)
                self._order += 1
                node.children[first] = _Node(tail_toks, tail_pages,
                                             self._clock, self._order)
                self.held_pages += len(tail_pages)
                retained += len(tail_pages)
                break
            child.last_used = self._clock
            k = 0
            while (k < child.n_pages and i < n
                   and tuple(toks[i * ps:(i + 1) * ps])
                   == child.tokens[k * ps:(k + 1) * ps]):
                k += 1
                i += 1
            if k == child.n_pages:
                node = child         # fully traversed: descend
                continue
            if i == n:
                break                # child extends past the new prompt
            # divergence inside the edge: split at the page boundary k
            node.children[first] = self._split(child, k)
            node = node.children[first]
        self.stats.inserted_pages += retained
        return retained

    def _split(self, child: _Node, k: int) -> _Node:
        """Split an edge after its k-th page: prefix node keeps pages[:k],
        the suffix node inherits the rest plus the children. Reference
        counts are untouched — the same pages, new bookkeeping."""
        ps = self.page_size
        assert 0 < k < child.n_pages
        self._order += 1
        prefix = _Node(child.tokens[:k * ps], child.pages[:k],
                       self._clock, self._order)
        suffix_first = tuple(child.tokens[k * ps:(k + 1) * ps])
        child.tokens = child.tokens[k * ps:]
        child.pages = child.pages[k:]
        prefix.children[suffix_first] = child
        prefix.last_used = max(prefix.last_used, child.last_used)
        return prefix

    # -------------------------------------------------------------- eviction
    def evict(self, need_pages: int) -> int:
        """Release cold leaves (LRU, ties by creation order) until at
        least ``need_pages`` pages have actually returned to the pool or
        nothing evictable remains. Leaves whose pages are ALL still
        row-shared are never victims: releasing them would free nothing
        (the rows hold their own references) yet forfeit every future
        hit on that prefix — those pages rejoin the evictable set when
        their rows free. Returns pages actually freed."""
        freed = 0
        while freed < need_pages:
            victim = self._coldest_leaf()
            if victim is None:
                break
            parent, key, node = victim
            freed += self.allocator.release(node.pages)
            self.held_pages -= len(node.pages)
            self.stats.evictions += 1
            del parent.children[key]
        self.stats.evicted_pages += freed
        return freed

    def _coldest_leaf(self):
        coldest = None
        stack = [self._root]
        while stack:
            node = stack.pop()
            for key, child in node.children.items():
                if child.children:
                    stack.append(child)
                    continue
                # skip leaves that would free nothing: every page is
                # still referenced by a live row or a pinned hit
                if all(self.allocator.refcount(p) > 1
                       for p in child.pages):
                    continue
                if (coldest is None
                        or (child.last_used, child.order)
                        < (coldest[2].last_used, coldest[2].order)):
                    coldest = (node, key, child)
        return coldest

    def retain_recent(self, window: int) -> int:
        """Prune every node colder than ``window`` cache operations
        (``last_used < clock - window``), bottom-up: a node survives if
        it is recent OR any descendant is — an ancestor's pages back its
        descendants' prefixes, so keeping a child keeps its spine. The
        engine's ``recover`` path calls this INSTEAD of ``flush``: a
        mid-run fault drops slot state (recompute-requeue) but not the
        warmed radix working set, so post-recovery admissions keep
        hitting. Returns pages whose references were released (counted
        as evictions)."""
        cutoff = self._clock - max(0, int(window))
        released = 0

        def _prune(node: _Node) -> bool:
            nonlocal released
            keep = node.last_used >= cutoff
            for key in list(node.children):
                child = node.children[key]
                if _prune(child):
                    keep = True
                else:
                    # child and (already-pruned) descendants are cold
                    released += self.allocator.release(child.pages)
                    self.held_pages -= len(child.pages)
                    self.stats.evictions += 1
                    del node.children[key]
            return keep

        _prune(self._root)
        self.stats.evicted_pages += released
        return released

    def flush(self) -> int:
        """Drop every node and release every held reference (pool reset
        between policy runs: replayed seeded runs start from a cold
        cache). Returns pages actually freed."""
        freed = 0
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            freed += self.allocator.release(node.pages)
            stack.extend(node.children.values())
        self._root = _Node((), [], clock=self._clock, order=0)
        self.held_pages = 0
        return freed

    # --------------------------------------------------------------- queries
    def page_refs(self) -> Dict[int, int]:
        """page -> number of references the tree holds (always 1 per node
        page) — the ``extra_refs`` argument for
        ``PagedKVCache.check_invariants``."""
        refs: Dict[int, int] = {}
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            for p in node.pages:
                refs[p] = refs.get(p, 0) + 1
            stack.extend(node.children.values())
        return refs

    def evictable_pages(self) -> int:
        """Pages that would actually free if the whole tree were evicted
        right now (held pages nobody else references)."""
        return sum(1 for p, _ in self.page_refs().items()
                   if self.allocator.refcount(p) == 1)

    def check_invariants(self) -> bool:
        """Tree-side audit: held-page accounting matches the tree, every
        held page is allocated with refcount covering the tree's hold,
        node keys are whole pages and children are keyed consistently."""
        refs = self.page_refs()
        assert sum(refs.values()) == self.held_pages, (
            f"held_pages {self.held_pages} != tree pages "
            f"{sum(refs.values())}")
        for p, n in refs.items():
            assert self.allocator.refcount(p) >= n, (
                f"page {p}: tree holds {n} refs, allocator has "
                f"{self.allocator.refcount(p)}")
        stack = [self._root]
        ps = self.page_size
        while stack:
            node = stack.pop()
            assert len(node.tokens) == len(node.pages) * ps, (
                "node key is not a whole number of pages")
            for key, child in node.children.items():
                assert key == tuple(child.tokens[:ps]), \
                    "child keyed by a token run it does not start with"
                stack.append(child)
        return True
