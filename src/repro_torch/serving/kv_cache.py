"""Paged KV-cache management: a page pool, block tables, and ragged lengths.

Why paging (the memory-side dual of D-STACK's packing argument)
---------------------------------------------------------------
The slot engine's original storage contract gave every slot a fixed-length
ring: a sequence that generates 12 tokens pays the same KV memory as one
that generates 512, so KV capacity — not compute — caps how many concurrent
DNN instances the accelerator multiplexes (``EnginePool.admit`` blocks on
free slots). The paged layout replaces the per-slot ring with a shared pool
of fixed-size **pages** so long and short sequences share cache memory and
memory in use tracks the tokens actually resident.

Block-table layout (vLLM PagedAttention; on TPU, ``ragged_paged_attention``)
---------------------------------------------------------------------------
A paged cache is a pytree of ``(num_pages, page_size, ...)`` K/V buffers —
the *physical* pool — plus two small per-sequence arrays:

  ``block_tables``  (B, max_pages) int32   logical page i of row b lives in
                                           physical page block_tables[b, i]
  ``lengths``       (B,)           int32   valid tokens per row (the cache's
                                           ``pos`` vector in the engine)

Logical cache position ``t`` of row ``b`` is stored at
``(block_tables[b, t // page_size], t % page_size)``. The decode kernel
(``repro_torch.kernels.paged_attention``) walks each row's table in
logical order and reads only its live pages, so
both FLOPs and HBM traffic scale with actual sequence length.

Physical page 0 is the reserved **null page**: the allocator never hands it
out, freed rows point their whole table row at it, and vacant
continuous-batching rows harmlessly scatter their dead writes into it
(length 0 masks every read). That preserves the ring engine's "vacant rows
cost nothing and corrupt nothing" invariant even though pages — unlike ring
rows — are shared across sequences.

``PageAllocator`` is the host-side free list (admission control reads
``free_pages``); ``PagedKVCache`` wraps one model's device buffers with
alloc / append / free and raises ``OutOfPages`` as the admission-blocking
signal. The serving engine embeds the same pieces directly
(``InferenceEngine.init_slots(paged=True)``); this module is the layer the
engine, pool admission, and tests all share.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

NULL_PAGE = 0


class OutOfPages(RuntimeError):
    """The page pool cannot satisfy an allocation — the admission-control
    signal: callers (``EnginePool.admit``) must defer or shrink the batch,
    not crash."""


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` cache entries (at least one — every
    live sequence owns a page so its writes never touch the null page)."""
    return max(1, math.ceil(max(0, int(tokens)) / page_size))


class PageAllocator:
    """Host-side free list over a pool of ``num_pages`` usable pages.

    Page ids are 1..num_pages — id 0 is the reserved null page (see module
    docstring). Frees are LIFO so a free-then-alloc churn reuses hot pages;
    fragmentation is not a concern because every page is the same size and
    tables provide full indirection (there is nothing contiguous to
    fragment — the classic paging argument)."""

    def __init__(self, num_pages: int):
        if num_pages < 1:
            raise ValueError(f"need at least one usable page, got {num_pages}")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages, 0, -1))  # pop() -> 1 first
        self._allocated: set = set()
        # per-page reference counts (prefix sharing): every allocated page
        # has a count >= 1; ``share`` adds holders, ``release`` drops them
        # and returns the page to the pool at zero. ``free`` stays the
        # strict single-owner path (it refuses shared pages), so legacy
        # callers cannot silently tear a page out from under a co-holder.
        self._ref: Dict[int, int] = {}
        # duck-typed hook (repro_torch.serving.faults.FaultInjector): when set,
        # alloc may raise an injected OutOfPages before touching the pool
        self.fault_injector = None

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Pop ``n`` pages, all-or-nothing. Raises OutOfPages when the pool
        cannot cover the request (no partial grants — a half-allocated
        sequence would deadlock against other half-allocated sequences)."""
        if self.fault_injector is not None:
            self.fault_injector.maybe_fault("alloc")
        if n > len(self._free):
            raise OutOfPages(
                f"requested {n} pages, {len(self._free)} free "
                f"of {self.num_pages}")
        pages = [self._free.pop() for _ in range(n)]
        self._allocated.update(pages)
        for p in pages:
            self._ref[p] = 1
        return pages

    def free(self, pages: Sequence[int]) -> None:
        """Return pages to the pool. Double-frees, frees of the null page,
        and frees of a page another holder still references are errors
        (they would alias two sequences onto one page)."""
        for p in pages:
            if p == NULL_PAGE:
                raise ValueError("cannot free the reserved null page")
            if p not in self._allocated:
                raise ValueError(f"page {p} is not allocated")
            if self._ref.get(p, 1) != 1:
                raise ValueError(
                    f"page {p} has {self._ref[p]} holders — use release()")
            self._ref.pop(p, None)
            self._allocated.remove(p)
            self._free.append(p)

    # ------------------------------------------------------ prefix sharing
    def refcount(self, page: int) -> int:
        """Current holder count for a page (0 when not allocated)."""
        return self._ref.get(page, 0)

    def share(self, pages: Sequence[int]) -> None:
        """Add one holder to each page (prefix-cache aliasing). Sharing an
        unallocated page or the null page is an error — a holder can only
        piggyback on a page that already has an owner."""
        for p in pages:
            if p == NULL_PAGE:
                raise ValueError("cannot share the reserved null page")
            if p not in self._allocated:
                raise ValueError(f"page {p} is not allocated")
            self._ref[p] += 1

    def release(self, pages: Sequence[int]) -> int:
        """Drop one holder from each page; pages whose count reaches zero
        return to the pool. Returns how many pages were actually freed
        (the planner's eviction loop needs real pages, not dropped refs)."""
        freed = 0
        for p in pages:
            if p == NULL_PAGE:
                raise ValueError("cannot release the reserved null page")
            if p not in self._allocated:
                raise ValueError(f"page {p} is not allocated")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                self._allocated.remove(p)
                self._free.append(p)
                freed += 1
        return freed

    def sort_free(self) -> None:
        """Restore the canonical free-list order (descending ids, so
        ``pop()`` hands out 1 first — the just-built state). Called on
        engine reset between runs: frees are LIFO, so the free list's
        order is otherwise a fossil of the previous run's free sequence
        and a replayed workload would receive different page ids."""
        self._free.sort(reverse=True)

    def check_invariants(self) -> bool:
        """Cheap host-side audit of the free list: page conservation, no
        duplicates, null page never live, every id in range. Raises
        AssertionError on violation — the chaos suite and hypothesis churn
        tests call this after every operation and every fault recovery."""
        free = self._free
        assert len(free) == len(set(free)), "duplicate page in free list"
        assert NULL_PAGE not in free, "null page in free list"
        assert NULL_PAGE not in self._allocated, "null page marked allocated"
        assert not set(free) & self._allocated, \
            "page simultaneously free and allocated"
        assert len(free) + len(self._allocated) == self.num_pages, (
            f"page conservation violated: {len(free)} free + "
            f"{len(self._allocated)} allocated != {self.num_pages}")
        assert all(1 <= p <= self.num_pages
                   for p in list(free) + list(self._allocated)), \
            "page id out of range"
        assert set(self._ref) == self._allocated, (
            "refcount keys and allocated set disagree: "
            f"{sorted(set(self._ref) ^ self._allocated)}")
        assert all(c >= 1 for c in self._ref.values()), \
            "allocated page with refcount < 1"
        return True


@dataclasses.dataclass
class SeqPages:
    """One sequence's page ownership: its table prefix and valid length."""
    pages: List[int]
    length: int


class PagedKVCache:
    """Block-table bookkeeping for one paged cache (host side).

    Tracks, per batch row, the ordered pages that row owns and its valid
    length; the device pytree (K/V page buffers + ``block_tables`` +
    ``pos``) is built by each model family's ``init_paged_cache`` and
    updated by the engine's jitted scatter helpers — this class is the
    source of truth the engine mirrors into those device arrays.
    """

    def __init__(self, batch: int, page_size: int, max_pages: int,
                 allocator: Optional[PageAllocator] = None,
                 num_pages: Optional[int] = None):
        if allocator is None:
            allocator = PageAllocator(num_pages or batch * max_pages)
        self.allocator = allocator
        self.batch = batch
        self.page_size = page_size
        self.max_pages = max_pages
        self._rows: Dict[int, SeqPages] = {}
        # bumps on every page-ownership change — an O(1) cache key for
        # host-side structures derived from page layouts (e.g. the
        # speculative rounds' uploaded block-table rows)
        self.version = 0

    # ------------------------------------------------------------- queries
    @property
    def free_pages(self) -> int:
        return self.allocator.free_pages

    @property
    def used_pages(self) -> int:
        return self.allocator.used_pages

    def length(self, row: int) -> int:
        sp = self._rows.get(row)
        return 0 if sp is None else sp.length

    def pages(self, row: int) -> List[int]:
        sp = self._rows.get(row)
        return [] if sp is None else list(sp.pages)

    def table_row(self, row: int) -> List[int]:
        """Full (max_pages,) table row: owned pages then null-page padding
        — a fixed shape, so the device-side row write never retraces."""
        pages = self.pages(row)
        return pages + [NULL_PAGE] * (self.max_pages - len(pages))

    def pages_needed(self, tokens: int) -> int:
        return pages_for(tokens, self.page_size)

    def can_admit(self, tokens: int) -> bool:
        return self.allocator.can_alloc(self.pages_needed(tokens))

    # ------------------------------------------------------------ mutation
    def alloc(self, row: int, tokens: int) -> List[int]:
        """Claim a free row and allocate pages for ``tokens`` entries
        (all-or-nothing; raises OutOfPages)."""
        if row in self._rows:
            raise ValueError(f"row {row} already allocated")
        tokens = int(tokens)
        if tokens > self.max_pages * self.page_size:
            raise OutOfPages(
                f"{tokens} tokens exceed the row maximum "
                f"{self.max_pages * self.page_size}")
        pages = self.allocator.alloc(self.pages_needed(tokens))
        self._rows[row] = SeqPages(pages=pages, length=tokens)
        self.version += 1
        return pages

    def alloc_alias(self, row: int, shared_pages: Sequence[int],
                    tokens: int) -> List[int]:
        """Claim a free row whose leading pages alias an already-resident
        prefix (prefix-cache hit). The caller must ALREADY hold one
        reference per shared page (``PageAllocator.share`` — the match-time
        pin); this call adopts those references as the row's ownership and
        allocates only the fresh tail pages, all-or-nothing. On
        ``OutOfPages`` nothing changes and the caller keeps its pins."""
        if row in self._rows:
            raise ValueError(f"row {row} already allocated")
        tokens = int(tokens)
        if tokens > self.max_pages * self.page_size:
            raise OutOfPages(
                f"{tokens} tokens exceed the row maximum "
                f"{self.max_pages * self.page_size}")
        shared = list(shared_pages)
        need = self.pages_needed(tokens) - len(shared)
        if need < 1:
            raise ValueError(
                f"aliased prefix ({len(shared)} pages) already covers "
                f"{tokens} tokens — nothing left to write")
        fresh = self.allocator.alloc(need)
        self._rows[row] = SeqPages(pages=shared + fresh, length=tokens)
        self.version += 1
        return fresh

    def append(self, row: int, n: int = 1) -> List[int]:
        """Advance row's length by ``n`` token slots, allocating new pages
        lazily as page boundaries are crossed. Returns the newly allocated
        pages (often empty — within-page appends are free). Raises
        OutOfPages with the row untouched when the pool can't cover it."""
        sp = self._rows.get(row)
        if sp is None:
            raise ValueError(f"row {row} has no pages (alloc first)")
        new_len = sp.length + int(n)
        if new_len > self.max_pages * self.page_size:
            raise OutOfPages(
                f"row {row}: {new_len} tokens exceed the row maximum "
                f"{self.max_pages * self.page_size}")
        need = pages_for(new_len, self.page_size) - len(sp.pages)
        fresh = self.allocator.alloc(need) if need > 0 else []
        if fresh:
            self.version += 1
        sp.pages.extend(fresh)
        sp.length = new_len
        return fresh

    def repoint(self, row: int, swaps: Sequence[Tuple[int, int]]) -> int:
        """Swap the row's page reference at each ``(index, new_page)``
        onto an already-allocated page holding identical content
        (cross-request prefix dedup): the row takes one reference on
        the new page and drops the one on the page it replaces.
        Returns how many replaced pages actually returned to the pool.
        The CALLER owns the equality argument (identical token prefix
        → bit-identical K/V) and must push the updated block-table row
        to the device afterwards."""
        sp = self._rows.get(row)
        if sp is None:
            raise ValueError(f"row {row} has no pages")
        freed = 0
        changed = False
        for idx, new in swaps:
            old = sp.pages[idx]
            if old == new:
                continue
            self.allocator.share([new])
            freed += self.allocator.release([old])
            sp.pages[idx] = int(new)
            changed = True
        if changed:
            self.version += 1
        return freed

    def free(self, row: int) -> int:
        """Drop the row's reference on every page it owns; returns how
        many pages actually returned to the pool (aliased prefix pages
        stay resident while the radix cache or another row still holds
        them). Idempotent for unknown rows (mirrors the engine's ``free``
        contract)."""
        sp = self._rows.pop(row, None)
        if sp is None:
            return 0
        self.version += 1
        return self.allocator.release(sp.pages)

    def reset(self) -> None:
        for row in list(self._rows):
            self.free(row)

    def check_invariants(self,
                         extra_refs: Optional[Dict[int, int]] = None) -> bool:
        """Audit row-level ownership on top of the allocator's free-list
        audit: every live row's page count matches its length, and page
        references are exactly conserved — for every allocated page, the
        number of rows holding it plus ``extra_refs`` (external holders:
        the prefix cache's ``page_refs()``) equals the allocator's
        refcount. Without sharing this degenerates to the historical
        contract (no page aliased by two rows, rows == allocated set);
        with sharing it is strictly stronger: a leaked reference, a
        dangling alias, and cross-request aliasing without a matching
        holder all trip it."""
        self.allocator.check_invariants()
        held: Dict[int, int] = dict(extra_refs or {})
        for row, sp in self._rows.items():
            assert sp.pages, f"live row {row} owns no pages"
            assert NULL_PAGE not in sp.pages, f"row {row} owns the null page"
            assert len(sp.pages) == pages_for(sp.length, self.page_size), (
                f"row {row}: {len(sp.pages)} pages for {sp.length} tokens")
            assert len(sp.pages) == len(set(sp.pages)), (
                f"row {row} lists a page twice")
            for p in sp.pages:
                held[p] = held.get(p, 0) + 1
        assert set(held) <= self.allocator._allocated, (
            "dangling alias: held pages not allocated "
            f"{sorted(set(held) - self.allocator._allocated)}")
        for p in self.allocator._allocated:
            refs = self.allocator.refcount(p)
            assert held.get(p, 0) == refs, (
                f"page {p}: {held.get(p, 0)} holders accounted "
                f"(rows + extra_refs) vs allocator refcount {refs}")
        return True
