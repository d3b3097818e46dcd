"""Paged KV-cache allocator: fixed-size blocks, per-request block tables.

The host-side half of the serving engine's memory system. Device state (the
page pools) lives in :class:`repro_torch.models.transformer.PagedDecodeState`;
this module owns the *accounting*: which pool pages are free, which belong
to which decode slot, and whether a new request fits under the HBM budget
the :class:`~repro_torch.core.config.GemminiConfig` grants long-lived state
(``hbm_bytes``). Paging exists precisely so that budget is spent on tokens
actually cached, not on max-context-sized contiguous reservations: a
request holds ``ceil(len / page_size)`` pages, never ``max_context``.

Invariants the engine relies on:

* page ids handed out are always in ``[0, n_pages)`` -- id ``n_pages`` is
  the reserved trash page retired decode slots spill to, and the allocator
  never owns it;
* every page is owned by exactly one of {the free list, the mapped set,
  the held set}; a *mapped* page is referenced by one or more slot tables
  and/or the prefix index, with ``refcount == total references >= 1``
  (copy-on-write prefix sharing is the only way a page lands in more than
  one table);
* ``free_slot`` decrefs the slot's pages and makes the unreferenced ones
  immediately reusable (eviction IS the preemption mechanism: the
  scheduler frees a victim's pages and re-queues it for recompute); pages
  still referenced -- shared CoW mappings or prefix-index entries --
  survive the eviction, which is what makes hot prefixes cheap to restart.

Two page-lifecycle extensions (both off unless the engine opts in):

* **prefix index** (:meth:`publish_prefix` / :meth:`match_prefix` /
  :meth:`alloc_slot_shared`): full pages are content-hash-indexed at
  prefill commit; a new request whose prompt chain-hashes to indexed
  pages maps them copy-on-write instead of recomputing them. Index-only
  pages (refcount 1, no table) are *reclaimable*: capacity checks count
  them as available and allocation evicts them LRU-first when the free
  list runs short, so the cache can never wedge admission.
* **host pool** (:meth:`host_put` / :meth:`host_peek` / :meth:`host_take`):
  a preempted victim's committed pages spill to a bounded host-memory
  pool (the engine owns the device->host copies; this class owns the
  accounting and LRU bound), so restart is a DMA restore plus a resumed
  chunk instead of a full re-prefill. A full pool evicts its LRU spill --
  degrading that victim to today's recompute path, never failing.

With a :class:`repro_torch.obs.trace.Tracer` attached (``tracer``; the engine
wires its own in), every accounting transition — alloc / grow / extend /
free / hold / release / defrag / cow / publish / spill / restore — lands
as a ``cat="alloc"`` instant on the allocator track, stamped with the
arena occupancy after the transition.  ``tracer=None`` (the default) costs
one None check.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


def pages_for(n_tokens: int, page_size: int) -> int:
    return -(-max(0, n_tokens) // page_size)


@dataclasses.dataclass
class HostSpill:
    """One preempted request's committed pages, parked in host memory.

    ``payload`` is opaque to the allocator: the engine stores whatever
    host arrays reconstruct the device state (KV page contents, recurrent
    slot state), keyed however it likes. ``tokens`` is the committed
    cache-position count the payload covers -- the restart anchor."""

    rid: int
    n_pages: int
    tokens: int
    payload: Dict[str, Any] = dataclasses.field(repr=False)


@dataclasses.dataclass
class PagedKVAllocator:
    """Free-list page allocator over one page arena shared by all layers.

    ``host_pool_pages``: capacity (in pages) of the host spill pool for
    preempted-victim offload; 0 (the default) disables offload entirely
    (:meth:`host_put` refuses every spill)."""

    n_pages: int
    page_size: int
    max_pages_per_seq: int
    tracer: Any = dataclasses.field(default=None, repr=False, compare=False)
    host_pool_pages: int = 0

    def _trace(self, event: str, **args) -> None:
        if self.tracer is None:
            return
        from repro_torch.obs import trace as otrace
        self.tracer.instant(event, cat="alloc", tid=otrace.TID_ALLOC,
                            free=len(self._free), used=self.used_pages,
                            held=len(self._held), **args)

    def __post_init__(self):
        if self.n_pages < 1:
            raise ValueError("paged cache needs at least one page; raise "
                             "hbm_bytes or shrink the model/page size")
        # LIFO free list: a just-freed page is the next handed out, so tests
        # can observe reuse deterministically and the hot arena stays small.
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self._tables: Dict[int, List[int]] = {}      # slot -> page ids
        self._held: List[int] = []                   # withheld (see hold_pages)
        # refcounts for mapped pages: #tables referencing the page, plus 1
        # if the prefix index holds it. Free/held pages have no entry.
        self._ref: Dict[int, int] = {}
        # content-hash prefix index: chain key -> physical page, insertion
        # order = LRU (match/publish refresh via move_to_end), plus the
        # page -> key reverse map so defrag and reclaim stay O(live).
        self._prefix: "collections.OrderedDict[bytes, int]" = \
            collections.OrderedDict()
        self._page_key: Dict[int, bytes] = {}
        # host offload pool: rid -> HostSpill, insertion order = LRU.
        self._host: "collections.OrderedDict[int, HostSpill]" = \
            collections.OrderedDict()

    # -- capacity accounting ----------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def utilization(self) -> float:
        return self.used_pages / self.n_pages

    @property
    def capacity_tokens(self) -> int:
        return self.n_pages * self.page_size

    def slot_pages(self, slot: int) -> List[int]:
        return list(self._tables.get(slot, ()))

    def _reclaimable(self) -> int:
        """Index-only pages (refcount 1, no table): evictable on demand,
        so capacity checks count them as available."""
        return sum(1 for p in self._prefix.values() if self._ref.get(p) == 1)

    def _reclaim(self, need_free: int) -> int:
        """Evict LRU index-only prefix pages until the free list holds at
        least ``need_free`` pages (or nothing reclaimable remains).
        Returns how many were reclaimed. Pages some table still references
        (refcount > 1) are never touched -- eviction refuses to split a
        shared physical page."""
        n = 0
        if len(self._free) >= need_free:
            return 0
        for key in list(self._prefix):             # OrderedDict: LRU first
            if len(self._free) >= need_free:
                break
            p = self._prefix[key]
            if self._ref.get(p) != 1:
                continue                           # mapped by a table too
            del self._prefix[key]
            del self._page_key[p]
            del self._ref[p]
            self._free.append(p)
            n += 1
        if n:
            self._trace("reclaim", pages=n)
        return n

    def can_admit(self, n_tokens: int) -> bool:
        need = pages_for(n_tokens, self.page_size)
        return (need <= len(self._free) + self._reclaimable()
                and need <= self.max_pages_per_seq)

    # -- alloc / free ------------------------------------------------------
    def _take_free(self, k: int) -> List[int]:
        """Pop ``k`` free pages (refcounted at 1). Caller checked capacity."""
        pages = [self._free.pop() for _ in range(k)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def alloc_slot(self, slot: int, n_tokens: int) -> Optional[List[int]]:
        """Pages covering positions [0, n_tokens) for a fresh request, or
        None when the arena (or the per-request table) cannot hold it."""
        if slot in self._tables:
            raise ValueError(f"slot {slot} already holds pages; free first")
        need = pages_for(n_tokens, self.page_size)
        self._reclaim(need)
        if need > self.max_pages_per_seq or need > len(self._free):
            return None
        pages = self._take_free(need)
        self._tables[slot] = pages
        self._trace("alloc", slot=slot, pages=need)
        return list(pages)

    def alloc_slot_shared(self, slot: int, n_tokens: int,
                          shared: Sequence[int]) -> Optional[List[int]]:
        """:meth:`alloc_slot`, but the first ``len(shared)`` pages are
        existing physical pages (a :meth:`match_prefix` run) mapped
        copy-on-write: increfed, not popped. Atomic -- on failure nothing
        is allocated and no refcount moves. The caller must never write
        the shared prefix pages through this slot (its fresh writes start
        at ``len(shared) * page_size``)."""
        if slot in self._tables:
            raise ValueError(f"slot {slot} already holds pages; free first")
        need = pages_for(n_tokens, self.page_size)
        fresh = need - len(shared)
        if fresh < 0:
            raise ValueError(f"{len(shared)} shared pages exceed the "
                             f"{need}-page footprint of {n_tokens} tokens")
        # Incref the shared run FIRST: a cache-only hit page (refcount 1)
        # must not be evicted by the reclaim scan below.
        for p in shared:
            self._ref[p] = self._ref.get(p, 0) + 1
        self._reclaim(fresh)
        if need > self.max_pages_per_seq or fresh > len(self._free):
            for p in shared:                        # undo: nothing happened
                self._ref[p] -= 1
            return None
        pages = list(shared) + self._take_free(fresh)
        self._tables[slot] = pages
        self._trace("cow", slot=slot, shared=len(shared), fresh=fresh)
        return list(pages)

    def grow_slot(self, slot: int, n_tokens: int) -> Optional[List[int]]:
        """Extend a slot's table to cover logical positions [0, n_tokens):
        allocates the missing pages (chunked prefill's per-chunk commitment
        point). Returns the newly allocated page ids ([] when the slot
        already covers them), or None when the arena or the per-sequence
        cap cannot hold them -- in which case NOTHING is allocated, so the
        scheduler can evict and retry atomically."""
        pages = self._tables.get(slot)
        if pages is None:
            raise ValueError(f"slot {slot} holds no pages")
        need = pages_for(n_tokens, self.page_size) - len(pages)
        if need <= 0:
            return []
        self._reclaim(need)
        if len(pages) + need > self.max_pages_per_seq or need > len(self._free):
            return None
        new = self._take_free(need)
        pages.extend(new)
        self._trace("extend", slot=slot, pages=need)
        return new

    def extend_slot(self, slot: int) -> Optional[int]:
        """One more page for a growing request (decode crossed a page
        boundary); None when the arena is exhausted or the request is at
        ``max_pages_per_seq`` (its context limit)."""
        pages = self._tables.get(slot)
        if pages is None:
            raise ValueError(f"slot {slot} holds no pages")
        if len(pages) >= self.max_pages_per_seq:
            return None
        self._reclaim(1)
        if not self._free:
            return None
        pid = self._take_free(1)[0]
        pages.append(pid)
        self._trace("extend", slot=slot, pages=1)
        return pid

    def free_slot(self, slot: int) -> int:
        """Release the slot's table: decref every page, return the
        now-unreferenced ones to the arena. Pages another table or the
        prefix index still references survive (CoW sharing / cache-only
        retention). Returns the table length."""
        pages = self._tables.pop(slot, [])
        freed: List[int] = []
        for p in reversed(pages):                  # keep LIFO reuse order
            r = self._ref.get(p, 1) - 1
            if r <= 0:
                self._ref.pop(p, None)
                freed.append(p)
            else:
                self._ref[p] = r
        self._free.extend(freed)
        if pages:
            self._trace("evict", slot=slot, pages=len(pages),
                        retained=len(pages) - len(freed))
        return len(pages)

    # -- prefix index (content-hash CoW sharing) ---------------------------
    def match_prefix(self, keys: Sequence[bytes]) -> List[int]:
        """The longest index-hit run for a chain-key sequence: physical
        pages a new request can map copy-on-write instead of recomputing.
        Hits are LRU-refreshed (a hot prefix stays resident)."""
        out: List[int] = []
        for k in keys:
            p = self._prefix.get(k)
            if p is None:
                break
            out.append(p)
        for k in keys[:len(out)]:
            self._prefix.move_to_end(k)
        return out

    def publish_prefix(self, key: bytes, page: int) -> bool:
        """Index a committed full page under its content chain key
        (increfs it: the index is an owner, so eviction can never free an
        indexed page out from under a future match). Re-publishing an
        existing key refreshes its LRU slot; a page already indexed under
        another key -- or a key another physical page already claimed --
        is left alone (first publication wins). Returns True when this
        call newly indexed the page."""
        if self._prefix.get(key) is not None:
            self._prefix.move_to_end(key)
            return False
        if page in self._page_key:
            return False
        if self._ref.get(page, 0) < 1:
            raise ValueError(f"page {page} is not mapped; only committed "
                             f"slot pages can be published")
        self._prefix[key] = page
        self._page_key[page] = key
        self._ref[page] += 1
        self._trace("publish", page=page, index=len(self._prefix))
        return True

    @property
    def prefix_index_pages(self) -> int:
        return len(self._prefix)

    # -- host offload pool -------------------------------------------------
    @property
    def host_used_pages(self) -> int:
        return sum(s.n_pages for s in self._host.values())

    def host_put(self, rid: int, n_pages: int, tokens: int,
                 payload: Dict[str, Any]) -> bool:
        """Park a preempted victim's committed pages in the host pool.
        Evicts LRU spills to fit (those victims degrade to recompute);
        refuses -- returning False, caller falls back to recompute -- when
        the pool is disabled or the spill alone exceeds its capacity."""
        if self.host_pool_pages <= 0 or n_pages > self.host_pool_pages:
            return False
        self._host.pop(rid, None)                  # re-spill replaces
        while self.host_used_pages + n_pages > self.host_pool_pages:
            self.host_evict_lru()
        self._host[rid] = HostSpill(rid=rid, n_pages=n_pages, tokens=tokens,
                                    payload=payload)
        self._trace("spill", rid=rid, pages=n_pages,
                    host_used=self.host_used_pages)
        return True

    def host_evict_lru(self) -> Optional[int]:
        """Evict the least-recently-spilled host-pool entry (its victim
        degrades to recompute on restart). ``host_put`` calls this under
        capacity pressure; the model checker calls it directly as an
        explicit action. Returns the evicted rid, or None on an empty
        pool."""
        if not self._host:
            return None
        old_rid, old = self._host.popitem(last=False)
        self._trace("spill_evict", rid=old_rid, pages=old.n_pages)
        return old_rid

    def host_peek(self, rid: int) -> Optional[HostSpill]:
        return self._host.get(rid)

    def host_take(self, rid: int) -> Optional[HostSpill]:
        """Pop a spill for restore (the payload moves back to the device;
        the pool entry is consumed either way)."""
        sp = self._host.pop(rid, None)
        if sp is not None:
            self._trace("restore", rid=rid, pages=sp.n_pages,
                        host_used=self.host_used_pages)
        return sp

    def host_drop(self, rid: int) -> None:
        """Discard a spill (restore failed / victim finished elsewhere)."""
        self._host.pop(rid, None)

    # -- pressure / reservation -------------------------------------------
    @property
    def held_pages(self) -> int:
        return len(self._held)

    def hold_pages(self, k: int) -> int:
        """Withhold up to ``k`` free pages from allocation; returns how
        many were actually held (bounded by the free list).

        Held pages count as used -- ``can_admit``/``alloc_slot``/
        ``grow_slot``/``extend_slot`` cannot see them -- which is how the
        fault injector applies *consistent* arena-exhaustion pressure for
        one scheduler iteration: pressure applied mid-iteration (e.g. by
        failing individual allocations) would break the scheduler's
        can_admit-then-alloc commitment protocol. Calls stack; pair with
        :meth:`release_held`. Holds come from the free list only --
        reclaimable prefix pages stay where they are, so pressure cannot
        silently flush the prefix cache.
        """
        k = max(0, min(k, len(self._free)))
        for _ in range(k):
            self._held.append(self._free.pop())
        if k:
            self._trace("hold", pages=k)
        return k

    def release_held(self) -> int:
        """Return every held page to the free list; returns how many."""
        n = len(self._held)
        self._free.extend(reversed(self._held))
        self._held = []
        if n:
            self._trace("release_held", pages=n)
        return n

    # -- defrag ------------------------------------------------------------
    def defrag(self) -> np.ndarray:
        """Compact live pages to the front of the arena.

        Returns the length-``n_pages`` permutation ``perm`` with
        ``perm[old_id] = new_id`` (identity for already-compact arenas);
        the caller must apply it to the device pools
        (``pool[:, :, perm_inverse]``, see ``ServingEngine.defrag``) and
        this allocator rewrites its tables -- and the prefix index, whose
        entries are live pages too -- in place. A physical page shared by
        several tables moves exactly once (one perm slot), so CoW aliases
        survive compaction intact. Paging makes defrag unnecessary for
        correctness -- it exists so a long-lived engine can shrink its
        arena (checkpoint/offload the contiguous free tail).

        Held pages (:meth:`hold_pages`) are released first: defrag rebuilds
        the free list wholesale, and a hold surviving it would alias pages
        the rebuild already re-issued. Holds are per-iteration pressure;
        the injector simply re-applies them on the next step.
        """
        self.release_held()
        live: List[int] = []
        seen: set = set()
        for slot in sorted(self._tables):
            for p in self._tables[slot]:
                if p not in seen:                  # shared pages move once
                    seen.add(p)
                    live.append(p)
        for p in self._prefix.values():
            if p not in seen:                      # index-only residents
                seen.add(p)
                live.append(p)
        perm = np.full((self.n_pages,), -1, np.int64)
        for new_id, old_id in enumerate(live):
            perm[old_id] = new_id
        nxt = len(live)
        for old_id in range(self.n_pages):
            if perm[old_id] < 0:
                perm[old_id] = nxt
                nxt += 1
        for slot, pages in self._tables.items():
            self._tables[slot] = [int(perm[p]) for p in pages]
        self._prefix = collections.OrderedDict(
            (k, int(perm[p])) for k, p in self._prefix.items())
        self._page_key = {int(perm[p]): k for p, k in self._page_key.items()}
        self._ref = {int(perm[p]): r for p, r in self._ref.items()}
        self._free = list(range(self.n_pages - 1, len(live) - 1, -1))
        self._trace("defrag", live=len(live))
        return perm

    # -- invariant audit ---------------------------------------------------
    def check(self) -> None:
        """Assert the ownership-partition invariants (the property suite's
        oracle; cheap enough to call after every op in tests):

        * free list / mapped set / held set partition ``[0, n_pages)``
          exactly (no page lost, duplicated, or resurrected);
        * a slot table never maps the same physical page twice (sharing is
          *across* tables, never within one);
        * every mapped page's refcount equals its reference count
          (#tables holding it + 1 if indexed) and is >= 1;
        * the prefix index and its reverse map agree bijectively;
        * free-page accounting is exact.
        """
        fset = set(self._free)
        assert len(fset) == len(self._free), "free-list duplicates"
        held = set(self._held)
        assert len(held) == len(self._held), "held-list duplicates"
        counts: collections.Counter = collections.Counter()
        for slot, pages in self._tables.items():
            assert len(pages) == len(set(pages)), \
                f"slot {slot} maps a page twice"
            counts.update(pages)
        for p in self._prefix.values():
            counts[p] += 1
        mapped = set(counts)
        assert not (fset & mapped), "free pages still mapped"
        assert not (fset & held), "free pages also held"
        assert not (held & mapped), "held pages still mapped"
        assert fset | mapped | held == set(range(self.n_pages)), \
            "arena pages lost"
        assert dict(counts) == self._ref, "refcount drift"
        assert all(r >= 1 for r in self._ref.values()), "mapped page ref<1"
        assert len(self._prefix) == len(self._page_key) and all(
            self._prefix[k] == p for p, k in self._page_key.items()), \
            "prefix index / reverse map disagree"
        assert len(self._free) == self.n_pages - len(mapped) - len(held), \
            "free-page accounting drift"
        assert self.host_used_pages <= max(0, self.host_pool_pages), \
            "host pool over capacity"

    def snapshot(self) -> Dict[str, Any]:
        """Order-faithful structural view of the allocator, for canonical
        state hashing (repro_torch.analysis.mc.canon): slot tables in slot
        order, refcounts, the prefix index in LRU order, held pages, the
        free list in POP order (LIFO: the next page issued comes first),
        and host-pool entries in LRU order. Physical page ids appear
        as-is; the canonicalizer relabels them by traversal order so two
        states differing only by page naming hash identically."""
        return {
            "tables": {s: list(p) for s, p in sorted(self._tables.items())},
            "ref": dict(self._ref),
            "prefix": [(k, p) for k, p in self._prefix.items()],
            "held": list(self._held),
            "free_pop_order": list(reversed(self._free)),
            "host": [(rid, sp.n_pages, sp.tokens)
                     for rid, sp in self._host.items()],
        }


def arena_pages(model_cfg, engine_cfg, page_size: int, *,
                budget_fraction: float = 0.5,
                max_pages: int = 4096) -> int:
    """Size the page arena against the config's HBM budget.

    One page costs ``L * 2 (K and V) * page * KVH * D * dtype_bytes``
    across the layer-stacked pools; ``budget_fraction`` of
    ``engine_cfg.hbm_bytes`` goes to the arena (the rest stays for weights
    and activations). ``max_pages`` caps the arena for smoke/CPU runs.
    """
    import torch
    dtype_bytes = torch.empty((), dtype=model_cfg.dtype).element_size()
    page_bytes = (model_cfg.n_layers * 2 * page_size * model_cfg.n_kv_heads
                  * model_cfg.head_dim * dtype_bytes)
    budget = int(engine_cfg.hbm_bytes * budget_fraction)
    return max(1, min(max_pages, budget // max(1, page_bytes)))
