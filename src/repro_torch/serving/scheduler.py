"""Continuous-batching scheduler: admission, interleave, preemption.

The request-level control loop the paper's full-stack argument calls for:
kernel quality only matters under the contention a real serving mix
creates, and this module is where that mix is shaped. Policy, in order of
application each engine iteration:

1. **Admission / prefill** (the chunk queue): queued requests are admitted
   into free decode slots in *admission-policy* order -- FIFO by default,
   or the ``priority`` / ``deadline`` (EDF) SLO-aware orders, preempted
   requests always first (see ``_order_queue``) -- as long as (a) a slot
   is free,
   (b) the paged allocator can hold the request, and (c) the iteration's
   *prefill token budget* is not exhausted. The budget is the classic
   continuous-batching knob balancing time-to-first-token of queued
   requests against inter-token latency of running ones: each admitted
   prompt stalls every running request for one prefill pass. With
   **chunked prefill** (``prefill_chunk``), long prompts split into
   fixed-size spans executed one-or-more per iteration under the same
   budget -- continuation chunks for mid-prefill runners go first, then
   new admissions -- so a single long prompt can no longer stall running
   decodes for a whole prefill pass (bounded TTFT *and* ITL; the paper's
   system-level contention argument at its sharpest).
2. **Decode capacity** (preemption-by-eviction): every running request
   about to cross a page boundary gets one page; when the arena is dry the
   *youngest* running request is evicted -- its pages freed, the request
   re-queued for recompute (prompt + tokens generated so far become the
   new prompt). Youngest-first eviction wastes the least completed work,
   and the oldest request can always make progress, so the loop is
   livelock-free. A request that hits its per-sequence page cap is
   finished as truncated instead (its context limit, not memory pressure).
3. **Decode**: one token for every running slot (the engine's single
   static-shape ``paged_decode_step``).

With ``enforce_deadlines=True`` the scheduler additionally *sheds* any
request whose absolute deadline has passed -- terminal ``deadline_missed``
status at the admission and decode-step boundaries (:meth:`shed_expired`)
-- so expired SLOs stop consuming prefill/decode budget. Off by default:
``admission_policy="deadline"`` without enforcement remains a pure
ordering policy.

Telemetry is per-request (TTFT, end-to-end latency, preemption count) and
aggregated to the p50/p99 + tokens/s numbers BENCH_serving.json tracks.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.paged_cache import PagedKVAllocator, pages_for


@dataclasses.dataclass
class Request:
    """One serving request plus its runtime bookkeeping."""

    rid: int
    prompt: np.ndarray                    # (P,) int32 [or (P, n_q)]
    max_new_tokens: int
    eos_id: int = -1                      # -1: never emitted
    # admission-policy inputs (ignored under FIFO): higher priority admits
    # first; deadline is an absolute time.time() SLO timestamp (None =
    # best-effort, sorts after every deadlined request).
    priority: int = 0
    deadline: Optional[float] = None

    # runtime (engine/scheduler owned)
    state: str = "queued"                 # queued | running | finished | shed
    slot: int = -1
    generated: list = dataclasses.field(default_factory=list)
    cache_len: int = 0                    # cached tokens (prompt+meta+gen)
    n_preempted: int = 0
    truncated: bool = False
    submitted_at: float = 0.0
    queued_since: float = 0.0             # start of the CURRENT queue wait
    admitted_seq: int = -1                # admission order (eviction key)
    t_first_token: Optional[float] = None
    t_last_token: Optional[float] = None
    t_finished: Optional[float] = None
    # chunked-prefill progress (cache positions written so far / needed);
    # target 0 means single-pass prefill (never observably "prefilling")
    prefill_pos: int = 0
    prefill_target: int = 0
    n_chunks: int = 0                     # prefill chunk calls executed
    # chunk-lattice anchor: the cache position prefill resumed from after
    # a host-pool restore or a prefix-cache hit (0 = the classic lattice
    # from position 0). Reset on preemption -- a fresh restart re-decides.
    chunk_anchor: int = 0
    # per-admission cache of the prompt's page-granular content chain keys
    # (prefix cache); invalidated on preemption (serve_prompt grows)
    prefix_keys: Optional[List[bytes]] = None
    itl_s: list = dataclasses.field(default_factory=list)
    # terminal-shed bookkeeping (state == "shed"): why the scheduler
    # dropped it ("deadline_missed" is the only producer today)
    shed_reason: Optional[str] = None

    @property
    def n_generated(self) -> int:
        return len(self.generated)

    @property
    def prefilling(self) -> bool:
        """Running but not yet fully prefilled: the slot holds pages and
        (for recurrent families) carried state, but must not decode --
        the engine keeps it out of the decode active mask."""
        return self.state == "running" and self.prefill_pos < self.prefill_target

    def serve_prompt(self) -> np.ndarray:
        """What prefill must (re)compute: the original prompt plus anything
        generated before a preemption (recompute-style restart)."""
        if not self.generated:
            return self.prompt
        return np.concatenate([self.prompt, np.asarray(self.generated,
                                                       self.prompt.dtype)])


@dataclasses.dataclass
class PrefillChunk:
    """One unit of prefill work the scheduler hands the engine.

    Spans are in *cache-position* space (meta tokens ride in the first
    chunk): this chunk writes positions [start, padded_end), of which
    [start, true_end) are real tokens and the rest bucket padding (last
    chunk of attention-only families; recurrent families never pad).
    ``first and last`` means single-span -- the classic whole-prompt
    prefill path, byte-for-byte the pre-chunking behavior.

    ``kv_pages``: STATIC bound on block-table entries that can ever hold
    this request's live keys (its whole padded prompt footprint in pages
    -- every chunk frontier lives inside it). The scheduler owns it so
    the padding policy has one owner; the engine passes it verbatim to
    the gather attention (dead-key elision; 0 = unbounded)."""

    req: Request
    slot: int
    start: int
    true_end: int
    padded_end: int
    first: bool
    last: bool
    kv_pages: int = 0


class ContinuousScheduler:
    """Slot/page bookkeeping + the three-phase policy above.

    The scheduler is deliberately device-free: it sees token counts and the
    allocator, never arrays, so its decisions are unit-testable without a
    model. The engine executes the actions it returns.
    """

    ADMISSION_POLICIES = ("fifo", "priority", "deadline")

    def __init__(self, allocator: PagedKVAllocator, n_slots: int, *,
                 prefill_token_budget: int = 512,
                 extra_tokens_per_prefill: int = 0,
                 pad_to: int = 1,
                 prefill_chunk: Optional[int] = None,
                 admission_policy: str = "fifo",
                 enforce_deadlines: bool = False,
                 clock: Optional[Callable[[], float]] = None,
                 tracer=None, metrics=None,
                 offload: bool = False,
                 prefix_cache: bool = False,
                 spill_fn: Optional[Callable] = None,
                 restore_fn: Optional[Callable] = None):
        if admission_policy not in self.ADMISSION_POLICIES:
            raise ValueError(f"unknown admission_policy "
                             f"{admission_policy!r}; have "
                             f"{self.ADMISSION_POLICIES}")
        self.alloc = allocator
        self.n_slots = n_slots
        self.prefill_token_budget = prefill_token_budget
        # meta tokens (hymba) ride along with every prefill's cache cost
        self.extra_tokens = extra_tokens_per_prefill
        # the engine bucket-pads prompts (compile caching), so admission
        # must charge the padded cache footprint, not the raw prompt
        self.pad_to = pad_to
        # chunked prefill: split prompts into prefill_chunk-position spans
        # interleaved with decode steps (None/0 = single-pass). Must exceed
        # the meta-token count (the first chunk carries them).
        if prefill_chunk:
            prefill_chunk = max(prefill_chunk, extra_tokens_per_prefill + 1)
        self.prefill_chunk = prefill_chunk or None
        # admission order: "fifo" admits in submission order (unchanged
        # default); "priority"/"deadline" re-sort the queue each
        # iteration (the SLO-aware policy drop-in the scheduler was
        # designed for -- see _order_queue).
        self.admission_policy = admission_policy
        # SLO *enforcement* (off by default -- "deadline" as a pure
        # admission ORDER stays available without it): when on, a request
        # whose absolute deadline has passed is shed -- terminal
        # "deadline_missed" status, pages freed -- at the admission and
        # decode-step boundaries (shed_expired) instead of consuming
        # prefill/decode budget to produce tokens nobody can use.
        self.enforce_deadlines = enforce_deadlines
        # Monotonic by default: wall clocks (time.time) can step backwards
        # under NTP and corrupt every TTFT/ITL/latency duration. Deadlines
        # are absolute timestamps in THIS clock's domain (engine.now()).
        self.clock = clock or time.monotonic
        # Observability hooks (both optional, engine-wired): a
        # repro_torch.obs.trace.Tracer receiving lifecycle events on each
        # request's track, and a repro_torch.obs.metrics.MetricsRegistry
        # receiving transition counters.
        self.tracer = tracer
        self.metrics = metrics
        # KV-lifecycle hooks (docs/serving.md#kv-lifecycle; engine-wired,
        # both off by default). ``offload``: a preempted victim's committed
        # pages spill to the allocator's host pool (``spill_fn``) and a
        # re-admission restores them (``restore_fn``) instead of
        # recomputing from chunk 0; either hook returning falsy degrades
        # that victim to the classic recompute restart. ``prefix_cache``:
        # admission content-hashes the prompt at page granularity and maps
        # already-materialized prefix pages copy-on-write, skipping their
        # prefill chunks.
        self.offload = offload
        self.prefix_cache = prefix_cache
        self.spill_fn = spill_fn
        self.restore_fn = restore_fn
        self.queue: List[Request] = []
        self.running: Dict[int, Request] = {}          # slot -> request
        self.rejected: List[Request] = []              # engine drains these
        self._admit_seq = 0

    # -- observability -----------------------------------------------------
    def _count(self, name: str, n: int = 1) -> None:
        if self.metrics is not None and n:
            self.metrics.counter(name).inc(n)

    def _event(self, req: Request, name: str, **args) -> None:
        if self.tracer is None:
            return
        from repro_torch.obs import trace as otrace
        self.tracer.instant(name, cat="request",
                            tid=otrace.req_tid(req.rid), **args)

    def _note_admitted(self, req: Request) -> None:
        """Close the request's queued span and count the admission."""
        self._count("admissions")
        if self.tracer is None:
            return
        from repro_torch.obs import trace as otrace
        self.tracer.complete("queued", req.queued_since or req.submitted_at,
                             cat="request", tid=otrace.req_tid(req.rid),
                             slot=req.slot, attempt=req.n_preempted + 1)

    def _prefill_need(self, req: Request) -> int:
        plen = len(req.serve_prompt())
        return -(-plen // self.pad_to) * self.pad_to + self.extra_tokens

    def _kv_pages(self, req: Request) -> int:
        """Static live-key page bound for ``req``'s gather attention: the
        pages its whole padded prompt will ever occupy (>= every chunk's
        ``padded_end``), capped at the per-sequence table width."""
        return min(self.alloc.max_pages_per_seq,
                   pages_for(self._prefill_need(req), self.alloc.page_size))

    def _chunk_spans(self, req: Request,
                     anchor: int = 0) -> List[Tuple[int, int, int]]:
        """(start, true_end, padded_end) spans covering prompt + meta in
        cache-position space. Single span (the classic path) when chunking
        is off or the request fits one chunk; otherwise every span is
        exactly ``prefill_chunk`` long except the last, which is padded to
        the engine's compile bucket (``pad_to``; 1 for recurrent families,
        whose scan state must never absorb padding).

        ``anchor > 0`` starts the lattice at that cache position instead
        of 0: positions [0, anchor) are already materialized (a host-pool
        restore or a prefix-cache CoW run) and must not be recomputed.
        The anchor is arbitrary -- a restored decode victim resumes
        mid-page -- so the anchored lattice is simply spans of
        ``prefill_chunk`` from ``anchor``."""
        total = len(req.serve_prompt()) + self.extra_tokens
        c = self.prefill_chunk
        if not anchor and (not c or total <= c):
            return [(0, total, self._prefill_need(req))]
        # The last span's compile-bucket padding never exceeds the
        # single-pass footprint (roundup of the total): a request that
        # fits the arena unchunked must never out-grow it merely because
        # the chunk size is not page-aligned.
        cap = -(-total // self.pad_to) * self.pad_to
        spans, s = [], anchor
        if anchor and not c:
            # chunking off but a lifecycle feature anchored this request:
            # one continuation span covers the remainder.
            pe = min(s + -(-(total - s) // self.pad_to) * self.pad_to, cap)
            return [(s, total, max(pe, total))]
        while s < total:
            e = min(s + c, total)
            pe = e if e - s == c else \
                min(s + -(-(e - s) // self.pad_to) * self.pad_to, cap)
            spans.append((s, e, max(pe, e)))
            s = e
        return spans

    # -- prefix-cache hashing ---------------------------------------------
    def _prefix_keys(self, req: Request) -> List[bytes]:
        """Page-granular content chain keys for ``req``'s prompt: key ``i``
        digests the whole token prefix covering cache positions
        [0, (i+1) * page_size) -- meta positions (model-constant) are
        seeded into the chain head, so two requests share key ``i`` iff
        their first ``i+1`` cache pages hold identical content. Only pages
        fully covered by TRUE positions get keys (pad- or decode-written
        pages are never content-addressable)."""
        page = self.alloc.page_size
        toks = np.ascontiguousarray(np.asarray(req.serve_prompt(), np.int32))
        total = len(toks) + self.extra_tokens
        h = hashlib.sha256(
            f"kvprefix:v1:{page}:{self.extra_tokens}".encode()).digest()
        keys: List[bytes] = []
        for i in range(total // page):
            lo = max(0, i * page - self.extra_tokens)
            hi = (i + 1) * page - self.extra_tokens
            h = hashlib.sha256(h + toks[lo:hi].tobytes()).digest()
            keys.append(h)
        return keys

    def _req_keys(self, req: Request) -> List[bytes]:
        if req.prefix_keys is None:
            req.prefix_keys = self._prefix_keys(req)
        return req.prefix_keys

    def note_committed(self, req: Request) -> None:
        """Engine hook after a prefill execution: publish content keys for
        every page now fully covered by committed TRUE positions
        (``req.cache_len``). Published pages become CoW candidates for
        later admissions and survive this slot's eviction (the index holds
        a reference). Publication happens strictly post-execution --
        publishing at chunk-emission time would index pages a skipped or
        faulted chunk never wrote."""
        if not self.prefix_cache or req.state != "running":
            return
        pages = self.alloc.slot_pages(req.slot)
        keys = self._req_keys(req)
        n_full = min(req.cache_len // self.alloc.page_size,
                     len(keys), len(pages))
        n = 0
        for i in range(n_full):
            if self.alloc.publish_prefix(keys[i], pages[i]):
                n += 1
        if n:
            self._count("prefix_pages_published", n)

    # -- submission --------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.state = "queued"
        req.submitted_at = req.submitted_at or self.clock()
        req.queued_since = req.submitted_at
        self._event(req, "submitted", prompt_tokens=int(len(req.prompt)))
        self.queue.append(req)

    def _order_queue(self) -> None:
        """Apply the admission policy: re-sort the wait queue in place
        before each admission pass. FIFO is the identity (submission
        order, preempted requests re-inserted at the front by
        :meth:`preempt`). The sorted policies are stable, and preempted
        requests keep absolute precedence under every policy -- they hold
        recompute debt, and re-admitting them first preserves the
        youngest-evicted/oldest-progresses livelock-freedom argument.

        * ``priority``: highest ``Request.priority`` first; deadline then
          submission time break ties.
        * ``deadline``: earliest-deadline-first (EDF); deadline-less
          requests are best-effort and sort last by submission time.

        The final tie-break is the rid: submission timestamps from a fast
        monotonic clock (or an injected logical clock) can collide, and an
        order that depends on sort stability over a queue whose layout
        varies with preemption history is not deterministic across runs.
        """
        if self.admission_policy == "fifo" or len(self.queue) < 2:
            return
        inf = float("inf")

        def key(r: Request):
            dl = r.deadline if r.deadline is not None else inf
            if self.admission_policy == "priority":
                return (r.n_preempted == 0, -r.priority, dl,
                        r.submitted_at, r.rid)
            return (r.n_preempted == 0, dl, r.submitted_at, r.rid)

        self.queue.sort(key=key)

    @property
    def has_work(self) -> bool:
        return bool(self.queue or self.running)

    def _free_slots(self) -> List[int]:
        return [s for s in range(self.n_slots) if s not in self.running]

    # -- phase 1: admission ------------------------------------------------
    def admissions(self) -> List[Tuple[Request, int, List[int]]]:
        """(request, slot, pages) to prefill this iteration. Pages are
        allocated here (the commitment point); the engine only executes."""
        out: List[Tuple[Request, int, List[int]]] = []
        budget = self.prefill_token_budget
        self._order_queue()
        free = self._free_slots()
        while self.queue and free:
            req = self.queue[0]
            if self._expired(req):
                # Deadline passed while waiting: shed at admission rather
                # than spend a prefill pass on a missed SLO.
                self.queue.pop(0)
                self.shed(req)
                continue
            need = self._prefill_need(req)
            cap = min(self.alloc.n_pages, self.alloc.max_pages_per_seq)
            if pages_for(need, self.alloc.page_size) > cap:
                # Can NEVER be admitted -- a preempted request regrew past
                # the arena (its recompute prompt includes everything it
                # generated). Reject it instead of head-of-line-blocking
                # the queue forever; the engine finishes it as truncated.
                self.queue.pop(0)
                self.rejected.append(req)
                continue
            if out and need > budget:
                break                      # budget spent; keep FIFO order
            if not self.alloc.can_admit(need):
                break                      # head-of-line blocks: no overtake
            self.queue.pop(0)
            slot = free.pop(0)
            pages = self.alloc.alloc_slot(slot, need)
            assert pages is not None       # can_admit just said yes
            req.state, req.slot = "running", slot
            req.admitted_seq = self._admit_seq
            self._admit_seq += 1
            self.running[slot] = req
            self._note_admitted(req)
            self._count("prefill_tokens",
                        len(req.serve_prompt()) + self.extra_tokens)
            if req.n_preempted:
                self._count("restarts_recomputed")
            budget -= need
            out.append((req, slot, pages))
        return out

    # -- phase 1, chunk-queue form ----------------------------------------
    def prefill_schedule(self, admit_new: bool = True) -> List[PrefillChunk]:
        """The iteration's prefill work as a chunk queue.

        ``admit_new=False`` suppresses pass 2 (new admissions) but still
        emits continuation chunks -- the static policy's group barrier
        blocks admission, never the completion of an in-flight prefill.

        With chunking off this is exactly :meth:`admissions` (each admitted
        request becomes one whole-prompt span). With chunking on, the
        queue is built in two passes under the same prefill token budget
        (charged in true cache positions; the first item always lands so
        prefill can never fully starve):

        1. *continuation chunks* for mid-prefill runners, oldest-admitted
           first -- they hold pages and carried state, so finishing them
           frees capacity soonest. A chunk whose pages cannot be allocated
           evicts the youngest strictly-younger runner and retries; if none
           exists the request stalls this iteration (an older runner will
           free pages), or -- when it is the sole runner -- finishes
           truncated (its prompt outgrew the arena and eviction cannot
           help, the mid-prefill mirror of the sole-runner decode rule).
        2. *admissions*: first chunks for queued requests, FIFO, as long
           as a slot is free, the first chunk's pages fit, and budget
           remains. Unservable requests (recompute prompt regrew past the
           arena) are rejected exactly as in :meth:`admissions`.

        With a KV-lifecycle feature on (``offload`` / ``prefix_cache``),
        pass 2 additionally decides restore-vs-recompute per candidate: a
        host-pool spill restores (all-fresh pages, ``restore_fn`` DMAs the
        payload back, prefill resumes at the committed anchor), a prefix
        match maps the hit pages copy-on-write and prefill starts at the
        hit boundary. Either path emits ONE continuation-style chunk
        (``first=False`` -- the cache below the anchor is live) and
        charges the budget only for positions actually computed. A failed
        restore degrades to the classic recompute admission in place.
        Both features off reduces this loop to the classic admission
        exactly.
        """
        if not self.prefill_chunk and not (self.offload
                                           or self.prefix_cache):
            if not admit_new:
                return []
            return [PrefillChunk(req, slot, 0, len(req.serve_prompt())
                                 + self.extra_tokens, self._prefill_need(req),
                                 True, True)
                    for (req, slot, _pages) in self.admissions()]
        out: List[PrefillChunk] = []
        budget = self.prefill_token_budget
        # pass 1: continuation chunks, oldest first
        for req in sorted(list(self.running.values()),
                          key=lambda r: r.admitted_seq):
            while req.state == "running" and req.prefilling:
                if out and budget <= 0:
                    break
                w = self._next_chunk(req)
                if w is None:              # arena pressure
                    if self._evict_younger_than(req):
                        continue
                    if len(self.running) == 1:
                        self.finish(req, truncated=True)
                    break
                budget -= w.true_end - w.start
                self._count("prefill_tokens", w.true_end - w.start)
                out.append(w)
                req.prefill_pos = w.true_end
            if budget <= 0 and out:
                break
        # pass 2: new admissions (first chunks; restore/prefix-aware)
        self._order_queue()
        free = self._free_slots() if admit_new else []
        page = self.alloc.page_size
        while self.queue and free and (budget > 0 or not out):
            req = self.queue[0]
            if self._expired(req):
                self.queue.pop(0)          # shed at admission (see above)
                self.shed(req)
                continue
            need = self._prefill_need(req)
            cap = min(self.alloc.n_pages, self.alloc.max_pages_per_seq)
            if pages_for(need, page) > cap:
                self.queue.pop(0)          # can NEVER be admitted
                self.rejected.append(req)
                continue
            target = len(req.serve_prompt()) + self.extra_tokens
            # restart decision: a spilled victim restores at its committed
            # anchor; otherwise a prefix match anchors at the CoW-hit
            # boundary (capped so at least one position is computed -- the
            # final chunk must produce logits to sample from).
            spill = self.alloc.host_peek(req.rid) if self.offload else None
            anchor = int(spill.tokens) if spill is not None else 0
            hits: List[int] = []
            if not anchor and self.prefix_cache:
                keys = self._req_keys(req)
                max_hit = max(0, min(len(keys), (target - 1) // page))
                hits = self.alloc.match_prefix(keys[:max_hit])
                anchor = len(hits) * page
            s, e, pe = self._chunk_spans(req, anchor)[0]
            if out and e - s > budget:
                break                      # budget spent; keep FIFO order
            slot = free[0]
            if hits:
                pages = self.alloc.alloc_slot_shared(slot, pe, hits)
                if pages is None:
                    break                  # head-of-line blocks: no overtake
            else:
                if not self.alloc.can_admit(pe):
                    break                  # head-of-line blocks: no overtake
                pages = self.alloc.alloc_slot(slot, pe)
                assert pages is not None   # can_admit just said yes
            restored = False
            if spill is not None:
                restored = bool(self.restore_fn is not None
                                and self.restore_fn(req, slot, anchor))
                if not restored:
                    # degraded restore (offload_io fault / payload gone):
                    # unwind the allocation and retry THIS request as a
                    # classic recompute admission -- the spill entry is
                    # consumed, so the retry takes the anchor-0 path.
                    self.alloc.free_slot(slot)
                    self.alloc.host_drop(req.rid)
                    continue
            self.queue.pop(0)
            free.pop(0)
            req.state, req.slot = "running", slot
            req.admitted_seq = self._admit_seq
            self._admit_seq += 1
            self.running[slot] = req
            self._note_admitted(req)
            req.prefill_target = target
            req.prefill_pos = e
            req.chunk_anchor = anchor
            budget -= e - s
            self._count("prefill_tokens", e - s)
            if hits:
                self._count("prefix_hit_tokens", anchor)
                self._event(req, "prefix_hit", tokens=anchor,
                            pages=len(hits))
            if restored:
                self._count("restarts_restored")
            elif req.n_preempted:
                self._count("restarts_recomputed")
            first = anchor == 0
            out.append(PrefillChunk(
                req, slot, s, e, pe, first, e >= target,
                kv_pages=0 if first else self._kv_pages(req)))
        return out

    def _next_chunk(self, req: Request) -> Optional[PrefillChunk]:
        """The continuation chunk at ``req.prefill_pos``, with its pages
        allocated (the commitment point) -- or None under arena pressure
        (nothing allocated)."""
        for (s, e, pe) in self._chunk_spans(req, req.chunk_anchor):
            if s == req.prefill_pos:
                new = self.alloc.grow_slot(req.slot, pe)
                if new is None:
                    return None
                return PrefillChunk(req, req.slot, s, e, pe, False,
                                    e >= req.prefill_target,
                                    kv_pages=self._kv_pages(req))
        raise AssertionError(f"prefill_pos {req.prefill_pos} off the "
                             f"chunk lattice for rid {req.rid}")

    def _evict_younger_than(self, req: Request) -> bool:
        """Preempt the youngest runner strictly younger than ``req`` (so
        the oldest mid-prefill request always makes progress: livelock-free
        for the same reason decode eviction is). False when none exists."""
        cands = [r for r in self.running.values()
                 if r.admitted_seq > req.admitted_seq]
        if not cands:
            return False
        self.preempt(max(cands, key=lambda r: r.admitted_seq))
        return True

    # -- phase 2: decode capacity / preemption ----------------------------
    def ensure_decode_capacity(self) -> Tuple[List[Tuple[int, int]],
                                              List[Request],
                                              List[Request]]:
        """Guarantee every running slot can take one more token.

        Returns (new_pages, evicted, truncated): ``new_pages`` as
        (slot, page_id) for the engine's table updates; ``evicted``
        requests were preempted back to the queue (their slots are free);
        ``truncated`` hit their per-sequence context cap and were finished
        here (immediately out of ``running`` -- a truncated request left
        running would be a legal eviction victim later in the same pass,
        and preempting an already-finished request would requeue it as a
        zombie).
        """
        new_pages: List[Tuple[int, int]] = []
        evicted: List[Request] = []
        truncated: List[Request] = []
        for slot in sorted(self.running):
            req = self.running.get(slot)
            if req is None or req.prefilling:
                continue               # mid-prefill slots do not decode
            while True:
                if req.cache_len % self.alloc.page_size != 0:
                    break                  # headroom in the current page
                held = len(self.alloc.slot_pages(slot))
                if req.cache_len < held * self.alloc.page_size:
                    break                  # page already allocated
                if held >= self.alloc.max_pages_per_seq:
                    self.finish(req, truncated=True)   # context limit
                    truncated.append(req)
                    break
                pid = self.alloc.extend_slot(slot)
                if pid is not None:
                    new_pages.append((slot, pid))
                    break
                if len(self.running) <= 1:
                    # The sole runner holds every live page yet needs more:
                    # its context outgrew the arena, and eviction cannot
                    # help. Finish it truncated rather than thrash.
                    self.finish(req, truncated=True)
                    truncated.append(req)
                    break
                victim = self._eviction_victim()
                self.preempt(victim)
                evicted.append(victim)
                if victim is req:
                    break                  # evicted itself; retry later
        return new_pages, evicted, truncated

    def _eviction_victim(self) -> Request:
        """The youngest-admitted runner: least completed work is wasted and
        the oldest request always keeps making progress (no livelock)."""
        return max(self.running.values(), key=lambda r: r.admitted_seq)

    # -- state transitions -------------------------------------------------
    def preempt(self, req: Request) -> None:
        """Evict a running request: free its pages, requeue for recompute.
        Generated tokens are kept (they re-prefill as prompt suffix); a
        mid-prefill victim restarts from chunk 0 (its pages and carried
        recurrent state are gone -- recompute IS the restart mechanism,
        at chunk granularity).

        With ``offload`` on, the victim's committed pages are spilled to
        the host pool first (``spill_fn``; a device->host copy), so its
        next admission can restore instead of recompute. The spill runs
        BEFORE ``free_slot`` -- page contents must be captured while the
        pages are still exclusively owned."""
        if (self.offload and self.spill_fn is not None
                and req.cache_len > 0):
            committed = req.cache_len
            pages = self.alloc.slot_pages(req.slot)[
                :pages_for(committed, self.alloc.page_size)]
            self.spill_fn(req, pages, committed)
        self.alloc.free_slot(req.slot)
        del self.running[req.slot]
        req.state, req.slot, req.cache_len = "queued", -1, 0
        req.prefill_pos = req.prefill_target = 0
        req.chunk_anchor = 0
        req.prefix_keys = None             # serve_prompt grew: keys stale
        req.n_preempted += 1
        req.queued_since = self.clock()
        self._count("preemptions")
        self._event(req, "preempt", n_preempted=req.n_preempted)
        self.queue.insert(0, req)          # preempted requests go first

    def finish(self, req: Request, *, truncated: bool = False) -> None:
        self.alloc.free_slot(req.slot)
        self.alloc.host_drop(req.rid)       # terminal: spill is dead weight
        self.running.pop(req.slot, None)
        req.state = "finished"
        req.truncated = truncated
        req.t_finished = self.clock()
        self._count("finished")
        if truncated:
            self._count("truncated")
        self._event(req, "finished", truncated=truncated,
                    new_tokens=req.n_generated)

    # -- SLO enforcement ---------------------------------------------------
    def _expired(self, req: Request, now: Optional[float] = None) -> bool:
        return (self.enforce_deadlines and req.deadline is not None
                and (self.clock() if now is None else now) >= req.deadline)

    def shed(self, req: Request, reason: str = "deadline_missed") -> None:
        """Terminal drop: free any held slot/pages, mark the request shed.
        Unlike :meth:`preempt` nothing is requeued -- the SLO is already
        missed, and recomputing it would burn budget deadlined traffic
        behind it needs. Partial tokens stay on the request (they are
        exact: shedding never rewinds the stream)."""
        if req.state == "running":
            self.alloc.free_slot(req.slot)
            self.running.pop(req.slot, None)
        self.alloc.host_drop(req.rid)       # terminal: spill is dead weight
        req.state, req.slot = "shed", -1
        req.shed_reason = reason
        req.t_finished = self.clock()
        self._count("shed")
        self._event(req, "shed", reason=reason,
                    new_tokens=req.n_generated)

    def shed_expired(self) -> List[Request]:
        """Shed every queued or running request whose deadline has passed.
        The engine calls this at the admission boundary (start of the
        iteration) and again at the decode-step boundary, so an expired
        request never charges another prefill chunk or decode token.
        No-op (and cheap) unless ``enforce_deadlines`` is on."""
        if not self.enforce_deadlines:
            return []
        now = self.clock()
        out: List[Request] = []
        for req in [r for r in self.queue if self._expired(r, now)]:
            self.queue.remove(req)
            self.shed(req)
            out.append(req)
        for req in [r for r in list(self.running.values())
                    if self._expired(r, now)]:
            self.shed(req)
            out.append(req)
        return out


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------
def _pct(vals: List[float], p: float) -> Optional[float]:
    """Percentile over a possibly-empty population: None when empty.

    A fabricated 0.0 here is worse than a gap — an all-shed or all-failed
    run would read as an infinitely fast one in BENCH rows and trend
    plots (the exact bug this replaces)."""
    if not vals:
        return None
    return float(np.percentile(np.asarray(vals), p))


def summarize(requests: List[Request], wall_s: float) -> Dict[str, float]:
    """Aggregate per-request telemetry into the BENCH_serving schema.

    TTFT and ITL are split out deliberately: TTFT measures queueing +
    prefill (what the admission policy controls), ITL the gaps *between* a
    request's tokens (what a co-tenant's prefill stalls -- the distribution
    chunked prefill exists to tighten). ITL percentiles pool every
    inter-token gap across requests, so one stalled request cannot hide in
    a per-request mean.

    Latency keys are ``None`` (JSON null) when their population is empty
    — no finished request, or no second token ever emitted — so consumers
    can distinguish "nothing completed" from "completed instantly"."""
    done = [r for r in requests if r.state == "finished"]
    lat = [r.t_finished - r.submitted_at for r in done
           if r.t_finished is not None]
    ttft = [r.t_first_token - r.submitted_at for r in done
            if r.t_first_token is not None]
    itl = [g for r in requests for g in r.itl_s]
    new_tokens = sum(r.n_generated for r in done)
    return {
        "requests": float(len(done)),
        "new_tokens": float(new_tokens),
        "wall_s": wall_s,
        "tokens_per_s": new_tokens / max(wall_s, 1e-9),
        "p50_latency_s": _pct(lat, 50),
        "p99_latency_s": _pct(lat, 99),
        "p50_ttft_s": _pct(ttft, 50),
        "p99_ttft_s": _pct(ttft, 99),
        "p50_itl_s": _pct(itl, 50),
        "p95_itl_s": _pct(itl, 95),
        "prefill_chunks": float(sum(r.n_chunks for r in requests)),
        "preemptions": float(sum(r.n_preempted for r in requests)),
        "truncated": float(sum(1 for r in requests if r.truncated)),
        # SLO enforcement: requests dropped with a terminal
        # deadline_missed status (scheduler.shed_expired); always present
        # (0.0 with enforcement off) so BENCH_serving rows track it.
        "shed": float(sum(1 for r in requests if r.state == "shed")),
    }
