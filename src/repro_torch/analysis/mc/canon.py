"""Canonical state hashing for memoization.

Two explored states must hash equal iff no sequence of future actions can
distinguish them. The hash therefore covers every decision input of the
control plane -- and ONLY decision inputs:

* the allocator, with physical page ids relabeled by a fixed traversal
  order (slot tables in slot order, then prefix index in LRU order, then
  held pages, then the free list in pop order). Page ids are opaque to a
  tensor-free engine, so states differing only in page naming are
  bisimilar; the free list's POP order is decision-relevant (it dictates
  which label the next allocation binds) and is preserved by the
  relabeling.
* per-request progress: state, slot, generated-token COUNT (values are a
  pure function of (rid, count) under the null executor), cache/prefill
  positions, chunk anchor, priority/deadline/submitted_at (admission-sort
  keys), and ``n_preempted`` clamped to {0, 1} -- only the ``== 0``
  distinction feeds any decision (queue ordering), and the raw count
  would make preempt/re-admit cycles an infinite state space.
* ``admitted_seq`` as a RANK over all ever-admitted requests: eviction
  and younger-than comparisons are order-relations, the raw monotone
  counter is not bounded.
* scheduler queue order, the running dict's INSERTION order (it fixes
  decode-commit order, which fixes free-list order on finish), the host
  pool's LRU order, and the logical clock.
* the armed-fault kind (if any) and the retired-fault log. Draw counters
  are excluded -- sound only because mc faults are one-shot p=1
  full-window specs (see ``actions._arm_fault``).

Excluded: metrics, tracer buffers, watchdog, fabricated token values,
timestamps other than ``submitted_at``/``deadline`` -- all write-only
telemetry the control plane never reads back.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

from repro_torch.analysis.mc.harness import NullEngine


def state_tuple(eng: NullEngine) -> Tuple:
    """The canonical (hash-ready) structural view of an engine state."""
    snap = eng.alloc.snapshot()
    relabel: dict = {}

    def lab(p: int) -> int:
        if p not in relabel:
            relabel[p] = len(relabel)
        return relabel[p]

    tables = tuple((slot, tuple(lab(p) for p in pages))
                   for slot, pages in snap["tables"].items())
    prefix = tuple((key, lab(p)) for key, p in snap["prefix"])
    held = tuple(lab(p) for p in snap["held"])
    free = tuple(lab(p) for p in snap["free_pop_order"])
    ref = tuple(sorted((lab(p), r) for p, r in snap["ref"].items()))
    host = tuple(snap["host"])

    seqs = sorted({r.admitted_seq for r in eng.requests
                   if r.admitted_seq >= 0})
    rank = {s: i for i, s in enumerate(seqs)}
    reqs = tuple(
        (r.rid, r.state, r.slot,
         min(r.n_preempted, 1),
         rank.get(r.admitted_seq, -1),
         r.n_generated, r.cache_len,
         # n_chunks is cumulative telemetry (preempt cycles grow it
         # without bound) and never feeds a decision: excluded
         r.prefill_pos, r.prefill_target, r.chunk_anchor,
         bool(r.truncated), r.shed_reason,
         r.priority, r.deadline, r.submitted_at,
         len(r.prompt), r.max_new_tokens,
         tuple(r.prefix_keys) if r.prefix_keys else None)
        for r in eng.requests)

    sched = (tuple(r.rid for r in eng.sched.queue),
             tuple((slot, r.rid) for slot, r in eng.sched.running.items()),
             tuple(r.rid for r in eng.sched.rejected))

    fault = (eng.faults.plan.specs[0].kind
             if eng.faults is not None else None,
             tuple(eng.mc_fired))

    return (tables, prefix, held, free, ref, host, reqs, sched, fault,
            round(eng.clock.t, 9))


def canonical_state(eng: NullEngine) -> str:
    """16-hex-char canonical hash of the state."""
    return hashlib.sha256(
        repr(state_tuple(eng)).encode()).hexdigest()[:16]
