"""Safety invariants checked on every explored transition, plus the
graph-level flags the wedge/liveness checks consume.

The GL8xx table (docs/analysis.md#model-checker):

======  ===================================================================
GL801   allocator ownership invariant broken (``PagedKVAllocator.check()``
        failed after an action -- the property suite's oracle, now run on
        EVERY reachable interleaving)
GL802   token-prefix rewind: a request's committed token stream is not a
        prefix-preserving extension of its pre-action stream
GL803   defrag conservation: compaction changed page accounting (used /
        prefix-index / per-slot table lengths / refcount multiset / host
        pool)
GL804   arena wedge: a reachable state from which no state satisfying
        ``can_admit(page_size) or drained`` is reachable (graph check;
        only sound when exploration is exhaustive)
GL805   terminal request retains resources: a finished/shed request still
        owns a slot table or a host-pool entry, or a mapped slot has no
        running request
GL806   bounded-fairness liveness: a reachable state from which no
        drained state (every submitted request terminal, scheduler idle)
        is reachable within the explored horizon (graph check)
GL807   unhandled exception escaping the control plane under a legal
        action
======  ===================================================================
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.mc.harness import NullEngine


@dataclasses.dataclass(frozen=True)
class Flags:
    """Per-state predicates for the graph-level checks."""

    can_admit: bool
    drained: bool


def state_flags(eng: NullEngine) -> Flags:
    all_submitted = len(eng.requests) == len(eng.mc_cfg.prompts)
    drained = (all_submitted and not eng.sched.has_work
               and all(r.state in ("finished", "shed")
                       for r in eng.requests))
    return Flags(can_admit=eng.alloc.can_admit(eng.page_size),
                 drained=drained)


def pre_snapshot(eng: NullEngine) -> Dict:
    """The pre-action facts the post-action checks compare against."""
    al = eng.alloc
    return {
        "gen": {r.rid: tuple(int(t) for t in r.generated)
                for r in eng.requests},
        "used": al.used_pages,
        "prefix_pages": al.prefix_index_pages,
        "tables_len": {s: len(p) for s, p in al._tables.items()},
        "ref_multiset": tuple(sorted(al._ref.values())),
        "host": tuple((rid, sp.n_pages) for rid, sp in al._host.items()),
    }


def check_transition(eng: NullEngine, pre: Dict, action: str,
                     exc: Optional[BaseException]
                     ) -> List[Tuple[str, str]]:
    """-> [(code, message)] for every invariant the transition broke."""
    out: List[Tuple[str, str]] = []
    if exc is not None:
        out.append(("GL807", f"unhandled {type(exc).__name__} escaping "
                             f"the control plane on {action!r}: {exc}"))
        return out              # post-state is not meaningful past a raise

    # GL801: the allocator's own ownership oracle
    try:
        eng.alloc.check()
    except AssertionError as e:
        out.append(("GL801", f"allocator invariant broken after "
                             f"{action!r}: {e}"))

    # GL802: committed token streams only ever grow by appending
    for r in eng.requests:
        before = pre["gen"].get(r.rid, ())
        now = tuple(int(t) for t in r.generated)
        if len(now) < len(before) or now[:len(before)] != before:
            out.append(("GL802", f"token-prefix rewind on rid {r.rid} "
                                 f"after {action!r}: {before} -> {now}"))

    # GL803: defrag is accounting-invariant
    if action == "defrag":
        al = eng.alloc
        post = {"used": al.used_pages,
                "prefix_pages": al.prefix_index_pages,
                "tables_len": {s: len(p) for s, p in al._tables.items()},
                "ref_multiset": tuple(sorted(al._ref.values())),
                "host": tuple((rid, sp.n_pages)
                              for rid, sp in al._host.items())}
        for k in post:
            if post[k] != pre[k]:
                out.append(("GL803", f"defrag changed {k}: "
                                     f"{pre[k]} -> {post[k]}"))

    # GL805: terminal requests hold nothing; mapped slots are running
    running_rids = {r.rid for r in eng.sched.running.values()}
    mapped_slots = set(eng.alloc._tables)
    if mapped_slots != set(eng.sched.running):
        out.append(("GL805", f"mapped slots {sorted(mapped_slots)} != "
                             f"running slots "
                             f"{sorted(eng.sched.running)} after "
                             f"{action!r}"))
    for r in eng.requests:
        if r.state not in ("finished", "shed"):
            continue
        if r.rid in running_rids:
            out.append(("GL805", f"terminal rid {r.rid} still running "
                                 f"after {action!r}"))
        if eng.alloc.host_peek(r.rid) is not None:
            out.append(("GL805", f"terminal rid {r.rid} still holds a "
                                 f"host-pool spill after {action!r}"))
        if r.state == "shed" and r.slot != -1:
            out.append(("GL805", f"shed rid {r.rid} kept slot {r.slot} "
                                 f"after {action!r}"))
    return out
