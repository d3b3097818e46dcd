"""Explicit-state BFS exploration, counterexample handling, replay.

Exploration is breadth-first over canonical state hashes: the parent
pointers therefore give a SHORTEST action trace to every state, which is
the seed :func:`minimize` shrinks further by greedy deletion (re-replaying
the candidate trace after each removal). Engines are deep-copied per
transition and held only on the frontier; expanded states keep just their
hash, flags, and edges.

The per-transition safety checks (GL801/802/803/805/807) run on every
edge. The graph-level checks run only when exploration is EXHAUSTIVE
(every reachable state expanded, no state/depth cap hit):

* GL804 (arena wedge): every reachable state must reach some state where
  ``can_admit(page_size)`` holds or the workload is drained -- computed
  as backward reachability from the good set over reversed edges.
* GL806 (bounded-fairness liveness): every reachable state must reach a
  drained state (all submitted requests terminal, scheduler idle).

Counterexample replay is deterministic by construction -- the null
engine's only inputs are the config and the action trace -- and
:func:`replay` re-executes a trace to (violation, final state hash), the
pair the exported pytest regression pins.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.mc.actions import apply_action, enabled_actions
from repro_torch.analysis.mc.canon import canonical_state
from repro_torch.analysis.mc.harness import (ALL_CONFIGS, MCConfig, build_engine)
from repro_torch.analysis.mc.invariants import (Flags, check_transition,
                                          pre_snapshot, state_flags)

# codes with a per-transition witness (minimizable by replay); GL804/806
# are graph properties whose BFS trace is already shortest
TRANSITION_CODES = ("GL801", "GL802", "GL803", "GL805", "GL807")


@dataclasses.dataclass(frozen=True)
class Violation:
    code: str
    message: str
    trace: Tuple[str, ...]
    state_hash: str                 # canonical hash of the violating state
    config: str


@dataclasses.dataclass
class MCResult:
    config: str
    states: int
    transitions: int
    memo_hits: int
    terminal_states: int            # drained states reached
    complete: bool                  # exhaustive (no cap hit)
    violations: List[Violation]
    wall_s: float

    def to_dict(self) -> Dict:
        return {"config": self.config, "states": self.states,
                "transitions": self.transitions,
                "memo_hits": self.memo_hits,
                "terminal_states": self.terminal_states,
                "complete": self.complete,
                "violations": [dataclasses.asdict(v)
                               for v in self.violations],
                "wall_s": round(self.wall_s, 3)}


@dataclasses.dataclass
class ReplayResult:
    violation: Optional[Violation]  # first violation of the stop transition
    state_hash: str                 # hash after the last executed action
    executed: int                   # actions executed before stop
    valid: bool                     # False: an action was not enabled
    # one transition can break several invariants at once (e.g. a planted
    # defrag leak is both GL801 and GL803); all of them, in check order
    violations: Tuple[Violation, ...] = ()


def _path_to(parents: Dict[str, Tuple[Optional[str], Optional[str]]],
             h: str) -> Tuple[str, ...]:
    out: List[str] = []
    while True:
        ph, a = parents[h]
        if ph is None:
            break
        out.append(a)
        h = ph
    return tuple(reversed(out))


def explore(cfg: MCConfig, *, max_states: int = 200_000,
            max_depth: Optional[int] = None,
            check_liveness: bool = True,
            max_violations: int = 16) -> MCResult:
    """Exhaust (or cap) the interleaving space of one configuration."""
    t0 = time.perf_counter()
    eng0 = build_engine(cfg)
    h0 = canonical_state(eng0)
    parents: Dict[str, Tuple[Optional[str], Optional[str]]] = {
        h0: (None, None)}
    flags: Dict[str, Flags] = {h0: state_flags(eng0)}
    edges: Dict[str, List[Tuple[str, str]]] = {}
    frontier = collections.deque([(h0, eng0, 0)])
    violations: List[Violation] = []
    transitions = memo_hits = 0
    complete = True

    while frontier:
        h, eng, depth = frontier.popleft()
        if max_depth is not None and depth >= max_depth:
            complete = False
            edges[h] = []
            continue
        outs: List[Tuple[str, str]] = []
        for a in enabled_actions(eng):
            child = copy.deepcopy(eng)
            pre = pre_snapshot(child)
            exc: Optional[BaseException] = None
            try:
                apply_action(child, a)
            except Exception as e:        # noqa: BLE001 - GL807 material
                exc = e
            transitions += 1
            viols = check_transition(child, pre, a, exc)
            if viols:
                tr = _path_to(parents, h) + (a,)
                vh = canonical_state(child) if exc is None else "exception"
                for code, msg in viols:
                    violations.append(Violation(code, msg, tr, vh,
                                                cfg.name))
                continue              # do not explore past a violation
            ch = canonical_state(child)
            outs.append((a, ch))
            if ch in parents:
                memo_hits += 1
            else:
                parents[ch] = (h, a)
                flags[ch] = state_flags(child)
                if len(parents) > max_states:
                    complete = False
                else:
                    frontier.append((ch, child, depth + 1))
        edges[h] = outs
        if len(violations) >= max_violations:
            complete = False
            break

    if complete:
        violations += _graph_checks(cfg, parents, flags, edges,
                                    check_liveness=check_liveness)

    terminal = sum(1 for f in flags.values() if f.drained)
    return MCResult(config=cfg.name, states=len(parents),
                    transitions=transitions, memo_hits=memo_hits,
                    terminal_states=terminal, complete=complete,
                    violations=violations,
                    wall_s=time.perf_counter() - t0)


def _graph_checks(cfg: MCConfig, parents, flags, edges,
                  *, check_liveness: bool) -> List[Violation]:
    """GL804/GL806 over the complete reachability graph: backward
    reachability from the good set; any state outside it is a witness.
    One violation per check, anchored at the shortest-trace witness."""
    rev: Dict[str, List[str]] = collections.defaultdict(list)
    for src, outs in edges.items():
        for _a, dst in outs:
            rev[dst].append(src)

    def backward_reach(good: List[str]) -> set:
        seen = set(good)
        stack = list(good)
        while stack:
            h = stack.pop()
            for p in rev.get(h, ()):
                if p not in seen:
                    seen.add(p)
                    stack.append(p)
        return seen

    def witness(bad: List[str]) -> str:
        return min(bad, key=lambda h: len(_path_to(parents, h)))

    out: List[Violation] = []
    admit_ok = [h for h, f in flags.items() if f.can_admit or f.drained]
    bad = [h for h in parents if h not in backward_reach(admit_ok)]
    if bad:
        w = witness(bad)
        out.append(Violation(
            code="GL804",
            message=(f"arena wedge: {len(bad)} reachable state(s) from "
                     f"which neither can_admit({cfg.page_size}) nor a "
                     f"drained workload is reachable"),
            trace=_path_to(parents, w), state_hash=w, config=cfg.name))

    if check_liveness:
        drained = [h for h, f in flags.items() if f.drained]
        bad = [h for h in parents if h not in backward_reach(drained)]
        if bad:
            w = witness(bad)
            out.append(Violation(
                code="GL806",
                message=(f"liveness: {len(bad)} reachable state(s) from "
                         f"which no drained state (every request "
                         f"finished|shed) is reachable"),
                trace=_path_to(parents, w), state_hash=w,
                config=cfg.name))
    return out


# -- replay / minimization ---------------------------------------------------

def replay(cfg: MCConfig, trace: Tuple[str, ...]) -> ReplayResult:
    """Re-execute an action trace from the initial state; stops at the
    first violating transition. Deterministic: (config, trace) is the
    null engine's entire input."""
    eng = build_engine(cfg)
    for i, a in enumerate(trace):
        if a not in enabled_actions(eng):
            return ReplayResult(None, canonical_state(eng), i, False)
        pre = pre_snapshot(eng)
        exc: Optional[BaseException] = None
        try:
            apply_action(eng, a)
        except Exception as e:            # noqa: BLE001
            exc = e
        viols = check_transition(eng, pre, a, exc)
        if viols:
            vh = canonical_state(eng) if exc is None else "exception"
            vs = tuple(Violation(code, msg, tuple(trace[:i + 1]), vh,
                                 cfg.name) for code, msg in viols)
            return ReplayResult(vs[0], vh, i + 1, True, vs)
    return ReplayResult(None, canonical_state(eng), len(trace), True)


def _reproduces(cfg: MCConfig, trace: Tuple[str, ...], code: str) -> bool:
    return any(v.code == code for v in replay(cfg, trace).violations)


def minimize(cfg: MCConfig, violation: Violation) -> Violation:
    """Greedy-deletion shrink: drop any action whose removal still
    reproduces the violation code, to a fixed point. Graph-check codes
    (GL804/806) keep their BFS trace -- it is already a shortest path,
    and the property is not a single-transition predicate."""
    if violation.code not in TRANSITION_CODES:
        return violation
    trace = list(violation.trace)
    changed = True
    while changed:
        changed = False
        i = 0
        while i < len(trace):
            cand = tuple(trace[:i] + trace[i + 1:])
            if _reproduces(cfg, cand, violation.code):
                del trace[i]
                changed = True
            else:
                i += 1
    r = replay(cfg, tuple(trace))
    match = next(v for v in r.violations if v.code == violation.code)
    return dataclasses.replace(violation, trace=tuple(trace),
                               message=match.message,
                               state_hash=match.state_hash)


# -- counterexample export ---------------------------------------------------

SPEC_PREFIX = "mc:v1;"


def format_spec(config: str, trace: Tuple[str, ...]) -> str:
    """Compact replayable spec: ``mc:v1;config=<name>;trace=a>b>c``."""
    return f"{SPEC_PREFIX}config={config};trace=" + ">".join(trace)


def parse_spec(spec: str) -> Tuple[MCConfig, Tuple[str, ...]]:
    if not spec.startswith(SPEC_PREFIX):
        raise ValueError(f"not an mc spec (want {SPEC_PREFIX!r}...): "
                         f"{spec!r}")
    fields = dict(kv.split("=", 1)
                  for kv in spec[len(SPEC_PREFIX):].split(";") if kv)
    name = fields.get("config", "")
    if name not in ALL_CONFIGS:
        raise ValueError(f"unknown mc config {name!r}; "
                         f"have {sorted(ALL_CONFIGS)}")
    trace = tuple(a for a in fields.get("trace", "").split(">") if a)
    return ALL_CONFIGS[name], trace


def export_pytest(v: Violation) -> str:
    """A self-contained pytest regression pinning (code, trace, state
    hash). While the bug is open the test documents the reproduction;
    the fix flips the assertion to ``res.violation is None`` and keeps
    the trace locked forever (baseline policy: counterexamples become
    regressions, never baseline entries)."""
    fn = v.code.lower() + "_" + v.config.replace("-", "_")
    return f'''"""Auto-generated model-checker counterexample regression.

{v.code} on config {v.config!r}: {v.message}
Replay spec: {format_spec(v.config, v.trace)}
"""

from repro_torch.analysis.mc import explore, harness

TRACE = {v.trace!r}


def test_mc_counterexample_{fn}():
    cfg = harness.ALL_CONFIGS[{v.config!r}]
    res = explore.replay(cfg, TRACE)
    assert res.valid, "trace no longer replays (alphabet drift)"
    assert any(x.code == {v.code!r} for x in res.violations)
    assert res.state_hash == {v.state_hash!r}, "replay is deterministic"
'''


def export_fault_script(v: Violation) -> str:
    """A ``GEMMINI_FAULTS``-style reproduction script: the armed fault
    plan (if the trace fires one) plus the replay invocation."""
    kinds = [a[len("fault:"):] for a in v.trace if a.startswith("fault:")]
    plan = ";".join(f"{k.partition('@')[0]}"
                    f"@{k.partition('@')[2] or '*'}:p=1,max=1"
                    for k in kinds)
    lines = ["#!/bin/sh",
             f"# model-checker counterexample: {v.code} on {v.config}",
             f"# {v.message}",
             f"# action trace: {' > '.join(v.trace)}"]
    if plan:
        lines.append(f'export GEMMINI_FAULTS="seed=0;{plan}"')
    lines.append('exec python -m repro_torch.analysis.mc --replay '
                 f'"{format_spec(v.config, v.trace)}"')
    return "\n".join(lines) + "\n"
