"""Trace inspector CLI (port of ``repro.obs.__main__``):
``python -m repro_torch.obs <trace> [--check] [--top K]``.

Summarizes an exported trace (Chrome-trace JSON or JSONL event log):
top-k spans by self time, the kernel utilization table (when the trace
carries profiled ``cat="kernel"`` spans), and a per-request lifecycle
timeline.  ``--check`` validates the Chrome-trace schema and exits
non-zero on any violation — CI runs it as a gate on the serve smoke's
trace artifact.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from typing import Any, Dict, Iterable, List

from repro_torch.obs import trace as otrace


def _fmt_ms(us: float) -> str:
    return f"{us / 1e3:.3f}ms"


def top_spans(events: Iterable[Dict[str, Any]], k: int) -> List[str]:
    agg: Dict[tuple, List[float]] = collections.defaultdict(lambda: [0, 0.0])
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cell = agg[(ev.get("cat", "?"), ev["name"])]
        cell[0] += 1
        cell[1] += float(ev.get("dur", 0.0))
    ranked = sorted(agg.items(), key=lambda kv: kv[1][1], reverse=True)[:k]
    lines = [f"{'span':<36} {'cat':<10} {'count':>7} {'total':>12}"]
    for (cat, name), (count, total) in ranked:
        lines.append(f"{name:<36} {cat:<10} {count:>7} {_fmt_ms(total):>12}")
    return lines


def kernel_table(events: Iterable[Dict[str, Any]]) -> List[str]:
    """comp% divides by the span's ``peak`` (the profiler's rate for the
    op's input dtype), or by the bf16 tensor rate where a span has none."""
    from repro_torch.analysis.roofline import HBM_BW, PEAK_FLOPS_BF16
    agg: Dict[tuple, Dict[str, float]] = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") != "kernel":
            continue
        args = ev.get("args") or {}
        key = (ev["name"], args.get("contract"), args.get("sig"))
        cell = agg.setdefault(key, {"calls": 0, "total": 0.0,
                                    "best": float("inf"),
                                    "flops": float(args.get("flops") or 0.0),
                                    "peak": float(args.get("peak") or
                                                  PEAK_FLOPS_BF16),
                                    "bytes": float(args.get("bytes") or 0.0)})
        cell["calls"] += 1
        cell["total"] += float(ev.get("dur", 0.0))
        cell["best"] = min(cell["best"], float(ev.get("dur", 0.0)))
    if not agg:
        return []
    lines = [f"{'op':<24} {'contract':<24} {'calls':>6} {'best':>10} "
             f"{'comp%':>7} {'mem%':>7}"]
    for (name, contract, _sig), cell in sorted(
            agg.items(), key=lambda kv: kv[1]["total"], reverse=True):
        best_s = cell["best"] / 1e6
        cu = (cell["flops"] / best_s / cell["peak"] * 100) if best_s else 0
        mu = (cell["bytes"] / best_s / HBM_BW * 100) if best_s else 0
        lines.append(f"{name:<24} {str(contract):<24} {cell['calls']:>6.0f} "
                     f"{_fmt_ms(cell['best']):>10} {cu:>7.2f} {mu:>7.2f}")
    return lines


def request_timeline(events: Iterable[Dict[str, Any]]) -> List[str]:
    by_req: Dict[int, List[Dict[str, Any]]] = collections.defaultdict(list)
    for ev in events:
        tid = ev.get("tid", 0)
        if isinstance(tid, int) and tid >= otrace.REQ_TID_BASE:
            by_req[tid - otrace.REQ_TID_BASE].append(ev)
    lines: List[str] = []
    for rid in sorted(by_req):
        evs = sorted(by_req[rid], key=lambda e: float(e.get("ts", 0.0)))
        steps = []
        for ev in evs:
            stamp = _fmt_ms(float(ev.get("ts", 0.0)))
            if ev.get("ph") == "X":
                steps.append(f"{ev['name']}@{stamp}"
                             f"(+{_fmt_ms(float(ev.get('dur', 0.0)))})")
            else:
                steps.append(f"{ev['name']}@{stamp}")
        lines.append(f"req {rid}: " + " -> ".join(steps))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Summarize / validate an exported repro_torch.obs "
                    "trace.")
    ap.add_argument("trace", help="Chrome-trace JSON or JSONL event log")
    ap.add_argument("--check", action="store_true",
                    help="validate Chrome-trace schema; non-zero exit on "
                         "violations (CI gate)")
    ap.add_argument("--top", type=int, default=15,
                    help="spans to list in the top-k table")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON instead of text")
    args = ap.parse_args(argv)

    try:
        events = otrace.load(args.trace)
    except (OSError, json.JSONDecodeError) as e:
        print(f"error: cannot load {args.trace}: {e}", file=sys.stderr)
        return 2

    if args.check:
        errors = otrace.validate_chrome(events)
        if errors:
            for err in errors:
                print(f"SCHEMA: {err}", file=sys.stderr)
            print(f"{args.trace}: {len(errors)} schema violation(s)",
                  file=sys.stderr)
            return 1
        print(f"{args.trace}: OK ({len(events)} events)")
        return 0

    if args.json:
        payload = {
            "events": len(events),
            "spans": sum(1 for e in events if e.get("ph") == "X"),
            "instants": sum(1 for e in events if e.get("ph") in ("i", "I")),
            "requests": len({e["tid"] - otrace.REQ_TID_BASE for e in events
                             if isinstance(e.get("tid"), int)
                             and e["tid"] >= otrace.REQ_TID_BASE}),
        }
        print(json.dumps(payload, indent=2))
        return 0

    print(f"== {args.trace}: {len(events)} events ==")
    print()
    print("-- top spans by total time --")
    for line in top_spans(events, args.top):
        print(line)
    kt = kernel_table(events)
    if kt:
        print()
        print("-- kernel utilization (from profiled spans) --")
        for line in kt:
            print(line)
    tl = request_timeline(events)
    if tl:
        print()
        print("-- request timelines --")
        for line in tl[:50]:
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
