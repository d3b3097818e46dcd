"""``python -m repro_torch.analysis.mc`` -- the control-plane model-checking
CI gate.

Explores every shipped bounded configuration (or ``--config`` a subset),
reports violations as GL8xx findings through the lint findings/baseline
machinery, and exits non-zero on any non-baselined finding.

  python -m repro_torch.analysis.mc                          # all configs, text
  python -m repro_torch.analysis.mc --config core-3s12p      # one config
  python -m repro_torch.analysis.mc --format json --out MC.json
  python -m repro_torch.analysis.mc --max-states 50000       # CI budget cap
  python -m repro_torch.analysis.mc --replay "mc:v1;config=...;trace=a>b"
  python -m repro_torch.analysis.mc --export-dir /tmp/ce     # write artifacts

  python -m repro_torch.analysis.mc --baseline F            # read F

Baseline policy: ``--baseline`` only reads a suppression file, and the
policy is an empty one -- a counterexample is a bug to fix in-tree plus a
minimized-trace pytest regression, never a suppression.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.lint.findings import (apply_baseline, finding,
                                                load_baseline, to_report)
from repro_torch.analysis.mc import explore as ex
from repro_torch.analysis.mc.harness import ALL_CONFIGS, CONFIGS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.mc",
        description="control-plane bounded model checker "
                    "(docs/analysis.md#model-checker)")
    ap.add_argument("--config", action="append", default=None,
                    metavar="NAME",
                    help="configuration(s) to explore (repeatable; "
                         "default: all shipped configs)")
    ap.add_argument("--list", action="store_true",
                    help="list configurations and exit")
    ap.add_argument("--max-states", type=int, default=200_000,
                    help="state budget per configuration (cap hit => "
                         "run marked incomplete, graph checks skipped)")
    ap.add_argument("--max-depth", type=int, default=None,
                    help="interleaving depth bound (default: none)")
    ap.add_argument("--no-liveness", action="store_true",
                    help="skip the GL806 liveness graph check")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON report to this path")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="suppression file to read (default: none; "
                         "policy: an empty baseline)")
    ap.add_argument("--replay", type=str, default=None, metavar="SPEC",
                    help="replay one counterexample spec "
                         "(mc:v1;config=...;trace=a>b>c) and exit")
    ap.add_argument("--export-dir", type=Path, default=None,
                    help="write each violation's pytest regression + "
                         "fault-script artifacts here")
    args = ap.parse_args(argv)

    if args.list:
        for name, cfg in ALL_CONFIGS.items():
            tag = " [selftest]" if cfg.sabotage else ""
            print(f"{name}: {cfg.slots} slots, {cfg.pages} pages, "
                  f"{len(cfg.prompts)} requests{tag}")
        return 0

    if args.replay:
        cfg, trace = ex.parse_spec(args.replay)
        r = ex.replay(cfg, trace)
        if not r.valid:
            print(f"trace invalid: action {r.executed} not enabled")
            return 2
        if r.violation is None:
            print(f"clean replay: {r.executed} action(s), final state "
                  f"{r.state_hash}")
            return 0
        v = r.violation
        print(f"{v.code} reproduced after {r.executed} action(s): "
              f"{v.message}\nviolating state hash: {v.state_hash}")
        return 1

    names = args.config or list(CONFIGS)
    unknown = [n for n in names if n not in ALL_CONFIGS]
    if unknown:
        ap.error(f"unknown config(s) {unknown}; have {sorted(ALL_CONFIGS)}")

    results, findings = [], []
    for name in names:
        cfg = ALL_CONFIGS[name]
        res = ex.explore(cfg, max_states=args.max_states,
                         max_depth=args.max_depth,
                         check_liveness=not args.no_liveness)
        res.violations = [ex.minimize(cfg, v) for v in res.violations]
        results.append(res)
        for v in res.violations:
            findings.append(finding(
                v.code, "error", site=f"mc:{v.config}", message=v.message,
                key="|".join(v.trace), trace=list(v.trace),
                state_hash=v.state_hash,
                spec=ex.format_spec(v.config, v.trace)))
        if args.export_dir and res.violations:
            args.export_dir.mkdir(parents=True, exist_ok=True)
            for i, v in enumerate(res.violations):
                stem = f"{v.code.lower()}_{v.config}_{i}"
                (args.export_dir / f"test_{stem}.py").write_text(
                    ex.export_pytest(v))
                (args.export_dir / f"{stem}.sh").write_text(
                    ex.export_fault_script(v))

    baseline = load_baseline(args.baseline) if args.baseline else {}
    new, suppressed = apply_baseline(findings, baseline)

    report = to_report(new, suppressed=suppressed)
    report["runs"] = [r.to_dict() for r in results]
    if args.out:
        args.out.write_text(json.dumps(report, indent=2, default=str)
                            + "\n")
    if args.format == "json":
        print(json.dumps(report, indent=2, default=str))
    else:
        for r in results:
            status = "exhaustive" if r.complete else "CAPPED"
            print(f"{r.config}: {r.states} states, {r.transitions} "
                  f"transitions, {r.memo_hits} memo hits, "
                  f"{r.terminal_states} drained, {status}, "
                  f"{len(r.violations)} violation(s), {r.wall_s:.1f}s")
        for f in new:
            print(f"ERROR   {f.code} {f.site}: {f.message}")
            print(f"        replay: {dict(f.data).get('spec')}")
        c = report["counts"]
        print(f"{c['total']} finding(s) ({c['suppressed']} baselined)")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
