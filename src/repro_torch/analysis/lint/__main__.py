"""``python -m repro_torch.analysis.lint`` — the lint gate.

Runs the static suite (the launch contracts over the tuner's schedule
space at the driver's probes, and the AST rules over the kernel
wrappers), subtracts the baseline, prints the findings, and exits
non-zero on any error or warning that no baseline suppresses. The plans
that need the card (GL303, info) are counted, never a failure.

  python -m repro_torch.analysis.lint                  # human output
  python -m repro_torch.analysis.lint --format json    # the report
  python -m repro_torch.analysis.lint --baseline F     # read F
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.lint import apply_baseline, load_baseline
from repro_torch.analysis.lint.driver import lint_repo_timed
from repro_torch.analysis.lint.findings import to_report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.lint",
        description="launch-contract and source lint of the H100 kernels")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--select", type=str, default=None, metavar="CODES",
                    help="comma-separated code prefixes (e.g. GL201,GL3)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="suppression file to read (default: none; "
                         "policy: an empty baseline)")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON report to this path")
    args = ap.parse_args(argv)

    findings, timings, counts = lint_repo_timed()
    if args.select:
        sel = tuple(c.strip() for c in args.select.split(",") if c.strip())
        findings = [f for f in findings
                    if any(f.code.startswith(c) for c in sel)]
    baseline = load_baseline(args.baseline) if args.baseline else {}
    new, suppressed = apply_baseline(findings, baseline)
    failing = [f for f in new if f.severity != "info"]

    report = to_report(new, suppressed=suppressed)
    report["timings_s"] = {k: round(v, 4) for k, v in timings.items()}
    report["plans"] = counts
    if args.out:
        args.out.write_text(json.dumps(report, indent=2, default=str) + "\n")
    if args.format == "json":
        print(json.dumps(report, indent=2, default=str))
    else:
        for f in new:
            print(f"{f.severity.upper():7s} {f.code} {f.site}: {f.message}")
        c = report["counts"]
        print(f"{counts['plans']} plans: {counts['admitted']} admitted, "
              f"{counts['refused']} refused, {counts['needs_card']} need "
              f"the card")
        print(f"{c['total']} finding(s) ({c['error']} error, "
              f"{c['warning']} warning, {c['info']} info; "
              f"{c['suppressed']} baselined)")
    return 1 if failing else 0


if __name__ == "__main__":
    sys.exit(main())
