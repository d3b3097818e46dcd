"""Structured lint findings + the baseline-suppression file.

A :class:`Finding` is one diagnostic at one site.  Its ``fingerprint``
is stable across runs (code + site + discriminating key, *not* the
human-readable message), so a baseline file can suppress known
findings without pinning message wording or line numbers.

A baseline file is a JSON object
``{"suppress": [{"fingerprint": ..., "code": ..., "site": ...,
"reason": ...}, ...]}``; the extra fields are for humans reading the
diff, only the fingerprint is matched.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional, Sequence, Tuple

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic.

    code:     stable diagnostic id, e.g. ``GL201`` (docs/analysis.md).
    severity: ``error`` | ``warning`` | ``info``.
    site:     where — ``path/to/file.py::function`` for source findings,
              ``contract:<name>[<instantiation>]`` for contract findings,
              ``engine:<step>`` for jit-audit findings.
    message:  human-readable explanation (not part of the fingerprint).
    key:      extra fingerprint discriminator when one site can carry
              several findings under one code (e.g. the operand name).
    data:     structured detail for the JSON report.
    """

    code: str
    severity: str
    site: str
    message: str
    key: str = ""
    data: Tuple[Tuple[str, object], ...] = ()

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r}")

    @property
    def fingerprint(self) -> str:
        h = hashlib.sha256(
            f"{self.code}|{self.site}|{self.key}".encode()).hexdigest()
        return h[:16]

    def to_dict(self) -> Dict:
        return {
            "code": self.code,
            "severity": self.severity,
            "site": self.site,
            "message": self.message,
            "key": self.key,
            "fingerprint": self.fingerprint,
            "data": dict(self.data),
        }


def finding(code: str, severity: str, site: str, message: str, *,
            key: str = "", **data) -> Finding:
    return Finding(code=code, severity=severity, site=site, message=message,
                   key=key, data=tuple(sorted(data.items())))


def dedupe(findings: Sequence[Finding]) -> List[Finding]:
    """Collapse identical fingerprints (e.g. the same contract violation
    re-proven at every schedule in the lattice): keep the first, count
    the rest in ``data['occurrences']``."""
    by_fp: Dict[str, Finding] = {}
    counts: Dict[str, int] = {}
    for f in findings:
        fp = f.fingerprint
        counts[fp] = counts.get(fp, 0) + 1
        by_fp.setdefault(fp, f)
    out = []
    for fp, f in by_fp.items():
        if counts[fp] > 1:
            f = dataclasses.replace(
                f, data=f.data + (("occurrences", counts[fp]),))
        out.append(f)
    return out


def to_report(findings: Sequence[Finding], *,
              suppressed: Sequence[Finding] = ()) -> Dict:
    sev = {s: sum(1 for f in findings if f.severity == s)
           for s in SEVERITIES}
    return {
        "schema": 1,
        "counts": {**sev, "total": len(findings),
                   "suppressed": len(suppressed)},
        "findings": [f.to_dict() for f in findings],
        "suppressed": [f.to_dict() for f in suppressed],
    }


# -- baseline ---------------------------------------------------------------

def load_baseline(path) -> Dict[str, Dict]:
    """fingerprint -> suppression entry.  Missing file = empty baseline."""
    try:
        with open(path) as fh:
            raw = json.load(fh)
    except FileNotFoundError:
        return {}
    return {e["fingerprint"]: e for e in raw.get("suppress", [])}


def write_baseline(path, findings: Sequence[Finding]) -> None:
    entries = [{"fingerprint": f.fingerprint, "code": f.code,
                "site": f.site, "key": f.key,
                "reason": "baselined (pre-existing)"}
               for f in sorted(findings, key=lambda f: (f.code, f.site))]
    with open(path, "w") as fh:
        json.dump({"suppress": entries}, fh, indent=2)
        fh.write("\n")


def apply_baseline(findings: Sequence[Finding],
                   baseline: Optional[Dict[str, Dict]]
                   ) -> Tuple[List[Finding], List[Finding]]:
    """-> (new, suppressed)."""
    baseline = baseline or {}
    new, suppressed = [], []
    for f in findings:
        (suppressed if f.fingerprint in baseline else new).append(f)
    return new, suppressed
