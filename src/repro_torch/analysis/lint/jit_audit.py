"""Trace-time audit of the serving engine's step buckets (GL601).

The JAX engine compiles one bucket per distinct step-argument shape; the
port has no jit cache, but its engine records the same bucket keys at
dispatch (``ServingEngine.observed_buckets``): they are the shapes the
tuner warms and the graphs a captured-graph path would hold. Buckets are
bounded by construction (prompt lengths quantize to ``prefill_pad``,
chunk lengths to the scheduler's spans, a chunk's ``kv_pages`` to
``max_pages_per_seq``), so a census from the engine's geometry is a
ceiling: a step past it leaks an unquantized shape.

===== ==================================================================
GL601 the engine dispatched more distinct bucket keys of a step than the
      static census allows
GL602 no counterpart while the port donates no buffer (ROADMAP B'1: a
      captured graph's static buffers bring the hazard back)
===== ==================================================================
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.analysis.lint.findings import Finding, finding


def expected_bucket_census(engine) -> Dict[str, int]:
    """Static per-step bucket ceiling from the engine geometry (as the JAX
    package's ``jit_audit.expected_bucket_census``)."""
    n_prompt_buckets = max(1, engine.max_context // engine.prefill_pad)
    census = {
        "prefill": n_prompt_buckets,
        "prefill_nl": n_prompt_buckets,
        "decode": 1,
    }
    chunk = getattr(engine, "prefill_chunk", None)
    if chunk:
        n_chunk_lens = max(1, -(-engine.max_context // chunk))
        kv_page_values = engine.max_pages_per_seq + 1
        census["chunk"] = n_chunk_lens * kv_page_values
        census["chunk_nl"] = n_chunk_lens * kv_page_values
    else:
        census["chunk"] = census["chunk_nl"] = 0
    return census


def audit_engine(engine) -> List[Finding]:
    """GL601 over a live ``ServingEngine``'s dispatched bucket keys."""
    out: List[Finding] = []
    census = expected_bucket_census(engine)
    for which, seen in getattr(engine, "observed_buckets", {}).items():
        expect = census.get(which)
        if expect is not None and len(seen) > expect:
            out.append(finding(
                "GL601", "error", f"engine:{which}",
                f"engine dispatched {len(seen)} distinct {which!r} bucket "
                f"keys; the static census caps it at {expect} (prefill_pad="
                f"{engine.prefill_pad}, prefill_chunk="
                f"{getattr(engine, 'prefill_chunk', None)}, "
                f"max_pages_per_seq={engine.max_pages_per_seq}): "
                f"{sorted(seen)[:8]}...",
                key="dispatched", observed=len(seen), expected=expect))
    return out
