"""Plan-feasibility predicates for the tuner (``tune/tuner.py``'s filter).

Each predicate builds the candidate's launch contract
(``kernels/contracts.py``) and asks the lint whether it admits it: no
coverage gap, no race, the split reduction's workspace, shared memory
and occupancy within the SM, the kernel's own limits. So "the lint
admits the plan" and "the tuner may measure it" are one fact, and the
card's C plan function is held to the same verdict (``card.py``).

Every predicate is total: a candidate whose contract cannot even be
built (garbage geometry) reports infeasible rather than raising.
"""

from __future__ import annotations

from repro_torch.analysis.lint.checks import admits
from repro_torch.kernels import contracts as kc


def _safe(build) -> bool:
    try:
        return admits(build())
    except Exception:
        return False


def gemm_plan_feasible(dtype, m: int, n: int, k: int, sched, *,
                       b_trans: bool = False) -> bool:
    if kc._name(dtype) == "int8":
        return _safe(lambda: kc.gemm_s8_contract(
            m, n, k, b_trans=b_trans, tile=sched["tile"],
            splits=sched["splits"]))
    return _safe(lambda: kc.gemm_contract(
        m, n, k, dtype=dtype, b_trans=b_trans, tile=sched["tile"],
        splits=sched["splits"]))


def conv_plan_feasible(dtype, m: int, n: int, k: int, sched) -> bool:
    """The conv's plan for its implicit GEMM (M, N, K): a 1x1 conv of M
    pixels (the strips, which only add shared memory, are not in it)."""
    return _safe(lambda: kc.conv_contract(
        1, m, 1, k, n, 1, 1, dtype=dtype, tile=sched["tile"],
        splits=sched["splits"]))


def attn_schedule_feasible(sched, *, b: int, tq: int, tk: int, h: int,
                           kvh: int, d: int, causal: bool = True,
                           window=None, dtype="bfloat16") -> bool:
    return _safe(lambda: kc.flash_contract(
        b, tq, tk, h, kvh, d, causal=causal, window=window, dtype=dtype,
        cluster=sched["cluster"], stages=sched["stages"]))


def paged_schedule_feasible(sched, *, b: int, h: int, kvh: int, d: int,
                            max_context: int, window=None,
                            dtype="bfloat16") -> bool:
    def build():
        page = sched.effective(max_context).page_size
        mp = -(-max_context // page)
        return kc.paged_decode_contract(
            max(b, 1), mp, page, h, kvh, d, n_pages=max(b, 1) * mp + 1,
            window=window, dtype=dtype, split_keys=sched.split_keys)
    return _safe(build)
