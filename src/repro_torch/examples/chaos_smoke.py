"""Chaos smoke: the self-healing serving invariants, exit-code gated (port
of ``examples/chaos_smoke.py``).

  PYTHONPATH=src python -m repro_torch.examples.chaos_smoke [--device cpu]

Runs the same trace twice through the continuous-batching engine -- once
fault-free, once under a seeded adversarial fault plan (NaN poison at
decode + transient prefill failures + straggler delays + arena
exhaustion) with NaN guards and retries on -- and gates on the robustness
contract:

  1. no request is silently lost (every one reaches a terminal status),
  2. every completing request's greedy tokens are BIT-IDENTICAL to the
     fault-free run (degradation changes latency, never numerics),
  3. the injected faults actually fired and the recovery machinery shows
     up in telemetry (fallbacks > 0, retries > 0, injected counts match
     the plan's caps).

The process exits 1 if any invariant fails. The JAX script's
``backend="interpret"`` has no counterpart here: the device decides, the
hand-written kernels on the card (the default, ``--device cuda``; no card
raises) or their plain versions on the CPU. A NaN-guard trip re-runs the
step on the same kernels with the op hooks off (the JAX engine falls back
to its XLA twin), counted in ``fallbacks`` as there.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch import configs
from repro_torch.serving import ServingEngine

FAULT_PLAN = ("seed=3;"
              "nan@decode:p=1,max=2;"
              "transient@prefill:max=1;"
              "straggler@step:delay=0.001,start=6,max=2;"
              "arena:pages=2,start=3,max=3")
EXPECTED_INJECTED = {"nan@decode": 2, "transient@prefill": 1,
                     "straggler@step": 2, "arena@arena": 3}
PROMPT_LENS = [5, 11, 19]
GEN_LENS = [6, 6, 6]


def run_trace(model_cfg, faults, device):
    # assert_invariants: the allocator's ownership oracle runs at every
    # step boundary -- the chaos run doubles as a lifecycle audit.
    eng = ServingEngine(model_cfg, max_slots=2, max_context=32, page_size=8,
                        n_pages=8, temperature=0.0, seed=0,
                        prefill_chunk=8, faults=faults,
                        assert_invariants=True, device=device)
    rng = np.random.default_rng(0)
    for plen, glen in zip(PROMPT_LENS, GEN_LENS):
        eng.submit(rng.integers(0, model_cfg.vocab, (plen,),
                                ).astype(np.int32), glen)
    return eng.run()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass --device cpu for "
                           "the plain path")
    model_cfg = configs.get_smoke("gemma2-2b")
    ok = True

    print("--- reference run (faults off) ---")
    ref = run_trace(model_cfg, None, args.device)
    rs = ref["summary"]
    print(f"  {int(rs['requests'])} reqs, {int(rs['new_tokens'])} tokens, "
          f"retries={int(rs['retries'])} fallbacks={int(rs['fallbacks'])}")
    if rs["retries"] or rs["fallbacks"] or rs["injected_faults"]:
        print("  FAIL: fault-free run shows nonzero robustness counters",
              file=sys.stderr)
        ok = False

    print(f"--- chaos run: {FAULT_PLAN} ---")
    rep = run_trace(model_cfg, FAULT_PLAN, args.device)
    s = rep["summary"]
    print(f"  retries={int(s['retries'])} fallbacks={int(s['fallbacks'])} "
          f"injected={int(s['injected_faults'])} shed={int(s['shed'])} "
          f"faults={rep['faults']}")

    # 1. no silent loss: every request terminal, none dropped
    if len(rep["requests"]) != len(PROMPT_LENS):
        print(f"  FAIL: {len(rep['requests'])} request reports for "
              f"{len(PROMPT_LENS)} submissions", file=sys.stderr)
        ok = False
    for r in rep["requests"]:
        if r["status"] not in ("finished", "shed"):
            print(f"  FAIL: rid {r['rid']} non-terminal status "
                  f"{r['status']!r}", file=sys.stderr)
            ok = False

    # 2. bit-exact degradation: chaos tokens == fault-free tokens
    for rr, fr in zip(ref["requests"], rep["requests"]):
        want = np.asarray(rr["tokens"], np.int32)
        got = np.asarray(fr["tokens"], np.int32)
        if fr["status"] == "shed":       # prefix of the reference stream
            want = want[:got.shape[0]]
        if got.shape != want.shape or not np.array_equal(got, want):
            print(f"  FAIL rid={fr['rid']}: chaos tokens {got.ravel()} != "
                  f"reference {want.ravel()}", file=sys.stderr)
            ok = False
        else:
            print(f"  rid {fr['rid']}: {got.shape[0]} tokens bit-identical "
                  f"to the fault-free run ({fr['status']})")

    # 3. the machinery fired and is visible in telemetry
    if not (s["fallbacks"] > 0 and s["retries"] > 0):
        print("  FAIL: expected nonzero fallbacks and retries under the "
              "chaos plan", file=sys.stderr)
        ok = False
    if rep["faults"] != EXPECTED_INJECTED:
        print(f"  FAIL: injected-fault report {rep['faults']} != "
              f"{EXPECTED_INJECTED}", file=sys.stderr)
        ok = False

    if not ok:
        print("\nchaos_smoke FAILED", file=sys.stderr)
        return 1
    print("\nchaos_smoke OK: all streams exact, recovery visible in "
          "telemetry")
    return 0


if __name__ == "__main__":
    sys.exit(main())
