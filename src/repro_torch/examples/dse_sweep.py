"""DSE example: explore a custom design space for your own workload (port
of ``examples/dse_sweep.py``).

  PYTHONPATH=src python -m repro_torch.examples.dse_sweep

The paper's core loop: define a workload (here: a transformer FFN inference
stream), sweep generator parameters one at a time from the baseline, and
pick the design point by performance-per-energy-proxy -- the same process
section 3 runs over Table 1. It runs the port's analytical model
(``core/dse.py`` over ``core/isa.py``'s timing); no device is touched.
"""

from __future__ import annotations

import sys

from repro_torch.core import dse, isa
from repro_torch.core.config import Dataflow, GemminiConfig


def ffn_workload(d_model=2048, d_ff=8192, batch=64, layers=24):
    gemms = []
    for _ in range(layers):
        gemms.append(dse.GemmShape(m=batch, n=d_ff, k=d_model))   # up proj
        gemms.append(dse.GemmShape(m=batch, n=d_model, k=d_ff))   # down proj
    return dse.Workload("ffn_24L", tuple(gemms))


def main(argv=None) -> int:
    wl = ffn_workload()
    base = GemminiConfig(dim=16, scratchpad_bytes=64 << 10,
                         accumulator_bytes=16 << 10)
    sweeps = {
        "baseline": base,
        "ws": base.replace(dataflow=Dataflow.WS),
        "dim32": base.replace(dim=32, accumulator_bytes=64 << 10),
        "spad256k": base.replace(scratchpad_bytes=256 << 10,
                                 accumulator_bytes=64 << 10),
        "fp32_io": base.replace(input_dtype="fp32", acc_dtype="fp32",
                                output_dtype="fp32"),
    }
    print("point,cycles,bottleneck,hbm_mb,perf_per_energy(norm)")
    results = {}
    for name, cfg in sweeps.items():
        df = Dataflow.WS if cfg.dataflow is Dataflow.WS else None
        r = dse.evaluate(cfg, wl, isa.ROCKET, dataflow=df)
        results[name] = r
    base_ppe = 1.0 / (results["baseline"]["total_cycles"] *
                      results["baseline"]["hbm_bytes"])
    best, best_ppe = None, -1.0
    for name, r in results.items():
        ppe = 1.0 / (r["total_cycles"] * r["hbm_bytes"]) / base_ppe
        print(f"{name},{r['total_cycles']:.0f},{r['bottleneck']},"
              f"{r['hbm_bytes']/1e6:.1f},{ppe:.2f}")
        if ppe > best_ppe:
            best, best_ppe = name, ppe
    print(f"\nselected design point: {best} "
          f"({best_ppe:.2f}x baseline perf/energy)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
