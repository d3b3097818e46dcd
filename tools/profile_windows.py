"""How often a ``torch.profiler`` window of ``chip_smoke.profile_call``
comes up short, with and without the idle gap at its edges, on a card.

Over phase 6b's four ResNet-50 datapaths (fp32, bf16, fp16, int16), each
route (host im2col + OS GEMM, host im2col + WS GEMM, the fused conv) and
each stage and the whole stream, takes one window with
``PROFILE_PAD_S = 0`` and one with the shipped gap, in alternating order,
round after round until ``--seconds`` have passed, and prints the count of
windows taken and of short ones (``window_short``: fewer launches recorded
than the launch counters counted) for each gap:

  python3 tools/profile_windows.py                 # about 4 minutes
  python3 tools/profile_windows.py --seconds 60 --json-out build/pw.json

Needs a card and ``nvcc`` (the kernels build at first use).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=240.0)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.core.generator import elaborate
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        sys.exit("no card: this tool times the profiler on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    shipped = cs.PROFILE_PAD_S
    cs.PROFILE_RETAKES = 0               # a short window ends the call

    def short(fn) -> int:
        try:
            cs.profile_call(torch, "window", fn, quiet=True)
            return 0
        except SystemExit:
            return 1

    streams = []
    for name, cfg in cs.datapath_instances():
        shift = 1 if cfg.input_torch.is_floating_point else 10
        layers = cs.resnet50_layers(torch, seed=1, dtype=cfg.input_torch)
        stages = {"whole": layers}
        for layer in layers:
            stages.setdefault(cs.stage_of(layer), []).append(layer)
        streams.append((elaborate(cfg), shift, stages))
    tally = {str(p): {"windows": 0, "short": 0} for p in (0.0, shipped)}
    t0, rounds = time.perf_counter(), 0
    while time.perf_counter() - t0 < args.seconds:
        pads = (0.0, shipped) if rounds % 2 == 0 else (shipped, 0.0)
        for inst, shift, stages in streams:
            for route in cs.ENGINE_ROUTES:
                for part in stages.values():
                    for pad in pads:
                        cs.PROFILE_PAD_S = pad
                        t = tally[str(pad)]
                        t["windows"] += 1
                        t["short"] += short(lambda: cs.run_stream(
                            inst, part, shift, route))
        rounds += 1
    out = {"rounds": rounds, "seconds": time.perf_counter() - t0,
           "by_pad_s": tally}
    print(json.dumps(out), flush=True)
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
