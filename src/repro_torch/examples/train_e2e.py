"""End-to-end training example (port of ``examples/train_e2e.py``): a
~100M-parameter model for a few hundred steps, or ``--tiny`` for the
smoke config.

  PYTHONPATH=src python -m repro_torch.examples.train_e2e             # card
  PYTHONPATH=src python -m repro_torch.examples.train_e2e --tiny --device cpu

Drives the real launcher (``repro_torch.launch.train``): the synthetic
Markov data pipeline, AdamW, checkpoints every 50 steps, straggler
detection and the restart loop. Exits 1 if the loss did not fall.
"""

import argparse
import dataclasses
import os
import sys
import tempfile

from repro_torch import configs
from repro_torch.launch import train as train_cli


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (plain path)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_e2e_ckpt"))
    args = ap.parse_args(argv)

    if args.tiny:
        argv = ["--arch", "gemma3-1b", "--smoke", "--steps",
                str(args.steps or 30), "--batch", "8", "--seq", "128"]
        ckpt = args.ckpt_dir + "_tiny"
    else:
        # ~100M-param dense config (gemma3-1b family, reduced width),
        # registered on the fly so the launcher can select it.
        base = configs.get("gemma3-1b")
        cfg100m = dataclasses.replace(
            base, name="gemma-100m", n_layers=16, d_model=512,
            n_heads=8, n_kv_heads=4, head_dim=64, d_ff=2560,
            vocab=32768, local_window=256)
        configs._REGISTRY["gemma-100m"] = lambda: cfg100m
        print(f"[e2e] gemma-100m params: {cfg100m.param_count()/1e6:.1f}M")
        argv = ["--arch", "gemma-100m", "--steps",
                str(args.steps or 200), "--batch", "8", "--seq", "256",
                "--lr", "1e-3"]
        ckpt = args.ckpt_dir
    argv += ["--ckpt-dir", ckpt, "--ckpt-every", "50", "--log-every", "10",
             "--device", args.device]
    result = train_cli.main(argv)
    print(f"[e2e] loss {result.losses[0]:.3f} -> {result.losses[-1]:.3f} "
          f"over {result.steps_done} steps")
    if not result.losses[-1] < result.losses[0]:
        print("[e2e] FAIL: loss did not decrease")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
