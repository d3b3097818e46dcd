"""Quickstart: elaborate a Gemmini instance and run quantized GEMMs and a
conv on it (port of ``examples/quickstart.py``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Walks the paper's section 2 flow end to end: configure the generator,
elaborate an accelerator instance, inspect the generated tiling "header
file", run a quantized GEMM with fused bias + ReLU + rounding-shift rescale
on both dataflows, and a conv by host im2col and by the fused kernel. Each
result must equal the plain oracle bit for bit; the program exits non-zero
on a mismatch. It runs on the card (the CUDA kernels) unless ``--device
cpu`` asks for the plain path.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.core.config import Activation, Dataflow, GemminiConfig
from repro_torch.core.generator import elaborate
from repro_torch.core.quantize import calibrate_symmetric, quantize
from repro_torch.kernels import ref

QUICKSTART_CFG = GemminiConfig(
    dataflow=Dataflow.BOTH,       # design point 3: runtime-selectable
    dim=128,                      # systolic tile granularity
    input_dtype="int8", acc_dtype="int32", output_dtype="int8",
    scratchpad_bytes=8 << 20, accumulator_bytes=4 << 20,
)


def quickstart_operands(device, seed: int = 0):
    """The quickstart's quantized (1000 x 2048) @ (2048 x 512) GEMM
    operands and int32 bias, from numpy's generator (as the JAX example
    draws them)."""
    rng = np.random.default_rng(seed)
    a_f = torch.from_numpy(rng.standard_normal((1000, 2048)).astype(np.float32))
    b_f = torch.from_numpy(rng.standard_normal((2048, 512)).astype(np.float32))
    a = quantize(a_f, calibrate_symmetric(a_f))
    b = quantize(b_f, calibrate_symmetric(b_f))
    bias = torch.from_numpy(rng.integers(-1000, 1000, (1, 512))
                            ).to(torch.int32)
    x = torch.from_numpy(rng.integers(-64, 64, (1, 14, 14, 16))).to(torch.int8)
    w = torch.from_numpy(rng.integers(-32, 32, (3, 3, 16, 32))).to(torch.int8)
    return [t.to(device) for t in (a, b, bias, x, w)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass --device cpu for "
                           "the plain path")

    # ---- 1. configure + elaborate (the paper's Chisel generator run) -----
    engine = elaborate(QUICKSTART_CFG)
    print("elaborated:", QUICKSTART_CFG.describe())

    # ---- 2. the generated tiling header (paper section 2.3) --------------
    hdr = engine.header(1000, 512, 2048)
    print("tiling header for (1000x512x2048):",
          {k: hdr[k] for k in ("DIM", "TILE_M", "TILE_N", "TILE_K", "GRID")})

    # ---- 3. quantized GEMM on both dataflows ------------------------------
    a, b, bias, x, w = quickstart_operands(args.device)
    ok = True
    y_ref = ref.gemm_ref(a, b, bias, acc_dtype=torch.int32,
                         out_dtype=torch.int8, shift=7,
                         activation=Activation.RELU)
    for df in (Dataflow.OS, Dataflow.WS):
        y = engine.gemm(a, b, bias, dataflow=df, shift=7,
                        activation=Activation.RELU)
        exact = bool(torch.equal(y, y_ref))
        print(f"{df.value}: out {tuple(y.shape)} {y.dtype} on {y.device}, "
              f"bit-exact vs oracle: {exact}")
        ok &= exact

    # ---- 4. a conv on the engine (host-im2col and fused paths) ------------
    kw = dict(stride=1, padding=1, shift=6, activation=Activation.RELU)
    y_host = engine.conv2d(x, w, **kw)
    y_fused = engine.conv2d(x, w, fused=True, **kw)
    y_cref = ref.conv2d_ref(x, w, None, acc_dtype=torch.int32,
                            out_dtype=torch.int8, **kw)
    exact = bool(torch.equal(y_host, y_fused)) and \
        bool(torch.equal(y_fused, y_cref))
    print(f"conv2d host-im2col == fused-im2col kernel == oracle: {exact}")
    ok &= exact
    print("quickstart OK" if ok else "quickstart FAILED: a result differs "
          "from the oracle")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
