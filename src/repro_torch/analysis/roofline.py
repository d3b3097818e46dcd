"""The card's peak rates, the roofline the profiler divides by (the peak
half of ``repro.analysis.roofline``; its HLO and collective terms read
XLA's compiled modules and have no counterpart here).

Published dense rates of one NVIDIA H100 SXM (80 GB HBM3) at its full
power limit of 700 W, the rates PERF.md's bounds use. A card set below
700 W reaches less; its limit is printed beside every measurement
(``nvidia-smi --query-gpu=name,power.limit``).

Hopper has no int16 MMA. An int16 product runs exactly as four int8
products of byte planes (``kernels/csrc/igemm.cuh``), so the int16 peak
is the int8 tensor rate over four.
"""

from __future__ import annotations

import torch

CARD = "NVIDIA H100 SXM 80GB HBM3, 700 W"

HBM_BW = 3.35e12                  # B/s
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, tensor cores
PEAK_FLOPS_FP16 = 989e12
PEAK_FLOPS_FP32 = 67e12           # CUDA cores (no TF32)
PEAK_OPS_INT8 = 1979e12           # OP/s, tensor cores
PEAK_OPS_INT16 = PEAK_OPS_INT8 / 4

_PEAKS = {torch.bfloat16: PEAK_FLOPS_BF16, torch.float16: PEAK_FLOPS_FP16,
          torch.float32: PEAK_FLOPS_FP32, torch.int8: PEAK_OPS_INT8,
          torch.int16: PEAK_OPS_INT16}


def peak_ops(dtype: torch.dtype) -> float:
    """The card's peak rate for products of ``dtype`` inputs."""
    try:
        return _PEAKS[dtype]
    except KeyError:
        raise ValueError(f"no peak rate for {dtype} inputs") from None
