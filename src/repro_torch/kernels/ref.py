"""Plain PyTorch oracles (port of ``repro.kernels.ref``).

``gemm_ref`` is the plain version of the engine GEMM: the CUDA kernel in
``kernels/gemm.py`` is held against it on the card, and it is what a CPU
tensor runs. The conv, attention and SSD oracles follow with their kernels
in later slices.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.config import Activation
from repro_torch.kernels import epilogue as epi


def _float_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 A @ B in IEEE fp32: TF32 is switched off for the call, so an
    fp32 engine config stays exact on the card as on the CPU."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a.to(torch.float32) @ b.to(torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def gemm_ref(a: torch.Tensor, b: torch.Tensor, d: Optional[torch.Tensor],
             *, acc_dtype: torch.dtype, out_dtype: torch.dtype,
             shift: int = 0,
             activation: Activation = Activation.NONE) -> torch.Tensor:
    """C = epilogue(A @ B + D) with accumulation in acc_dtype."""
    if acc_dtype.is_floating_point:
        acc = _float_matmul(a, b).to(acc_dtype)
    else:
        # Integer datapath: int64 products summed exactly, then wrapped to
        # the accumulator width (as an int32 MAC array would).
        acc = (a.to(torch.int64) @ b.to(torch.int64)).to(acc_dtype)
    if d is not None:
        acc = acc + d.to(acc_dtype)
    return epi.apply(acc, shift=shift, activation=activation,
                     out_dtype=out_dtype)
