"""Accumulator -> output epilogue (port of ``repro.kernels.epilogue``).

Rounding bitshift (round half to even), saturation to the output
bitwidth, and the activation units. This is the plain version; the CUDA
GEMM applies the same float epilogue in its store loop
(``csrc/gemm.cu``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.config import Activation


def _rounding_shift(x: torch.Tensor, shift: int) -> torch.Tensor:
    if shift <= 0:
        return x
    half = 1 << (shift - 1)
    frac = torch.bitwise_and(x, (1 << shift) - 1)
    shifted = torch.bitwise_right_shift(x, shift)      # arithmetic on int32
    bump = (frac > half) | ((frac == half) & (torch.bitwise_and(shifted, 1) == 1))
    return shifted + bump.to(x.dtype)


def activate(x: torch.Tensor, activation: Activation) -> torch.Tensor:
    if activation is Activation.NONE:
        return x
    if activation is Activation.RELU:
        return torch.clamp_min(x, 0)
    if activation is Activation.RELU6:
        return torch.clamp(x, 0, 6)
    if activation is Activation.GELU:
        # jax.nn.gelu defaults to the tanh approximation.
        return F.gelu(x, approximate="tanh")
    if activation is Activation.SILU:
        return x * torch.sigmoid(x)
    raise ValueError(activation)


def apply(acc: torch.Tensor, *, shift: int, activation: Activation,
          out_dtype: torch.dtype) -> torch.Tensor:
    """acc (int32 or fp32) -> activation(round_shift(acc)) saturated to out."""
    if not acc.is_floating_point():
        y = _rounding_shift(acc.to(torch.int32), shift)
        y = activate(y, activation)
        if not out_dtype.is_floating_point and out_dtype != torch.int32:
            info = torch.iinfo(out_dtype)
            y = torch.clamp(y, info.min, info.max)
        return y.to(out_dtype)
    y = activate(acc, activation)
    if shift:
        y = y / (2.0 ** shift)
    return y.to(out_dtype)
