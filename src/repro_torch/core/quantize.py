"""Quantization numerics of the Gemmini datapath (port of
``repro.core.quantize``; paper sections 2.1-2.2).

Gemmini accumulates int8 x int8 products into 32-bit accumulators and
scales the result back down with a rounding, saturating bitshift. These are
those numerics on torch tensors, equal bit for bit to the JAX package's,
plus the host-side helpers the software library needs: per-tensor scale
calibration, fake-quant with a straight-through gradient, and the
multiplier + shift decomposition of a real-valued rescale
(gemmlowp-style fixed-point multiply).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rounding_shift(x: torch.Tensor, shift) -> torch.Tensor:
    """Round-half-to-even right shift of an integer tensor (Gemmini's unit).

    round(x / 2**shift) with ties to even, in integer ops only; ``shift``
    is a python int or an int tensor scalar, and shift <= 0 is the
    identity. ``torch.bitwise_right_shift`` is arithmetic on int32."""
    x = x.to(torch.int32)
    shift = torch.as_tensor(shift, dtype=torch.int32, device=x.device)
    s = torch.clamp_min(shift, 1)       # the shifted branch, masked below
    one = torch.ones((), dtype=torch.int32, device=x.device)
    half = torch.bitwise_left_shift(one, s - 1)
    frac = torch.bitwise_and(x, torch.bitwise_left_shift(one, s) - 1)
    shifted = torch.bitwise_right_shift(x, s)
    bump = (frac > half) | ((frac == half) &
                            (torch.bitwise_and(shifted, 1) == 1))
    return torch.where(shift > 0, shifted + bump.to(torch.int32), x)


def saturate(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Saturating cast to a narrower integer dtype."""
    info = torch.iinfo(dtype)
    return torch.clamp(x, info.min, info.max).to(dtype)


def scale_and_saturate(acc: torch.Tensor, shift,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """The accumulator-output path: rounding shift then saturating cast."""
    return saturate(rounding_shift(acc, shift), out_dtype)


def quantize_multiplier(scale: float) -> Tuple[int, int]:
    """Decompose a real rescale into (int32 multiplier, right shift):
    scale ~= multiplier * 2**-shift with multiplier in [2**30, 2**31)."""
    if scale <= 0:
        raise ValueError("scale must be positive")
    mant, exp = np.frexp(scale)            # scale = mant * 2**exp, mant in [0.5,1)
    q = int(np.round(mant * (1 << 31)))
    if q == (1 << 31):
        q //= 2
        exp += 1
    shift = 31 - exp
    if shift < 0:
        raise ValueError(f"scale {scale} too large for fixed-point path")
    return q, int(shift)


def fixed_point_rescale(acc, multiplier: int, shift: int) -> np.ndarray:
    """int32 acc * (multiplier * 2**-shift) on integer arithmetic
    (SaturatingRoundingDoublingHighMul + rounding shift, Jacob et al.).

    Host-side, in numpy int64 as in the JAX package: the device datapath
    uses the power-of-two rounding bitshift, and non-power-of-two rescales
    are resolved to (multiplier, shift) on the host at calibration time.
    ``acc`` may be a tensor or an array."""
    if isinstance(acc, torch.Tensor):
        acc = acc.cpu().numpy()
    acc64 = np.asarray(acc, np.int64)
    prod = acc64 * np.int64(multiplier)
    nudge = np.where(prod >= 0, np.int64(1) << 30,
                     np.int64(1) - (np.int64(1) << 30))
    q64 = prod + nudge
    # gemmlowp divides by 2^31 truncating toward zero (not a floor shift)
    high = np.sign(q64) * (np.abs(q64) >> 31)     # fits in int32
    rs = shift - 31
    if rs <= 0:                                   # scale >= 1: left shift
        return (high << (-rs)).astype(np.int32)
    half = np.int64(1) << (rs - 1)
    frac = high & ((np.int64(1) << rs) - 1)
    shifted = high >> rs
    bump = (frac > half) | ((frac == half) & ((shifted & 1) == 1))
    return (shifted + bump).astype(np.int32)


def calibrate_symmetric(x: torch.Tensor, dtype=torch.int8) -> float:
    """Per-tensor symmetric scale: max|x| mapped to the dtype max.

    The division is in float64 on python floats, as in the JAX package
    (``float(amax) / qmax``), so both give the same scale."""
    amax = float(torch.max(torch.abs(x)))
    qmax = torch.iinfo(dtype).max
    return (amax / qmax) if amax > 0 else 1.0


def quantize(x: torch.Tensor, scale: float, dtype=torch.int8) -> torch.Tensor:
    """round(x / scale) (ties to even), saturated to ``dtype``. The divisor
    is the fp32 value of ``scale``, as in the JAX package's weakly typed
    ``x / scale`` on an fp32 array."""
    info = torch.iinfo(dtype)
    q = torch.round(x / torch.tensor(scale, dtype=x.dtype, device=x.device))
    return torch.clamp(q, info.min, info.max).to(dtype)


def dequantize(q: torch.Tensor, scale: float) -> torch.Tensor:
    return q.to(torch.float32) * scale


class _FakeQuant(torch.autograd.Function):
    """Quantize-dequantize forward, identity (straight-through) backward."""

    @staticmethod
    def forward(ctx, x, scale, dtype):
        return dequantize(quantize(x, scale, dtype), scale)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def fake_quant(x: torch.Tensor, scale: float, dtype=torch.int8) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient estimator."""
    return _FakeQuant.apply(x, scale, dtype)
