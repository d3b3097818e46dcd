"""Accumulator -> output epilogue (port of ``repro.kernels.epilogue``).

Rounding bitshift (round half to even), saturation to the output
bitwidth, and the activation units. This is the plain version; the CUDA
kernels apply the same epilogue from one header, ``csrc/epilogue.cuh``
(the GEMMs' and the conv's store loops, and ``accumulator_epilogue``).

It computes what the JAX package's ``epilogue.apply`` computes on every
(accumulator, output) pair, bit for bit but for GELU, whose tanh differs
between libraries in the last ulp:

- an integer accumulator (int8, int16 or int32) is widened to int32, then
  shifted, activated and, for an int8 / int16 output, clipped to the
  output's range. ReLU and ReLU6 stay in int32. GELU runs in fp32 on the
  int32 value converted to fp32 (JAX's ``gelu`` promotes its argument):
  [-300, 5, 1000], shift 2, reads [0, 0, 127] in int8 (-75 -> -0.0,
  1 -> 0.84 -> 0, 250 -> 250 -> clipped to 127). SiLU raises
  ``TypeError``, as JAX's ``sigmoid`` does on an integer;
- a float accumulator (bf16, fp16 or fp32) is activated in its own dtype,
  divided by 2^shift (exact but for subnormals) and cast;
- every cast is XLA's ``convert`` (:func:`convert`): a float -> integer
  cast truncates toward zero, saturates and maps NaN to 0 (300.0 -> int8
  reads 127, where ``Tensor.to`` wraps it to 44); integer -> float and
  float -> float round to nearest even, an fp16 overflow reads +-inf
  (int32 70000 -> fp16 reads inf, 65519 reads 65504); integer ->
  integer wraps.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.config import Activation


def convert(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.astype(dtype)`` as XLA's convert computes it (module
    docstring): a float -> integer cast truncates toward zero, saturates
    and maps NaN to 0; every other cast is ``Tensor.to``'s (round to
    nearest even, integers wrap)."""
    if x.dtype == dtype:
        return x
    if x.is_floating_point() and not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        y = torch.nan_to_num(x.to(torch.float64), nan=0.0)
        y = y.clamp(info.min, info.max).trunc()
        return y.to(torch.int64).to(dtype)
    return x.to(dtype)


def _rounding_shift(x: torch.Tensor, shift: int) -> torch.Tensor:
    if shift <= 0:
        return x
    half = 1 << (shift - 1)
    frac = torch.bitwise_and(x, (1 << shift) - 1)
    shifted = torch.bitwise_right_shift(x, shift)      # arithmetic on int32
    bump = (frac > half) | ((frac == half) & (torch.bitwise_and(shifted, 1) == 1))
    return shifted + bump.to(x.dtype)


_SQRT_2_OVER_PI = float(torch.tensor(math.sqrt(2.0 / math.pi),
                                     dtype=torch.float32))
# XLA's fp32 tanh on the CPU (Eigen's rational approximation, its Horner
# steps fused multiply-adds; inputs clamped where it reads exactly +-1):
# x P(x^2) / Q(x^2), and x itself below 4e-4.
_TANH_CLAMP = 7.99881172180175781
_TANH_P = (-2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
           5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
           4.89352455891786e-03)
_TANH_Q = (1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
           4.89352518554385e-03)


def _f32(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32))


def _tanh_xla(x: torch.Tensor) -> torch.Tensor:
    """fp32 tanh as XLA's CPU computes it, bit for bit (each fused
    multiply-add in float64, whose product of two fp32 values is exact,
    rounded once to fp32)."""
    xc = x.clamp(-_TANH_CLAMP, _TANH_CLAMP)
    x2 = (xc * xc).to(torch.float64)

    def horner(coeffs):
        p = torch.full_like(x2, _f32(coeffs[0]))
        for c in coeffs[1:]:
            p = (p * x2 + _f32(c)).to(torch.float32).to(torch.float64)
        return p.to(torch.float32)
    y = (xc * horner(_TANH_P)) / horner(_TANH_Q)
    return torch.where(x.abs() < _f32(0.0004), x, y)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's tanh approximation as XLA's CPU computes it, bit for
    bit: in fp32 through XLA's tanh (an integer is promoted to fp32); in
    bf16 / fp16 each operation, its constants and the fp32 tanh rounded
    to the dtype in turn."""
    dt = x.dtype
    if not dt.is_floating_point or dt == torch.float32:
        x = x.to(torch.float32)
        inner = _SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))
        return x * (0.5 * (1.0 + _tanh_xla(inner)))

    def r(v):
        return v.to(dt).to(torch.float32)
    c0, c1 = (_f32(float(torch.tensor(c, dtype=dt)))
              for c in (_SQRT_2_OVER_PI, 0.044715))
    xf = x.to(torch.float32)
    inner = r(c0 * r(xf + r(c1 * r(r(xf * xf) * xf))))
    y = xf * r(0.5 * r(1.0 + r(_tanh_xla(inner))))
    return y.to(dt)


def _silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), the sigmoid XLA's 1 / (1 + exp(-x)); in bf16 / fp16
    each operation rounded to the dtype in turn (bit for bit); in fp32
    within an ulp (XLA's exp is its own approximation)."""
    dt = x.dtype
    if dt == torch.float32:
        return x * torch.sigmoid(x)

    def r(v):
        return v.to(dt).to(torch.float32)
    xf = x.to(torch.float32)
    sig = r(1.0 / r(1.0 + r(torch.exp(-xf))))
    return (xf * sig).to(dt)


def activate(x: torch.Tensor, activation: Activation) -> torch.Tensor:
    if activation is Activation.NONE:
        return x
    if activation is Activation.RELU:
        return torch.clamp_min(x, 0)
    if activation is Activation.RELU6:
        return torch.clamp(x, 0, 6)
    if activation is Activation.GELU:
        # jax.nn.gelu promotes an integer argument to fp32
        return _gelu(x)
    if activation is Activation.SILU:
        if not x.is_floating_point():
            raise TypeError(f"SILU is a float unit: sigmoid does not accept "
                            f"{x.dtype}")
        return _silu(x)
    raise ValueError(activation)


def check_int_activation(activation: Activation) -> None:
    """Raise where :func:`apply` raises on an integer accumulator (SiLU),
    before a kernel launch."""
    if activation is Activation.SILU:
        raise TypeError("SILU is a float unit: sigmoid does not accept an "
                        "integer accumulator")


def apply(acc: torch.Tensor, *, shift: int, activation: Activation,
          out_dtype: torch.dtype) -> torch.Tensor:
    """acc (any integer or float dtype) -> activation(round_shift(acc))
    saturated to out (module docstring)."""
    if not acc.is_floating_point():
        check_int_activation(activation)
        y = _rounding_shift(acc.to(torch.int32), shift)
        y = activate(y, activation)
        if not out_dtype.is_floating_point and out_dtype != torch.int32:
            info = torch.iinfo(out_dtype)
            y = torch.clamp(y, info.min, info.max)
        return convert(y, out_dtype)
    y = activate(acc, activation)
    if shift:
        y = y / (2.0 ** shift)
    return convert(y, out_dtype)
