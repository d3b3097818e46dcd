"""Plain PyTorch oracles (port of ``repro.kernels.ref``).

``gemm_ref`` is the plain version of the engine GEMM and ``conv2d_ref``
(explicit ``im2col`` + ``gemm_ref``) that of the implicit-im2col conv: the
CUDA kernels in ``kernels/gemm.py`` and ``kernels/conv.py`` are held
against them on the card, and they are what a CPU tensor runs.

``gemm_ref`` computes what JAX's ``gemm_ref`` computes on every (input,
accumulator, output) combination it accepts, as probed on XLA's CPU (jax
0.9.0; (8 x 64) @ (64 x 8) operands): ``dot_general(a, b,
preferred_element_type=P)`` sums in one dtype D (:func:`product_dtypes`)
and converts the sum to P.

- Inputs of two dtypes: JAX converts both to P first, so D = P (int8 @
  fp16 into int32 truncates the fp16 operand to int32, then sums exactly).
- Inputs of one dtype T: D is the higher of T and P in XLA's precision
  order int8 < int16 < int32 < fp16 < bf16 < fp32. fp32 inputs into a bf16
  or fp16 accumulator sum in fp32 and round once (converting the inputs
  first differed by 0.5); fp16 inputs into bf16 are converted to bf16 and
  summed (matched exactly); bf16 inputs into fp16 sum in fp32, round to
  bf16, then convert to fp16 (XLA's HLO: convert f32 -> bf16 -> f16); bf16
  or fp16 inputs into an integer accumulator round the sum to the input
  type, then truncate; integer inputs into a wider integer wrap in it
  (int8 into int16: the int32 sum wrapped to 16 bits).
- ``TypeError`` where JAX raises: both inputs integer and P narrower than
  either (int16 -> int8, int32 -> int8 / int16 / bf16 / fp16).
- Float sums run in fp32 in another order than XLA's (within the fp
  rules); integer sums are exact. The bias is converted to P and added in
  P; the epilogue and every cast are ``kernels/epilogue.py``'s. ``ssd_ref`` is the naive Mamba-2
recurrence, the oracle the chunked SSD (``kernels/mamba2.py``) is held
against in the tests.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.config import Activation
from repro_torch.kernels import epilogue as epi


def _float_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A @ B summed in IEEE fp32: TF32 is switched off for the call, so an
    fp32 engine config stays exact on the card as on the CPU."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a.to(torch.float32) @ b.to(torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _int_matmul(a: torch.Tensor, b: torch.Tensor,
                out: torch.dtype = torch.int32) -> torch.Tensor:
    """Exact integer A @ B, wrapped to ``out``'s width as an integer MAC
    array of that width wraps.

    CUDA has no integer matmul, so the products run in float64, where
    every product and partial sum stays an integer below 2^53: 8- and
    16-bit operands directly (|a*b| <= 2^30, K < 2^23); int32 operands as
    an unsigned low and a signed high half each, lo*lo + 2^16 (hi*lo +
    lo*hi) modulo 2^32 (K < 2^21). The sum is exact in any order, rounded
    to int64 and wrapped."""
    if a.element_size() <= 2 and b.element_size() <= 2:
        acc = torch.round(a.to(torch.float64) @ b.to(torch.float64))
        return acc.to(torch.int64).to(out)
    a, b = a.to(torch.int64), b.to(torch.int64)
    a_lo, b_lo = a & 0xFFFF, b & 0xFFFF
    a_hi, b_hi = (a - a_lo) >> 16, (b - b_lo) >> 16

    def mm(x, y):
        return torch.round(x.to(torch.float64) @ y.to(torch.float64)) \
            .to(torch.int64)
    low = mm(a_lo, b_lo)
    mid = (mm(a_hi, b_lo) + mm(a_lo, b_hi)) & 0xFFFF
    return (low + (mid << 16)).to(out)


_BITS = {torch.int8: 8, torch.int16: 16, torch.int32: 32,
         torch.bfloat16: 16, torch.float16: 16, torch.float32: 32}
# XLA's HigherPrecisionType order (JAX's ``_dot_general_dtype_rule``:
# exponent range, then mantissa, then width): the dot of two T operands
# into P runs in the higher of T and P.
_RANK = {torch.int8: 0, torch.int16: 1, torch.int32: 2, torch.float16: 3,
         torch.bfloat16: 4, torch.float32: 5}


def product_dtypes(a_dtype: torch.dtype, b_dtype: torch.dtype,
                   acc_dtype: torch.dtype) -> torch.dtype:
    """The dtype ``dot_general(a, b, preferred_element_type=acc_dtype)``
    sums in on XLA's CPU (module docstring): the accumulator where the
    inputs' dtypes differ (JAX converts both to it) or where it ranks
    above the inputs' dtype, else the inputs' dtype, the sum then
    converted to the accumulator. ``TypeError`` where JAX raises: both
    inputs integer and the accumulator narrower than either (int16 ->
    int8, int32 -> int8 / int16 / bf16 / fp16)."""
    if a_dtype not in _BITS or b_dtype not in _BITS or acc_dtype not in _BITS:
        raise TypeError(f"gemm: no datapath for {a_dtype} @ {b_dtype} -> "
                        f"{acc_dtype}")
    if not (a_dtype.is_floating_point or b_dtype.is_floating_point) and \
            _BITS[acc_dtype] < max(_BITS[a_dtype], _BITS[b_dtype]):
        raise TypeError(f"gemm: accumulator {acc_dtype} is narrower than the "
                        f"inputs {a_dtype} @ {b_dtype}")
    if a_dtype != b_dtype or _RANK[acc_dtype] >= _RANK[a_dtype]:
        return acc_dtype
    return a_dtype


def dot_sum(a: torch.Tensor, b: torch.Tensor,
            dot: torch.dtype) -> torch.Tensor:
    """A @ B with the inputs converted to ``dot`` and summed there: floats
    in fp32, rounded once to ``dot``; integers exactly, wrapped to its
    width."""
    a, b = epi.convert(a, dot), epi.convert(b, dot)
    if dot.is_floating_point:
        return _float_matmul(a, b).to(dot)
    return _int_matmul(a, b, dot)


def epilogue_any_ref(w: torch.Tensor, dot: torch.dtype,
                     acc_dtype: torch.dtype, d: Optional[torch.Tensor],
                     out_dtype: torch.dtype, shift: int,
                     activation: Activation) -> torch.Tensor:
    """A sum ``w`` rounded or wrapped to ``dot``, converted to the
    accumulator, the bias converted and added there (an integer
    accumulator wraps), then the epilogue: the plain version of
    ``datapath.epilogue_any``."""
    acc = epi.convert(epi.convert(w, dot), acc_dtype)
    if d is not None:
        acc = acc + epi.convert(d, acc_dtype)
    return epi.apply(acc, shift=shift, activation=activation,
                     out_dtype=out_dtype)


def gemm_ref(a: torch.Tensor, b: torch.Tensor, d: Optional[torch.Tensor],
             *, acc_dtype: torch.dtype, out_dtype: torch.dtype,
             shift: int = 0,
             activation: Activation = Activation.NONE) -> torch.Tensor:
    """C = epilogue(A @ B + D) with accumulation in acc_dtype: XLA's
    ``dot_general(preferred_element_type=acc_dtype)`` (summed in the dtype
    :func:`product_dtypes` names), then :func:`epilogue_any_ref`."""
    dot = product_dtypes(a.dtype, b.dtype, acc_dtype)
    return epilogue_any_ref(dot_sum(a, b, dot), dot, acc_dtype, d, out_dtype,
                            shift, activation)


# -- Conv2D (explicit im2col, the paper's shipped host-side path) ------------
def im2col(x: torch.Tensor, kh: int, kw: int, stride: int,
           padding: int) -> torch.Tensor:
    """NHWC -> (N*OH*OW, KH*KW*C) patch matrix, columns tap-major with the
    channel fastest (the row order of an HWIO filter reshaped to
    (KH*KW*C, CO))."""
    n, h, w, c = x.shape
    x = torch.nn.functional.pad(x, (0, 0, padding, padding, padding, padding))
    oh = (h + 2 * padding - kh) // stride + 1
    ow = (w + 2 * padding - kw) // stride + 1
    patches = [x[:, i:i + (oh - 1) * stride + 1:stride,
                 j:j + (ow - 1) * stride + 1:stride, :]
               for i in range(kh) for j in range(kw)]
    stacked = torch.stack(patches, dim=3)          # (N, OH, OW, KH*KW, C)
    return stacked.reshape(n * oh * ow, kh * kw * c)


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
               *, stride: int = 1, padding: int = 0,
               acc_dtype: torch.dtype = torch.int32,
               out_dtype: torch.dtype = torch.int8, shift: int = 0,
               activation: Activation = Activation.NONE) -> torch.Tensor:
    """Conv2D NHWC x HWIO via explicit im2col + GEMM (paper section 3.3)."""
    n, h, wd, c = x.shape
    kh, kw, ci, co = w.shape
    if ci != c:
        raise ValueError(f"conv2d: input has {c} channels, filter {ci}")
    oh = (h + 2 * padding - kh) // stride + 1
    ow = (wd + 2 * padding - kw) // stride + 1
    a = im2col(x, kh, kw, stride, padding)
    d = None if b is None else b[None, :]
    y = gemm_ref(a, w.reshape(kh * kw * c, co), d, acc_dtype=acc_dtype,
                 out_dtype=out_dtype, shift=shift, activation=activation)
    return y.reshape(n, oh, ow, co)


# -- Mamba-2 SSD oracle -------------------------------------------------------
def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor, *,
            d_skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Naive-recurrence SSD: x (B, T, H, P), dt (B, T, H) softplus'd, a_log
    (H,), b/c (B, T, G, N); head h reads group h // (H // G). One step per
    token, state (B, H, P, N) in fp32. Returns y (B, T, H, P) in x's dtype."""
    bsz, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    hpg = h // g
    a = -torch.exp(a_log.to(torch.float32))
    dt = dt.to(torch.float32)
    da = torch.exp(dt * a[None, None, :])
    bf = b.to(torch.float32).repeat_interleave(hpg, dim=2)     # (B, T, H, N)
    cf = c.to(torch.float32).repeat_interleave(hpg, dim=2)
    xf = x.to(torch.float32)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(t):
        state = state * da[:, i, :, None, None] + \
            (dt[:, i, :, None] * xf[:, i])[..., None] * bf[:, i, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cf[:, i]))
    y = torch.stack(ys, dim=1)
    if d_skip is not None:
        y = y + d_skip[None, None, :, None] * xf
    return y.to(x.dtype)
