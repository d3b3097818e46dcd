"""Plain PyTorch oracles (port of ``repro.kernels.ref``).

``gemm_ref`` is the plain version of the engine GEMM and ``conv2d_ref``
(explicit ``im2col`` + ``gemm_ref``) that of the implicit-im2col conv: the
CUDA kernels in ``kernels/gemm.py`` and ``kernels/conv.py`` are held
against them on the card, and they are what a CPU tensor runs. ``ssd_ref`` is the naive Mamba-2
recurrence, the oracle the chunked SSD (``kernels/mamba2.py``) is held
against in the tests.
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


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer A @ B, wrapped to int32 as an int32 MAC array wraps.

    CUDA has no integer matmul, so 8- and 16-bit operands multiply in
    float64: every product and partial sum is an integer below 2^53
    (|a*b| <= 2^30 and K < 2^22 for 16-bit inputs, 2^14 and K < 2^39 for
    int8), so the sum is exact in any order. It is rounded to int64 and
    wrapped to int32. Wider inputs take int64 products, on the CPU only."""
    if a.element_size() <= 2 and b.element_size() <= 2:
        acc = a.to(torch.float64) @ b.to(torch.float64)
        return torch.round(acc).to(torch.int64).to(torch.int32)
    return (a.to(torch.int64) @ b.to(torch.int64)).to(torch.int32)


def gemm_ref(a: torch.Tensor, b: torch.Tensor, d: Optional[torch.Tensor],
             *, acc_dtype: torch.dtype, out_dtype: torch.dtype,
             shift: int = 0,
             activation: Activation = Activation.NONE) -> torch.Tensor:
    """C = epilogue(A @ B + D) with accumulation in acc_dtype."""
    if acc_dtype.is_floating_point:
        acc = _float_matmul(a, b).to(acc_dtype)
    else:
        acc = _int_matmul(a, b).to(acc_dtype)
    if d is not None:
        acc = acc + d.to(acc_dtype)
    return epi.apply(acc, shift=shift, activation=activation,
                     out_dtype=out_dtype)


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
