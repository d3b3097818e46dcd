"""Engine GEMM: the CUDA kernel (``csrc/gemm.cu``) and its plain version.

Replaces ``repro.kernels.gemm.gemm_os``. ``gemm`` computes
``C = act(round_shift(A @ B + D))`` at fp32 accumulation: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain version
``repro_torch.kernels.ref.gemm_ref``. The kernel masks ragged edges itself,
so operands are never padded to a tile plan, and it reads B through its
strides: a transposed view (the tied unembedding's ``table.T``) costs no
copy. ``gemm.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.config import Activation
from repro_torch.kernels import _build
from repro_torch.kernels.ref import gemm_ref

_ACT = {Activation.NONE: 0, Activation.RELU: 1, Activation.RELU6: 2,
        Activation.GELU: 3, Activation.SILU: 4}
_DT = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _L, _I, _I, _I, _F, _P]


def _b_layout(b: torch.Tensor):
    """(b, transposed, ldb): B as row-major (K, N), or read as the
    transpose of a row-major (N, K) buffer, whichever its strides are."""
    if b.stride(1) == 1:
        return b, 0, b.stride(0)
    if b.stride(0) == 1:
        return b, 1, b.stride(1)
    b = b.contiguous()
    return b, 0, b.stride(0)


def gemm(a: torch.Tensor, b: torch.Tensor, d: Optional[torch.Tensor] = None,
         *, acc_dtype: torch.dtype, out_dtype: torch.dtype, shift: int = 0,
         activation: Activation = Activation.NONE) -> torch.Tensor:
    """a: (M, K); b: (K, N) with any strides; d: bias broadcastable to
    (M, N) (a (N,) / (1, N) row or a full (M, N) matrix)."""
    if a.device.type == "cpu":
        return gemm_ref(a, b, d, acc_dtype=acc_dtype, out_dtype=out_dtype,
                        shift=shift, activation=activation)
    if a.device.type != "cuda":
        raise ValueError(f"gemm: no kernel for device {a.device}")
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if b.device != a.device or (d is not None and d.device != a.device):
        raise ValueError("gemm: operands on different devices")
    if a.dtype not in _DT or b.dtype != a.dtype:
        raise NotImplementedError(
            f"gemm kernel takes bf16 or fp32 inputs of one dtype, got "
            f"{a.dtype} @ {b.dtype} (int8 -> int32 is ROADMAP queue B)")
    if acc_dtype != torch.float32 or out_dtype not in _DT:
        raise NotImplementedError(
            f"gemm kernel accumulates in fp32 and writes bf16/fp32, got "
            f"acc {acc_dtype}, out {out_dtype}")
    a = a.contiguous()
    b, trans, ldb = _b_layout(b)
    ldd = 0
    if d is not None:
        d = d.to(torch.float32)
        if d.dim() == 2 and d.shape[0] == m and m > 1:
            d = d.expand(m, n).contiguous()
            ldd = n
        else:
            d = d.reshape(n).contiguous()
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    fn = _build.bind("gemm", "gemm_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), b.data_ptr(), d.data_ptr() if d is not None else None,
             c.data_ptr(), m, n, k, a.stride(0), ldb, trans, ldd, _DT[a.dtype],
             _DT[out_dtype], _ACT[activation], 1.0 / (1 << shift) if shift > 0
             else 1.0, stream)
    _build.check(err, "gemm")
    gemm.launches += 1
    return c


gemm.launches = 0
