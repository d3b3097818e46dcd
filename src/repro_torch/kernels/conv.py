"""Conv2D as an implicit-im2col GEMM: the CUDA kernel (``csrc/conv.cu``)
and its plain version.

Replaces ``repro.kernels.conv.conv2d_implicit``. The kernel is the int8
GEMM's main loop (``csrc/igemm.cuh``) over the implicit GEMM (N*OH*OW,
CO, KH*KW*CI), with its plan (:func:`repro_torch.kernels.gemm.gemm_s8_plan`):
tiles and K splits over the taps from the shape, the splits merged
through the stream's workspace. The patch matrix is never materialised:
the kernel gathers each A tile from the NHWC image by ``cp.async``, the
stride in the address and the padding as the copy's zero-fill; 1x1
filters at stride 1 without padding read the image as a row-major
(N*H*W, CI) matrix. Products accumulate in a wrapping int32, and the bias
and the GEMM's epilogue run once, after the last tap. A CUDA tensor
launches the kernel (or raises); a CPU tensor takes the plain version
``repro_torch.kernels.ref.conv2d_ref`` (explicit im2col + GEMM).
``conv2d_implicit.launches`` counts kernel launches.

The CUDA kernel takes the int8 datapath only (int8 in, int32 accumulate,
int8 or int32 out): a float conv raises on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.config import Activation
from repro_torch.kernels import _build
from repro_torch.kernels import epilogue as epi
from repro_torch.kernels.gemm import (_ACT, _INT_OUT, _S8_PLANS,
                                      _check_int_shift, _workspace,
                                      gemm_s8_plan)
from repro_torch.kernels.ref import conv2d_ref

_I, _P = ctypes.c_int, ctypes.c_void_p
_ARGS = [_P, _P, _P, _P] + [_I] * 14 + [_P, _P]


def out_hw(h: int, w: int, kh: int, kw: int, stride: int,
           padding: int) -> "tuple[int, int]":
    return ((h + 2 * padding - kh) // stride + 1,
            (w + 2 * padding - kw) // stride + 1)


def conv2d_implicit(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None, *,
                    acc_dtype: torch.dtype, out_dtype: torch.dtype,
                    stride: int = 1, padding: int = 0, shift: int = 0,
                    activation: Activation = Activation.NONE) -> torch.Tensor:
    """x: (N, H, W, CI), w: (KH, KW, CI, CO), b: (CO,) -> (N, OH, OW, CO)."""
    if x.device.type == "cpu":
        return conv2d_ref(x, w, b, stride=stride, padding=padding,
                          acc_dtype=acc_dtype, out_dtype=out_dtype,
                          shift=shift, activation=activation)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_implicit: no kernel for device {x.device}")
    n, h, wd, ci = x.shape
    kh, kw, ci2, co = w.shape
    if ci != ci2:
        raise ValueError(f"conv2d: input has {ci} channels, filter {ci2}")
    if w.device != x.device or (b is not None and b.device != x.device):
        raise ValueError("conv2d_implicit: operands on different devices")
    if x.dtype != torch.int8 or w.dtype != torch.int8 or \
            acc_dtype != torch.int32 or out_dtype not in _INT_OUT:
        raise NotImplementedError(
            f"conv2d_implicit kernel takes int8 x int8 -> int32 -> int8 / "
            f"int32, got {x.dtype} x {w.dtype} -> {acc_dtype} -> {out_dtype}")
    if stride < 1 or padding < 0:
        raise ValueError(f"stride {stride} / padding {padding}")
    epi.check_int_activation(activation)
    _check_int_shift(shift)
    oh, ow = out_hw(h, wd, kh, kw, stride, padding)
    out = torch.empty((n, max(oh, 0), max(ow, 0), co), dtype=out_dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    x, w = x.contiguous(), w.contiguous()
    if b is not None:
        b = b.to(torch.int32).reshape(co).contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    m, k = n * oh * ow, kh * kw * ci
    plan = _S8_PLANS.get((m, co, k, False, x.device.index)) \
        or gemm_s8_plan(m, co, k, device=x.device)
    need = plan["workspace_bytes"]
    wsp = _workspace(x.device, stream, need).data_ptr() if need else None
    fn = _build.bind("conv", "conv2d_s8_launch", _ARGS)
    err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr() if b is not None
             else None, out.data_ptr(), n, h, wd, ci, co, kh, kw, stride,
             padding, oh, ow, _INT_OUT[out_dtype], _ACT[activation], shift,
             stream, wsp)
    _build.check(err, "conv2d_implicit")
    conv2d_implicit.launches += 1
    return out


conv2d_implicit.launches = 0
