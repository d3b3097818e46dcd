"""Conv2D as an implicit-im2col GEMM: the CUDA kernel (``csrc/conv.cu``)
and its plain version.

Replaces ``repro.kernels.conv.conv2d_implicit``, on every (input,
filter, accumulator, output) combination JAX's ``conv2d_ref`` accepts,
raising ``TypeError`` where it does (``ref.product_dtypes``). One launch
with the epilogue fused runs int8, int16 and int32 inputs of one dtype
into a wrapping int32, stored int8, int16 (saturated) or int32 (no
GELU), and bf16, fp16 and fp32 inputs into fp32, stored bf16, fp16 or
fp32 (rounded to nearest even; an fp16 overflow stores +-inf). Every
other combination converts its operands to the dtype XLA sums them in
(``datapath.convert``), runs that dtype's kernel into its wide sum and
finishes on ``datapath.epilogue_any``, as the GEMM's ``_gemm_any`` does.
The kernel runs the implicit GEMM (N*OH*OW, CO, KH*KW*CI) on one of two main
loops, with a plan (:func:`conv_plan`: tiles and K splits over the taps
from the shape, the splits merged through the stream's workspace): int8,
bf16 and fp16 on the tensor cores (``csrc/igemm.cuh``, the GEMM's plan),
fp32, int16 and int32 on the CUDA cores (``csrc/sgemm.cuh`` with the conv's own
plan: 56 x 64 tiles of 7 x 8 micro-tiles, 4 groups of threads splitting
each tile's k, no split longer than 512 k, so fp32's chains stay
short). The patch matrix is never materialised: the kernel
gathers each A tile from the NHWC image by ``cp.async``, the stride in
the address and the padding as the copy's zero-fill; an image whose tap
is less than 16 bytes of channels (the stem's CI = 3) has the strips a
tile reads staged in shared memory first; 1x1 filters at stride 1
without padding read the image as a row-major (N*H*W, CI) matrix. The
bias and the GEMM's epilogue run once per output, after the last tap. A
CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version ``repro_torch.kernels.ref.conv2d_ref`` (explicit im2col + GEMM).

A call may name its plan (``plan={"tile": code, "splits": s}``; the codes
are :func:`conv_plan`'s), else under ``GEMMINI_TUNE=cached`` / ``full``
the tuner resolves one per shape, as for the GEMM.

Launch counts, one per kernel of the ``kernels`` report:
``conv2d_implicit.launches`` the int8 kernel (``conv2d_implicit``), and
``COUNTS[dtype].launches`` the fp32, bf16, fp16, int16 and int32 ones
(``conv2d_implicit[fp32]`` and so on).
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Dict, Optional

import torch

from repro_torch.core import flags
from repro_torch.core.config import Activation
from repro_torch.core.dtensor import require_local
from repro_torch.kernels import _build
from repro_torch.kernels import datapath as dp
from repro_torch.kernels.contracts import kernel_contract
from repro_torch.kernels import epilogue as epi
from repro_torch.kernels.gemm import (_ACT, _DT, _INT_OUT, _PLAN_KEYS,
                                      _check_int_shift, _device_index,
                                      _plan_dict, _workspace, direct,
                                      loop_dtype)
from repro_torch.kernels.ref import conv2d_ref, product_dtypes

_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_ARGS = [_P, _P, _P, _P] + [_I] * 15 + [_F, _P, _P, _I, _I]
# Input codes of conv2d_launch, and each input's accumulator.
_IN = {torch.int8: 0, torch.int16: 1, torch.float32: 2, torch.bfloat16: 3,
       torch.float16: 4, torch.int32: 5}
# Each input's accumulator on the fused datapaths.
_ACC = {d: torch.int32 if not d.is_floating_point else torch.float32
        for d in _IN}
_REGIMES = ("skinny", "square", "cuda cores")
_PLANS: Dict[tuple, dict] = {}


def out_hw(h: int, w: int, kh: int, kw: int, stride: int,
           padding: int) -> "tuple[int, int]":
    return ((h + 2 * padding - kh) // stride + 1,
            (w + 2 * padding - kw) // stride + 1)


def conv_plan(m: int, n: int, k: int, dtype: torch.dtype = torch.int8,
              device=None, *, tile: int = 0, splits: int = 0) -> dict:
    """The conv kernel's plan for ``dtype`` inputs and the implicit GEMM
    (M, N, K) = (N*OH*OW, CO, KH*KW*CI) on a card: ``regime`` ("skinny" 16
    x 64 or "square" 64 x 64 tiles on the tensor cores, int8 / bf16 /
    fp16; "cuda cores", fp32 / int16: 56 x 64 tiles), ``tile`` (rows,
    columns, k per stage: bytes on the tensor cores, values on the CUDA
    cores),
    ``splits`` of K, ``grid`` (blocks), ``threads``, ``stages``, ``smem``
    bytes (the loop's; the stem's strips add to it) and
    ``workspace_bytes`` (0 for one split). It depends on the shape, the
    dtype and the card's SM count only; int8's equals
    :func:`repro_torch.kernels.gemm.gemm_s8_plan` of the implicit GEMM,
    int16's equals fp32's. ``tile`` and ``splits`` name another plan (both
    0: the shape's own; ``tile_code``): the tensor cores' 1 skinny, 2
    square (any M), the CUDA cores' 1 (their one tile); a plan the kernel
    cannot run raises ``RuntimeError``."""
    if dtype not in _IN:
        raise NotImplementedError(f"conv_plan: no conv kernel for {dtype}")
    index = _device_index(device)
    key = (m, n, k, dtype, index, tile, splits)
    plan = _PLANS.get(key)
    if plan is None:
        out = (ctypes.c_longlong * len(_PLAN_KEYS))()
        fn = _build.bind("conv", "conv_plan", [_I] * 6 + [_P])
        with torch.cuda.device(index):
            _build.check(fn(m, n, k, _IN[dtype], int(tile), int(splits),
                            ctypes.addressof(out)), "conv_plan")
        plan = _PLANS[key] = _plan_dict(dict(zip(_PLAN_KEYS, out)),
                                        _REGIMES)
    return plan


@kernel_contract("conv2d_implicit")
def conv2d_implicit(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None, *,
                    acc_dtype: torch.dtype, out_dtype: torch.dtype,
                    stride: int = 1, padding: int = 0, shift: int = 0,
                    activation: Activation = Activation.NONE,
                    plan: Optional[dict] = None) -> torch.Tensor:
    """x: (N, H, W, CI), w: (KH, KW, CI, CO), b: (CO,) -> (N, OH, OW, CO);
    ``plan``: the caller's ``{"tile", "splits"}`` (module docstring)."""
    require_local("conv2d_implicit", x, w, b)
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
    if stride < 1 or padding < 0:
        raise ValueError(f"stride {stride} / padding {padding}")
    dot = product_dtypes(x.dtype, w.dtype, acc_dtype)  # TypeError as JAX's
    if not acc_dtype.is_floating_point:
        epi.check_int_activation(activation)
        _check_int_shift(shift)
    if not direct(x.dtype, w.dtype, acc_dtype, out_dtype, activation):
        loop = loop_dtype(x.dtype, w.dtype, dot)
        wide = torch.float32 if loop.is_floating_point else torch.int32
        s = conv2d_implicit(dp.convert(x, loop), dp.convert(w, loop), None,
                            acc_dtype=wide, out_dtype=wide, stride=stride,
                            padding=padding, plan=plan)
        y = dp.epilogue_any(s.reshape(-1, co), dot, acc_dtype,
                            None if b is None else b.reshape(co), out_dtype,
                            shift, activation)
        return y.reshape(s.shape)
    outs = _INT_OUT if acc_dtype == torch.int32 else _DT
    oh, ow = out_hw(h, wd, kh, kw, stride, padding)
    out = torch.empty((n, max(oh, 0), max(ow, 0), co), dtype=out_dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    x, w = x.contiguous(), w.contiguous()
    if b is not None:
        b = dp.convert(b, acc_dtype).reshape(co).contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    m, k = n * oh * ow, kh * kw * ci
    if plan is None and flags.get("tune_mode") != "off" and \
            x.dtype != torch.int32:
        from repro_torch.tune import tuner
        plan = tuner.conv_schedule(x.dtype, out_dtype, n, h, wd, ci, co, kh,
                                   kw, stride, padding, b is not None,
                                   x.device)
    tile, splits = (plan["tile"], plan["splits"]) if plan else (0, 0)
    plan = _PLANS.get((m, co, k, x.dtype, x.device.index, tile, splits)) \
        or conv_plan(m, co, k, x.dtype, x.device, tile=tile, splits=splits)
    need = plan["workspace_bytes"]
    wsp = _workspace(x.device, stream, need).data_ptr() if need else None
    fn = _build.bind("conv", "conv2d_launch", _ARGS)
    err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr() if b is not None
             else None, out.data_ptr(), n, h, wd, ci, co, kh, kw, stride,
             padding, oh, ow, _IN[x.dtype], outs[out_dtype],
             _ACT[activation], shift,
             1.0 / (1 << shift) if shift > 0 else 1.0, stream, wsp, tile,
             splits)
    _build.check(err, "conv2d_implicit")
    if x.dtype == torch.int8:
        conv2d_implicit.launches += 1
    else:
        COUNTS[x.dtype].launches += 1
    return out


conv2d_implicit.launches = 0
# The fp32, bf16, fp16, int16 and int32 kernels' launches (the kernels report
# names them conv2d_implicit[fp32] and so on).
COUNTS = {dtype: SimpleNamespace(launches=0)
          for dtype in (torch.float32, torch.bfloat16, torch.float16,
                        torch.int16, torch.int32)}
