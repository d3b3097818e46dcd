"""The engine's generic datapath kernels (``csrc/datapath.cu``): XLA's
convert between any two dtypes of the dtype table, and the generic
epilogue, with their plain versions.

:func:`convert` is mechanism (d) of ``csrc/datapath.cu``: an operand
whose dtype is not its main loop's (mixed input dtypes, a float input of
an integer product, the operands of a mixed-dtype attention or SSD call
and a 16-bit paged call above head dim 256 widened to fp32) converted by
XLA's rules (``epilogue.convert``), one kernel per dtype pair on 16-byte
vectors where the view's innermost axis is packed. :func:`epilogue_any`
is mechanism (c): a main loop's wide sum (fp32 or int32) rounded or
wrapped to the product's dtype, converted to the accumulator, the bias
converted and added there, then ``epilogue.apply``. A CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain version.

Launch counts: ``convert.launches`` (the ``kernels`` report's
``convert``) and ``epilogue_any.launches`` (``epilogue[any]``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.config import Activation
from repro_torch.core.dtensor import require_local
from repro_torch.kernels import _build
from repro_torch.kernels import epilogue as epi
from repro_torch.kernels.contracts import convert_view, kernel_contract
from repro_torch.kernels.ref import epilogue_any_ref

# dtype codes of the C interface
ANY = {torch.int8: 0, torch.int16: 1, torch.int32: 2, torch.bfloat16: 3,
       torch.float16: 4, torch.float32: 5}
_ACT = {Activation.NONE: 0, Activation.RELU: 1, Activation.RELU6: 2,
        Activation.GELU: 3, Activation.SILU: 4}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_CONVERT_ARGS = [_P, _I, _P, _I] + [_L] * 8 + [_P]
_EPI_ANY_ARGS = [_P, _I, _I, _I, _P, _I, _L, _P, _I, _L, _L, _I, _I, _F, _P]


def _check_dtype(name: str, *dtypes) -> None:
    for d in dtypes:
        if d not in ANY:
            raise TypeError(f"{name}: no datapath for {d}")


def _view(x: torch.Tensor):
    """(x, sizes, strides): ``x``'s view coalesced as the kernel takes it
    (``contracts.convert_view``); a view that keeps more than 4 dims is
    reshaped first (a copy where its strides ask for one)."""
    v = convert_view(x.shape, x.stride())
    if v is None:
        x = x.reshape(-1, *x.shape[-3:])
        v = convert_view(x.shape, x.stride())
    return x, v[0], v[1]


CONVERT_PLAN_KEYS = ("path", "blocks", "threads", "group", "units", "vec",
                     "rows", "len", "segs", "shift", "wide")


def convert_plan(x: torch.Tensor, dtype: torch.dtype) -> dict:
    """The launch :func:`convert` makes for ``x`` on the card (the C
    ``convert_plan``: its path, 0 packed, 1 rows, 2 general, and grid);
    launches nothing."""
    _check_dtype("convert", x.dtype, dtype)
    _, sizes, strides = _view(x)
    out = (ctypes.c_longlong * len(CONVERT_PLAN_KEYS))()
    fn = _build.bind("datapath", "convert_plan",
                     [_I, _I] + [_L] * 9 + [_P])
    _build.check(fn(ANY[x.dtype], ANY[dtype], *sizes, *strides,
                    x.data_ptr() % 16, ctypes.addressof(out)),
                 "convert_plan")
    return dict(zip(CONVERT_PLAN_KEYS, out))


@kernel_contract("convert")
def convert(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` converted to ``dtype`` by XLA's rules (``epilogue.convert``),
    read through its strides, written contiguous, but a transposed
    row-major matrix (the tied unembedding's ``table.T``) stays a
    transposed view of its converted buffer, so a GEMM reads it as it read
    ``x``. The same tensor where ``x`` is already ``dtype``. The kernel's
    path (packed, rows or general: ``contracts.convert_geometry``) follows
    from the coalesced view and the source's alignment."""
    require_local("convert", x)
    if x.dtype == dtype:
        return x
    if x.device.type == "cpu":
        return epi.convert(x, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"convert: no kernel for device {x.device}")
    _check_dtype("convert", x.dtype, dtype)
    if x.dim() == 2 and x.stride(0) == 1 and x.stride(1) == x.shape[0] \
            and x.shape[1] > 1:
        # a transposed row-major buffer: convert the buffer, keep the view
        return convert(x.t(), dtype).t()
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    if x.numel() == 0:
        return out
    v, sizes, strides = _view(x)
    fn = _build.bind("datapath", "convert_launch", _CONVERT_ARGS)
    err = fn(v.data_ptr(), ANY[x.dtype], out.data_ptr(), ANY[dtype], *sizes,
             *strides, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "convert")
    convert.launches += 1
    return out


@kernel_contract("epilogue_any")
def epilogue_any(w: torch.Tensor, dot_dtype: torch.dtype,
                 acc_dtype: torch.dtype, d: Optional[torch.Tensor],
                 out_dtype: torch.dtype, shift: int = 0,
                 activation: Activation = Activation.NONE) -> torch.Tensor:
    """C = apply(convert(convert(w, dot_dtype), acc_dtype) + convert(d,
    acc_dtype)) over a 2-D (or flat) contiguous ``w`` of any dtype: the
    bias a row of N values or a full (M, N) matrix; shift and activation
    as ``epilogue.apply`` (SiLU on an integer accumulator raises
    ``TypeError``)."""
    require_local("epilogue_any", w, d)
    if w.device.type == "cpu":
        return epilogue_any_ref(w, dot_dtype, acc_dtype, d, out_dtype,
                                shift, activation)
    if w.device.type != "cuda":
        raise ValueError(f"epilogue_any: no kernel for device {w.device}")
    _check_dtype("epilogue_any", w.dtype, dot_dtype, acc_dtype, out_dtype)
    if not acc_dtype.is_floating_point:
        epi.check_int_activation(activation)
        if not 0 <= shift <= 31:
            raise ValueError(f"int32 rounding shift must be in [0, 31], got "
                             f"{shift}")
    w = w.contiguous()
    n_cols = w.shape[-1] if w.dim() >= 1 else 1
    ldd, bias = 0, None
    if d is not None:
        if d.device != w.device:
            raise ValueError("epilogue_any: operands on different devices")
        _check_dtype("epilogue_any", d.dtype)
        if d.dim() == 2 and w.dim() == 2 and d.shape[0] == w.shape[0] and \
                w.shape[0] > 1:
            bias = d.expand(w.shape).contiguous()
            ldd = n_cols
        else:
            bias = d.reshape(n_cols).contiguous()
    c = torch.empty(w.shape, dtype=out_dtype, device=w.device)
    if w.numel() == 0:
        return c
    fn = _build.bind("datapath", "epilogue_any_launch", _EPI_ANY_ARGS)
    err = fn(w.data_ptr(), ANY[w.dtype], ANY[dot_dtype], ANY[acc_dtype],
             None if bias is None else bias.data_ptr(),
             ANY[bias.dtype] if bias is not None else 0, ldd, c.data_ptr(),
             ANY[out_dtype], n_cols, w.numel(), _ACT[activation], shift,
             1.0 / (1 << shift) if shift > 0 else 1.0,
             torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(err, "epilogue_any")
    epilogue_any.launches += 1
    return c


convert.launches = 0
epilogue_any.launches = 0
