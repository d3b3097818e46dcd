"""Engine GEMM on both dataflows, and the mvout epilogue: the CUDA kernels
(``csrc/gemm.cu`` for int8, bf16 and fp32 inputs, ``csrc/gemm16.cu`` for
fp16 and int16 inputs, ``csrc/datapath.cu`` for int32 inputs and the
generic datapath; main loops in ``csrc/hgemm.cuh`` (bf16, fp16),
``csrc/sgemm.cuh`` (fp32, int32) and ``csrc/igemm.cuh`` (int8, int16))
and their plain versions.

Replaces ``repro.kernels.gemm``: ``gemm_os``, ``gemm_ws``,
``accumulator_epilogue`` and the dataflow dispatch ``gemm``. The GEMMs
compute ``C = act(round_shift(A @ B + D))`` on every (input, input,
accumulator, output) combination JAX's ``gemm_ref`` accepts, and raise
``TypeError`` exactly where it does (both inputs integer and the
accumulator narrower: int16 -> int8, int32 -> int8 / int16 / bf16 /
fp16). One kernel with its epilogue fused (:func:`direct`) runs float
inputs (bf16, fp16, fp32) of one dtype into fp32 and out bf16, fp16 or
fp32 (rounded to nearest even; an fp16 overflow stores +-inf, as JAX's
``astype`` does), and integer inputs (int8, int16, int32) of one dtype
into a wrapping int32 (the bias added once, modulo 2^32 like every int32
add of the kernel) saturated to int8 or int16, or stored as int32. Every
other combination -- another accumulator, mixed input dtypes, GELU on an
integer accumulator -- runs :func:`_gemm_any`: the inputs converted to the
dtype XLA sums them in (``ref.product_dtypes``), the wide sum on that
dtype's main loop, and ``datapath.epilogue_any``; the result is the plain
version's, its dtype rules documented in ``kernels/ref.py``. A CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain version
(``repro_torch.kernels.ref.gemm_ref``, ``epilogue.apply``). The kernels mask
ragged edges themselves, so operands are never padded to a tile plan
(zero padding changes no result: the unpadded output is the JAX package's
``out[:m, :n]``), and they read B through its strides: a transposed view
(the tied unembedding's ``table.T``) costs no copy.

bf16 and fp16 inputs run one of two kernels by the shape alone
(:func:`gemm_plan`): split-K ``mma.sync`` for M <= 16 (decode) and
``wgmma`` for wider M (prefill; two consumer warpgroups fed by a TMA
warp, K split over a cluster of blocks that adds its partials in
distributed shared memory, so it needs no workspace); fp32 inputs run
the CUDA-core kernel (IEEE FMAs with a blocked sum; register micro-tiles,
split K where the tiles leave SMs idle); int8 inputs
run ``igemm.cuh``'s tensor-core main loop (:func:`gemm_s8_plan`: 16 x 64 or
64 x 64 tiles by the shape, a 4-stage ``cp.async`` ring, K split by a
waves x k-steps model and merged exactly, since int32 sums wrap), and
int16 inputs the same loop on byte planes (each value a signed high and
an unsigned low byte, four int8 products combined with shifts, modulo
2^32 exact; the int8 plan over 2 K bytes). Each
is one launch per call, and WS walks the same tiles weight-major, so WS
equals OS bit for bit on every datapath. Where the plan splits K, the
call uses its stream's workspace (:func:`_workspace`), made once per
stream and shared by every GEMM and conv on it.

The gradient (:class:`_GemmGrad`, the training path's; the JAX kernels
have none: JAX trains on XLA's dot). When an operand requires grad,
:func:`gemm` runs the float datapath through a ``torch.autograd.Function``
whose backward products, ``dA = dC @ B^T`` and ``dB = A^T @ dC``, fp32
accumulation, each output in its operand's dtype (JAX's grads take the
parameter's dtype), run on the backward kernel (``csrc/hgemm_bwd.cuh``,
:func:`_gemm_bwd`) where :func:`bwd_route` admits them: 16-bit operands
read in place by their strides, dB written in its parameter's layout.
The rest run the forward kernels: dA with B^T read through
:func:`_b_layout`, dB as ``A^T @ dC`` or ``(dC^T @ A)^T``, whichever
copies fewer bytes (the forward kernels read A row-major). The bias's
gradient is dC summed over rows in fp32. The output
rounding passes the gradient straight through, as JAX's ``astype``
transposes. A shift, an activation or an integer datapath has no
derivative here and raises ``NotImplementedError`` under grad. On the CPU
the same Function runs the plain versions; on the card it launches only
kernels. :func:`gemm_tape` lets the training forward's ``dots`` remat
policy keep the GEMM outputs instead of recomputing them.

A call may name its plan (``plan={"tile": code, "splits": s}``, the
tuner's schedule; :func:`gemm_plan` lists the tile codes); with none it
runs the plan of its shape, unless ``GEMMINI_TUNE`` is ``cached`` or
``full``, where the tuner resolves one per shape (memoized, so a call
pays a dict lookup; ``off`` never imports it). A plan the kernel cannot
run raises; nothing is clamped or replaced. Split sums change their
order with the plan, so a float plan is held by the same tolerances as
the static one; int32 sums wrap and stay bit for bit.

Launch counts, one per kernel of the ``kernels`` report:
``gemm.launches`` the bf16 kernel in OS order (the serving path's),
``gemm_os.launches`` the int8 kernel in OS order,
``OS_COUNTS[dtype].launches`` the fp32 / fp16 / int16 / int32 kernel in OS
order,
``gemm_ws.launches`` any of them in WS order,
``BWD_COUNT.launches`` either backward product, any float datapath
(``gemm[bwd]``; ``BWD_COUNT.persistent`` those on the backward kernel),
``accumulator_epilogue.launches``; :func:`_gemm_any`'s conversions and
generic epilogue count in ``datapath.convert`` and
``datapath.epilogue_any``, its product in its main loop's count.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import flags
from repro_torch.core.config import Activation, Dataflow
from repro_torch.core.dtensor import require_local
from repro_torch.kernels import _build
from repro_torch.kernels import datapath as dp
from repro_torch.kernels.contracts import kernel_contract
from repro_torch.kernels import epilogue as epi
from repro_torch.kernels.ref import gemm_ref, product_dtypes

_ACT = {Activation.NONE: 0, Activation.RELU: 1, Activation.RELU6: 2,
        Activation.GELU: 3, Activation.SILU: 4}
# Float input / output codes and integer output codes of the C interface;
# gemm_plan's input codes add int16.
_DT = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_INT_OUT = {torch.int32: 0, torch.int8: 1, torch.int16: 2}
_PLAN_DT = {**_DT, torch.int16: 3}
# The integer inputs and their kernels' libraries: (library, entry point).
_INT_IN = {torch.int8: ("gemm", "gemm_s8_launch"),
           torch.int16: ("gemm16", "gemm_s16_launch"),
           torch.int32: ("datapath", "gemm_s32_launch")}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_FLOAT_ARGS = [_P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _L, _I, _I, _I, _F, _I,
               _P, _P, _I, _I]
_S8_ARGS = [_P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _L, _I, _I, _I, _I, _P,
            _P, _I, _I]
_F16_ARGS = [_P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _L, _I, _I, _F, _I, _P,
             _P, _I, _I]
_EPI_ARGS = [_P, _P, _L, _I, _I, _I, _I, _F, _P]


def _b_layout(b: torch.Tensor):
    """(b, transposed, ldb): B as row-major (K, N), or read as the
    transpose of a row-major (N, K) buffer, whichever its strides are."""
    if b.stride(1) == 1:
        return b, 0, b.stride(0)
    if b.stride(0) == 1:
        return b, 1, b.stride(1)
    b = b.contiguous()
    return b, 0, b.stride(0)


_PLAN_KEYS = ("regime", "bm", "bn", "bk", "splits", "blocks", "threads",
              "stages", "smem", "workspace_words", "tile_code")
_REGIMES = ("skinny", "wide", "fp32", "square")
_PLANS: Dict[tuple, dict] = {}
_WORKSPACE: Dict[Tuple[int, int], torch.Tensor] = {}


def _plan_dict(raw: dict, regimes: tuple) -> dict:
    return {"regime": regimes[raw["regime"]],
            "tile": (raw["bm"], raw["bn"], raw["bk"]),
            "splits": raw["splits"], "grid": raw["blocks"],
            "threads": raw["threads"], "stages": raw["stages"],
            "smem": raw["smem"],
            "workspace_bytes": 4 * raw["workspace_words"],
            "tile_code": raw["tile_code"]}


def gemm_plan(m: int, n: int, k: int, b_trans: bool = False,
              device=None, dtype: torch.dtype = torch.bfloat16, *,
              tile: int = 0, splits: int = 0) -> dict:
    """The kernel's plan for an (M, N, K) call on a card with ``dtype``
    inputs (bf16, fp16, fp32 or int16; int8 has :func:`gemm_s8_plan`), B
    row-major or (``b_trans``) read as the transpose of a row-major (N, K)
    buffer: ``regime`` (bf16 and fp16: "skinny", split-K ``mma.sync`` for
    M <= 16, or "wide", ``wgmma``; "fp32": CUDA-core FMAs; int16, the
    int8 tensor-core loop on byte planes: "skinny", 16 x 64 tiles of 4
    warps for M <= 16, or "square", 64 x 64 tiles of 8 warps, the int8
    plan of :func:`gemm_s8_plan` over 2 K bytes), ``tile`` (rows, columns,
    k per stage), ``splits`` of K, ``grid`` (blocks), ``threads`` per
    block, ``stages`` of the load ring (bf16 / fp16 skinny: 1, loads go
    straight to registers), ``smem`` bytes and ``workspace_bytes`` (tickets
    and partials; 0 for one split and for every wide plan, whose splits
    merge within a cluster), and ``tile_code``. It depends on the shape, B's
    layout and the card's SM count only, so OS and WS take the same plan.

    ``tile`` and ``splits`` name another plan (both 0: the shape's own):
    tile codes bf16 / fp16 1 skinny (M <= 16), 2-5 the wide tiles 128 x 64,
    128 x 128, 128 x 256, 64 x 256 (M > 16); fp32 1 and 2 for 64- and
    128-row tiles; int16 1 skinny, 2 square (any M). A plan the kernel
    cannot run (more splits than its k steps or than it merges, a wide
    cluster the card cannot hold) raises ``RuntimeError``."""
    if dtype not in _PLAN_DT:
        raise NotImplementedError(f"gemm_plan: no kernel plan for {dtype}")
    index = _device_index(device)
    key = (m, n, k, bool(b_trans), index, dtype, tile, splits)
    plan = _PLANS.get(key)
    if plan is None:
        out = (ctypes.c_longlong * len(_PLAN_KEYS))()
        fn = _build.bind("gemm", "gemm_plan", [_I] * 7 + [_P])
        with torch.cuda.device(index):
            _build.check(fn(m, n, k, int(bool(b_trans)), _PLAN_DT[dtype],
                            int(tile), int(splits), ctypes.addressof(out)),
                         "gemm_plan")
        plan = _PLANS[key] = _plan_dict(dict(zip(_PLAN_KEYS, out)),
                                        _REGIMES)
    return plan


_S32_PLANS: Dict[tuple, dict] = {}


def gemm_s32_plan(m: int, n: int, k: int, b_trans: bool = False,
                  device=None, *, tile: int = 0, splits: int = 0) -> dict:
    """The int32 kernel's plan (``csrc/datapath.cu`` on ``sgemm.cuh``:
    fp32's tiles and K splits, int32 multiply-adds modulo 2^32), as
    :func:`gemm_plan` reports one; tile codes 1 and 2 (64- and 128-row
    tiles)."""
    index = _device_index(device)
    key = (m, n, k, bool(b_trans), index, tile, splits)
    plan = _S32_PLANS.get(key)
    if plan is None:
        out = (ctypes.c_longlong * len(_PLAN_KEYS))()
        fn = _build.bind("datapath", "gemm_s32_plan", [_I] * 6 + [_P])
        with torch.cuda.device(index):
            _build.check(fn(m, n, k, int(bool(b_trans)), int(tile),
                            int(splits), ctypes.addressof(out)),
                         "gemm_s32_plan")
        plan = _S32_PLANS[key] = _plan_dict(dict(zip(_PLAN_KEYS, out)),
                                            _REGIMES)
    return plan


def direct(a_dtype: torch.dtype, b_dtype: torch.dtype, acc_dtype: torch.dtype,
           out_dtype: torch.dtype, activation: Activation) -> bool:
    """Whether one kernel computes this datapath with its epilogue fused:
    inputs of one dtype, int8 / int16 / int32 into a wrapping int32 and
    out int8, int16 or int32 (no GELU), or bf16 / fp16 / fp32 into fp32
    and out bf16, fp16 or fp32. Every other combination JAX accepts runs
    :func:`_gemm_any`."""
    if a_dtype != b_dtype:
        return False
    if a_dtype in _INT_IN:
        return acc_dtype == torch.int32 and out_dtype in _INT_OUT and \
            activation is not Activation.GELU
    return a_dtype in _DT and acc_dtype == torch.float32 and out_dtype in _DT


def loop_dtype(a_dtype: torch.dtype, b_dtype: torch.dtype,
               dot: torch.dtype) -> torch.dtype:
    """The main loop a product summed in ``dot`` runs on: ``dot`` itself,
    but integer inputs keep the wider input's loop (an int8 or int16 sum
    wrapped to ``dot``'s width is the int32 sum wrapped)."""
    if not (dot.is_floating_point or a_dtype.is_floating_point or
            b_dtype.is_floating_point):
        return max(a_dtype, b_dtype, key=lambda t: torch.iinfo(t).bits)
    return dot


def _gemm_any(a: torch.Tensor, b: torch.Tensor, d: Optional[torch.Tensor],
              *, acc_dtype: torch.dtype, out_dtype: torch.dtype, shift: int,
              activation: Activation, ws: bool,
              plan: Optional[dict]) -> torch.Tensor:
    """A combination no kernel fuses (``csrc/datapath.cu``): the inputs
    converted to their main loop's dtype where they are not (mechanism
    (d)), the product's wide sum on that loop ((a), or (b) for int32), the
    generic epilogue ((c)). Two to four launches, each counted."""
    dot = product_dtypes(a.dtype, b.dtype, acc_dtype)
    loop = loop_dtype(a.dtype, b.dtype, dot)
    wide = torch.float32 if loop.is_floating_point else torch.int32
    a = dp.convert(a, loop)
    b = dp.convert(b, loop)
    s = _gemm(a, b, None, acc_dtype=wide, out_dtype=wide, shift=0,
              activation=Activation.NONE, ws=ws, plan=plan)
    return dp.epilogue_any(s, dot, acc_dtype, d, out_dtype, shift,
                           activation)


_S8_REGIMES = ("skinny", "square")
_S8_PLANS: Dict[tuple, dict] = {}


def _device_index(device) -> int:
    if device is None:
        return torch.cuda.current_device()
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def gemm_s8_plan(m: int, n: int, k: int, b_trans: bool = False,
                 device=None, *, tile: int = 0, splits: int = 0) -> dict:
    """The int8 kernel's plan (``csrc/igemm.cuh``) for an (M, N, K) call on
    a card, B row-major or (``b_trans``) read as the transpose of a
    row-major (N, K) buffer: ``regime`` ("skinny": 16 x 64 tiles of 4
    warps for M <= 16, "square": 64 x 64 tiles of 8 warps), ``tile``
    (rows, columns, k per stage), ``splits`` of K, ``grid`` (blocks),
    ``threads`` per block, ``stages`` of the cp.async ring, ``smem`` bytes
    and ``workspace_bytes`` (tickets and int32 partials, 0 for one split).
    It depends on the shape, B's layout and the card's SM count only, so
    OS and WS take the same plan and sum every tile alike; a conv's plan is
    that of its implicit GEMM, (N*OH*OW, CO, KH*KW*CI), B row-major.
    ``tile`` (1 skinny, 2 square, at any M) and ``splits`` name another
    plan, as for :func:`gemm_plan` (``tile_code``)."""
    index = _device_index(device)
    key = (m, n, k, bool(b_trans), index, tile, splits)
    plan = _S8_PLANS.get(key)
    if plan is None:
        out = (ctypes.c_longlong * len(_PLAN_KEYS))()
        fn = _build.bind("gemm", "gemm_s8_plan", [_I] * 6 + [_P])
        with torch.cuda.device(index):
            _build.check(fn(m, n, k, int(bool(b_trans)), int(tile),
                            int(splits), ctypes.addressof(out)),
                         "gemm_s8_plan")
        plan = _S8_PLANS[key] = _plan_dict(dict(zip(_PLAN_KEYS, out)),
                                           _S8_REGIMES)
    return plan


def _workspace(device: torch.device, stream: int, nbytes: int):
    """The calling stream's workspace, at least ``nbytes``: tickets then
    partials. Made zeroed once per stream (and again only to grow); the
    kernel leaves every ticket at 0, so a call needs no memset, and two
    streams never share a ticket."""
    key = (device.index, stream)
    buf = _WORKSPACE.get(key)
    if buf is None or buf.numel() * 4 < nbytes:
        words = max(nbytes // 4, 2 * buf.numel() if buf is not None else 0)
        buf = torch.zeros(words, dtype=torch.int32, device=device)
        _WORKSPACE[key] = buf
    return buf


def _check_int_shift(shift: int) -> None:
    if not 0 <= shift <= 31:
        raise ValueError(f"int32 rounding shift must be in [0, 31], got {shift}")


@kernel_contract("gemm", "gemm_s8")
def _gemm(a: torch.Tensor, b: torch.Tensor, d: Optional[torch.Tensor], *,
          acc_dtype: torch.dtype, out_dtype: torch.dtype, shift: int,
          activation: Activation, ws: bool, bwd: bool = False,
          plan: Optional[dict] = None) -> torch.Tensor:
    """The plain version for a CPU tensor; else the kernel of this datapath
    in OS or WS order (or an error). ``bwd``: a backward product, counted
    in ``BWD_COUNT``. ``plan``: the caller's ``{"tile", "splits"}``, else
    the tuner's under ``cached`` / ``full``, else the shape's own."""
    require_local("gemm_ws" if ws else "gemm", a, b, d)
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
    product_dtypes(a.dtype, b.dtype, acc_dtype)    # TypeError where JAX's
    if not acc_dtype.is_floating_point:
        epi.check_int_activation(activation)
        _check_int_shift(shift)
    if not direct(a.dtype, b.dtype, acc_dtype, out_dtype, activation):
        return _gemm_any(a, b, d, acc_dtype=acc_dtype, out_dtype=out_dtype,
                         shift=shift, activation=activation, ws=ws,
                         plan=plan)
    integer = a.dtype in _INT_IN
    a = a.contiguous()
    b, trans, ldb = _b_layout(b)
    ldd = 0
    if d is not None:
        d = dp.convert(d, acc_dtype)
        if d.dim() == 2 and d.shape[0] == m and m > 1:
            d = d.expand(m, n).contiguous()
            ldd = n
        else:
            d = d.reshape(n).contiguous()
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    stream = torch.cuda.current_stream(a.device).cuda_stream
    dptr = d.data_ptr() if d is not None else None
    if plan is None and flags.get("tune_mode") != "off" and \
            a.dtype != torch.int32:
        from repro_torch.tune import tuner
        plan = tuner.gemm_schedule(a.dtype, acc_dtype, out_dtype, ws, m, n,
                                   k, d is not None, bool(trans), a.device)
    tile, splits = (plan["tile"], plan["splits"]) if plan else (0, 0)
    if a.dtype == torch.int8:
        plan = _S8_PLANS.get((m, n, k, bool(trans), a.device.index, tile,
                              splits)) \
            or gemm_s8_plan(m, n, k, trans, a.device, tile=tile,
                            splits=splits)
    elif a.dtype == torch.int32:
        plan = _S32_PLANS.get((m, n, k, bool(trans), a.device.index, tile,
                               splits)) \
            or gemm_s32_plan(m, n, k, trans, a.device, tile=tile,
                             splits=splits)
    else:
        plan = _PLANS.get((m, n, k, bool(trans), a.device.index, a.dtype,
                           tile, splits)) \
            or gemm_plan(m, n, k, trans, a.device, a.dtype, tile=tile,
                         splits=splits)
    need = plan["workspace_bytes"]
    wsp = _workspace(a.device, stream, need).data_ptr() if need else None
    scale = 1.0 / (1 << shift) if shift > 0 else 1.0
    if integer:
        fn = _build.bind(*_INT_IN[a.dtype], _S8_ARGS)
        err = fn(a.data_ptr(), b.data_ptr(), dptr, c.data_ptr(), m, n, k,
                 a.stride(0), ldb, trans, ldd, _INT_OUT[out_dtype],
                 _ACT[activation], shift, int(ws), stream, wsp, tile, splits)
    elif a.dtype == torch.float16:
        fn = _build.bind("gemm16", "gemm_f16_launch", _F16_ARGS)
        err = fn(a.data_ptr(), b.data_ptr(), dptr, c.data_ptr(), m, n, k,
                 a.stride(0), ldb, trans, ldd, _DT[out_dtype],
                 _ACT[activation], scale, int(ws), stream, wsp, tile, splits)
    else:
        fn = _build.bind("gemm", "gemm_launch", _FLOAT_ARGS)
        err = fn(a.data_ptr(), b.data_ptr(), dptr, c.data_ptr(), m, n, k,
                 a.stride(0), ldb, trans, ldd, _DT[a.dtype], _DT[out_dtype],
                 _ACT[activation], scale, int(ws), stream, wsp, tile, splits)
    _build.check(err, "gemm_ws" if ws else "gemm")
    if bwd:
        BWD_COUNT.launches += 1
    elif ws:
        gemm_ws.launches += 1
    elif a.dtype == torch.int8:
        gemm_os.launches += 1
    elif a.dtype in OS_COUNTS:
        OS_COUNTS[a.dtype].launches += 1
    else:
        gemm.launches += 1
    return c


def gemm_os(a: torch.Tensor, b: torch.Tensor, d: Optional[torch.Tensor] = None,
            *, acc_dtype: torch.dtype, out_dtype: torch.dtype, shift: int = 0,
            activation: Activation = Activation.NONE,
            plan: Optional[dict] = None) -> torch.Tensor:
    """Output-stationary GEMM. a: (M, K); b: (K, N) with any strides; d:
    bias broadcastable to (M, N) (a (N,) / (1, N) row or a full (M, N)
    matrix), cast to the accumulator dtype; ``plan``: the caller's
    ``{"tile", "splits"}`` (module docstring)."""
    return _gemm(a, b, d, acc_dtype=acc_dtype, out_dtype=out_dtype,
                 shift=shift, activation=activation, ws=False, plan=plan)


def gemm_ws(a: torch.Tensor, b: torch.Tensor, d: Optional[torch.Tensor] = None,
            *, acc_dtype: torch.dtype, out_dtype: torch.dtype, shift: int = 0,
            activation: Activation = Activation.NONE,
            plan: Optional[dict] = None) -> torch.Tensor:
    """Weight-stationary GEMM: the same function as :func:`gemm_os` (equal
    bit for bit on every datapath), the kernel walking the grid
    weight-major."""
    return _gemm(a, b, d, acc_dtype=acc_dtype, out_dtype=out_dtype,
                 shift=shift, activation=activation, ws=True, plan=plan)


def gemm(a: torch.Tensor, b: torch.Tensor, d: Optional[torch.Tensor] = None,
         *, acc_dtype: torch.dtype, out_dtype: torch.dtype, shift: int = 0,
         activation: Activation = Activation.NONE,
         dataflow: Dataflow = Dataflow.OS) -> torch.Tensor:
    """Dispatch on a resolved dataflow (OS or WS; ``ctx.gemm`` resolves a
    BOTH instance's and refuses the other dataflow of a single-dataflow
    one). Under grad (an operand requires it) the call goes through
    :class:`_GemmGrad`."""
    if dataflow is Dataflow.BOTH:
        raise ValueError("gemm: pass a resolved dataflow, OS or WS")
    ws = dataflow is Dataflow.WS
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, d)):
        if not acc_dtype.is_floating_point or shift or \
                activation is not Activation.NONE:
            raise NotImplementedError(
                f"gemm: no gradient through acc {acc_dtype}, shift {shift}, "
                f"activation {activation.name}; the training path runs the "
                f"float datapath with neither")
        return _GemmGrad.apply(a, b, d, acc_dtype, out_dtype, ws)
    fn = gemm_ws if ws else gemm_os
    return fn(a, b, d, acc_dtype=acc_dtype, out_dtype=out_dtype, shift=shift,
              activation=activation)


# The dots remat policy's record of GEMM outputs: ("record", list) while a
# checkpointed block runs forward, ("replay", deque) while it is
# recomputed; None otherwise.
_TAPE: Optional[Tuple[str, collections.deque]] = None


@contextlib.contextmanager
def _taping(mode: str, tape: collections.deque):
    global _TAPE
    prev, _TAPE = _TAPE, (mode, tape)
    try:
        yield
    finally:
        _TAPE = prev


def gemm_tape():
    """A ``context_fn`` for ``torch.utils.checkpoint.checkpoint``: the
    forward context records each differentiable GEMM's output, the
    recompute context hands them back in order instead of launching (JAX's
    ``dots_with_no_batch_dims_saveable``: the products are saved, the
    elementwise work is recomputed)."""
    tape: collections.deque = collections.deque()
    return _taping("record", tape), _taping("replay", tape)


_BWD_PLAN_KEYS = ("bm", "bn", "bk", "stages", "threads", "smem", "tiles_m",
                  "tiles_n", "ksteps", "dp_tiles", "sk_tiles", "splits",
                  "sk_blocks", "grid", "workspace_words")
_BWD_PLANS: Dict[tuple, dict] = {}
_BWD_ARGS = [_P, _P, _P, _I, _I, _I, _L, _L, _L, _I, _I, _P, _P]
# the backward kernel's entry points by operand dtype: (library, launch)
_BWD_LIBS = {torch.bfloat16: ("gemm_bwd", "gemm_bwd_launch"),
             torch.float16: ("gemm_bwd16", "gemm_bwd_f16_launch")}


def gemm_bwd_plan(m: int, n: int, k: int, device=None) -> dict:
    """The backward kernel's plan (``csrc/hgemm_bwd.cuh``) for an (M, N, K)
    product on a card: ``tile`` (128 rows, 192 or 128 columns, 64 k a
    stage), ``stages``, ``threads``, ``smem`` bytes, ``tiles`` (M, N),
    ``ksteps``, ``dp_tiles`` (whole waves, block g taking tiles g, g + G,
    ...), ``sk_tiles`` (the rest, each in ``splits`` equal k ranges, one a
    stream-K block: ``sk_blocks``), ``grid`` and ``workspace_bytes``
    (flags, then a partial tile a stream-K block, where a tile is split).
    It depends on the shape and the card's SM count only; the same for
    bf16 and fp16 and every operand layout. A product past the kernel's
    limits raises ``RuntimeError``."""
    index = _device_index(device)
    key = (m, n, k, index)
    plan = _BWD_PLANS.get(key)
    if plan is None:
        out = (ctypes.c_longlong * len(_BWD_PLAN_KEYS))()
        fn = _build.bind("gemm_bwd", "gemm_bwd_plan", [_I] * 3 + [_P])
        with torch.cuda.device(index):
            _build.check(fn(m, n, k, ctypes.addressof(out)),
                         "gemm_bwd_plan")
        raw = dict(zip(_BWD_PLAN_KEYS, out))
        plan = _BWD_PLANS[key] = {
            "tile": (raw["bm"], raw["bn"], raw["bk"]),
            "stages": raw["stages"], "threads": raw["threads"],
            "smem": raw["smem"], "tiles": (raw["tiles_m"], raw["tiles_n"]),
            "ksteps": raw["ksteps"], "dp_tiles": raw["dp_tiles"],
            "sk_tiles": raw["sk_tiles"], "splits": raw["splits"],
            "sk_blocks": raw["sk_blocks"],
            "grid": raw["grid"],
            "workspace_bytes": 4 * raw["workspace_words"]}
    return plan


def _major(t: torch.Tensor):
    """(t, trans, ld) of a 2-D operand read by its strides: row-major
    (``t[i, j]`` at ``i * ld + j``; an A operand K-major, a B operand
    N-major), or ``trans``, the transpose of a row-major buffer (at ``j *
    ld + i``; an A operand M-major, a B operand K-major); a tensor with
    neither unit stride is made contiguous."""
    if t.stride(1) == 1:
        return t, False, t.stride(0)
    if t.stride(0) == 1:
        return t, True, t.stride(1)
    t = t.contiguous()
    return t, False, t.stride(0)


def bwd_route(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> str:
    """Which kernel runs a backward product ``a @ b`` into ``dtype`` on the
    card, by dtype, shape and strides alone: "persistent" (``csrc/
    hgemm_bwd.cuh``: 16-bit operands of one dtype written in it, more than
    16 rows, each operand a unit stride on one dim and its rows, and the
    output's, whole 16-byte words on a 16-byte boundary, so that tensor
    maps describe them), else "forward" (the forward kernels through
    :func:`_gemm`: M <= 16 on the skinny kernel, rows off 16 bytes, such
    as a vocab of 49155, on the wide kernel's cp.async ring, fp32 on the
    CUDA-core kernel)."""
    if a.dtype not in _BWD_LIBS or b.dtype != a.dtype or dtype != a.dtype \
            or a.shape[0] <= 16 or a.shape[1] < 1 or b.shape[1] < 1 or \
            b.shape[1] % 8:
        return "forward"
    for t in (a, b):
        if t.stride(0) != 1 and t.stride(1) != 1 or \
                _major(t)[2] % 8 or t.data_ptr() % 16:
            return "forward"
    return "persistent"


@kernel_contract("gemm_bwd")
def _gemm_bwd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B on the backward kernel (``bwd_route`` "persistent"):
    16-bit operands read in place by their strides, fp32 sums, C (M, N)
    contiguous in the operands' dtype. A CUDA launch, or an error."""
    require_local("gemm_bwd", a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"gemm_bwd: no kernel for {a.device} / {b.device}")
    m, k = a.shape
    n = b.shape[1]
    a, a_mn, lda = _major(a)
    b, b_k, ldb = _major(b)
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    need = gemm_bwd_plan(m, n, k, a.device)["workspace_bytes"]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    wsp = _workspace(a.device, stream, need).data_ptr() if need else None
    fn = _build.bind(*_BWD_LIBS[a.dtype], _BWD_ARGS)
    err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, lda, ldb, n,
             int(a_mn), int(b_k), stream, wsp)
    _build.check(err, "gemm_bwd")
    BWD_COUNT.launches += 1
    BWD_COUNT.persistent += 1
    return c


def grad_a(dc: torch.Tensor, b: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """dA = dC @ B^T, fp32 sums, written in ``dtype``. On the card a 16-bit
    product runs the backward kernel (:func:`bwd_route`), which reads dC
    and B^T by their strides: a row-major weight as its transpose, the tied
    unembedding's ``table.T`` as the row-major table; the rest runs the
    forward kernels, B^T read through :func:`_b_layout` (no copy but a
    non-contiguous dC)."""
    if dc.device.type == "cuda" and bwd_route(dc, b.t(), dtype) == \
            "persistent":
        return _gemm_bwd(dc, b.t())
    return _gemm(dc, b.t(), None, acc_dtype=torch.float32, out_dtype=dtype,
                 shift=0, activation=Activation.NONE, ws=False, bwd=True)


def grad_b(a: torch.Tensor, dc: torch.Tensor, dtype: torch.dtype,
           trans: bool = False) -> torch.Tensor:
    """dB = A^T @ dC, fp32 sums, written in ``dtype``. On the card a 16-bit
    product runs the backward kernel (:func:`bwd_route`), which reads A^T
    and dC in place and writes dB in its parameter's layout: row-major, or
    (``trans``: B was the transpose of a row-major buffer, the tied
    unembedding's ``table.T``) as the transpose of a row-major (N, K)
    buffer, computed as dC^T @ A. Nothing is copied. The rest (and the
    plain version on the CPU) runs the forward kernels, which read their A
    operand row-major, so either A^T (M x K elements) or dC^T (M x N) is
    copied: A^T @ dC where K <= N, else (dC^T @ A)^T."""
    if a.device.type == "cuda":
        if trans and bwd_route(dc.t(), a, dtype) == "persistent":
            return _gemm_bwd(dc.t(), a).t()
        if not trans and bwd_route(a.t(), dc, dtype) == "persistent":
            return _gemm_bwd(a.t(), dc)
    kw = dict(acc_dtype=torch.float32, out_dtype=dtype, shift=0,
              activation=Activation.NONE, ws=False, bwd=True)
    if a.shape[1] <= dc.shape[1]:
        return _gemm(a.t(), dc, None, **kw)
    return _gemm(dc.t(), a, None, **kw).t()


class _GemmGrad(torch.autograd.Function):
    """C = A @ B (+ D), fp32 accumulation, rounded to ``out_dtype``; the
    backward products on the same kernels (module docstring)."""

    @staticmethod
    def forward(ctx, a, b, d, acc_dtype, out_dtype, ws):
        ctx.save_for_backward(a, b)
        ctx.d_shape = None if d is None else (d.shape, d.dtype)
        if _TAPE is not None and _TAPE[0] == "replay" and _TAPE[1]:
            return _TAPE[1].popleft()
        c = _gemm(a, b, d, acc_dtype=acc_dtype, out_dtype=out_dtype,
                  shift=0, activation=Activation.NONE, ws=ws)
        if _TAPE is not None and _TAPE[0] == "record":
            _TAPE[1].append(c.detach())
        return c

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        need_a, need_b, need_d = ctx.needs_input_grad[:3]
        # the output rounding transposes to a cast; widening is exact
        dc = dc.to(a.dtype)
        da = grad_a(dc, b, a.dtype) if need_a else None
        db = grad_b(a, dc, b.dtype, trans=b.stride(0) == 1 and
                    b.stride(1) != 1) if need_b else None
        dd = None
        if need_d:
            shape, dtype = ctx.d_shape
            if len(shape) == 2 and shape[0] == dc.shape[0] and shape[0] > 1:
                dd = dc.to(dtype)
            else:
                dd = dc.to(torch.float32).sum(0).reshape(shape).to(dtype)
        return da, db, dd, None, None, None


_EPI_PLAN_KEYS = ("blocks", "threads", "head", "runs", "tail", "packed")


def epilogue_plan(count: int, acc_dtype: torch.dtype, out_dtype: torch.dtype,
                  acc_addr: int = 0, out_addr: int = 0, device=None) -> dict:
    """The mvout epilogue's launch for ``count`` values of an int32 or fp32
    accumulator at device address ``acc_addr`` into ``out_dtype`` at
    ``out_addr`` (only their residues modulo 16 matter): ``blocks``,
    ``threads``, ``head`` (values before the first 16-byte-aligned
    accumulator address), ``runs`` of four, ``tail`` values and
    ``packed`` (1 where the runs store four outputs at once)."""
    if acc_dtype == torch.int32:
        codes = (0, _INT_OUT[out_dtype])
    else:
        codes = (1, _DT[out_dtype])
    out = (ctypes.c_longlong * len(_EPI_PLAN_KEYS))()
    fn = _build.bind("gemm", "epilogue_plan",
                     [_L, _I, _I, ctypes.c_ulonglong, ctypes.c_ulonglong, _P])
    with torch.cuda.device(_device_index(device)):
        _build.check(fn(int(count), *codes, int(acc_addr), int(out_addr),
                        ctypes.addressof(out)), "epilogue_plan")
    return dict(zip(_EPI_PLAN_KEYS, out))


@kernel_contract("accumulator_epilogue")
def accumulator_epilogue(acc: torch.Tensor, *, out_dtype: torch.dtype,
                         shift: int = 0,
                         activation: Activation = Activation.NONE
                         ) -> torch.Tensor:
    """The mvout path: rounding shift, activation and saturation over a raw
    accumulator of any shape and any dtype of the table into any output:
    int32 -> int8 / int16 / int32 (no GELU) and fp32 -> fp32 / bf16 / fp16
    on the packed mvout kernel, every other pair on the generic epilogue
    (:func:`repro_torch.kernels.datapath.epilogue_any`)."""
    require_local("accumulator_epilogue", acc)
    if acc.device.type == "cpu":
        return epi.apply(acc, shift=shift, activation=activation,
                         out_dtype=out_dtype)
    if acc.device.type != "cuda":
        raise ValueError(f"accumulator_epilogue: no kernel for device {acc.device}")
    if not acc.is_floating_point():
        epi.check_int_activation(activation)
        _check_int_shift(shift)
    if acc.dtype == torch.int32 and out_dtype in _INT_OUT and \
            activation is not Activation.GELU:
        acc_code, out_code = 0, _INT_OUT[out_dtype]
    elif acc.dtype == torch.float32 and out_dtype in _DT:
        acc_code, out_code = 1, _DT[out_dtype]
    else:
        return dp.epilogue_any(acc, acc.dtype, acc.dtype, None, out_dtype,
                               shift, activation)
    acc = acc.contiguous()
    c = torch.empty(acc.shape, dtype=out_dtype, device=acc.device)
    if acc.numel() == 0:
        return c
    fn = _build.bind("gemm", "epilogue_launch", _EPI_ARGS)
    err = fn(acc.data_ptr(), c.data_ptr(), acc.numel(), acc_code, out_code,
             _ACT[activation], shift,
             1.0 / (1 << shift) if shift > 0 else 1.0,
             torch.cuda.current_stream(acc.device).cuda_stream)
    _build.check(err, "accumulator_epilogue")
    accumulator_epilogue.launches += 1
    return c


gemm.launches = 0
gemm_os.launches = 0
gemm_ws.launches = 0
accumulator_epilogue.launches = 0
# The fp32, fp16, int16 and int32 kernels' launches in OS order (gemm_os
# and gemm run them; the kernels report names them gemm[fp32], gemm[fp16],
# gemm[int16] and gemm[int32]).
OS_COUNTS = {torch.float32: SimpleNamespace(launches=0),
             torch.float16: SimpleNamespace(launches=0),
             torch.int16: SimpleNamespace(launches=0),
             torch.int32: SimpleNamespace(launches=0)}
# Either backward product of :class:`_GemmGrad`, on any float datapath (the
# kernels report names it gemm[bwd]); ``persistent``: those of them on the
# backward kernel (``csrc/hgemm_bwd.cuh``).
BWD_COUNT = SimpleNamespace(launches=0, persistent=0)
