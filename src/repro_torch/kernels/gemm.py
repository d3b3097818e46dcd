"""Engine GEMM on both dataflows, and the mvout epilogue: the CUDA kernels
(``csrc/gemm.cu`` for int8, bf16 and fp32 inputs, ``csrc/gemm16.cu`` for
fp16 and int16 inputs; main loops in ``csrc/hgemm.cuh`` (bf16, fp16),
``csrc/sgemm.cuh`` (fp32) and ``csrc/igemm.cuh`` (int8, int16)) and their
plain versions.

Replaces ``repro.kernels.gemm``: ``gemm_os``, ``gemm_ws``,
``accumulator_epilogue`` and the dataflow dispatch ``gemm``. The GEMMs
compute ``C = act(round_shift(A @ B + D))`` on every datapath a Gemmini
instance of the dtype table elaborates: float inputs (bf16, fp16, fp32)
accumulate in fp32 and store bf16, fp16 or fp32 (rounded to nearest even;
an fp16 overflow stores +-inf, as JAX's ``astype`` does); integer inputs
(int8, int16) accumulate in a wrapping int32 (the bias added once, modulo
2^32 like every int32 add of the kernel) and saturate to int8 or int16, or
store int32. Other combinations (int32 inputs, another accumulator, mixed
input dtypes) raise ``NotImplementedError`` on the card. A CUDA tensor
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
whose backward products run on the same kernels, fp32 accumulation, each
output in its operand's dtype (JAX's grads take the parameter's dtype):
``dA = dC @ B^T``, with B^T read through :func:`_b_layout` (no copy), and
``dB = A^T @ dC``, or ``(dC^T @ A)^T`` where that copies fewer bytes (the
kernel reads A row-major, so A^T or dC^T is made contiguous: M x K
elements against M x N; the tied unembedding's dB, N = vocab, copies
A); the bias's gradient is dC summed over rows in fp32. The output
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
``OS_COUNTS[dtype].launches`` the fp32 / fp16 / int16 kernel in OS order,
``gemm_ws.launches`` any of them in WS order,
``BWD_COUNT.launches`` either backward product, any float datapath
(``gemm[bwd]``),
``accumulator_epilogue.launches``.
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
from repro_torch.kernels import _build
from repro_torch.kernels.contracts import kernel_contract
from repro_torch.kernels import epilogue as epi
from repro_torch.kernels.ref import gemm_ref

_ACT = {Activation.NONE: 0, Activation.RELU: 1, Activation.RELU6: 2,
        Activation.GELU: 3, Activation.SILU: 4}
# Float input / output codes and integer output codes of the C interface;
# gemm_plan's input codes add int16.
_DT = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_INT_OUT = {torch.int32: 0, torch.int8: 1, torch.int16: 2}
_PLAN_DT = {**_DT, torch.int16: 3}
# The integer inputs and their kernels' libraries: (library, entry point).
_INT_IN = {torch.int8: ("gemm", "gemm_s8_launch"),
           torch.int16: ("gemm16", "gemm_s16_launch")}

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
    if b.dtype != a.dtype:
        raise NotImplementedError(f"gemm kernel takes inputs of one dtype, "
                                  f"got {a.dtype} @ {b.dtype}")
    integer = a.dtype in _INT_IN
    if integer:
        if acc_dtype != torch.int32 or out_dtype not in _INT_OUT:
            raise NotImplementedError(
                f"{a.dtype} gemm kernel accumulates in int32 and writes int8, "
                f"int16 or int32, got acc {acc_dtype}, out {out_dtype}")
        epi.check_int_activation(activation)
        _check_int_shift(shift)
    elif a.dtype not in _DT:
        raise NotImplementedError(
            f"gemm kernel takes int8, int16, bf16, fp16 or fp32 inputs, got "
            f"{a.dtype}")
    elif acc_dtype != torch.float32 or out_dtype not in _DT:
        raise NotImplementedError(
            f"gemm kernel accumulates float inputs in fp32 and writes bf16, "
            f"fp16 or fp32, got acc {acc_dtype}, out {out_dtype}")
    a = a.contiguous()
    b, trans, ldb = _b_layout(b)
    ldd = 0
    if d is not None:
        d = d.to(acc_dtype)
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
    if plan is None and flags.get("tune_mode") != "off":
        from repro_torch.tune import tuner
        plan = tuner.gemm_schedule(a.dtype, acc_dtype, out_dtype, ws, m, n,
                                   k, d is not None, bool(trans), a.device)
    tile, splits = (plan["tile"], plan["splits"]) if plan else (0, 0)
    if a.dtype == torch.int8:
        plan = _S8_PLANS.get((m, n, k, bool(trans), a.device.index, tile,
                              splits)) \
            or gemm_s8_plan(m, n, k, trans, a.device, tile=tile,
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


def grad_a(dc: torch.Tensor, b: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """dA = dC @ B^T, fp32 sums, written in ``dtype``: B^T is read through
    :func:`_b_layout` (a row-major weight is read transposed, the tied
    unembedding's ``table.T`` row-major), so nothing is copied but a
    non-contiguous dC."""
    return _gemm(dc, b.t(), None, acc_dtype=torch.float32, out_dtype=dtype,
                 shift=0, activation=Activation.NONE, ws=False, bwd=True)


def grad_b(a: torch.Tensor, dc: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """dB = A^T @ dC, fp32 sums, written in ``dtype``. The kernel reads its
    A operand row-major, so either A^T (M x K elements) or dC^T (M x N) is
    copied: A^T @ dC where K <= N, else (dC^T @ A)^T."""
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
        db = grad_b(a, dc, b.dtype) if need_b else None
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
    accumulator of any shape (int32 -> int8 / int16 / int32, or fp32 ->
    fp32 / bf16 / fp16)."""
    if acc.device.type == "cpu":
        return epi.apply(acc, shift=shift, activation=activation,
                         out_dtype=out_dtype)
    if acc.device.type != "cuda":
        raise ValueError(f"accumulator_epilogue: no kernel for device {acc.device}")
    if acc.dtype == torch.int32:
        if out_dtype not in _INT_OUT:
            raise NotImplementedError(f"int32 accumulator -> {out_dtype}")
        epi.check_int_activation(activation)
        _check_int_shift(shift)
        acc_code, out_code = 0, _INT_OUT[out_dtype]
    elif acc.dtype == torch.float32:
        if out_dtype not in _DT:
            raise NotImplementedError(f"fp32 accumulator -> {out_dtype}")
        acc_code, out_code = 1, _DT[out_dtype]
    else:
        raise NotImplementedError(f"accumulator dtype {acc.dtype}")
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
# The fp32, fp16 and int16 kernels' launches in OS order (gemm_os and gemm
# run them; the kernels report names them gemm[fp32], gemm[fp16] and
# gemm[int16]).
OS_COUNTS = {torch.float32: SimpleNamespace(launches=0),
             torch.float16: SimpleNamespace(launches=0),
             torch.int16: SimpleNamespace(launches=0)}
# Either backward product of :class:`_GemmGrad`, on any float datapath (the
# kernels report names it gemm[bwd]).
BWD_COUNT = SimpleNamespace(launches=0)
