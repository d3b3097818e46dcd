"""Chunked Mamba-2 SSD (``csrc/ssd.cuh``) and its plain version.

Replaces ``repro.kernels.mamba2.ssd``. ``ssd`` launches the CUDA kernel for
CUDA tensors (or raises) and runs ``ssd_plain`` for CPU tensors;
``ssd.launches`` counts the calls that launched it.

``ssd_plain`` is the JAX package's XLA route: the model function
``repro_torch.models.ssm.ssd_chunked`` (the port of ``ssd_chunked_xla``,
which the training forward calls itself) plus ``_final_state``: per chunk
of ``q = min(chunk,
T)`` tokens an intra-chunk term ``(C B^T * L * dt) @ X`` with the decay
matrix ``L[i, j] = exp(seg_i - seg_j)`` masked before the exponential, a
carried-state term ``exp(seg) * (C @ S)``, the ``d_skip * x`` residual and
the inter-chunk scan over the (N, P) state; the final state comes from the
whole-sequence cumulative decay. ``initial_state`` resumes a previous
segment (chunked prefill).

On the card bf16 and fp16 inputs run the tensor-core kernel and fp32
inputs the CUDA-core kernel, each one launch per chunk of the sequence (a
serving call is one chunk); ``ssd.launches`` grows by one per call. fp16
inputs (``csrc/ssd16.cu``, ``csrc/ssd16_any.cu``) are read straight from
the caller's views like bf16's: the scores run on the fp16 MMA, every
other product splits its fp16 operand exactly into two bf16 terms (the
JAX kernel upcasts x, B and C to fp32 in its body), so the decay-weighted
scores, the carried state and its update keep fp32's range (a state past
65504 stays finite); y is rounded to fp16 in the kernel's store, the
states are fp32. ``F16_COUNT.launches`` counts its launches; such a call
launches no ``datapath.convert``. Mixed x / B / C dtypes run the fp32
kernel on operands widened by ``datapath.convert`` (exact), y written in
fp32 and rounded to x's dtype the same way (``MIXED_COUNT.launches``).

Every shape the JAX kernel takes runs on the card up to ``N_MAX``: a head
dim P the kernels do not compile runs as column slices of at most 64 on
the grid's z axis, and a chunk longer than ``SUB_CHUNK`` as consecutive
sub-chunks of ``SUB_CHUNK`` rows, the state carried between them (the same
function; only the grouping of the fp32 sums differs). A head dim of
``P_DIMS`` with N <= ``N_FIRST`` launches ``csrc/ssd.cu``'s instances
(fp16: ``ssd16.cu``), the code they were first written as; every other
shape ``csrc/ssd_any.cu``'s (``ssd16_any.cu``) (:func:`kernel_lib`).

One deliberate difference from the JAX dispatch (``ops.ssd_impl``): there,
a chunk that resumes from a carried state leaves the TPU kernel for the XLA
route, because the kernel's state scratch starts from zeros. The CUDA
kernels load the initial state instead, so a continuation chunk runs on
the card like a fresh prompt.
"""

from __future__ import annotations

import ctypes

import torch

from types import SimpleNamespace

from repro_torch.kernels import _build
from repro_torch.kernels import datapath as dp
from repro_torch.core.dtensor import require_local
from repro_torch.kernels.contracts import kernel_contract
from repro_torch.models.ssm import ssd_chunked

P_DIMS = (8, 16, 32, 64)        # slice widths the kernels are compiled for
N_MAX = 256                     # largest state size a block holds
N_FIRST = 128                   # ... ssd.cu's instances hold
SUB_CHUNK = 256                 # longest chunk one launch's scan holds
_DT = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_FLOATS = (torch.float32, torch.bfloat16, torch.float16)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------
def _final_state(x, dt, a_log, b, initial_state=None) -> torch.Tensor:
    """``repro.models.ssm._final_state``: the (B, H, N, P) fp32 state after
    the sequence; ``initial_state`` decays by the whole segment."""
    h = x.shape[2]
    hpg = h // b.shape[2]
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))
    seg = torch.cumsum(dt.to(f32) * a[None, None, :], dim=1)
    decay_to_end = torch.exp(seg[:, -1:, :] - seg)
    bh = b.to(f32).repeat_interleave(hpg, dim=2)
    state = torch.einsum("bth,bth,bthn,bthp->bhnp", decay_to_end, dt.to(f32),
                         bh, x.to(f32))
    if initial_state is not None:
        state = state + initial_state.to(f32) * \
            torch.exp(seg[:, -1, :])[:, :, None, None]
    return state


def ssd_plain(x, dt, a_log, b, c, *, d_skip=None, chunk: int = 256,
              initial_state=None, return_final_state: bool = False):
    """x (B, T, H, P), dt (B, T, H) softplus'd fp32, a_log (H,), b/c
    (B, T, G, N), head h on group h // (H // G); ``initial_state`` (B, H,
    N, P) fp32 or None (zeros). Returns y (B, T, H, P) in x's dtype [and the
    final (B, H, N, P) fp32 state]. Sums run in fp32."""
    y = ssd_chunked(x, dt, a_log, b, c, d_skip=d_skip, chunk=chunk,
                     initial_state=initial_state)
    if not return_final_state:
        return y
    return y, _final_state(x, dt, a_log, b, initial_state=initial_state)


def split_f16(x: torch.Tensor):
    """fp16 values as two bf16 terms (hi, lo) whose fp32 sum is the value
    exactly: hi the nearest bf16 (ties to even), lo the remainder, itself a
    bf16 (at most four of fp16's ulps, in fp32's exponent range). What the
    fp16 SSD kernel does to each fp16 operand fragment before a bf16 MMA
    (``csrc/ssd.cuh`` split_f16)."""
    f = x.float()
    hi = f.to(torch.bfloat16)
    return hi, (f - hi.float()).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------
def _inner_contiguous(t: torch.Tensor) -> torch.Tensor:
    """The kernel reads (B, T, heads, width) operands by their strides but
    wants the innermost axis packed."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _rows16(*ts: torch.Tensor) -> bool:
    """Whether every row of each (B, T, heads, width) operand starts on 16
    bytes and spans whole 16-byte words, so the kernels copy rows with
    16-byte ``cp.async`` (else element by element)."""
    return all(t.data_ptr() % 16 == 0 and
               t.shape[-1] * t.element_size() % 16 == 0 and
               all(st * t.element_size() % 16 == 0 for st in t.stride()[:-1])
               for t in ts)


_PLAN_KEYS = ("chunks", "threads", "smem", "cluster", "out_blocks",
              "state_blocks", "first_blocks", "last_blocks", "rows",
              "scratch_words", "slices")


def ssd_plan(bsz: int, t: int, h: int, g: int, n: int, p: int, chunk: int,
             dtype: torch.dtype = torch.bfloat16,
             final_state: bool = False, device=None) -> dict:
    """The launches an :func:`ssd` call of this ``chunk`` makes, one per
    sub-chunk of ``launch_chunk(chunk, t)`` rows: threads, dynamic shared
    memory bytes and blocks per cluster of each, the output and state
    blocks of a whole sub-chunk, the first and last one's blocks per grid
    row and column slice, the grid rows, the scratch's fp32 words and the
    column slices (the grid's z). ``dtype``: the kernel's
    (:func:`kernel_dtype`)."""
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    fn = _build.bind(kernel_lib(p, n, dtype), "ssd_plan", [_I] * 9 + [_P])
    with torch.cuda.device(device if device is not None
                           else torch.cuda.current_device()):
        _build.check(fn(bsz, t, h, g, n, p, launch_chunk(chunk, t), _DT[dtype],
                        int(bool(final_state)), ctypes.addressof(out)),
                     "ssd_plan")
    return dict(zip(_PLAN_KEYS, out))


def kernel_lib(p: int, n: int, dtype: torch.dtype = torch.bfloat16) -> str:
    """``ssd`` for a compiled head dim and N <= ``N_FIRST``, else
    ``ssd_any``; ``ssd16`` / ``ssd16_any`` for the fp16 kernel."""
    lib = "ssd" if p in P_DIMS and n <= N_FIRST else "ssd_any"
    return lib.replace("ssd", "ssd16") if dtype == torch.float16 else lib


def launch_chunk(chunk: int, t: int) -> int:
    """The rows of one launch: the call's chunk (at most T), in sub-chunks
    of at most ``SUB_CHUNK``."""
    return min(chunk, t, SUB_CHUNK)


def kernel_dtype(x: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor) -> torch.dtype:
    """The kernel a call runs: bf16, fp16 or fp32 where x, B and C share
    it, else the fp32 kernel on widened operands (mixed dtypes)."""
    if x.dtype == b.dtype == c.dtype and x.dtype in _DT:
        return x.dtype
    return torch.float32


@kernel_contract("ssd")
def ssd(x, dt, a_log, b, c, *, d_skip=None, chunk: int = 256,
        initial_state=None, return_final_state: bool = False):
    """The chunked SSD on the card (CUDA tensors) or ``ssd_plain`` (CPU
    tensors); arguments and results as for :func:`ssd_plain`. x, b and c
    are fp32, bf16 or fp16, any mix, read by their strides where they share
    a dtype, so the model's views into its fused projection are never
    copied; y is written in x's dtype, the states in fp32."""
    require_local("ssd", x, dt, a_log, b, c, d_skip, initial_state)
    if x.device.type == "cpu":
        return ssd_plain(x, dt, a_log, b, c, d_skip=d_skip, chunk=chunk,
                         initial_state=initial_state,
                         return_final_state=return_final_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: no kernel for device {x.device}")
    bsz, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if any(v.dtype not in _FLOATS for v in (x, b, c)):
        raise NotImplementedError(f"ssd: x, b and c take fp32, bf16 or "
                                  f"fp16, got {x.dtype} / {b.dtype} / "
                                  f"{c.dtype}")
    if tuple(dt.shape) != (bsz, t, h) or tuple(c.shape) != tuple(b.shape) \
            or b.shape[:2] != x.shape[:2] or h % g \
            or tuple(a_log.shape) != (h,):
        raise ValueError(f"ssd: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"b {tuple(b.shape)}, c {tuple(c.shape)}, a_log "
                         f"{tuple(a_log.shape)}")
    if n > N_MAX:
        raise NotImplementedError(
            f"ssd: state size {n} above {N_MAX}: a block holds a 64-row C "
            f"tile and both heads' carried states in shared memory, and past "
            f"N = 320 they pass the 227 KB a block may hold")
    if t == 0 or p == 0 or chunk < 1:
        raise ValueError(f"ssd: T={t}, P={p}, chunk={chunk}")
    q = launch_chunk(chunk, t)
    dev = x.device
    out_dtype, run = x.dtype, kernel_dtype(x, b, c)
    mixed = not x.dtype == b.dtype == c.dtype
    if mixed:
        x, b, c = (dp.convert(v, run) for v in (x, b, c))
    x, b, c = _inner_contiguous(x), _inner_contiguous(b), _inner_contiguous(c)
    dt = _inner_contiguous(dt.to(torch.float32))
    a_log = a_log.to(torch.float32).contiguous()
    d = torch.zeros((h,), dtype=torch.float32, device=dev) if d_skip is None \
        else d_skip.to(torch.float32).contiguous()
    init = None
    if initial_state is not None:
        if tuple(initial_state.shape) != (bsz, h, n, p):
            raise ValueError(f"ssd: initial_state {tuple(initial_state.shape)}"
                             f" != {(bsz, h, n, p)}")
        init = initial_state.to(torch.float32).contiguous()
        if init.data_ptr() % 16:          # the kernels copy 16-byte words
            init = init.clone()
    for tns in (dt, a_log, b, c, d) + ((init,) if init is not None else ()):
        if tns.device != dev:
            raise ValueError("ssd: operands on different devices")
    y = torch.empty((bsz, t, h, p), dtype=x.dtype, device=dev)
    fin = torch.empty((bsz, h, n, p), dtype=torch.float32, device=dev) \
        if return_final_state else None
    # Between chunks the kernels carry the state in two buffers.
    scratch = torch.empty((2, bsz, h, n, p), dtype=torch.float32,
                          device=dev) if t > q else None
    fn = _build.bind(kernel_lib(p, n, run), "ssd_launch",
                     [_P, _L, _L, _L, _P, _L, _L, _L, _P, _P, _P, _L, _L, _L,
                      _P, _L, _L, _L, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _I, _I, _I, _P])
    err = fn(x.data_ptr(), x.stride(0), x.stride(1), x.stride(2),
             dt.data_ptr(), dt.stride(0), dt.stride(1), dt.stride(2),
             a_log.data_ptr(), d.data_ptr(),
             b.data_ptr(), b.stride(0), b.stride(1), b.stride(2),
             c.data_ptr(), c.stride(0), c.stride(1), c.stride(2),
             None if init is None else init.data_ptr(), y.data_ptr(),
             None if fin is None else fin.data_ptr(),
             None if scratch is None else scratch.data_ptr(),
             bsz, t, h, g, n, p, q, _DT[x.dtype], int(_rows16(x, b, c)),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ssd")
    if mixed:
        MIXED_COUNT.launches += 1
    elif out_dtype == torch.float16:
        F16_COUNT.launches += 1
    else:
        ssd.launches += 1
    if init is not None:
        ssd.resumed_launches += 1
    if mixed:
        y = dp.convert(y, out_dtype)
    return (y, fin) if return_final_state else y


ssd.launches = 0
ssd.resumed_launches = 0        # the launches that carried a state in
# The fp16 SSD's launches (the kernels report names them ssd[fp16]).
F16_COUNT = SimpleNamespace(launches=0)
# The launches on mixed x / B / C dtypes (ssd[mixed]).
MIXED_COUNT = SimpleNamespace(launches=0)
