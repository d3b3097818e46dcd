"""Chunked Mamba-2 SSD (``csrc/ssd.cu``) and its plain version.

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

On the card bf16 inputs run the tensor-core kernel and fp32 inputs the
CUDA-core kernel, each one launch per chunk of the sequence (a serving
call is one chunk); ``ssd.launches`` grows by one per call. fp16 inputs
run the fp32 kernel: x, B and C widened exactly to fp32 by
``datapath.convert`` (the JAX kernel upcasts every operand to fp32 in its
body too), y written in fp32 and rounded to fp16 by the same kernel, so
the decay-weighted scores and the carried state never meet fp16's range
(a state past 65504 stays finite); ``F16_COUNT.launches`` counts its SSD
launches, the conversions count in ``datapath.convert``.

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

P_DIMS = (8, 16, 32, 64)        # head dims the kernel is compiled for
N_MAX = 128                     # largest state size it holds
CHUNK_MAX = 256                 # longest chunk its per-chunk scan holds
_DT = {torch.float32: 0, torch.bfloat16: 1}

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
              "scratch_words")


def ssd_plan(bsz: int, t: int, h: int, g: int, n: int, p: int, chunk: int,
             dtype: torch.dtype = torch.bfloat16,
             final_state: bool = False, device=None) -> dict:
    """The launches an :func:`ssd` call makes, one per chunk of ``chunk``
    rows (the wrapper's ``min(chunk, T)``): threads, dynamic shared memory
    bytes and blocks per cluster of each, the output and state blocks of a
    whole chunk, the first and last chunk's blocks per grid row, the grid
    rows and the scratch's fp32 words."""
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    fn = _build.bind("ssd", "ssd_plan", [_I] * 9 + [_P])
    with torch.cuda.device(device if device is not None
                           else torch.cuda.current_device()):
        # fp16 runs the fp32 kernel on widened operands
        code = _DT[torch.float32 if dtype == torch.float16 else dtype]
        _build.check(fn(bsz, t, h, g, n, p, chunk, code,
                        int(bool(final_state)), ctypes.addressof(out)),
                     "ssd_plan")
    return dict(zip(_PLAN_KEYS, out))


@kernel_contract("ssd")
def ssd(x, dt, a_log, b, c, *, d_skip=None, chunk: int = 256,
        initial_state=None, return_final_state: bool = False):
    """The chunked SSD on the card (CUDA tensors) or ``ssd_plain`` (CPU
    tensors); arguments and results as for :func:`ssd_plain`. x, b and c
    share the model dtype (fp32, bf16 or fp16) and are read by their strides,
    so the model's views into its fused projection are never copied; y is
    written in x's dtype, the states in fp32."""
    require_local("ssd", x, dt, a_log, b, c, d_skip, initial_state)
    if x.device.type == "cpu":
        return ssd_plain(x, dt, a_log, b, c, d_skip=d_skip, chunk=chunk,
                         initial_state=initial_state,
                         return_final_state=return_final_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: no kernel for device {x.device}")
    bsz, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    q = min(chunk, t)
    if x.dtype not in _DT and x.dtype != torch.float16 or \
            b.dtype != x.dtype or c.dtype != x.dtype:
        raise NotImplementedError(f"ssd: x, b and c must share fp32, bf16 "
                                  f"or fp16, got {x.dtype} / {b.dtype} / "
                                  f"{c.dtype}")
    if tuple(dt.shape) != (bsz, t, h) or tuple(c.shape) != tuple(b.shape) \
            or b.shape[:2] != x.shape[:2] or h % g \
            or tuple(a_log.shape) != (h,):
        raise ValueError(f"ssd: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"b {tuple(b.shape)}, c {tuple(c.shape)}, a_log "
                         f"{tuple(a_log.shape)}")
    if p not in P_DIMS or n > N_MAX or q > CHUNK_MAX or t == 0:
        raise NotImplementedError(
            f"ssd: head dim {p} (compiled: {P_DIMS}), state {n} (<= "
            f"{N_MAX}), chunk {q} (<= {CHUNK_MAX}), T={t}")
    dev = x.device
    out_dtype = x.dtype
    if x.dtype == torch.float16:
        x, b, c = (dp.convert(v, torch.float32) for v in (x, b, c))
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
    fn = _build.bind("ssd", "ssd_launch",
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
    if out_dtype == torch.float16:
        F16_COUNT.launches += 1
    else:
        ssd.launches += 1
    if init is not None:
        ssd.resumed_launches += 1
    y = dp.convert(y, out_dtype)
    return (y, fin) if return_final_state else y


ssd.launches = 0
ssd.resumed_launches = 0        # the launches that carried a state in
# The fp16 SSD's launches (the kernels report names them ssd[fp16]).
F16_COUNT = SimpleNamespace(launches=0)
