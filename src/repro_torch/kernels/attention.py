"""Attention kernels (``csrc/attention.cuh``) and their plain versions.

Replaces, in ``repro.kernels.attention``: ``flash_attention``,
``decode_attention``, ``paged_decode_attention`` and
``paged_prefill_attention``. Each wrapper launches its CUDA kernel for
CUDA tensors (or raises) and runs its plain version for CPU tensors;
``<wrapper>.launches`` counts kernel launches on bf16 and fp32 inputs,
``F16_COUNTS[<wrapper name>].launches`` on fp16 ones and
``MIXED_COUNTS[<wrapper name>].launches`` on mixed ones and
``ANY_COUNTS[<wrapper name>].launches`` (flash and paged prefill) on the
generic 16-bit kernel's. fp16 runs the bf16 kernels' instantiations for
``__half`` (the tensor cores' .f16 MMA for flash and paged prefill; the
CUDA-core decode kernels), the output in q's dtype as the JAX kernels
write it.

The calls the kernels were first written for -- a compiled head dim
(``HEAD_DIMS``), one dtype, whole aligned rows -- launch
``csrc/attention.cu``'s instances, so they keep their code; every other
call a generic library (:func:`kernel_lib`). Flash and paged prefill run
any head dim up to ``FLASH_HEAD_DIM_MAX`` of their dtype: bf16 and fp16
on ``csrc/attention_wg.cuh``'s Hopper kernel (``attention_wg.cu``,
``attention_wg16.cu``: wgmma at the head dim's own padded width, column
slices of V and O above 256, TMA, ``cp.async`` or element copies by the
rows' alignment), fp32 on ``attention_any.cu``'s CUDA-core kernel (the
next compiled instance up to 128, above it column slices of the 128
instance). The two decodes (``attention_decode_any.cu``) run a head dim d
between the compiled ones on the next compiled instance, up to
``HEAD_DIM_MAX`` (512, fp32's widest; a 16-bit decode above 256 widens to
fp32). Operands whose rows are not whole, 16-byte aligned words take the
kernels' narrower copies. Mixed q / k / v dtypes widen every operand to
fp32 with ``datapath.convert`` (exact), run the fp32 kernel and round the
output to q's dtype, as the JAX kernels compute on operands upcast to
fp32.

The two wrappers the tuner has a space for take an optional plan, its
schedule: flash ``{"cluster": blocks per cluster (1, 2, 4), "stages": 1
or 2}`` (K / V stages a warp; the generic 16-bit kernel's V tiles in
flight; :func:`flash_plan` gives a call's own), paged decode
``{"split_keys": keys per split}`` (a multiple of 16 up to 4096; the
kernel's own is 64). A plan the kernel cannot run raises. Under
``GEMMINI_TUNE=cached`` / ``full`` a flash call with none resolves one
through the tuner (memoized per shape); the paged decode's split comes
with the engine's page size (``ExecutionContext.decode_split``). Dense
decode and paged prefill run their own plans (ROADMAP A12).

The plain versions mirror the JAX package's XLA twins in
``repro.models.attention``: flash attention's is the model function
``repro_torch.models.attention.blockwise_attention`` (the port of
``blockwise_attention_xla``, which the training forward calls itself),
``decode_attention_plain`` is the dense
``decode_attention`` (its default, repeat-GQA branch),
``paged_decode_attention_plain`` is ``paged_decode_attention_xla`` and
``paged_prefill_attention_plain`` is ``paged_prefill_attention_xla``.
Where the paged two differ from the TPU kernels
-- a decode slot with ``len == 0``, and dead page slots that hold
non-finite garbage -- the plain versions follow the kernels: keys past the
live length are zeroed before they are used, so an empty slot yields a
zero row and a dead page can never leak ``0 * NaN`` into a live row.
"""

from __future__ import annotations

import ctypes
import math
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import flags
from repro_torch.core.dtensor import require_local
from repro_torch.kernels import _build
from repro_torch.kernels import contracts as kc
from repro_torch.kernels import datapath as dp
from repro_torch.kernels.contracts import kernel_contract
from repro_torch.models.attention import NEG_INF, blockwise_attention

HEAD_DIMS = kc.HEAD_DIMS                # compiled for every dtype
HEAD_DIM_MAX = kc.HEAD_DIM_MAX          # the decodes' widest (fp32)
# flash and paged prefill: the widest head dim whose plan fits shared
# memory (16-bit: a 64-row Q tile resident; fp32: 16 rows of Q)
FLASH_HEAD_DIM_MAX = {torch.float32: kc.F32_HEAD_DIM_MAX,
                      torch.bfloat16: kc.WG_HEAD_DIM_MAX,
                      torch.float16: kc.WG_HEAD_DIM_MAX}
_DT = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the generic 16-bit flash and paged prefill kernel's library per dtype
_WG_LIBS = {torch.bfloat16: "attention_wg", torch.float16: "attention_wg16"}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_WORKSPACE: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def decode_attention_plain(q, k, v, pos: int, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """One query token against a dense cache (``models.attention.
    decode_attention``): q (B, 1, H, D), k/v (B, S, KVH, D); keys at
    positions <= ``pos`` (and inside the window) are live."""
    b, tq, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    kpos = torch.arange(s, device=q.device)
    mask = kpos <= pos
    if window is not None:
        mask = mask & (kpos > pos - window)
    kh = k.repeat_interleave(rep, dim=2)
    vh = v.repeat_interleave(rep, dim=2)
    sl = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32) * sc,
                      kh.to(torch.float32))
    if softcap is not None:
        sl = softcap * torch.tanh(sl / softcap)
    sl = torch.where(mask[None, None, None], sl, NEG_INF)
    p = torch.softmax(sl, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vh.to(torch.float32))
    return out.to(q.dtype)


def _gather(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """(KVH, NP, page, D) pool -> (B, MP * page, KVH, D) in logical order."""
    kvh, _, page, d = pool.shape
    b, mp = tables.shape
    g = pool[:, tables.long()]                         # (KVH, B, MP, page, D)
    return g.permute(1, 2, 3, 0, 4).reshape(b, mp * page, kvh, d)


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, lengths, *,
                                 window: Optional[int] = None,
                                 softcap: Optional[float] = None,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """One decode token per slot against the page pools, by explicit
    gather (``paged_decode_attention_xla``). ``lengths`` counts the live
    tokens including the current one."""
    b, _, h, d = q.shape
    kvh = k_pool.shape[0]
    rep = h // kvh
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    kg, vg = _gather(k_pool, block_tables), _gather(v_pool, block_tables)
    kpos = torch.arange(kg.shape[1], device=q.device)
    pos = (lengths.to(torch.int64) - 1)[:, None]
    mask = kpos[None, :] <= pos                        # (B, S_ctx)
    if window is not None:
        mask = mask & (kpos[None, :] > pos - window)
    zero = torch.zeros((), dtype=kg.dtype, device=q.device)
    kg = torch.where(mask[:, :, None, None], kg, zero)
    vg = torch.where(mask[:, :, None, None], vg, zero)
    kh = kg.repeat_interleave(rep, dim=2)
    vh = vg.repeat_interleave(rep, dim=2)
    sl = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32) * sc,
                      kh.to(torch.float32))
    if softcap is not None:
        sl = softcap * torch.tanh(sl / softcap)
    sl = torch.where(mask[:, None, None, :], sl, NEG_INF)
    p = torch.softmax(sl, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vh.to(torch.float32))
    return out.to(q.dtype)


def paged_prefill_attention_plain(q, k_pool, v_pool, block_table, start: int, *,
                                  window: Optional[int] = None,
                                  softcap: Optional[float] = None,
                                  scale: Optional[float] = None) -> torch.Tensor:
    """A chunk of one request's queries at [start, start + T) against its
    pages, by explicit gather (``paged_prefill_attention_xla``); the
    chunk's own KV is already in the pools."""
    tq = q.shape[1]
    tables = block_table[None]
    return blockwise_attention(
        q, _gather(k_pool, tables), _gather(v_pool, tables), causal=True,
        window=window, softcap=softcap, scale=scale, q_offset=int(start),
        kv_len=int(start) + tq)


def column_slice_attention_plain(q, k, v, *, causal: bool = True,
                                 window: Optional[int] = None,
                                 softcap: Optional[float] = None,
                                 scale: Optional[float] = None,
                                 width: Optional[int] = None) -> torch.Tensor:
    """Flash attention as the generic kernels run a head dim above 256:
    column slices of V and O (``width`` columns each; by default
    ``contracts.wg_width``'s), each slice's scores over the whole head
    dim (fp32), its softmax, then P V on the slice's columns alone. The
    same function as ``blockwise_attention``: the plain form of the
    mechanism, not a kernel's plain version."""
    b, tq, h, d = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    width = width or kc.wg_width(d)[0]
    sc = _scale(scale, d)
    qpos = torch.arange(tq)[:, None] + (tk - tq)
    kpos = torch.arange(tk)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    mask = mask.to(q.device)
    kh = k.repeat_interleave(rep, dim=2).to(torch.float32)
    vh = v.repeat_interleave(rep, dim=2).to(torch.float32)
    out = []
    for c0 in range(0, d, width):
        s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32) * sc, kh)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
        out.append(torch.einsum("bhqk,bkhd->bqhd", p,
                                vh[..., c0:c0 + width]))
    return torch.cat(out, dim=-1).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check_cuda(name: str, tensors) -> None:
    """Same device for all (the kernels read any alignment)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on different devices")


def _check_head(name: str, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, h: int, kvh: int, d: int,
                decode: bool = False) -> None:
    if any(t.dtype not in _DT for t in (q, k, v)):
        raise NotImplementedError(f"{name}: takes bf16, fp16 or fp32, got "
                                  f"{q.dtype} / {k.dtype} / {v.dtype}")
    if decode and not 1 <= d <= HEAD_DIM_MAX:
        raise NotImplementedError(
            f"{name}: head_dim {d} above {HEAD_DIM_MAX}: a lane of the "
            f"split decode holds its query rows' D / 32 accumulators, and "
            f"the fp32 instance at 512 is its widest")
    top = FLASH_HEAD_DIM_MAX[kernel_dtype(q, k, v, d)]
    if not decode and not 1 <= d <= top:
        raise NotImplementedError(
            f"{name}: head_dim {d} above {top}: the resident query tile, "
            f"one K chunk and one V tile would pass the 227 KB of shared "
            f"memory a block holds")
    if h % kvh:
        raise ValueError(f"{name}: H={h} not a multiple of KVH={kvh}")


def kernel_dtype(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 d: int, decode: bool = False) -> torch.dtype:
    """The dtype of the kernel a call runs: q's, where q, k and v share it
    and an instance of that dtype holds the head dim (every head dim for
    flash and paged prefill; up to 256 at 16 bits for the decodes); else
    fp32 (the operands widened)."""
    if q.dtype == k.dtype == v.dtype and (q.dtype == torch.float32 or
                                          not decode or d <= HEAD_DIMS[-1]):
        return q.dtype
    return torch.float32


def _row_align(d: int, es: int, *ptrs: int) -> int:
    """The largest of 16, 8, 4 and 2 bytes that divides every pointer and
    a row's ``d * es`` bytes (``attention_wg.cuh`` row_align)."""
    bits = 16
    for p in ptrs:
        bits |= p
    return kc.row_align(d, es, bits)


def _lib_of(d: int, dtype: torch.dtype, align: int,
            decode: bool = False) -> str:
    if d in HEAD_DIMS and align >= 16:
        return "attention"
    if decode:
        return "attention_decode_any"
    return _WG_LIBS.get(dtype, "attention_any")


def kernel_lib(d: int, *ts: torch.Tensor, decode: bool = False) -> str:
    """``attention`` for a compiled head dim whose operands' rows are
    whole 16-byte words on 16-byte boundaries; else, for the two decodes,
    ``attention_decode_any``, for flash and paged prefill
    ``attention_wg`` (bf16), ``attention_wg16`` (fp16) or
    ``attention_any`` (fp32), by the operands' dtype."""
    align = _row_align(d, ts[0].element_size(), *(t.data_ptr() for t in ts))
    return _lib_of(d, ts[0].dtype, align, decode)


def _widened(run: torch.dtype, *ts: torch.Tensor):
    """The operands in the kernel's dtype: ``datapath.convert`` (exact for
    bf16 and fp16 to fp32; the same tensor where it already is)."""
    return tuple(dp.convert(t, run) for t in ts)




def _check_pools(name: str, q: torch.Tensor, k_pool: torch.Tensor,
                 v_pool: torch.Tensor) -> None:
    if k_pool.shape != v_pool.shape or k_pool.dim() != 4 or \
            k_pool.shape[3] != q.shape[3]:
        raise ValueError(f"{name}: q {tuple(q.shape)} against pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")


def _scale(scale: Optional[float], d: int) -> float:
    return scale if scale is not None else 1.0 / math.sqrt(d)


def _workspace(device: torch.device, stream: int, tickets: int,
               words: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The calling stream's split-decode workspace: (tickets, partials),
    at least ``tickets`` int32 and ``words`` fp32. The tickets are made
    zeroed and the kernel leaves each at 0, so a call needs no memset;
    partials are written before they are read. Made once per stream (and
    again only to grow), so two streams never share a ticket and a call
    allocates nothing."""
    key = (device.index, stream)
    tk, part = _WORKSPACE.get(key, (None, None))
    if tk is None or tk.numel() < tickets:
        tk = torch.zeros(max(tickets, 2 * tk.numel() if tk is not None
                             else 0), dtype=torch.int32, device=device)
    if part is None or part.numel() < max(words, 1):
        part = torch.empty(max(words, 1, 2 * part.numel() if part is not None
                               else 0), dtype=torch.float32, device=device)
    _WORKSPACE[key] = (tk, part)
    return tk, part


def _flash_args(plan: Optional[dict]) -> Tuple[int, int]:
    return (int(plan["cluster"]), int(plan["stages"])) if plan else (0, 0)


def _split_arg(plan: Optional[dict]) -> int:
    return int(plan["split_keys"]) if plan else 0


FLASH_PLAN_KEYS = kc.FLASH_PLAN_KEYS


def _plan_align(d: int, dtype: torch.dtype, align: int) -> int:
    return kc.row_align(d, kc.dt(dtype)[1], align)


def flash_plan(b: int, tq: int, tk: int, h: int, kvh: int, d: int, *,
               causal: bool = True, window: Optional[int] = None,
               dtype: torch.dtype = torch.bfloat16, device=None,
               plan: Optional[dict] = None, align: int = 16) -> dict:
    """The launch a flash call of these shapes makes under ``plan``
    (``{"cluster", "stages"}``; None for its own), its operands' rows on
    ``align`` bytes (16: whole aligned words), in the library
    :func:`kernel_lib` picks: blocks per cluster, stages (K/V a warp; the
    generic 16-bit kernel's V tiles in flight), the grid, threads, dynamic
    shared memory bytes, the instance's head dim, column slices, query
    rows a block, K ring slots and load path (``contracts.flash_contract``
    has the grids). A plan the kernel cannot run raises, as at launch."""
    align = _plan_align(d, dtype, align)
    out = (ctypes.c_longlong * len(FLASH_PLAN_KEYS))()
    fn = _build.bind(_lib_of(d, dtype, align), "flash_attention_plan",
                     [_I] * 12 + [_P])
    with torch.cuda.device(device if device is not None
                           else torch.cuda.current_device()):
        _build.check(fn(b, tq, tk, h, kvh, d, int(causal), int(window or 0),
                        _DT[dtype], *_flash_args(plan), align,
                        ctypes.addressof(out)),
                     "flash_attention_plan")
    return dict(zip(FLASH_PLAN_KEYS, out))


@kernel_contract("flash_attention")
def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None,
                    plan: Optional[dict] = None) -> torch.Tensor:
    """q: (B, Tq, H, D); k/v: (B, Tk, KVH, D); queries right-aligned to
    the keys. Returns (B, Tq, H, D) in q's dtype. On the card bf16 runs
    the tensor-core kernel and fp32 the CUDA-core one (IEEE fp32);
    ``plan``: the caller's ``{"cluster", "stages"}`` (module docstring)."""
    require_local("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return blockwise_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    b, tq, h, d = q.shape
    _, tk, kvh, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} against k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    _check_head("flash_attention", q, k, v, h, kvh, d)
    _check_cuda("flash_attention", (q, k, v))
    out_dtype, run = q.dtype, kernel_dtype(q, k, v, d)
    mixed = not q.dtype == k.dtype == v.dtype
    q, k, v = (t.contiguous() for t in _widened(run, q, k, v))
    if plan is None and flags.get("tune_mode") != "off":
        from repro_torch.tune import tuner
        plan = tuner.attn_schedule(b, tq, tk, h, kvh, d, causal, window,
                                   run, q.device)
    cluster, stages = _flash_args(plan)
    o = torch.empty_like(q)
    lib = kernel_lib(d, q, k, v, o)
    fn = _build.bind(lib, "flash_attention_launch",
                     [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                      _I, _P, _I, _I])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, tq, tk,
             h, kvh, d, int(causal), int(window or 0), float(softcap or 0.0),
             _scale(scale, d), _DT[run],
             torch.cuda.current_stream(q.device).cuda_stream, cluster, stages)
    _build.check(err, "flash_attention")
    if mixed:
        MIXED_COUNTS["flash_attention"].launches += 1
    elif lib in _WG_LIBS.values():
        ANY_COUNTS["flash_attention"].launches += 1
    elif out_dtype == torch.float16:
        F16_COUNTS["flash_attention"].launches += 1
    else:
        flash_attention.launches += 1
    return dp.convert(o, out_dtype)


@kernel_contract("decode_attention")
def decode_attention(q, k, v, pos: int, *, window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, 1, H, D); k/v: (B, S, KVH, D) dense cache; ``pos``: host int,
    keys 0..pos live. Returns (B, 1, H, D) in q's dtype.

    The kernel splits the live keys over blocks (``decode_plan``) and
    merges their partial softmax states in the same launch, in its
    stream's workspace."""
    pos = int(pos)
    require_local("decode_attention", q, k, v)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, pos, window=window,
                                      softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    b, tq, h, d = q.shape
    _, s, kvh, _ = k.shape
    if tq != 1:
        raise ValueError("decode_attention: one query token")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} against k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    _check_head("decode_attention", q, k, v, h, kvh, d, decode=True)
    _check_cuda("decode_attention", (q, k, v))
    out_dtype, run = q.dtype, kernel_dtype(q, k, v, d, decode=True)
    mixed = not q.dtype == k.dtype == v.dtype
    q, k, v = (t.contiguous() for t in _widened(run, q, k, v))
    plan = decode_plan(b, s, h, kvh, d, pos, window)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets, ws = _workspace(q.device, stream, plan[1], plan[4])
    o = torch.empty_like(q)
    fn = _build.bind(kernel_lib(d, q, k, v, decode=True),
                     "decode_attention_launch",
                     [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I,
                      _P, _P, _P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h,
             kvh, d, pos, int(window or 0), float(softcap or 0.0),
             _scale(scale, d), _DT[run], stream, ws.data_ptr(),
             tickets.data_ptr())
    _build.check(err, "decode_attention")
    if mixed:
        MIXED_COUNTS["decode_attention"].launches += 1
    elif out_dtype == torch.float16:
        F16_COUNTS["decode_attention"].launches += 1
    else:
        decode_attention.launches += 1
    return dp.convert(o, out_dtype)


def decode_plan(b: int, s: int, h: int, kvh: int, d: int, pos: int,
                window: Optional[int] = None) -> tuple:
    """The split decode kernel's plan for a dense call: (splits, groups,
    query heads per block, keys per split, fp32 words of partials); its
    grid is splits x groups blocks, and each group takes one ticket."""
    out = (ctypes.c_longlong * 5)()
    fn = _build.bind("attention_decode_any", "decode_attention_plan",
                     [_I] * 7 + [_P])
    _build.check(fn(b, s, h, kvh, d, int(pos), int(window or 0),
                    ctypes.addressof(out)), "decode_attention_plan")
    return tuple(out)


_PAGED_PLANS: Dict[tuple, tuple] = {}


def paged_decode_plan(slots: int, max_pages: int, page: int, h: int,
                      kvh: int, d: int, window: Optional[int] = None, *,
                      split_keys: int = 0) -> tuple:
    """The same for a paged call, from the shapes alone: the splits the
    table's reach (``max_pages * page`` keys) or the window can hold, so
    the grid never depends on the lengths; a block whose split is past its
    slot's live keys returns at once."""
    key = (slots, max_pages, page, h, kvh, d, int(window or 0),
           int(split_keys))
    plan = _PAGED_PLANS.get(key)
    if plan is None:
        out = (ctypes.c_longlong * 5)()
        fn = _build.bind("attention_decode_any", "paged_decode_plan",
                         [_I] * 8 + [_P])
        _build.check(fn(*key, ctypes.addressof(out)), "paged_decode_plan")
        plan = _PAGED_PLANS[key] = tuple(out)
    return plan


@kernel_contract("paged_decode_attention")
def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None,
                           plan: Optional[dict] = None) -> torch.Tensor:
    """q: (S, 1, H, D); pools: (KVH, NP, page, D); block_tables: (S, MP)
    int32; lengths: (S,) int32 live tokens including the current one. The
    kernel reads tables and lengths in device memory; one launch, whose
    grid (``paged_decode_plan``) and workspace come from the shapes (and
    ``plan``'s ``split_keys``)."""
    require_local("paged_decode_attention", q, k_pool, v_pool, block_tables,
                  lengths)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            lengths, window=window,
                                            softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    s, tq, h, d = q.shape
    kvh, npool, page, _ = k_pool.shape
    if tq != 1:
        raise ValueError("paged_decode_attention: one query token per slot")
    _check_pools("paged_decode_attention", q, k_pool, v_pool)
    if block_tables.dim() != 2 or block_tables.shape[0] != s or \
            tuple(lengths.shape) != (s,):
        raise ValueError(f"paged_decode_attention: {s} slots against tables "
                         f"{tuple(block_tables.shape)} and lengths "
                         f"{tuple(lengths.shape)}")
    _check_head("paged_decode_attention", q, k_pool, v_pool, h, kvh, d,
                decode=True)
    _check_cuda("paged_decode_attention",
                (q, k_pool, v_pool, block_tables, lengths))
    out_dtype, run = q.dtype, kernel_dtype(q, k_pool, v_pool, d,
                                           decode=True)
    mixed = not q.dtype == k_pool.dtype == v_pool.dtype
    q, k_pool, v_pool = (t.contiguous()
                         for t in _widened(run, q, k_pool, v_pool))
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    mp = tables.shape[1]
    split = _split_arg(plan)
    grid = paged_decode_plan(s, mp, page, h, kvh, d, window,
                             split_keys=split)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets, ws = _workspace(q.device, stream, grid[1], grid[4])
    o = torch.empty_like(q)
    fn = _build.bind(kernel_lib(d, q, k_pool, v_pool, decode=True),
                     "paged_decode_launch",
                     [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                      _F, _F, _I, _P, _P, _P, _I])
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             tables.data_ptr(), lens.data_ptr(), o.data_ptr(), s, mp, h, kvh,
             d, npool, page, int(window or 0), float(softcap or 0.0),
             _scale(scale, d), _DT[run], stream, ws.data_ptr(),
             tickets.data_ptr(), split)
    _build.check(err, "paged_decode_attention")
    if mixed:
        MIXED_COUNTS["paged_decode_attention"].launches += 1
    elif out_dtype == torch.float16:
        F16_COUNTS["paged_decode_attention"].launches += 1
    else:
        paged_decode_attention.launches += 1
    return dp.convert(o, out_dtype)


def paged_prefill_plan(tq: int, start: int, h: int, kvh: int, d: int,
                       window: Optional[int] = None, *,
                       dtype: torch.dtype = torch.bfloat16,
                       device=None, page: int = 16,
                       align: int = 16) -> dict:
    """The launch a paged prefill call of these arguments makes (its own
    plan, from T, start and the window; the page size and the rows'
    alignment pick the generic 16-bit kernel's load path), as
    :func:`flash_plan`'s fields."""
    align = _plan_align(d, dtype, align)
    out = (ctypes.c_longlong * len(FLASH_PLAN_KEYS))()
    fn = _build.bind(_lib_of(d, dtype, align), "paged_prefill_plan",
                     [_I] * 9 + [_P])
    with torch.cuda.device(device if device is not None
                           else torch.cuda.current_device()):
        _build.check(fn(int(tq), int(start), h, kvh, d, int(window or 0),
                        _DT[dtype], page, align, ctypes.addressof(out)),
                     "paged_prefill_plan")
    return dict(zip(FLASH_PLAN_KEYS, out))


@kernel_contract("paged_prefill_attention")
def paged_prefill_attention(q, k_pool, v_pool, block_table, start: int, *,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """q: (1, T, H, D) at logical positions [start, start + T); pools:
    (KVH, NP, page, D) holding the chunk's own KV already; block_table:
    (kv_pages,) int32 with ``kv_pages * page >= start + T``; ``start`` is
    a host int. On the card bf16 runs the tensor-core flash kernel reading
    K/V through the block table (one launch; its grid comes from T, start
    and the window), fp32 the CUDA-core one (IEEE fp32)."""
    start = int(start)
    require_local("paged_prefill_attention", q, k_pool, v_pool, block_table)
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(q, k_pool, v_pool, block_table,
                                             start, window=window,
                                             softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention: no kernel for {q.device}")
    b, tq, h, d = q.shape
    kvh, npool, page, _ = k_pool.shape
    if b != 1:
        raise ValueError("paged_prefill_attention: one request per call")
    _check_pools("paged_prefill_attention", q, k_pool, v_pool)
    if block_table.shape[0] * page < start + tq:
        raise ValueError(f"paged_prefill_attention: table of "
                         f"{block_table.shape[0]} pages cannot hold positions "
                         f"up to {start + tq}")
    _check_head("paged_prefill_attention", q, k_pool, v_pool, h, kvh, d)
    if npool * page >= 1 << 31:
        raise ValueError(f"paged_prefill_attention: a pool of {npool} pages "
                         f"of {page} rows per kv head exceeds 2^31 rows")
    _check_cuda("paged_prefill_attention", (q, k_pool, v_pool, block_table))
    out_dtype, run = q.dtype, kernel_dtype(q, k_pool, v_pool, d)
    mixed = not q.dtype == k_pool.dtype == v_pool.dtype
    q, k_pool, v_pool = (t.contiguous()
                         for t in _widened(run, q, k_pool, v_pool))
    table = block_table.to(torch.int32).contiguous()
    o = torch.empty_like(q)
    lib = kernel_lib(d, q, k_pool, v_pool, o)
    fn = _build.bind(lib, "paged_prefill_launch",
                     [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                      _F, _I, _P])
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             table.data_ptr(), o.data_ptr(), tq, start, h, kvh, d, npool, page,
             int(window or 0), float(softcap or 0.0), _scale(scale, d),
             _DT[run], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_prefill_attention")
    if mixed:
        MIXED_COUNTS["paged_prefill_attention"].launches += 1
    elif lib in _WG_LIBS.values():
        ANY_COUNTS["paged_prefill_attention"].launches += 1
    elif out_dtype == torch.float16:
        F16_COUNTS["paged_prefill_attention"].launches += 1
    else:
        paged_prefill_attention.launches += 1
    return dp.convert(o, out_dtype)


flash_attention.launches = 0
decode_attention.launches = 0
paged_decode_attention.launches = 0
paged_prefill_attention.launches = 0
# The fp16 instantiations' launches (the kernels report names them
# flash_attention[fp16] and so on); bf16 and fp32 count in the wrapper's.
F16_COUNTS = {name: SimpleNamespace(launches=0)
              for name in ("flash_attention", "decode_attention",
                           "paged_decode_attention",
                           "paged_prefill_attention")}
# The launches on mixed q / k / v dtypes (the fp32 kernels on widened
# operands; the kernels report's flash_attention[mixed] and so on).
MIXED_COUNTS = {name: SimpleNamespace(launches=0) for name in F16_COUNTS}
# The generic 16-bit flash and paged prefill kernel's launches, bf16 and
# fp16 (attention_wg.cuh; the kernels report's flash_attention[any] and
# paged_prefill_attention[any]).
ANY_COUNTS = {name: SimpleNamespace(launches=0)
              for name in ("flash_attention", "paged_prefill_attention")}
