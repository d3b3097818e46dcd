"""Attention kernels (``csrc/attention.cu``) and their plain versions.

Replaces, in ``repro.kernels.attention``: ``flash_attention``,
``decode_attention``, ``paged_decode_attention`` and
``paged_prefill_attention``. Each wrapper launches its CUDA kernel for
CUDA tensors (or raises) and runs its plain version for CPU tensors;
``<wrapper>.launches`` counts kernel launches on bf16 and fp32 inputs,
``F16_COUNTS[<wrapper name>].launches`` on fp16 ones. fp16 runs the bf16
kernels' instantiations for ``__half`` (the tensor cores' .f16 MMA for
flash and paged prefill; the CUDA-core decode kernels), the output in
q's dtype as the JAX kernels write it.

The two wrappers the tuner has a space for take an optional plan, its
schedule: flash ``{"cluster": blocks per cluster (1, 2, 4), "stages": 1
or 2}`` (:func:`flash_plan` gives a call's own), paged decode
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
from repro_torch.kernels.contracts import kernel_contract
from repro_torch.models.attention import NEG_INF, blockwise_attention

HEAD_DIMS = (16, 32, 64, 128, 256)
_DT = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

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


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check_cuda(name: str, vecs, others=()) -> None:
    """Same device for all; 16-byte alignment for the operands the kernel
    reads in vector loads."""
    dev = vecs[0].device
    for t in (*vecs, *others):
        if t.device != dev:
            raise ValueError(f"{name}: operands on different devices")
    for t in vecs:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operand not 16-byte aligned")


def _check_head(name: str, q: torch.Tensor, k: torch.Tensor, h: int,
                kvh: int, d: int) -> None:
    if q.dtype not in _DT or k.dtype != q.dtype:
        raise NotImplementedError(f"{name}: takes bf16, fp16 or fp32, got "
                                  f"{q.dtype} / {k.dtype}")
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"{name}: head_dim {d} not in {HEAD_DIMS}")
    if h % kvh:
        raise ValueError(f"{name}: H={h} not a multiple of KVH={kvh}")


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


_FLASH_PLAN_KEYS = ("cluster", "stages", "grid_x", "grid_y", "grid_z",
                    "threads", "smem")


def flash_plan(b: int, tq: int, tk: int, h: int, kvh: int, d: int, *,
               causal: bool = True, window: Optional[int] = None,
               dtype: torch.dtype = torch.bfloat16, device=None,
               plan: Optional[dict] = None) -> dict:
    """The launch a flash call of these shapes makes under ``plan``
    (``{"cluster", "stages"}``; None for its own): blocks per cluster, K/V
    stages a warp, the grid (bf16: clusters x row tiles of 16 x heads x
    batch; fp32: clusters x kv heads x batch x row tiles of (position,
    query head) pairs), threads and dynamic shared memory bytes. A plan
    the kernel cannot run raises, as at launch."""
    out = (ctypes.c_longlong * len(_FLASH_PLAN_KEYS))()
    fn = _build.bind("attention", "flash_attention_plan", [_I] * 11 + [_P])
    with torch.cuda.device(device if device is not None
                           else torch.cuda.current_device()):
        _build.check(fn(b, tq, tk, h, kvh, d, int(causal), int(window or 0),
                        _DT[dtype], *_flash_args(plan),
                        ctypes.addressof(out)),
                     "flash_attention_plan")
    return dict(zip(_FLASH_PLAN_KEYS, out))


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
    _check_head("flash_attention", q, k, h, kvh, d)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_cuda("flash_attention", (q, k, v))
    if plan is None and flags.get("tune_mode") != "off":
        from repro_torch.tune import tuner
        plan = tuner.attn_schedule(b, tq, tk, h, kvh, d, causal, window,
                                   q.dtype, q.device)
    cluster, stages = _flash_args(plan)
    o = torch.empty_like(q)
    fn = _build.bind("attention", "flash_attention_launch",
                     [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                      _I, _P, _I, _I])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, tq, tk,
             h, kvh, d, int(causal), int(window or 0), float(softcap or 0.0),
             _scale(scale, d), _DT[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream, cluster, stages)
    _build.check(err, "flash_attention")
    if q.dtype == torch.float16:
        F16_COUNTS["flash_attention"].launches += 1
    else:
        flash_attention.launches += 1
    return o


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
    _check_head("decode_attention", q, k, h, kvh, d)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_cuda("decode_attention", (q, k, v))
    plan = decode_plan(b, s, h, kvh, d, pos, window)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets, ws = _workspace(q.device, stream, plan[1], plan[4])
    o = torch.empty_like(q)
    fn = _build.bind("attention", "decode_attention_launch",
                     [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I,
                      _P, _P, _P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h,
             kvh, d, pos, int(window or 0), float(softcap or 0.0),
             _scale(scale, d), _DT[q.dtype], stream, ws.data_ptr(),
             tickets.data_ptr())
    _build.check(err, "decode_attention")
    if q.dtype == torch.float16:
        F16_COUNTS["decode_attention"].launches += 1
    else:
        decode_attention.launches += 1
    return o


def decode_plan(b: int, s: int, h: int, kvh: int, d: int, pos: int,
                window: Optional[int] = None) -> tuple:
    """The split decode kernel's plan for a dense call: (splits, groups,
    query heads per block, keys per split, fp32 words of partials); its
    grid is splits x groups blocks, and each group takes one ticket."""
    out = (ctypes.c_longlong * 5)()
    fn = _build.bind("attention", "decode_attention_plan", [_I] * 7 + [_P])
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
        fn = _build.bind("attention", "paged_decode_plan", [_I] * 8 + [_P])
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
    _check_head("paged_decode_attention", q, k_pool, h, kvh, d)
    q = q.contiguous()
    k_pool, v_pool = k_pool.contiguous(), v_pool.contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    _check_cuda("paged_decode_attention", (q, k_pool, v_pool), (tables, lens))
    mp = tables.shape[1]
    split = _split_arg(plan)
    grid = paged_decode_plan(s, mp, page, h, kvh, d, window,
                             split_keys=split)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets, ws = _workspace(q.device, stream, grid[1], grid[4])
    o = torch.empty_like(q)
    fn = _build.bind("attention", "paged_decode_launch",
                     [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                      _F, _F, _I, _P, _P, _P, _I])
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             tables.data_ptr(), lens.data_ptr(), o.data_ptr(), s, mp, h, kvh,
             d, npool, page, int(window or 0), float(softcap or 0.0),
             _scale(scale, d), _DT[q.dtype], stream, ws.data_ptr(),
             tickets.data_ptr(), split)
    _build.check(err, "paged_decode_attention")
    if q.dtype == torch.float16:
        F16_COUNTS["paged_decode_attention"].launches += 1
    else:
        paged_decode_attention.launches += 1
    return o


def paged_prefill_plan(tq: int, start: int, h: int, kvh: int, d: int,
                       window: Optional[int] = None, *,
                       dtype: torch.dtype = torch.bfloat16,
                       device=None) -> dict:
    """The launch a paged prefill call of these arguments makes (its own
    plan, from T, start and the window): blocks per cluster, K/V stages,
    the grid (bf16: clusters x row tiles of 16 x heads; fp32: clusters x
    kv heads x row tiles of (position, query head) pairs), threads and
    dynamic shared memory bytes."""
    out = (ctypes.c_longlong * len(_FLASH_PLAN_KEYS))()
    fn = _build.bind("attention", "paged_prefill_plan", [_I] * 7 + [_P])
    with torch.cuda.device(device if device is not None
                           else torch.cuda.current_device()):
        _build.check(fn(int(tq), int(start), h, kvh, d, int(window or 0),
                        _DT[dtype], ctypes.addressof(out)),
                     "paged_prefill_plan")
    return dict(zip(_FLASH_PLAN_KEYS, out))


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
    _check_head("paged_prefill_attention", q, k_pool, h, kvh, d)
    if npool * page >= 1 << 31:
        raise ValueError(f"paged_prefill_attention: a pool of {npool} pages "
                         f"of {page} rows per kv head exceeds 2^31 rows")
    q = q.contiguous()
    k_pool, v_pool = k_pool.contiguous(), v_pool.contiguous()
    table = block_table.to(torch.int32).contiguous()
    _check_cuda("paged_prefill_attention", (q, k_pool, v_pool), (table,))
    o = torch.empty_like(q)
    fn = _build.bind("attention", "paged_prefill_launch",
                     [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                      _F, _I, _P])
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             table.data_ptr(), o.data_ptr(), tq, start, h, kvh, d, npool, page,
             int(window or 0), float(softcap or 0.0), _scale(scale, d),
             _DT[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_prefill_attention")
    if q.dtype == torch.float16:
        F16_COUNTS["paged_prefill_attention"].launches += 1
    else:
        paged_prefill_attention.launches += 1
    return o


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
