"""Attention kernels (``csrc/attention.cu``) and their plain versions.

Replaces, in ``repro.kernels.attention``: ``flash_attention``,
``decode_attention``, ``paged_decode_attention`` and
``paged_prefill_attention``. Each wrapper launches its CUDA kernel for
CUDA tensors (or raises) and runs its plain version for CPU tensors;
``<wrapper>.launches`` counts kernel launches.

The plain versions mirror the JAX package's XLA twins in
``repro.models.attention``: ``blockwise_attention`` is
``blockwise_attention_xla`` (online softmax over KV blocks clamped to a
128-multiple of the key length), ``decode_attention_plain`` is the dense
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
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIMS = (16, 32, 64, 128, 256)
_DT = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def blockwise_attention(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None, block_k: int = 1024,
                        q_offset: Optional[int] = None,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """Online-softmax attention scanning KV blocks (``blockwise_attention_xla``).

    q: (B, Tq, H, D), k/v: (B, Tk, KVH, D). ``q_offset``: global position
    of query row 0 (default ``Tk - Tq``, right-aligned); ``kv_len``: live
    keys (default ``Tk``); keys at or past it are masked and zeroed."""
    b, tq, h, d = q.shape
    _, tk, kvh, _ = k.shape
    rep = h // kvh
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    if q_offset is None:
        q_offset = tk - tq
    if kv_len is None:
        kv_len = tk
    live = (torch.arange(tk, device=dev) < kv_len)[None, :, None, None]
    k = torch.where(live, k, torch.zeros((), dtype=k.dtype, device=dev))
    v = torch.where(live, v, torch.zeros((), dtype=v.dtype, device=dev))
    block_k = min(block_k, -(-max(tk, 1) // 128) * 128)
    nb = -(-tk // block_k)
    pad = nb * block_k - tk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))

    qf = q.to(torch.float32) * sc
    qpos = torch.arange(tq, device=dev) + q_offset
    m = torch.full((b, h, tq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, tq, d), dtype=torch.float32, device=dev)
    for i in range(nb):
        kh = k[:, i * block_k:(i + 1) * block_k].repeat_interleave(rep, dim=2)
        vh = v[:, i * block_k:(i + 1) * block_k].repeat_interleave(rep, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kh.to(torch.float32))
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        kpos = i * block_k + torch.arange(block_k, device=dev)
        mask = (kpos[None, :] <= kv_len - 1).expand(tq, block_k)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, vh.to(torch.float32))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-37)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


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
        raise NotImplementedError(f"{name}: takes bf16 or fp32, got "
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


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Tq, H, D); k/v: (B, Tk, KVH, D); queries right-aligned to
    the keys. Returns (B, Tq, H, D) in q's dtype. On the card bf16 runs
    the tensor-core kernel and fp32 the CUDA-core one (IEEE fp32)."""
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
    o = torch.empty_like(q)
    fn = _build.bind("attention", "flash_attention_launch",
                     [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                      _I, _P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, tq, tk,
             h, kvh, d, int(causal), int(window or 0), float(softcap or 0.0),
             _scale(scale, d), _DT[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return o


def decode_attention(q, k, v, pos: int, *, window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, 1, H, D); k/v: (B, S, KVH, D) dense cache; ``pos``: host int,
    keys 0..pos live. Returns (B, 1, H, D) in q's dtype.

    The kernel splits the live keys over blocks (``decode_plan``) and
    merges their partial softmax states in the same launch, in a
    workspace of its own for each call."""
    pos = int(pos)
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
    ws = torch.empty(decode_plan(b, s, h, kvh, d, pos, window)[4],
                     dtype=torch.float32, device=q.device)
    o = torch.empty_like(q)
    fn = _build.bind("attention", "decode_attention_launch",
                     [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I,
                      _P, _P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h,
             kvh, d, pos, int(window or 0), float(softcap or 0.0),
             _scale(scale, d), _DT[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream, ws.data_ptr())
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return o


def decode_plan(b: int, s: int, h: int, kvh: int, d: int, pos: int,
                window: Optional[int] = None) -> tuple:
    """The split decode kernel's plan for a call: (splits, groups, query
    heads per block, keys per split, 4-byte words of workspace); its grid
    is splits x groups blocks."""
    out = (ctypes.c_longlong * 5)()
    fn = _build.bind("attention", "decode_attention_plan", [_I] * 7 + [_P])
    _build.check(fn(b, s, h, kvh, d, int(pos), int(window or 0),
                    ctypes.addressof(out)), "decode_attention_plan")
    return tuple(out)


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q: (S, 1, H, D); pools: (KVH, NP, page, D); block_tables: (S, MP)
    int32; lengths: (S,) int32 live tokens including the current one. The
    kernel reads tables and lengths in device memory."""
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
    o = torch.empty_like(q)
    fn = _build.bind("attention", "paged_decode_launch",
                     [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                      _F, _F, _I, _P])
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             tables.data_ptr(), lens.data_ptr(), o.data_ptr(), s,
             tables.shape[1], h, kvh, d, npool, page, int(window or 0),
             float(softcap or 0.0), _scale(scale, d), _DT[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return o


def paged_prefill_attention(q, k_pool, v_pool, block_table, start: int, *,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """q: (1, T, H, D) at logical positions [start, start + T); pools:
    (KVH, NP, page, D) holding the chunk's own KV already; block_table:
    (kv_pages,) int32 with ``kv_pages * page >= start + T``; ``start`` is
    a host int."""
    start = int(start)
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
    paged_prefill_attention.launches += 1
    return o


flash_attention.launches = 0
decode_attention.launches = 0
paged_decode_attention.launches = 0
paged_prefill_attention.launches = 0
