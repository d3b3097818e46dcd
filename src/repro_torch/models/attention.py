"""KV caches, the attention op routers and the training path's
blockwise attention (port of ``repro.models.attention``): the paged cache
of the serving engine, the dense cache of the static reference path, and
:func:`blockwise_attention`, the model function the training forward
differentiates.

Both caches are updated in place (``index_put_`` through advanced indexing,
slice assignment): a pool is the serving engine's whole KV arena and a dense
cache is sized for the whole sequence, and a functional update would copy
all of it for every token written. The plain attention versions live
beside their kernels in ``repro_torch.kernels.attention``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core import dtensor as shard

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


class KVCache(NamedTuple):
    """One layer's dense KV cache (the static reference path)."""

    k: torch.Tensor        # (B, S, KVH, D)
    v: torch.Tensor        # (B, S, KVH, D)


def update_cache(cache: KVCache, k_new, v_new, pos: int) -> KVCache:
    """Write (B, T, KVH, D) at positions [pos, pos + T), in place (the JAX
    package's dynamic-update-slice branch, its flag default)."""
    t = k_new.shape[1]
    cache.k[:, pos:pos + t] = k_new.to(cache.k.dtype)
    cache.v[:, pos:pos + t] = v_new.to(cache.v.dtype)
    return cache


def blockwise_attention(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None, block_k: int = 1024,
                        q_offset: Optional[int] = None,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """Online-softmax attention scanning KV blocks: the port of
    ``repro.models.attention.blockwise_attention_xla``, the same blocking
    (``block_k`` keys clamped to a 128-multiple of the key length), online
    softmax, causal mask, window, softcap and GQA.

    q: (B, Tq, H, D), k/v: (B, Tk, KVH, D). ``q_offset``: global position
    of query row 0 (default ``Tk - Tq``, right-aligned); ``kv_len``: live
    keys (default ``Tk``); keys at or past it are masked and zeroed.

    Autograd differentiates it, so it is the training forward's attention
    (``transformer.forward`` calls it, not :func:`attn_op`): the JAX
    package trains on this XLA route on every backend, because its Pallas
    flash kernel has no VJP (``repro/models/transformer.py:518-524``). It
    is also the plain version the flash kernels are held against
    (``repro_torch.kernels.attention``)."""
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
        def pad_keys(t):
            return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
        k = shard.local_along(pad_keys, k, 1)
        v = shard.local_along(pad_keys, v, 1)

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


def decode_attention(ctx, q, cache: KVCache, pos: int, *, window=None,
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None):
    """One-token attention against the dense cache: q (B, 1, H, D), keys at
    positions <= ``pos`` live. The JAX package's default (repeat-GQA)
    branch on the CPU; the dense decode kernel on a card."""
    return ctx.decode_attention(q, cache.k, cache.v, int(pos),
                                window=_static_window(window),
                                softcap=softcap, scale=scale)


class PagedKVCache(NamedTuple):
    """One layer's paged KV cache: shared page pools + per-slot tables.

    ``active`` masks live decode slots and ``trash`` names the reserved
    spill page retired slots write to (see :func:`paged_update_decode`);
    prefill ignores both."""

    k: torch.Tensor             # (KVH, NP, page, D) page pool
    v: torch.Tensor             # (KVH, NP, page, D)
    tables: torch.Tensor        # (B, MP) int32 page ids per slot
    lengths: torch.Tensor       # (B,) int32 tokens already cached per slot
    page: int                   # static page size (tokens per page)
    active: Optional[torch.Tensor] = None   # (B,) bool decode-slot liveness
    trash: int = 0                          # reserved spill page id


def paged_update_decode(cache: PagedKVCache, k_new, v_new,
                        active: torch.Tensor, trash_page: int) -> PagedKVCache:
    """Write one decode token per slot into its paged position, in place.

    k_new/v_new: (B, 1, KVH, D); slot b's token lands at logical position
    ``lengths[b]``. Inactive slots write the reserved ``trash_page`` and
    keep their lengths, so a retired slot never touches pages the
    allocator handed to another request."""
    page = cache.page
    mp = cache.tables.shape[1]
    lengths = cache.lengths.to(torch.int64)
    col = torch.clamp_max(lengths[:, None] // page, mp - 1)
    pidx = torch.gather(cache.tables.to(torch.int64), 1, col)[:, 0]
    pidx = torch.where(active, pidx, torch.full_like(pidx, trash_page))
    off = lengths % page
    kt = k_new[:, 0].transpose(0, 1).to(cache.k.dtype)       # (KVH, B, D)
    vt = v_new[:, 0].transpose(0, 1).to(cache.v.dtype)
    cache.k[:, pidx, off] = kt
    cache.v[:, pidx, off] = vt
    new_len = torch.where(active, cache.lengths + 1, cache.lengths)
    return cache._replace(lengths=new_len)


def paged_update_prefill(cache: PagedKVCache, k_new, v_new,
                         pages: torch.Tensor, start: int = 0) -> PagedKVCache:
    """Scatter a prompt chunk's KV (1, T, KVH, D) at logical positions
    [start, start + T) into its pages, in place. Positions past the true
    prompt length are bucket padding; the length mask keeps them dead."""
    page = cache.page
    t = k_new.shape[1]
    pos = int(start) + torch.arange(t, device=k_new.device)
    pidx = pages.to(torch.int64)[pos // page]
    off = pos % page
    cache.k[:, pidx, off] = k_new[0].transpose(0, 1).to(cache.k.dtype)
    cache.v[:, pidx, off] = v_new[0].transpose(0, 1).to(cache.v.dtype)
    return cache


def _static_window(window) -> Optional[int]:
    """Per-layer windows are host ints in the port (0 = global)."""
    return (int(window) or None) if window is not None else None


def attn_op(ctx, q, k, v, *, causal: bool = True, window=None,
            softcap: Optional[float] = None, scale: Optional[float] = None):
    return ctx.flash_attention(q, k, v, causal=causal,
                               window=_static_window(window),
                               softcap=softcap, scale=scale)


def paged_attn_op(ctx, q, cache: PagedKVCache, *, window=None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None):
    return ctx.paged_attention(q, cache.k, cache.v, cache.tables,
                               cache.lengths, window=_static_window(window),
                               softcap=softcap, scale=scale)


def paged_prefill_attn_op(ctx, q, cache: PagedKVCache, start: int, *,
                          window=None, softcap: Optional[float] = None,
                          scale: Optional[float] = None,
                          kv_pages: Optional[int] = None):
    return ctx.paged_prefill_attention(
        q, cache.k, cache.v, cache.tables[0], start,
        window=_static_window(window), softcap=softcap, scale=scale,
        kv_pages=kv_pages)
