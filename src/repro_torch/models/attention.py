"""Paged KV cache and the attention op routers (port of the serving half of
``repro.models.attention``).

The page pools are updated in place (``index_put_`` through advanced
indexing): a pool is the serving engine's whole KV arena, and a functional
update would copy all of it for every token written. The plain attention
versions live beside their kernels in ``repro_torch.kernels.attention``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


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
