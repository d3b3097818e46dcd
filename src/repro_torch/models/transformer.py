"""Dense decoder over paged KV pools (port of the serving path of
``repro.models.transformer``).

The parameter tree is the JAX package's: per-layer weights stacked along a
leading ``L`` axis, the same names, the same (d_in, d_out) layout, so
``repro_torch.convert`` moves JAX parameters across as they are. Layers run
in a Python loop, so each layer's sliding window is a static int and the
attention kernels run on gemma's local and global layers alike (the JAX
package scans windows as traced data and demotes such models to XLA).

Only the dense family is in this slice; MoE, SSM and hybrid blocks raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Copy of ``repro.models.transformer.ModelConfig``; ``dtype`` is a
    torch dtype."""

    name: str
    family: str                       # dense | moe | ssm | hybrid
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    activation: str = "silu"
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    local_window: Optional[int] = None
    global_period: int = 0
    rope_base: float = 10000.0
    rope_base_local: Optional[float] = None
    post_norms: bool = False
    qk_norm: bool = False
    embed_scale: bool = False
    tie_embeddings: bool = True
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    router_weights_before: bool = False
    capacity_factor: float = 1.25
    expert_padding: int = 16
    d_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    d_conv: int = 4
    ssm_chunk: int = 256
    modality: str = "none"
    n_codebooks: int = 1
    n_meta_tokens: int = 0
    dtype: Any = torch.bfloat16


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.n_codebooks != 1 or cfg.n_meta_tokens:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
            f"queue A: SSM/hybrid/audio is item 8, MoE item 9)")


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer sliding-window sizes; 0 encodes 'global'."""
    win = np.zeros((cfg.n_layers,), np.int32)
    if cfg.local_window:
        for i in range(cfg.n_layers):
            is_global = (cfg.global_period > 0 and
                         (i + 1) % cfg.global_period == 0)
            win[i] = 0 if is_global else cfg.local_window
    return win


def layer_rope_bases(cfg: ModelConfig) -> np.ndarray:
    base = np.full((cfg.n_layers,), cfg.rope_base, np.float32)
    if cfg.rope_base_local is not None and cfg.local_window:
        for i in range(cfg.n_layers):
            is_global = (cfg.global_period > 0 and
                         (i + 1) % cfg.global_period == 0)
            if not is_global:
                base[i] = cfg.rope_base_local
    return base


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg: ModelConfig, *,
                device=None) -> Params:
    """Random parameters from a seeded generator, on ``device`` (default:
    the generator's). Same tree, names and stacked (L, ...) layout as the
    JAX package; the numbers differ (torch and jax draw differently), so
    tests convert JAX parameters through :mod:`repro_torch.convert`."""
    _require_dense(cfg)
    device = torch.device(device) if device is not None else gen.device
    L, d, dt = cfg.n_layers, cfg.d_model, cfg.dtype
    hq, hk = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim

    def dense(d_in, d_out):
        return (torch.randn((L, d_in, d_out), generator=gen, device=device)
                / d_in ** 0.5).to(dt)

    def norm(n):
        return torch.zeros((L, n), dtype=torch.float32, device=device)

    att = {"wq": dense(d, hq), "wk": dense(d, hk), "wv": dense(d, hk),
           "wo": dense(hq, d)}
    if cfg.qkv_bias:
        for name, n in (("bq", hq), ("bk", hk), ("bv", hk)):
            att[name] = torch.zeros((L, n), dtype=dt, device=device)
    blocks: Params = {"ln1": norm(d), "attn": att}
    if cfg.qk_norm:
        blocks["qnorm"] = norm(cfg.head_dim)
        blocks["knorm"] = norm(cfg.head_dim)
    if cfg.d_ff:
        blocks["ln2"] = norm(d)
        blocks["mlp"] = {"wi": dense(d, cfg.d_ff), "wo": dense(cfg.d_ff, d),
                         "wg": dense(d, cfg.d_ff)}
    if cfg.post_norms:
        blocks["post_ln1"] = norm(d)
        if "ln2" in blocks:
            blocks["post_ln2"] = norm(d)
    p: Params = {"embed": layers.embed_init(gen, cfg.vocab, d, dtype=dt,
                                            device=device),
                 "blocks": blocks,
                 "final_norm": layers.rmsnorm_init(d, device=device)}
    if not cfg.tie_embeddings:
        p["unembed"] = layers.dense_init(gen, d, cfg.vocab, dtype=dt,
                                         device=device)
    return p


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked block tree (views, no copies)."""
    def take(node):
        if isinstance(node, dict):
            return {k: take(v) for k, v in node.items()}
        return node[i]
    return take(params["blocks"])


# ---------------------------------------------------------------------------
# block forward
# ---------------------------------------------------------------------------
def _attn_branch(ctx, cfg: ModelConfig, bp: Params, h: torch.Tensor,
                 positions: torch.Tensor, window: int, rope_base: float,
                 cache: attn.PagedKVCache, prefill_start: Optional[int] = None,
                 kv_pages: Optional[int] = None):
    """window: static int, 0 = global. ``prefill_start``: cache position of
    a continuation chunk's first token (None = fresh prefill or decode)."""
    b, t, _ = h.shape
    p = bp["attn"]
    q = layers.project(ctx, h, p["wq"], p.get("bq")).reshape(
        b, t, cfg.n_heads, cfg.head_dim)
    k = layers.project(ctx, h, p["wk"], p.get("bk")).reshape(
        b, t, cfg.n_kv_heads, cfg.head_dim)
    v = layers.project(ctx, h, p["wv"], p.get("bv")).reshape(
        b, t, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = layers.rmsnorm(q, bp["qnorm"])
        k = layers.rmsnorm(k, bp["knorm"])
    q = layers.rope(q, positions, base=rope_base)
    k = layers.rope(k, positions, base=rope_base)

    # The continuation test precedes the t == 1 decode test: a final chunk
    # may be one token long.
    if prefill_start is not None:
        cache = attn.paged_update_prefill(cache, k, v, cache.tables[0],
                                          start=prefill_start)
        o = attn.paged_prefill_attn_op(ctx, q, cache, prefill_start,
                                       window=window, softcap=cfg.attn_softcap,
                                       kv_pages=kv_pages)
    elif t == 1:
        cache = attn.paged_update_decode(cache, k, v, cache.active,
                                         cache.trash)
        o = attn.paged_attn_op(ctx, q, cache, window=window,
                               softcap=cfg.attn_softcap)
    else:
        # fresh prefill: the prompt attends only itself; the pool is
        # write-only here.
        cache = attn.paged_update_prefill(cache, k, v, cache.tables[0])
        o = attn.attn_op(ctx, q, k, v, causal=True, window=window,
                         softcap=cfg.attn_softcap)
    o = o.reshape(b, t, cfg.n_heads * cfg.head_dim)
    return layers.project(ctx, o, p["wo"]), cache


def _block_apply(ctx, cfg: ModelConfig, bp: Params, h: torch.Tensor,
                 positions, window: int, rope_base: float,
                 cache: attn.PagedKVCache, prefill_start=None, kv_pages=None):
    """One dense decoder block; returns h."""
    x = layers.rmsnorm(h, bp["ln1"])
    mixed, _ = _attn_branch(ctx, cfg, bp, x, positions, window, rope_base,
                            cache, prefill_start=prefill_start,
                            kv_pages=kv_pages)
    if cfg.post_norms:
        mixed = layers.rmsnorm(mixed, bp["post_ln1"])
    h = h + mixed
    if "mlp" in bp:
        x2 = layers.rmsnorm(h, bp["ln2"])
        f = layers.mlp_apply(ctx, bp["mlp"], x2, activation=cfg.activation)
        if cfg.post_norms:
            f = layers.rmsnorm(f, bp["post_ln2"])
        h = h + f
    return h


def embed_inputs(cfg: ModelConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    _require_dense(cfg)
    return layers.embed_apply(params["embed"], tokens,
                              scale_by_sqrt_dim=cfg.embed_scale)


def unembed(ctx, cfg: ModelConfig, params: Params,
            h: torch.Tensor) -> torch.Tensor:
    h = layers.rmsnorm(h, params["final_norm"])
    if cfg.tie_embeddings:
        return layers.unembed_apply(ctx, params["embed"], h,
                                    softcap=cfg.final_softcap)
    logits = layers.project(ctx, h, params["unembed"]).to(torch.float32)
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


# ---------------------------------------------------------------------------
# paged serving steps
# ---------------------------------------------------------------------------
class PagedDecodeState(NamedTuple):
    """Decode-slot state over paged KV pools. The last pool page (id NP)
    is the reserved trash page retired slots spill to. ``conv`` / ``ssm``
    stay None for the dense family."""

    kv_k: Optional[torch.Tensor]      # (L, KVH, NP + 1, page, D)
    kv_v: Optional[torch.Tensor]
    conv: Optional[torch.Tensor]
    ssm: Optional[torch.Tensor]
    tables: torch.Tensor              # (slots, MP) int32 page ids
    lengths: torch.Tensor             # (slots,) int32 cached tokens per slot


def init_paged_state(cfg: ModelConfig, slots: int, n_pages: int,
                     page_size: int, max_pages: int, dtype=torch.bfloat16,
                     *, device="cpu") -> PagedDecodeState:
    _require_dense(cfg)
    shape = (cfg.n_layers, cfg.n_kv_heads, n_pages + 1, page_size,
             cfg.head_dim)
    return PagedDecodeState(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device), None, None,
        torch.zeros((slots, max_pages), dtype=torch.int32, device=device),
        torch.zeros((slots,), dtype=torch.int32, device=device))


def _run_layers(ctx, cfg, params, h, positions, caches: List, **kw):
    win, bases = layer_windows(cfg), layer_rope_bases(cfg)
    for i in range(cfg.n_layers):
        h = _block_apply(ctx, cfg, layer_params(params, i), h, positions,
                         int(win[i]), float(bases[i]), caches[i], **kw)
    return h


def _prefill_caches(cfg, state, pages, page_size):
    zero_len = torch.zeros((1,), dtype=torch.int32, device=pages.device)
    return [attn.PagedKVCache(state.kv_k[i], state.kv_v[i], pages[None],
                              zero_len, page_size)
            for i in range(cfg.n_layers)]


def paged_prefill(ctx, params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  state: PagedDecodeState, slot: int, pages: torch.Tensor, *,
                  page_size: int, with_logits: bool = True
                  ) -> Tuple[Optional[torch.Tensor], PagedDecodeState]:
    """Prefill ONE fresh request (tokens (1, P), bucket-padded) into its
    pages (``pages``: (MP,) int32). Returns (logits (1, P, V) or None,
    state); the pools are written in place and the caller owns the
    table/length update."""
    h = embed_inputs(cfg, params, tokens)
    t = h.shape[1]
    positions = torch.arange(t, device=h.device)[None]
    h = _run_layers(ctx, cfg, params, h, positions,
                    _prefill_caches(cfg, state, pages, page_size))
    logits = unembed(ctx, cfg, params, h) if with_logits else None
    return logits, state


def paged_prefill_chunk(ctx, params: Params, cfg: ModelConfig,
                        tokens: torch.Tensor, state: PagedDecodeState,
                        slot: int, pages: torch.Tensor, start: int, *,
                        page_size: int, with_logits: bool = True,
                        kv_pages: Optional[int] = None
                        ) -> Tuple[Optional[torch.Tensor], PagedDecodeState]:
    """Prefill a CONTINUATION chunk (tokens (1, Tc)) at cache positions
    [start, start + Tc); ``start`` is a host int. Attention reads cache
    pages + the chunk through the block table, cut to ``kv_pages``."""
    h = embed_inputs(cfg, params, tokens)
    t = h.shape[1]
    positions = (int(start) + torch.arange(t, device=h.device))[None]
    h = _run_layers(ctx, cfg, params, h, positions,
                    _prefill_caches(cfg, state, pages, page_size),
                    prefill_start=int(start), kv_pages=kv_pages)
    logits = unembed(ctx, cfg, params, h) if with_logits else None
    return logits, state


def paged_decode_step(ctx, params: Params, cfg: ModelConfig,
                      tokens: torch.Tensor, state: PagedDecodeState,
                      active: torch.Tensor, *, page_size: int
                      ) -> Tuple[torch.Tensor, PagedDecodeState]:
    """One continuous-batching decode step: every slot advances one token
    (tokens (slots, 1)); inactive slots write the trash page and keep
    frozen lengths. Each slot ropes and attends at its own position."""
    h = embed_inputs(cfg, params, tokens)
    positions = state.lengths[:, None]
    trash = state.kv_k.shape[2] - 1
    caches = [attn.PagedKVCache(state.kv_k[i], state.kv_v[i], state.tables,
                                state.lengths, page_size, active, trash)
              for i in range(cfg.n_layers)]
    h = _run_layers(ctx, cfg, params, h, positions, caches)
    logits = unembed(ctx, cfg, params, h)
    lengths = torch.where(active, state.lengths + 1, state.lengths)
    return logits, state._replace(lengths=lengths)
