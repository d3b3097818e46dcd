"""Empirical kernel-schedule tuning on the H100 (port of ``repro.tune``).

The JAX package measures its Pallas kernels' block sizes; this package
measures the card kernels' own run-time plans:

* ``schedules``                    -- the GEMM's tiles x K splits, the
                                      conv's splits, flash attention's
                                      cluster x stages, the page size x the
                                      paged decode split,
* ``measure``                      -- CUDA-event timing, L2 flushed,
* ``tuner.resolve_plan`` /
  ``tuner.resolve_conv_schedule`` /
  ``tuner.resolve_attn_schedule`` /
  ``tuner.resolve_paged_attn_schedule`` -- flag-gated resolution,
* ``cache``                        -- the persistent JSON schedule cache.

Controlled by ``GEMMINI_TUNE={off,cached,full}`` (``core.flags``), the
serve and train CLIs' ``--tune``, and ``GEMMINI_TUNE_CACHE`` for the
file.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core.config import Dataflow, GemminiConfig
from repro_torch.tune.cache import (PlanCache, default_cache_path, fingerprint,
                                    get_cache, kernel_fingerprint,
                                    reset_cache)
from repro_torch.tune.measure import measurement_backend, time_callable
from repro_torch.tune.schedules import (PagedAttnSchedule, attn_cache_key,
                                        conv_cache_key,
                                        enumerate_attn_schedules,
                                        enumerate_conv_schedules,
                                        enumerate_gemm_schedules,
                                        enumerate_paged_schedules,
                                        gemm_cache_key, paged_attn_cache_key)
from repro_torch.tune.tuner import (TIE_BAND, TuneReport,
                                    resolve_attn_schedule,
                                    resolve_conv_schedule,
                                    resolve_paged_attn_schedule, resolve_plan,
                                    tune_attention, tune_conv, tune_gemm,
                                    tune_paged_attention)

__all__ = [
    "PagedAttnSchedule", "PlanCache", "TIE_BAND",
    "TuneReport", "attn_cache_key", "conv_cache_key", "default_cache_path",
    "enumerate_attn_schedules", "enumerate_conv_schedules",
    "enumerate_gemm_schedules", "enumerate_paged_schedules", "fingerprint",
    "gemm_cache_key", "get_cache", "kernel_fingerprint",
    "measurement_backend", "paged_attn_cache_key", "reset_cache",
    "resolve_attn_schedule", "resolve_conv_schedule",
    "resolve_paged_attn_schedule", "resolve_plan", "time_callable",
    "tune_attention", "tune_conv", "tune_gemm", "tune_paged_attention",
    "warm_conv_plans", "warm_model_plans",
]


def warm_model_plans(cfg: GemminiConfig, model_cfg, batch: int, seq: int, *,
                     dataflow: Optional[Dataflow] = None,
                     include_decode: bool = True,
                     include_attention: bool = True,
                     n_shards: int = 1,
                     paged_slots: int = 0,
                     paged_max_context: int = 0,
                     device=None) -> Dict[str, int]:
    """Resolve (and, under ``tune_mode=full``, tune + persist) a schedule for
    every GEMM and attention shape a model will run, so serving never
    tunes on the request path (``repro.tune.warm_model_plans``).

    ``n_shards``: each device sees ``ceil(batch / n_shards)`` rows of the
    batch, the per-device M the dispatch launches. GEMM shapes carry their
    ``has_bias`` flag, the router's fp32 input and the tied unembedding's
    transposed B, as the dispatch keys them. ``paged_slots`` /
    ``paged_max_context``: also resolve the engine's page size (and decode
    split) at its decode batch, one entry, window None, as the engine
    resolves it at startup. ``device``: where the shapes run (default: the
    card where there is one).

    Returns {shapes, gemm_shapes, attn_shapes, paged_shapes, cache_hits,
    cache_misses} for the warm pass.
    """
    from repro_torch.models.transformer import (model_attention_shapes,
                                                model_gemm_calls)
    cache = get_cache()
    h0, m0 = cache.hits, cache.misses
    shard_batch = max(1, -(-batch // max(1, n_shards)))
    calls = model_gemm_calls(model_cfg, shard_batch, seq,
                             include_decode=include_decode)
    for (m, n, k, has_bias, in_fp32, b_trans) in calls:
        resolve_plan(cfg, m, n, k, dataflow=dataflow, has_bias=has_bias,
                     b_trans=b_trans, in_fp32=in_fp32, device=device)
    ashapes: List[Tuple] = []
    if include_attention:
        ashapes = model_attention_shapes(model_cfg, shard_batch, seq)
        for (b, tq, tk, h, kvh, d, causal, window) in ashapes:
            resolve_attn_schedule(cfg, b, tq, tk, h, kvh, d, causal=causal,
                                  window=window, dtype=model_cfg.dtype,
                                  device=device)
    pshapes: List[Tuple] = []
    if paged_slots and paged_max_context and model_cfg.has_attn:
        pshapes.append((paged_slots, model_cfg.n_heads,
                        model_cfg.n_kv_heads, model_cfg.head_dim,
                        paged_max_context, None))
        for (b, h, kvh, d, ctx, window) in pshapes:
            resolve_paged_attn_schedule(cfg, b, h, kvh, d, ctx,
                                        window=window,
                                        dtype=model_cfg.dtype, device=device)
    return {"shapes": len(calls) + len(ashapes) + len(pshapes),
            "gemm_shapes": len(calls), "attn_shapes": len(ashapes),
            "paged_shapes": len(pshapes),
            "cache_hits": cache.hits - h0,
            "cache_misses": cache.misses - m0}


def warm_conv_plans(cfg: GemminiConfig, shapes, *,
                    device=None) -> Dict[str, int]:
    """Resolve a schedule for each explicit conv shape ``(n, h, w, ci, co,
    kh, kw, stride, padding, has_bias)`` at ``cfg``'s datapath -- the warm
    entry for CNN workloads (``repro.tune.warm_conv_plans``)."""
    cache = get_cache()
    h0, m0 = cache.hits, cache.misses
    shapes = list(shapes)
    for (n, h, w, ci, co, kh, kw, stride, padding, has_bias) in shapes:
        resolve_conv_schedule(cfg, n, h, w, ci, co, kh, kw, stride=stride,
                              padding=padding, has_bias=has_bias,
                              device=device)
    return {"shapes": len(shapes), "cache_hits": cache.hits - h0,
            "cache_misses": cache.misses - m0}
