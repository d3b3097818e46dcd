"""Architecture registry (port of ``repro.configs``), every arch of the
JAX package's: the dense gemma3-1b, gemma3-4b, gemma2-2b and qwen1.5-4b,
the vision-language llava-next-34b (a dense backbone; its image tower is
a stub that hands patch embeddings to the training forward), the recurrent
mamba2-1.3b, the hybrid hymba-1.5b, the multi-codebook musicgen-medium and
the MoE granite-moe-3b-a800m and llama4-scout-17b-a16e. ``get(name)``
returns the full-size ModelConfig; ``get_smoke(name)`` the reduced
same-family config the CPU tests use."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from repro_torch.models.transformer import ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def names():
    _ensure_loaded()
    return sorted(_REGISTRY)


# archs for which long_500k is runnable (sub-quadratic), as in the JAX
# registry
LONG_CONTEXT_ARCHS = frozenset({
    "gemma2-2b", "gemma3-1b", "gemma3-4b", "hymba-1.5b", "mamba2-1.3b"})


def shapes_for(arch: str):
    """The dry run's shape cells of ``arch`` (``launch.steps.SHAPES``)."""
    base = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_ARCHS:
        base.append("long_500k")
    return tuple(base)


def get_smoke(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (the JAX package's
    reduction rule)."""
    cfg = get(name)
    kw = dict(n_layers=2, d_model=64, vocab=128, d_ff=128 if cfg.d_ff else 0,
              head_dim=16, dtype=cfg.dtype)
    if cfg.has_attn:
        kw.update(n_heads=4, n_kv_heads=max(1, cfg.n_kv_heads * 4
                                            // max(cfg.n_heads, 1)))
    if cfg.family == "moe":
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2), moe_d_ff=32,
                  expert_padding=1)
    if cfg.has_ssm:
        kw.update(d_state=8, ssm_head_dim=8)
    if cfg.local_window:
        kw.update(local_window=8)
    if cfg.n_meta_tokens:
        kw.update(n_meta_tokens=4)
    return dataclasses.replace(cfg, **kw)


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    from repro_torch.configs import (gemma2_2b, gemma3_1b,  # noqa: F401
                                     gemma3_4b, granite_moe_3b, hymba_1_5b,
                                     llama4_scout, llava_next_34b,
                                     mamba2_1_3b, musicgen_medium,
                                     qwen1_5_4b)
    _LOADED = True
