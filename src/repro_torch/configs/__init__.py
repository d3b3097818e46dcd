"""Architecture registry (port of ``repro.configs``) for the archs this
slice serves. ``get(name)`` returns the full-size ModelConfig;
``get_smoke(name)`` the reduced same-family config the CPU tests use."""

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


def get_smoke(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (the JAX package's
    reduction rule)."""
    cfg = get(name)
    kw = dict(n_layers=2, d_model=64, vocab=128, d_ff=128 if cfg.d_ff else 0,
              head_dim=16, dtype=cfg.dtype, n_heads=4,
              n_kv_heads=max(1, cfg.n_kv_heads * 4 // max(cfg.n_heads, 1)))
    if cfg.local_window:
        kw.update(local_window=8)
    return dataclasses.replace(cfg, **kw)


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    from repro_torch.configs import gemma3_1b, qwen1_5_4b   # noqa: F401
    _LOADED = True
