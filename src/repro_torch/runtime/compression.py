"""Gradient compression for the data-parallel reduction (port of
``repro.runtime.compression``).

* **Top-k sparsification with error feedback** (Deep Gradient
  Compression): only the k largest-magnitude entries are exchanged; the
  residual is carried in an error-feedback buffer added back before the
  next selection. The k entries are chosen in ``jax.lax.top_k``'s order,
  ties to the lower index (a stable descending sort; ``torch.topk`` breaks
  ties otherwise).
* **int8 linear quantization**, per-tensor symmetric, rounding half to
  even as ``jnp.round`` does: a 4x smaller payload than fp32.

Nothing on the training path calls these, in the JAX package either: no
module of it calls ``runtime/compression.py`` (only ``runtime/__init__``
re-exports it), so the sharded train step reduces gradients without them
(ROADMAP A15a).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core import tree as tu


# ---------------------------------------------------------------------------
# top-k + error feedback
# ---------------------------------------------------------------------------
def topk_compress(g: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the k largest-|.| entries. Returns (values, flat_indices)."""
    flat = g.reshape(-1)
    k = min(k, flat.shape[0])
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    return flat[idx], idx


def topk_decompress(values: torch.Tensor, idx: torch.Tensor, shape,
                    dtype) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    flat = torch.zeros((n,), dtype=dtype, device=values.device)
    flat[idx] = values.to(dtype)
    return flat.reshape(tuple(shape))


class ErrorFeedbackState(NamedTuple):
    residual: Any          # tree mirroring grads


def init_error_feedback(grads: Any) -> ErrorFeedbackState:
    return ErrorFeedbackState(tu.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads))


def compress_grads_with_feedback(grads: Any, state: ErrorFeedbackState,
                                 density: float = 0.01
                                 ) -> Tuple[Any, ErrorFeedbackState]:
    """DGC step: g + residual -> top-k kept (exchanged) -> residual update.

    Returns (sparse grads to feed the optimizer/all-reduce, new state).
    """

    def one(g, r):
        acc = g.to(torch.float32) + r
        k = max(1, int(density * acc.numel()))
        vals, idx = topk_compress(acc, k)
        kept = topk_decompress(vals, idx, acc.shape, torch.float32)
        return kept.to(g.dtype), acc - kept

    outs = [one(g, r) for g, r in zip(tu.leaves(grads),
                                      tu.leaves(state.residual))]
    kept = tu.unflatten(grads, [o[0] for o in outs])
    resid = tu.unflatten(grads, [o[1] for o in outs])
    return kept, ErrorFeedbackState(resid)


# ---------------------------------------------------------------------------
# int8 linear quantization (per-tensor symmetric)
# ---------------------------------------------------------------------------
def int8_compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = torch.clamp_min(torch.max(torch.abs(g.to(torch.float32))), 1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(g.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def int8_compress_tree(grads: Any) -> Any:
    return tu.tree_map(int8_compress, grads)


def int8_roundtrip_tree(grads: Any) -> Any:
    """Quantize-dequantize every leaf (models the compressed all-reduce)."""
    def one(g):
        q, s = int8_compress(g)
        return int8_decompress(q, s).to(g.dtype)
    return tu.tree_map(one, grads)
