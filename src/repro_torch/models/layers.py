"""Core layers on the engine substrate (port of ``repro.models.layers``).

Every projection runs the engine GEMM through ``ctx.matmul``; the bias
rides the GEMM's D input into the fp32 accumulator. This is the JAX
engine datapath (``layers.project`` on a non-``xla`` backend). The JAX
float-LM shortcut (dot, round, then add the bias) has no counterpart here.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init helpers (seeded torch.Generator; numbers differ from jax.random)
# ---------------------------------------------------------------------------
def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               dtype=torch.bfloat16, scale: Optional[float] = None,
               device="cpu") -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (_normal(gen, (d_in, d_out), device) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, *,
               dtype=torch.bfloat16, device="cpu") -> torch.Tensor:
    # 1/sqrt(d): with sqrt(d) embed scaling the residual stream starts O(1).
    return (_normal(gen, (vocab, d), device) / math.sqrt(d)).to(dtype)


def rmsnorm_init(d: int, *, device="cpu") -> torch.Tensor:
    return torch.zeros((d,), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# norms and rotary embeddings
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
            zero_centered: bool = True) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    w = (1.0 + scale.to(torch.float32)) if zero_centered \
        else scale.to(torch.float32)
    return (y * w).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, *, base: float = 10000.0,
         scaling: float = 1.0) -> torch.Tensor:
    """x: (..., T, H, D); positions: broadcastable to (..., T). Half-split
    rotation, angles in fp32."""
    d = x.shape[-1]
    half = d // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(base, dtype=torch.float32, device=x.device),
                     exps)
    ang = positions[..., None].to(torch.float32) * freq / scaling
    ang = ang[..., None, :]                                   # (..., T, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# engine-backed projections
# ---------------------------------------------------------------------------
def project(ctx, x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w (+ b) on the engine GEMM; x: (..., d_in), w: (d_in, d_out)
    with any strides. The bias is the GEMM's D input, added in the fp32
    accumulator before the output rounding."""
    return ctx.matmul(x, w, d=b)


_ACTS = {"silu": F.silu,
         "gelu": lambda v: F.gelu(v, approximate="tanh"),
         "relu": F.relu}


def mlp_apply(ctx, p: Params, x: torch.Tensor, *,
              activation: str = "silu") -> torch.Tensor:
    act = _ACTS[activation]
    h = project(ctx, x, p["wi"])
    if "wg" in p:
        h = act(project(ctx, x, p["wg"])) * h
    else:
        h = act(h)
    return project(ctx, h, p["wo"])


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------
def embed_apply(table: torch.Tensor, tokens: torch.Tensor, *,
                scale_by_sqrt_dim: bool = False) -> torch.Tensor:
    y = table[tokens.long()]
    if scale_by_sqrt_dim:
        y = (y.to(torch.float32) * math.sqrt(table.shape[1])).to(y.dtype)
    return y


def unembed_apply(ctx, table: torch.Tensor, x: torch.Tensor, *,
                  softcap: Optional[float] = None) -> torch.Tensor:
    # table.T is a strided view: the GEMM reads it without a copy.
    logits = project(ctx, x, table.T).to(torch.float32)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits
