"""AdamW with global-norm clipping (port of ``repro.optim.adamw``).

``m`` and ``v`` mirror the parameter tree in fp32; the update computes in
fp32 and writes each parameter back in its own dtype. The update is
functional, as the JAX module's: it returns new trees and leaves its
inputs alone, so a step's state stays valid to checkpoint or compare while
the next runs. Leaves are visited in ``jax.tree_util``'s order
(:mod:`repro_torch.core.tree`), so the global norm adds the leaves' sums
in the JAX module's order. No weight decay on norms and biases (leaves of
fewer than two dimensions).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.core import tree as tu

Params = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params: Params) -> Dict[str, Any]:
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tu.leaves(params)[0].device
    return {"m": tu.tree_map(zeros32, params),
            "v": tu.tree_map(zeros32, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Params) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in tu.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Params, grads: Params,
                 state: Dict[str, Any], lr_scale=1.0
                 ) -> Tuple[Params, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One optimizer step. Returns (new_params, new_state, metrics)."""
    f32 = torch.float32
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    count = state["count"] + 1
    c1 = 1.0 - cfg.b1 ** count.to(f32)
    c2 = 1.0 - cfg.b2 ** count.to(f32)
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        g = g.to(f32) * clip
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        step = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if cfg.weight_decay and p.dim() >= 2:
            step = step + cfg.weight_decay * p.to(f32)
        return (p.to(f32) - lr * step).to(p.dtype), m, v

    out = [upd(p, g, m, v) for p, g, m, v in
           zip(tu.leaves(params), tu.leaves(grads), tu.leaves(state["m"]),
               tu.leaves(state["v"]))]
    new_p = tu.unflatten(params, [o[0] for o in out])
    new_m = tu.unflatten(params, [o[1] for o in out])
    new_v = tu.unflatten(params, [o[2] for o in out])
    metrics = {"grad_norm": gnorm,
               "lr": torch.as_tensor(lr, dtype=f32, device=gnorm.device)}
    return new_p, {"m": new_m, "v": new_v, "count": count}, metrics
