"""Learning-rate schedules (port of ``repro.optim.schedule``): pure
functions of the step counter (a Python int or an int tensor), fp32
scalars out."""

from __future__ import annotations

import math

import torch


def _f32(value) -> torch.Tensor:
    return torch.as_tensor(value).to(torch.float32)


def linear_warmup(step, warmup_steps: int) -> torch.Tensor:
    return torch.clamp(_f32((step + 1) / max(1, warmup_steps)), max=1.0)


def cosine_schedule(step, total_steps: int, warmup_steps: int = 0,
                    final_frac: float = 0.1) -> torch.Tensor:
    warm = linear_warmup(step, warmup_steps)
    t = torch.clamp(_f32((step - warmup_steps) /
                         max(1, total_steps - warmup_steps)), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return warm * cos
