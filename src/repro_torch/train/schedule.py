"""Learning-rate schedules: pure functions of the step, computed in fp32
tensors as the reference (``repro.train.schedule``) computes them in jnp."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor_frac: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor_frac * peak_lr`` at ``total``."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = peak_lr * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor_frac + (1 - floor_frac)
                         * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup, warm, cos)
    return lr


def constant(value: float):
    def lr(step: torch.Tensor) -> torch.Tensor:
        return torch.full((), value, dtype=torch.float32)
    return lr
