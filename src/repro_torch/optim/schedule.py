"""LR schedules (port of ``repro/optim/schedule.py``): step -> lr.

``step`` is an int or a 0-d tensor on the CPU (the train state's counter).
The arithmetic runs in float32, as the JAX package's does, and the result
comes back as a Python float.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def exponential_decay(init_lr: float, decay_rate: float, decay_steps: int):
    """Paper §V-B1: lr initialized at 5e-4, decayed exponentially."""
    def fn(step) -> float:
        return float(init_lr * decay_rate ** (_f32(step) / decay_steps))
    return fn


def cosine_schedule(init_lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step) -> float:
        t = torch.clamp(_f32(step) / total_steps, max=1.0)
        return float(init_lr * (final_frac + (1 - final_frac) * 0.5
                                * (1 + torch.cos(math.pi * t))))
    return fn


def warmup_cosine(init_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = cosine_schedule(init_lr, max(total_steps - warmup_steps, 1), final_frac)

    def fn(step) -> float:
        s = _f32(step)
        if s < warmup_steps:
            return float(init_lr * s / max(warmup_steps, 1))
        return cos(s - warmup_steps)
    return fn
