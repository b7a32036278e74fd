"""LR schedules, warmup + cosine and constant (port of
``repro.optim.schedule``): functions of the int32 step tensor that
return a float32 0-d tensor, with JAX's float32 arithmetic."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    def f(step):
        step = step.float()
        warm = peak * step / max(warmup_steps, 1)
        prog = ((step - warmup_steps)
                / max(total_steps - warmup_steps, 1)).clamp(0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return f


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)
