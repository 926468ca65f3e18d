"""Learning-rate schedules: callables of the int32 step returning an f32
0-d tensor on the step's device.  Port of ``src/repro/optim/schedules.py``,
with the reference's operations in its order."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def linear_warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                         final_fraction: float = 0.1):
    def fn(step):
        step = step.float()
        warm = lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = lr * (final_fraction + (1 - final_fraction) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return fn


def inverse_sqrt(lr: float, warmup_steps: int = 100):
    def fn(step):
        step = torch.clamp(step.float(), min=1.0)
        return lr * torch.minimum(step / warmup_steps, torch.sqrt(warmup_steps / step))
    return fn
