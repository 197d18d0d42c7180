"""Learning-rate schedules as pure step -> lr callables, ported from the JAX
package's ``train/schedule.py``. ``step`` is the optimizer's int32 step
tensor; the rate is a float32 tensor on its device, so a schedule never
waits for the card."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def f(step):
        s = step.to(torch.float32)
        warm = peak * s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0, 1)
        cos = peak * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup_steps, warm, cos)
    return f


def inverse_sqrt(peak: float, warmup_steps: int):
    def f(step):
        s = torch.clamp_min(step.to(torch.float32), 1.0)
        return peak * torch.minimum(s / max(warmup_steps, 1), torch.sqrt(warmup_steps / s))
    return f
