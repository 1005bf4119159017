"""Learning-rate schedules as ``step -> lr`` callables: ``step`` a Python
int or a tensor (an optimizer's int32 count), ``lr`` a float32 0-d tensor
on the step's device, computed in float32 as the JAX package's are."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step)


def constant_schedule(value: float):
    def schedule(step):
        # a fill on the device, which a CUDA graph can capture
        return torch.full((), value, dtype=torch.float32,
                          device=_step(step).device)

    return schedule


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int):
    def schedule(step):
        frac = torch.clamp(_step(step) / max(transition_steps, 1), 0.0, 1.0)
        return (init_value + frac * (end_value - init_value)).to(
            torch.float32)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0):
    def schedule(step):
        frac = torch.clamp(_step(step) / max(decay_steps, 1), 0.0, 1.0)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return (init_value * ((1 - alpha) * cosine + alpha)).to(
            torch.float32)

    return schedule


def linear_warmup_cosine(peak_value: float, warmup_steps: int,
                         total_steps: int, end_value: float = 0.0):
    """Linear warmup from 0 to ``peak_value``, then cosine decay to
    ``end_value``."""

    def schedule(step):
        step = _step(step).to(torch.float32)
        warm = peak_value * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = end_value + (peak_value - end_value) * 0.5 * (
            1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, cos).to(torch.float32)

    return schedule
