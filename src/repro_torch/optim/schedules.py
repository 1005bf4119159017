"""Learning-rate schedules as ``step -> lr`` callables."""
from __future__ import annotations

import torch


def constant_schedule(value: float):
    """``lr`` as a float32 scalar on the step counter's device."""
    def schedule(step: torch.Tensor) -> torch.Tensor:
        return torch.tensor(value, dtype=torch.float32, device=step.device)

    return schedule
