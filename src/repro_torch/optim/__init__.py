"""The optimizer the SNN trainer uses: ``adam`` with a constant schedule,
in the JAX package's ``init`` / ``update`` / ``apply_updates`` protocol and
its float32 arithmetic."""
from repro_torch.optim.optimizers import (AdamState, GradientTransform,
                                          ScaleState, adam, apply_updates,
                                          chain, scale_by_schedule)
from repro_torch.optim.schedules import constant_schedule

__all__ = ["AdamState", "GradientTransform", "ScaleState", "adam",
           "apply_updates", "chain", "constant_schedule",
           "scale_by_schedule"]
