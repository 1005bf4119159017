"""Optimizers, schedules and gradient transforms, in the JAX package's
``init`` / ``update`` / ``apply_updates`` protocol and its float32
arithmetic: SGD, Adam, AdamW and Adafactor-lite on trees of tensors,
global-norm clipping, learning-rate schedules and chaining."""
from repro_torch.optim.optimizers import (AdamState, GradientTransform,
                                          ScaleState, adafactor_lite, adam,
                                          adamw, apply_updates, chain,
                                          clip_by_global_norm, global_norm,
                                          scale_by_schedule, sgd)
from repro_torch.optim.schedules import (constant_schedule,
                                         cosine_decay_schedule,
                                         linear_schedule,
                                         linear_warmup_cosine)

__all__ = [
    "GradientTransform",
    "adam",
    "adamw",
    "adafactor_lite",
    "sgd",
    "chain",
    "clip_by_global_norm",
    "scale_by_schedule",
    "apply_updates",
    "global_norm",
    "constant_schedule",
    "cosine_decay_schedule",
    "linear_warmup_cosine",
    "linear_schedule",
    "AdamState",
    "ScaleState",
]
