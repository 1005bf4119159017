"""Device resolution shared by the port's public entry points.

Public functions default to ``device="cuda"``.  When no card is present
they raise instead of quietly running on the CPU: a caller who wants the
CPU (the tests, a laptop rehearsal) says so with ``device="cpu"``.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
