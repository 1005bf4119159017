"""Carry model parameters between this package and the JAX package.

Both keep one dict per layer in ``cfg.layers`` order: ``{"w", "b"}`` for a
spiking layer (HWIO conv weights, (K, N) dense weights, (N,) biases) and
``{}`` for a pool.  The exchange format is NumPy, so neither package
imports the other.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve


def params_from_numpy(np_params: Sequence[dict], device: DeviceLike = None
                      ) -> list[dict[str, torch.Tensor]]:
    """NumPy parameter list -> contiguous fp32 tensors on ``device``."""
    dev = resolve(device)
    return [{k: torch.from_numpy(np.array(v, np.float32)).to(dev)
             for k, v in p.items()} for p in np_params]


def params_to_numpy(params: Sequence[dict]) -> list[dict[str, np.ndarray]]:
    return [{k: v.detach().cpu().numpy() for k, v in p.items()}
            for p in params]
