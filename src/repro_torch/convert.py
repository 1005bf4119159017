"""Carry model parameters and Adam states between this package and the JAX
package.

Both keep one dict per layer in ``cfg.layers`` order: ``{"w", "b"}`` for a
spiking layer (HWIO conv weights, (K, N) dense weights, (N,) biases) and
``{}`` for a pool.  An ``optim.adam`` state is, in both, the chain
``(AdamState(count, mu, nu), ScaleState(count))`` with ``mu`` and ``nu``
shaped as the parameters; as NumPy it is ``{"count", "mu", "nu"}``.  The
exchange format is NumPy, so neither package imports the other.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.optim import AdamState, ScaleState


def params_from_numpy(np_params: Sequence[dict], device: DeviceLike = None
                      ) -> list[dict[str, torch.Tensor]]:
    """NumPy parameter list -> contiguous fp32 tensors on ``device``."""
    dev = resolve(device)
    return [{k: torch.from_numpy(np.array(v, np.float32)).to(dev)
             for k, v in p.items()} for p in np_params]


def params_to_numpy(params: Sequence[dict]) -> list[dict[str, np.ndarray]]:
    return [{k: v.detach().cpu().numpy() for k, v in p.items()}
            for p in params]


def adam_state_from_numpy(np_state: dict, device: DeviceLike = None
                          ) -> tuple[AdamState, ScaleState]:
    """``{"count", "mu", "nu"}`` -> the ``optim.adam`` state on ``device``
    (both counters set to ``count``)."""
    dev = resolve(device)
    count = torch.tensor(int(np_state["count"]), dtype=torch.int32,
                         device=dev)
    return (AdamState(count=count,
                      mu=params_from_numpy(np_state["mu"], dev),
                      nu=params_from_numpy(np_state["nu"], dev)),
            ScaleState(count=count.clone()))


def adam_state_to_numpy(state: tuple[AdamState, ScaleState]) -> dict:
    adam = state[0]
    return {"count": np.asarray(int(adam.count), np.int32),
            "mu": params_to_numpy(adam.mu), "nu": params_to_numpy(adam.nu)}
