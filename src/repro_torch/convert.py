"""Carry model parameters and Adam states between this package and the JAX
package.

Both keep one dict per layer in ``cfg.layers`` order: ``{"w", "b"}`` for a
spiking layer (HWIO conv weights, (K, N) dense weights, (N,) biases) and
``{}`` for a pool.  An ``optim.adam`` state is, in both, the chain
``(AdamState(count, mu, nu), ScaleState(count))`` with ``mu`` and ``nu``
shaped as the parameters; as NumPy it is ``{"count", "mu", "nu"}``.  The
exchange format is NumPy, so neither package imports the other.

An LM's parameters (``lm_params_from_numpy``/``lm_params_to_numpy``) are
the reference's tree: nested dicts with the stacked leading layer axes,
each leaf in the dtype that ``init_params`` gives it: ``cfg.dtype``, except
the float32 leaves of a Mamba2 block (``A_log``, ``dt_bias``, ``D``) in
every model.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
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


def lm_params_from_numpy(tree: Any, cfg: ArchConfig,
                         device: DeviceLike = None) -> Any:
    """A nested dict of NumPy leaves -> the same tree of tensors on
    ``device``, each leaf in the dtype the port's ``init_params`` gives it
    (read from an init on the meta device, which allocates nothing).  JAX's
    bf16 leaves come out of ``np.asarray`` as ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` rejects, so every leaf goes through float32 first:
    widening a bf16 value and narrowing it back are both exact."""
    from repro_torch.models import registry

    dev = resolve(device)
    like = registry.init_params(torch.Generator(), cfg, device="meta")

    def walk(node, ref):
        if isinstance(node, dict):
            if set(node) != set(ref):
                raise KeyError(f"{cfg.name}: keys {sorted(node)} where "
                               f"init_params has {sorted(ref)}")
            return {k: walk(v, ref[k]) for k, v in node.items()}
        t = torch.from_numpy(np.array(node, dtype=np.float32))
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{cfg.name}: a leaf of shape {tuple(t.shape)} "
                             f"where init_params has {tuple(ref.shape)}")
        return t.to(device=dev, dtype=ref.dtype)

    return walk(tree, like)


def lm_params_to_numpy(tree: Any) -> Any:
    """An LM param tree -> nested dicts of float32 NumPy arrays (a bf16
    leaf comes back widened, value for value)."""
    if isinstance(tree, dict):
        return {k: lm_params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().to("cpu", torch.float32).numpy()
