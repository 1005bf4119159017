"""Train-step builders: the loss, gradient accumulation over microbatches
and the optimizer update, the JAX package's ``repro.train.steps`` on one
device.

``build_train_step`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``.  The reference jits it with params and
optimizer state donated; here the step returns new tensors, and the caller
drops the old ones (a caller that keeps them sees them unchanged).
Gradients come from ``torch.autograd.grad`` over the parameter leaves, each
in its leaf's dtype (bf16 for a bf16 model, float32 for a Mamba2 block's
float32 leaves), as JAX's do; with microbatches they are accumulated in
float32, as the reference's scan accumulates them.

The sharded path (a ``mesh``: sharding constraints on the logits, state
shardings with ZeRO-1 moments) comes with the distribution layer (ROADMAP
§1); until then passing a mesh raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import optim
from repro_torch.configs.base import ArchConfig
from repro_torch.models import registry
from repro_torch.tree import leaves, tree_map, unflatten

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    z_loss: float = 1e-4
    aux_loss_weight: float = 0.01        # MoE load-balance loss
    optimizer: str = "adamw"             # adamw | adafactor
    microbatches: int = 1                # gradient accumulation
    remat: bool = True


def no_mesh(mesh) -> None:
    """Raise for a device mesh: sharded training needs the distribution
    layer, which this package does not have yet (ROADMAP §1)."""
    if mesh is not None:
        raise NotImplementedError(
            "sharded training (a mesh) needs the distribution layer "
            "(ROADMAP §1: distributed/sharding.py, launch/mesh.py), which "
            "is not ported yet; pass mesh=None to train on one device")


def make_optimizer(s: TrainSettings) -> optim.GradientTransform:
    if s.optimizer == "adafactor":
        return optim.adafactor_lite(s.learning_rate)
    return optim.adamw(s.learning_rate, weight_decay=s.weight_decay,
                       clip_norm=s.clip_norm)


def loss_fn(params: PyTree, cfg: ArchConfig, batch: dict,
            settings: TrainSettings, mesh=None
            ) -> tuple[torch.Tensor, dict]:
    """Cross-entropy of the labels in float32, plus the z-loss and the MoE
    aux loss.  The label logit is a gather, which gives the reference's
    iota-mask sum exactly (the rest of that sum is zeros)."""
    no_mesh(mesh)
    logits, aux = registry.forward(params, cfg, batch, remat=settings.remat)
    logits32 = logits.to(torch.float32)
    logz = torch.logsumexp(logits32, dim=-1)
    labels = batch["labels"].to(torch.int64)
    label_logit = torch.gather(logits32, -1, labels[..., None])[..., 0]
    nll = torch.mean(logz - label_logit)
    zl = settings.z_loss * torch.mean(torch.square(logz))
    total = nll + zl + settings.aux_loss_weight * aux
    return total, {"nll": nll, "z_loss": zl, "aux": aux}


def _value_and_grad(params: PyTree, cfg: ArchConfig, batch: dict,
                    settings: TrainSettings):
    """(loss, metrics), grads of one batch: every leaf of ``params``
    differentiated, in ``leaves`` order, each grad in its leaf's dtype."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(unflatten(params, flat), cfg, batch,
                                settings)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            unflatten(params, grads))


def _split(batch: dict, n: int) -> list[dict]:
    """``n`` microbatches: every leaf split on its batch axis, 0, except
    ``positions``, whose batch axis is 1 (qwen2-vl's (3, B, S) ids)."""
    out = [{} for _ in range(n)]
    for k, v in batch.items():
        axis = 1 if k == "positions" else 0
        b = v.shape[axis]
        if b % n:
            raise ValueError(f"a batch of {b} does not split into {n} "
                             f"microbatches")
        for i, part in enumerate(torch.chunk(v, n, dim=axis)):
            out[i][k] = part
    return out


def grads_fn(params: PyTree, cfg: ArchConfig, batch: dict,
             settings: TrainSettings, mesh=None):
    """(loss, metrics, grads), with optional microbatch accumulation: then
    the grads are float32 sums over the microbatches divided by their
    count, the loss the mean, and the metrics the last microbatch's."""
    no_mesh(mesh)
    if settings.microbatches <= 1:
        (loss, metrics), grads = _value_and_grad(params, cfg, batch,
                                                 settings)
        return loss, metrics, grads

    n = settings.microbatches
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    for mb in _split(batch, n):
        (loss, metrics), grads = _value_and_grad(params, cfg, mb, settings)
        acc = tree_map(lambda a, g: a + g, acc, grads)
        loss_sum = loss_sum + loss
    return loss_sum / n, metrics, tree_map(lambda g: g / n, acc)


def build_train_step(cfg: ArchConfig, settings: TrainSettings,
                     mesh=None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: new tensors each, the arguments left as they were.  The
    metrics are ``nll``, ``z_loss``, ``aux``, ``loss`` and the unclipped
    grads' ``grad_norm``, as 0-d tensors on the device."""
    no_mesh(mesh)
    tx = make_optimizer(settings)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = grads_fn(params, cfg, batch, settings)
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optim.apply_updates(params, updates)
            metrics = dict(metrics, loss=loss,
                           grad_norm=optim.global_norm(grads))
        return params, opt_state, metrics

    return train_step


def abstract_state(cfg: ArchConfig, settings: TrainSettings):
    """(params, opt_state) on the meta device: every leaf's shape and
    dtype, no allocation."""
    tx = make_optimizer(settings)
    params = registry.init_params(torch.Generator(), cfg, device="meta")
    return params, tx.init(params)
