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

With a ``mesh`` (a ``DeviceMesh`` over ("data", "model") or ("pod",
"data", "model")) the same step runs on DTensors: params and optimizer
state placed by ``state_shardings`` (the arch's param specs, ZeRO-1
moments), the batch by ``sharding.batch_specs``.  Every rank runs the step
on its own blocks; DTensor inserts the collectives each op needs, the
logits are constrained to (batch axes, None, "model"), the grads come back
on their params' placements, and the new state is put back on the
placements it came in with (the reference's ``out_shardings``).  The
metrics come back whole, as plain 0-d tensors on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import optim
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import batch_axes, use_mesh
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


def check_mesh(mesh) -> None:
    """Raise unless ``mesh`` is None or a ``DeviceMesh`` (an axis-named
    mesh from ``launch.mesh``): nothing else is taken for one."""
    if mesh is not None and getattr(mesh, "mesh_dim_names", None) is None:
        raise TypeError(f"a mesh is a torch DeviceMesh with named axes "
                        f"(launch.mesh.make_test_mesh or "
                        f"make_production_mesh), not {mesh!r}")


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
    iota-mask sum exactly (the rest of that sum is zeros); on a mesh it is
    the reference's iota-mask sum itself, elementwise over the
    vocab-sharded logits and a sharded sum."""
    check_mesh(mesh)
    with use_mesh(mesh):
        logits, aux = registry.forward(params, cfg, batch,
                                       remat=settings.remat)
        labels = batch["labels"].to(torch.int64)
        if mesh is None:
            logits32 = logits.to(torch.float32)
            label_logit = torch.gather(logits32, -1,
                                       labels[..., None])[..., 0]
        else:
            # keep the (B, S, V) logits sharded: batch over (pod, data),
            # vocab over model
            logits = sharding.constrain(
                logits, sharding.P(batch_axes(mesh), None, "model"), mesh)
            logits32 = logits.to(torch.float32)
            vocab_ids = torch.arange(logits32.shape[-1],
                                     device=logits32.device)
            label_logit = torch.sum(
                torch.where(vocab_ids == labels[..., None], logits32, 0.0),
                dim=-1)
        logz = torch.logsumexp(logits32, dim=-1)
        nll = torch.mean(logz - label_logit)
        zl = settings.z_loss * torch.mean(torch.square(logz))
        total = nll + zl + settings.aux_loss_weight * aux
    return total, {"nll": nll, "z_loss": zl, "aux": aux}


def _value_and_grad(params: PyTree, cfg: ArchConfig, batch: dict,
                    settings: TrainSettings, mesh=None):
    """(loss, metrics), grads of one batch: every leaf of ``params``
    differentiated, in ``leaves`` order, each grad in its leaf's dtype (on
    a mesh, on its leaf's placements)."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(unflatten(params, flat), cfg, batch,
                                settings, mesh)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _placed_like(g, p)
             for p, g in zip(flat, grads)]
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            unflatten(params, grads))


def _placed_like(x, like):
    """``x`` on ``like``'s placements when ``like`` is a DTensor."""
    if sharding.is_dtensor(like) and sharding.is_dtensor(x):
        return x.redistribute(like.device_mesh, like.placements)
    return x


def _split(batch: dict, n: int) -> list[dict]:
    """``n`` microbatches: every leaf split on its batch axis, 0, except
    ``positions``, whose batch axis is 1 (qwen2-vl's (3, B, S) ids).  On a
    mesh each microbatch is put back on its batch's placements."""
    out = [{} for _ in range(n)]
    for k, v in batch.items():
        axis = 1 if k == "positions" else 0
        b = v.shape[axis]
        if b % n:
            raise ValueError(f"a batch of {b} does not split into {n} "
                             f"microbatches")
        for i, part in enumerate(torch.chunk(v, n, dim=axis)):
            out[i][k] = _placed_like(part, v)
    return out


def grads_fn(params: PyTree, cfg: ArchConfig, batch: dict,
             settings: TrainSettings, mesh=None):
    """(loss, metrics, grads), with optional microbatch accumulation: then
    the grads are float32 sums over the microbatches divided by their
    count, the loss the mean, and the metrics the last microbatch's."""
    check_mesh(mesh)
    with use_mesh(mesh):
        if settings.microbatches <= 1:
            (loss, metrics), grads = _value_and_grad(params, cfg, batch,
                                                     settings, mesh)
            return loss, metrics, grads

        n = settings.microbatches
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
        acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
        for mb in _split(batch, n):
            (loss, metrics), grads = _value_and_grad(params, cfg, mb,
                                                     settings, mesh)
            acc = tree_map(lambda a, g: a + g, acc, grads)
            loss_sum = loss_sum + loss
        return loss_sum / n, metrics, tree_map(lambda g: g / n, acc)


def build_train_step(cfg: ArchConfig, settings: TrainSettings,
                     mesh=None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: new tensors each, the arguments left as they were.  The
    metrics are ``nll``, ``z_loss``, ``aux``, ``loss`` and the unclipped
    grads' ``grad_norm``, as 0-d tensors on the device.  With a ``mesh``
    the step takes and returns state placed by ``state_shardings`` and a
    batch placed by ``batch_specs``."""
    check_mesh(mesh)
    tx = make_optimizer(settings)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = grads_fn(params, cfg, batch, settings, mesh)
        with torch.no_grad(), use_mesh(mesh):
            updates, new_opt = tx.update(grads, opt_state, params)
            new_params = optim.apply_updates(params, updates)
            metrics = dict(metrics, loss=loss,
                           grad_norm=optim.global_norm(grads))
            if mesh is not None:
                new_params = tree_map(_placed_like, new_params, params)
                new_opt = tree_map(_placed_like, new_opt, opt_state)
                metrics = {k: sharding.whole(v) for k, v in metrics.items()}
        return new_params, new_opt, metrics

    return train_step


def abstract_state(cfg: ArchConfig, settings: TrainSettings):
    """(params, opt_state) on the meta device: every leaf's shape and
    dtype, no allocation."""
    tx = make_optimizer(settings)
    params = registry.init_params(torch.Generator(), cfg, device="meta")
    return params, tx.init(params)


def state_shardings(cfg: ArchConfig, settings: TrainSettings, mesh):
    """``NamedSharding`` trees for (params, opt_state), and their meta
    stand-ins.

    Optimizer state additionally shards over "data" (ZeRO-1) wherever a
    large leaf still has a free dim: fp32 moments are the biggest resident
    tensors, and resharding them costs one transfer per optimizer step.
    """
    params_s, opt_s = abstract_state(cfg, settings)
    p_specs = sharding.param_specs(cfg, params_s, mesh)
    o_specs = sharding.opt_state_specs(opt_s, params_s, p_specs)
    o_specs = tree_map(
        lambda spec, leaf: (sharding.fsdp_extend(spec, tuple(leaf.shape),
                                                 mesh, min_size=4096,
                                                 skip_tp_experts=False)
                            if leaf.ndim >= 2 else spec),
        o_specs, opt_s, is_leaf=sharding.is_spec)
    return (sharding.to_named(p_specs, mesh),
            sharding.to_named(o_specs, mesh), params_s, opt_s)
