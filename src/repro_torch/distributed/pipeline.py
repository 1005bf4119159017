"""Pipeline parallelism: the GPipe schedule over a mesh axis, the JAX
package's ``repro.distributed.pipeline``.

Layers are partitioned into S stages; stage s's parameters live on the rank
at index s of mesh axis ``stage``.  Microbatches stream through: at step t,
stage s processes microbatch t-s while a ring send/recv carries each
stage's activation to the next stage, the classic GPipe pipeline with S-1
bubble steps.  The reference writes it as one ``shard_map`` program with
``ppermute``; here every rank runs the same loop on its own stage, and the
ring is a ``batch_isend_irecv`` on the axis's subgroup.  At the end the
last stage broadcasts its outputs, so every rank returns them.

Intended for depth-dominated models at node counts where a 2D (data, model)
mesh runs out of useful tensor-parallel width.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map

PyTree = Any


def _stage_slice(x: torch.Tensor, stage: int) -> torch.Tensor:
    """This stage's slice of a stage-stacked leaf: a DTensor sharded on its
    leading axis holds it as its one local row; a whole tensor is
    indexed."""
    if hasattr(x, "to_local"):
        local = x.to_local()
        if local.shape[0] != 1:
            raise ValueError("stage params must be sharded one stage a "
                             "rank on their leading axis")
        return local[0]
    return x[stage]


def pipeline_apply(stage_fn: Callable, stage_params: PyTree,
                   micro_inputs: torch.Tensor, mesh,
                   axis: str = "stage") -> torch.Tensor:
    """Run ``stage_fn`` as an S-stage pipeline.

    stage_fn(params_slice, x) -> y with x.shape == y.shape (the activation
    that flows between stages).
    stage_params: tree whose leaves lead with dim S (one slice per stage),
    whole on every rank or DTensors sharded over ``axis``.
    micro_inputs: (n_micro, ...) microbatched inputs, alike on every rank.
    Returns (n_micro, ...) outputs of the final stage, on every rank.
    """
    group = mesh.get_group(axis)
    n_stages = dist.get_world_size(group)
    stage = mesh.get_local_rank(axis)
    ranks = dist.get_process_group_ranks(group)
    nxt, prv = ranks[(stage + 1) % n_stages], ranks[(stage - 1) % n_stages]
    n_micro = micro_inputs.shape[0]
    params = tree_map(lambda p: _stage_slice(p, stage), stage_params)

    carry = torch.zeros_like(micro_inputs[0])
    outputs = torch.zeros_like(micro_inputs)
    for t in range(n_micro + n_stages - 1):
        x = micro_inputs[min(t, n_micro - 1)] if stage == 0 else carry
        y = stage_fn(params, x)
        out_idx = t - (n_stages - 1)
        if out_idx >= 0 and stage == n_stages - 1:
            outputs[out_idx] = y
        # ring: stage s sends to s+1, receives from s-1 (the reference's
        # ppermute, the last stage's send landing on stage 0 unused)
        y = y.contiguous()
        carry = torch.empty_like(y)
        for req in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, y, nxt, group),
                 dist.P2POp(dist.irecv, carry, prv, group)]):
            req.wait()
    dist.broadcast(outputs, group_src=n_stages - 1, group=group)
    return outputs


def stack_stages(layer_params: PyTree, n_stages: int) -> PyTree:
    """Regroup per-layer stacked params (L, ...) into (S, L/S, ...)."""
    def regroup(leaf):
        L = leaf.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} "
                             f"stages")
        return leaf.reshape(n_stages, L // n_stages, *leaf.shape[1:])

    return tree_map(regroup, layer_params)
