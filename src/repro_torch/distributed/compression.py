"""Gradient compression for the data-parallel all-reduce (int8 + error
feedback): the JAX package's ``repro.distributed.compression``.

Synchronous data parallelism all-reduces fp32 gradients; at 1000+ nodes the
DP all-reduce is bandwidth-bound, and 4x compression is ~4x fewer bytes on
the wire.  The scheme is the standard error-feedback quantizer:

    e      <- residual carried from last step           (local, never sent)
    g'     <- g + e
    q      <- round(g' / scale) clipped to int8, scale = max|g'| / 127
    e      <- g' - q * scale                            (new residual)
    G      <- all_reduce_mean(q * scale)                (wire: 1 byte/elem)

The reference writes the per-shard body under ``shard_map``; here every
rank runs it on its own batch block, and the mean over each batch axis is
an explicit ``all_reduce`` on that axis's subgroup of the mesh.  As in the
reference the reduction carries the dequantized values (the byte savings
are a property of the interconnect's codec).  ``torch.round`` rounds half
to even, as ``jnp.round`` does, and the operations run in the reference's
order, so one shard's result is the reference's bit for bit.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.tree import leaves, tree_map, unflatten

PyTree = Any


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _pmean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The mean of ``x`` over ``axis``'s ranks of ``mesh`` (every rank of
    the subgroup gets it)."""
    group = mesh.get_group(axis)
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x / dist.get_world_size(group)


def ef_compress_allreduce(grads: PyTree, errors: PyTree,
                          axis_names: Sequence[str], mesh=None
                          ) -> tuple[PyTree, PyTree]:
    """Per rank: error-feedback int8 quantize, mean-all-reduce over each of
    ``axis_names`` of ``mesh`` in turn, return (global grads, new error
    residuals).  With no axis names (one shard) nothing is sent."""
    if axis_names and mesh is None:
        raise ValueError("an all-reduce over mesh axes needs the mesh")

    def one(g, e):
        g32 = g.to(torch.float32) + e
        q, scale = quantize_int8(g32)
        deq = dequantize(q, scale)
        new_e = g32 - deq
        total = deq
        for ax in axis_names:
            total = _pmean(total, mesh, ax)
        return total, new_e

    out = [one(g, e) for g, e in zip(leaves(grads), leaves(errors))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))


def _local_block(x: torch.Tensor, mesh, batch_axes: Sequence[str]
                 ) -> torch.Tensor:
    """This rank's block of a batch leaf along dim 0: a DTensor's local
    tensor, or of a whole tensor that every rank holds alike, the rows the
    rank's coordinates on ``batch_axes`` pick (the first axis outermost)."""
    if hasattr(x, "to_local"):
        return x.to_local()
    n, idx = 1, 0
    for ax in batch_axes:
        size = mesh.size(mesh.mesh_dim_names.index(ax))
        idx = idx * size + mesh.get_local_rank(ax)
        n *= size
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not split over "
                         f"{n} shards")
    per = x.shape[0] // n
    return x[idx * per:(idx + 1) * per]


def make_compressed_grad_fn(loss_fn: Callable, mesh,
                            batch_axes: tuple[str, ...] = ("data",)
                            ) -> Callable:
    """Wrap a per-shard loss into a gradient function with the int8
    error-feedback all-reduce.

    ``loss_fn(params, batch) -> scalar``, computed on the LOCAL batch
    shard.  Returns ``grad_step(params, batch, errors) -> (loss, grads,
    new_errors)``: params whole on every rank, the batch whole on every
    rank (each takes its block over ``batch_axes``) or DTensors sharded
    over them, and the residuals this rank's own (``init_errors``).  The
    loss and grads come back as the mean over the batch shards.
    """
    def grad_step(params, batch, errors):
        local = tree_map(lambda x: _local_block(x, mesh, batch_axes), batch)
        flat = [p.detach().requires_grad_() for p in leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(unflatten(params, flat), local)
            grads = torch.autograd.grad(loss, flat)
        loss = loss.detach()
        for ax in batch_axes:
            loss = _pmean(loss, mesh, ax)
        grads, errors = ef_compress_allreduce(unflatten(params, grads),
                                              errors, batch_axes, mesh)
        return loss, grads, errors

    return grad_step


def init_errors(params: PyTree) -> PyTree:
    """This rank's residuals: float32 zeros shaped like the params.  (The
    reference stacks every shard's residual on a leading axis, as one
    controller holds them all; here each rank keeps its own.)"""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
