"""Per-architecture sharding rules: the JAX package's
``repro.distributed.sharding``, with DTensor placements in place of
``NamedSharding``.

Conventions (DESIGN.md §5):
  * "model" (M, 16-way): tensor-parallel dims — flattened head projections,
    d_ff, vocab, MoE experts (when E % 16 == 0), SSD heads, cache seq.
  * "data" (D, 16-way) and "pod" (P, 2-way): the global batch; additionally
    the FSDP axis for very large models (optimizer state + params shard over
    D), and the cache *sequence* axis when batch == 1 (long_500k).
  * Projections are sharded on their flattened output dim (e.g. n_heads *
    head_dim), never on a raw head count.

A spec is a ``P``: a tuple with an entry per tensor dimension (``None``, an
axis name, or a tuple of names), read as ``jax.sharding.PartitionSpec``
reads; missing trailing entries are ``None``.  The rules read only a mesh's
``axis_names`` and ``shape[axis]`` (``launch.mesh.axis_sizes``), so they run
on a stand-in mesh at production size.  ``to_named`` pairs a spec with a
``DeviceMesh``; its ``placements`` are DTensor's: for each mesh dimension,
``Shard(d)`` on the tensor dim whose entry names that axis, else
``Replicate()``.

One layout differs from the reference's: a tuple entry such as
``("model", "data")`` on one dim.  JAX splits that dim model-major (the
first name outermost); DTensor splits a dim sharded over two mesh
dimensions in mesh-dimension order, so on a ``("data", "model")`` mesh the
port's blocks are data-major.  The global values agree; which rank holds
which block differs.

Paths are the reference's ``_keystr`` of the same tree: dict keys joined by
``/`` (``layers/attn/wq``).  The port's parameter trees carry the
reference's keys, so every rule reads the same path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import axis_sizes
from repro_torch.tree import leaves, tree_map, unflatten

PyTree = Any

# archs whose optimizer state / params additionally shard over "data" (ZeRO)
FSDP_ARCHS = {"arctic-480b", "qwen2-vl-72b", "mixtral-8x7b", "chatglm3-6b"}


class P(tuple):
    """A partition spec: ``P("data", None)``.  A tuple of entries, so two
    specs compare as tuples (and as the reference's ``PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def is_spec(x) -> bool:
    """A spec is a leaf of a tree of specs (``tree``'s ``is_leaf``)."""
    return isinstance(x, P)


def _map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree's leaves; ``path`` as the reference's
    ``_keystr`` builds it (keys and indices joined by ``/``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", None)
        items = [_map_with_path(fn, x, f"{prefix}{fields[i] if fields else i}/")
                 for i, x in enumerate(tree)]
        return type(tree)(*items) if fields else type(tree)(items)
    return fn(prefix[:-1], tree)


def _divisible(n: int, mesh, axis: str) -> bool:
    return n % mesh.shape[axis] == 0


def param_spec(path: str, shape: tuple[int, ...], cfg: ArchConfig,
               mesh) -> P:
    """Sharding spec for one parameter leaf.

    ``shape`` includes the stacked-layer leading dim (scan layout): specs
    lead with None for it.
    """
    mesh = axis_sizes(mesh)
    lead = (None,)  # stacked layers / groups dims (never sharded)
    is_stacked = ("layers/" in path or "mamba/" in path or
                  "encoder/" in path or "decoder/" in path)
    core = shape[1:] if is_stacked else shape
    if "mamba/" in path:                  # (ng, every, ...) double-stacked
        core = shape[2:]
        lead = (None, None)
    if not is_stacked:
        lead = ()

    def with_lead(*spec):
        return P(*lead, *spec)

    M = "model"
    # ---- embeddings / unembedding ----
    if path.endswith("embed/embedding"):
        return P(M, None)                 # vocab-sharded
    if "lm_head" in path:
        return with_lead(None, M) if len(core) == 2 else with_lead(None)
    # ---- MoE ----
    if "/moe/" in path or path.startswith("moe/"):
        if "router" in path:
            return with_lead(*([None] * len(core)))
        if len(core) == 3:  # (E, d, ff) / (E, ff, d)
            if cfg.moe and _divisible(cfg.moe.num_experts, mesh, M):
                return with_lead(M, None, None)        # expert parallel
            # few experts (mixtral): tensor-parallel on each expert's ff dim
            ff_dim = 1 if "w_down" in path else 2
            spec = [None, None, None]
            spec[ff_dim] = M
            return with_lead(*spec)
        # dense-residual MLP inside the moe dict
        if "w_down" in path:
            return with_lead(M, None)
        if "w_gate" in path or "w_up" in path:
            return with_lead(None, M)
        return with_lead(*([None] * len(core)))
    # ---- attention / MLP projections ----
    if any(k in path for k in ("wq", "wk", "wv")):
        return with_lead(None, M)
    if "wo" in path:
        return with_lead(M, None)
    if "w_gate" in path or "w_up" in path:
        return with_lead(None, M)
    if "w_down" in path:
        return with_lead(M, None)
    # ---- SSM block ----
    if "in_proj" in path:
        return with_lead(None, M)
    if "out_proj" in path:
        return with_lead(M, None)
    if "conv_w" in path:
        return with_lead(None, M)
    if "conv_b" in path:
        return with_lead(M)
    # ---- norms, biases, scalars ----
    return with_lead(*([None] * len(core)))


def param_specs(cfg: ArchConfig, params_shapes: PyTree, mesh,
                fsdp: Optional[bool] = None) -> PyTree:
    fsdp = cfg.name in FSDP_ARCHS if fsdp is None else fsdp

    def one(path, leaf):
        spec = param_spec(path, tuple(leaf.shape), cfg, mesh)
        if fsdp:
            spec = fsdp_extend(spec, tuple(leaf.shape), mesh,
                               skip_tp_experts=False)
        return spec

    return _map_with_path(one, params_shapes)


def fsdp_extend(spec: P, shape: tuple[int, ...], mesh,
                axis: str = "data", min_size: int = 1024,
                skip_tp_experts: bool = True) -> P:
    """ZeRO-style: shard the largest still-replicated dim over `axis`."""
    mesh = axis_sizes(mesh)
    if axis not in mesh.axis_names:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for e in entries:                    # already data-sharded (e.g. 2D ff)
        if e == axis or (isinstance(e, tuple) and axis in e):
            return spec
    if skip_tp_experts and len(shape) >= 3 and any(
            e == "model" for e in entries[1:]):
        return spec
    best, best_size = None, min_size - 1
    for i, (s, n) in enumerate(zip(entries, shape)):
        if s is None and n % mesh.shape[axis] == 0 and n > best_size:
            best, best_size = i, n
    if best is None:
        return spec
    entries[best] = axis
    return P(*entries)


def serve_param_specs(cfg: ArchConfig, params_shapes: PyTree, mesh) -> PyTree:
    """Decode-time weight sharding: 2D TP across (model x data).  Every
    large weight is fully sharded across both axes with "data" on a
    NON-contracted dim, so the forward needs no weight resharding."""
    base = param_specs(cfg, params_shapes, mesh, fsdp=False)
    mesh = axis_sizes(mesh)

    def extend(spec: P, leaf) -> P:
        shape = tuple(leaf.shape)
        if len(shape) < 2 or "data" not in mesh.axis_names:
            return spec
        nd_data = mesh.shape["data"]
        nd_both = nd_data * mesh.shape["model"]
        entries = list(spec) + [None] * (len(shape) - len(spec))
        if "data" in entries or any(isinstance(e, tuple) for e in entries):
            return spec
        last = len(shape) - 1
        # output (non-contracted) dim last: prefer sharding it
        if entries[last] is None and shape[last] % nd_data == 0:
            entries[last] = "data"
        elif entries[last] == "model" and shape[last] % nd_both == 0:
            entries[last] = ("model", "data")
        else:
            for i in range(len(shape) - 1, -1, -1):
                if entries[i] is None and shape[i] % nd_data == 0:
                    entries[i] = "data"
                    break
        return P(*entries)

    return tree_map(extend, base, params_shapes, is_leaf=is_spec)


# ---------------------------------------------------------------------------
# Optimizer state specs (mirror the param tree; factored leaves truncated)
# ---------------------------------------------------------------------------

def _structure(tree):
    """A hashable outline of a tree: its containers and where leaves sit."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_structure(x) for x in tree))
    return "*"


def opt_state_specs(opt_shapes: PyTree, params_shapes: PyTree,
                    p_specs: PyTree) -> PyTree:
    """The specs of an optimizer state (a tree of ``optim`` NamedTuples):
    a subtree shaped like the params takes their specs, leaf by leaf (a
    factored Adafactor row or column the spec without its last or
    second-to-last entry); every other leaf (a step count) is
    replicated."""
    pstruct = _structure(params_shapes)
    p_leaves = leaves(params_shapes)
    s_leaves = leaves(p_specs, is_leaf=is_spec)

    def match_leaf(leaf, param, spec):
        lshape, pshape = tuple(leaf.shape), tuple(param.shape)
        if lshape == pshape:
            return spec
        entries = list(spec) + [None] * (len(pshape) - len(spec))
        if lshape == pshape[:-1]:                        # adafactor row
            return P(*entries[:-1])
        if lshape == pshape[:-2] + pshape[-1:]:          # adafactor col
            return P(*(entries[:-2] + entries[-1:]))
        return P()

    def rec(sub):
        if sub is None:
            return None
        if not isinstance(sub, (dict, list, tuple)):
            return P()                                   # scalar state (count)
        if _structure(sub) == pstruct:
            return unflatten(sub, [match_leaf(*x) for x in
                                   zip(leaves(sub), p_leaves, s_leaves)])
        if hasattr(sub, "_fields"):
            return type(sub)(*[rec(getattr(sub, f)) for f in sub._fields])
        if isinstance(sub, (tuple, list)):
            return type(sub)(rec(x) for x in sub)
        return {k: rec(v) for k, v in sub.items()}

    return rec(opt_shapes)


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------

def _baxes(mesh):
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _nb(mesh, ba) -> int:
    n = 1
    for a in (ba if isinstance(ba, tuple) else (ba,)):
        n *= mesh.shape[a]
    return n


def batch_specs(cfg: ArchConfig, batch: PyTree, mesh) -> PyTree:
    mesh = axis_sizes(mesh)
    ba = _baxes(mesh)
    nb = _nb(mesh, ba)

    def one(path, leaf):
        if "positions" in path:            # (3, B, S)
            return P(None, ba, None) if leaf.shape[1] % nb == 0 else P()
        if leaf.shape[0] % nb != 0:        # tiny batch (long_500k): replicate
            return P(*([None] * leaf.ndim))
        return P(ba, *([None] * (leaf.ndim - 1)))

    return _map_with_path(one, batch)


def cache_specs(cfg: ArchConfig, cache_shapes: PyTree, mesh,
                batch_size: int) -> PyTree:
    """KV/state cache sharding.

    batch >= batch-shards: shard batch over (pod?, data), the K/V sequence
    axis over model.  batch == 1 (long_500k): shard the cache sequence axis
    over (data, model) instead.  ``length`` (a host int) is replicated.
    """
    mesh = axis_sizes(mesh)
    ba = _baxes(mesh)
    nb = _nb(mesh, ba)
    shard_batch = batch_size % nb == 0
    M = "model"

    def one(p, leaf):
        if p.endswith("length"):
            return P()
        if p.endswith("slot_pos"):          # (B, C)
            if shard_batch:
                return P(ba, None)
            return (P(None, "data")
                    if leaf.shape[1] % mesh.shape["data"] == 0 else P())
        # cache tensors: (L, B, C, n_kv, hd) | (L/ng, B, ...) | (ng, every, B, ...)
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        try:
            bpos = shape.index(batch_size)
        except ValueError:
            return P(*spec)
        if shard_batch:
            spec[bpos] = ba
        if p.endswith("k") or p.endswith("v") or "cross" in p:
            # (..., B, C, n_kv, hd): shard the SEQUENCE dim C on "model"
            # (split-KV / flash-decoding style)
            if not shard_batch and shape[-3] % (
                    mesh.shape["data"] * mesh.shape[M]) == 0:
                spec[-3] = ("data", M)
            elif shape[-3] % mesh.shape[M] == 0:
                spec[-3] = M
        elif p.endswith("h"):               # SSD state (..., B, H, N, P)
            if shape[bpos + 1] % mesh.shape[M] == 0:
                spec[bpos + 1] = M          # heads on model
        elif "conv" in p:                   # (..., B, W-1, conv_ch)
            if shape[-1] % mesh.shape[M] == 0:
                spec[-1] = M
        return P(*spec)

    return _map_with_path(one, cache_shapes)


# ---------------------------------------------------------------------------
# Specs on a mesh: DTensor placements
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh``: the reference's ``NamedSharding``."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for axis in self.mesh.mesh_dim_names:
            dims = [d for d, e in enumerate(self.spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def splits(x, dim: int) -> int:
    """The count of blocks dim ``dim`` of ``x`` is split into over its
    mesh; 1 for anything but a DTensor."""
    if not is_dtensor(x):
        return 1
    mesh = x.device_mesh
    return math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                     if p.is_shard(dim))


def whole(x):
    """A DTensor gathered whole on every rank (a collective: every rank
    calls it); anything else as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def mesh_of(tree: PyTree):
    """The mesh of a tree's first DTensor leaf, or None."""
    return next((x.device_mesh for x in leaves(tree) if is_dtensor(x)),
                None)


def to_named(tree_specs: PyTree, mesh) -> PyTree:
    return tree_map(lambda s: NamedSharding(mesh, s), tree_specs,
                    is_leaf=is_spec)


def constrain(x, spec: P, mesh):
    """``x`` redistributed to ``spec`` on ``mesh`` when it is a DTensor
    (the reference's ``with_sharding_constraint``); a plain tensor is
    returned as it is."""
    if not is_dtensor(x):
        return x
    return x.redistribute(mesh, NamedSharding(mesh, spec).placements)


def place(x, sharding: NamedSharding):
    """One tensor as a DTensor on ``sharding``'s mesh and placements: from
    a full tensor that every rank holds alike (each rank keeps its block,
    nothing is sent), or a DTensor redistributed.  A tensor off the mesh's
    device type moves there first."""
    from torch.distributed.tensor import distribute_tensor
    mesh, placements = sharding.mesh, sharding.placements
    if is_dtensor(x):
        return x.redistribute(mesh, placements)
    x = x.to(mesh.device_type)
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def place_tree(tree: PyTree, shardings: PyTree) -> PyTree:
    """``place`` over a tree and its tree of shardings (the reference's
    ``jax.device_put(tree, shardings)``); non-tensor leaves (a host int)
    stay as they are."""
    import torch
    xs, shs = leaves(tree), leaves(shardings)
    if len(xs) != len(shs):
        raise ValueError(f"{len(xs)} leaves against {len(shs)} shardings")
    return unflatten(tree, [place(x, s) if isinstance(x, torch.Tensor)
                            else x for x, s in zip(xs, shs)])


__all__ = ["FSDP_ARCHS", "NamedSharding", "P", "batch_specs", "cache_specs",
           "constrain", "fsdp_extend", "is_dtensor", "is_spec", "mesh_of",
           "opt_state_specs", "param_spec", "param_specs", "place",
           "place_tree", "serve_param_specs", "splits", "to_named", "whole"]
