"""Device meshes: the production meshes, small test meshes, the axis
helpers of the JAX package's ``repro.launch.mesh``, and the ambient mesh
that ``models.layers.maybe_shard`` constrains against.

PyTorch is multi-controller: every rank runs the same program on its own
shard, so a mesh is built over an initialised process group (NCCL on the
cards, gloo on the CPU), one rank a device.  ``init_distributed`` starts
that group from a ``torchrun``-style environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``), or from an explicit ``init_method``.
A mesh that is asked for and cannot be built raises; nothing falls back to
one device.

The sharding rules (``distributed/sharding.py``) read only
``axis_names`` and ``shape[axis]`` of a mesh; ``axis_sizes`` gives that
view of a ``DeviceMesh`` or of any object that already has both (a
stand-in mesh in a test), so the rules run at production size without
512 processes.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
from typing import Iterator, Optional

import torch
import torch.distributed as dist

#: The production meshes: one pod of 16 x 16 chips, two pods of them.
SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def init_distributed(device_type: str = "cuda", *,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: float = 600.0) -> None:
    """Initialise the default process group unless one exists: NCCL for
    ``"cuda"`` (each rank on card ``LOCAL_RANK``, else ``rank`` modulo the
    local cards), gloo for ``"cpu"``.  Without ``init_method`` the group
    reads the ``torchrun`` environment, and raises if it is not set."""
    if dist.is_initialized():
        return
    if init_method is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(
                "no process group: set " + ", ".join(missing) +
                " (as torchrun does) or pass init_method, rank and "
                "world_size")
        init_method = "env://"
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        global_rank = int(os.environ.get("RANK", 0)) if rank is None else rank
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", global_rank % torch.cuda.device_count())))
    kw = {} if rank is None else {"rank": rank, "world_size": world_size}
    dist.init_process_group(backend, init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...],
          device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs an initialised process "
                           f"group (launch.mesh.init_distributed)")
    want = math.prod(shape)
    if dist.get_world_size() != want:
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh over "
                           f"{axes} needs {want} ranks; the process group "
                           f"has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: 16x16 = 256 ranks over ("data", "model").  Multi-pod:
    2 pods x 256 = 512 ranks over ("pod", "data", "model").  Raises unless
    the process group has exactly that many ranks."""
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    return _mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type: str = "cpu"):
    """A small mesh over the current process group: on ``"cpu"`` over
    gloo, on ``"cuda"`` over NCCL."""
    return _mesh(tuple(shape), tuple(axes), device_type)


def batch_axes(mesh) -> tuple[str, ...]:
    """The axes the global batch shards over."""
    names = axis_sizes(mesh).axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def model_axis(mesh) -> str:
    return "model"


def num_chips(mesh) -> int:
    return math.prod(axis_sizes(mesh).shape.values())


class AxisSizes:
    """``axis_names`` and ``shape[axis]`` of a mesh: all the sharding
    rules read."""

    def __init__(self, axis_names, sizes):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))


def axis_sizes(mesh) -> AxisSizes:
    """The axis-size view of a ``DeviceMesh`` (``mesh_dim_names`` and
    ``mesh.shape``), or of an object that has ``axis_names`` and a
    ``shape`` mapping already."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return AxisSizes(names, tuple(mesh.shape))
    return AxisSizes(mesh.axis_names,
                     tuple(mesh.shape[a] for a in mesh.axis_names))


# ---------------------------------------------------------------------------
# The ambient mesh
# ---------------------------------------------------------------------------

_AMBIENT: list = []


def current_mesh():
    """The mesh of the innermost ``use_mesh``, or None."""
    return _AMBIENT[-1] if _AMBIENT else None


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator:
    """Run the body against ``mesh``: ``maybe_shard`` constrains to it, and
    plain tensors that meet a DTensor in an op (masks, positions, rope
    tables made inside a model) count as replicated on it.  ``None`` is a
    no-op, as the reference's code runs outside a mesh."""
    if mesh is None:
        yield None
        return
    # the flag of torch.distributed.tensor.experimental.implicit_replication,
    # restored on the way out (that context clears it, which would end an
    # enclosing use_mesh's too); it is thread-local state that autograd
    # hands to the threads that run a backward
    prev = torch._C._get_dtensor_allow_implicit_replication()
    _AMBIENT.append(mesh)
    torch._C._set_dtensor_allow_implicit_replication(True)
    try:
        yield mesh
    finally:
        torch._C._set_dtensor_allow_implicit_replication(prev)
        _AMBIENT.pop()
