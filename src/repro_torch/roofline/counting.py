"""Per-rank FLOP, byte, collective and memory counts of eager PyTorch: the
port's counterpart of the JAX package's ``roofline.hlo_parse``.

It is not a parser.  The reference reads the optimized HLO of a compiled
program, where a scanned layer stack is one ``while`` body whose trip
count has to be recovered from its condition.  Eager PyTorch has no HLO
and unrolls nothing: every loop iteration runs, and every operator it runs
passes through one ``TorchDispatchMode``.  ``count(fn, *args, **kwargs)``
runs ``fn`` under that mode and adds up what the operators do, so there is
no trip count to recover; ``ModuleStats.unknown_trip_loops`` is always 0
and stays so that records have the reference's keys.  The mode only
observes: every operator runs as it would without it, so ``fn`` computes
the same values.  It runs on real tensors, on fake ones
(``torch._subclasses.FakeTensorMode``) and on DTensors over any process
group, the fake one of ``torch.testing._internal.distributed.fake_pg``
included.

The rules are the reference's:

* **FLOPs**: 2 * output elements * contraction for ``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, ``dot``, ``mv`` and ``addmv`` (``matmul``,
  ``einsum`` and ``linear`` reach the dispatcher as these); for a
  convolution 2 * output elements * the product of the weight's dims but
  the output channels (``hlo_parse._conv_flops``), and that again for each
  gradient a ``convolution_backward`` computes; nothing for an elementwise
  op, so that the count compares with ``hlo_parse``'s.  ``dots`` counts
  the products.
* **Bytes**: the operand and output bytes of every operator, except those
  that move no data, the counterpart of ``hlo_parse._NO_TRAFFIC``: views
  (``view``, ``t``, ``permute``, ``expand``, ``slice``, ``select``,
  ``unsqueeze``, ``detach``, ``alias`` and every other operator whose
  schema says it returns a view), ``_unsafe_view``, the waits of
  collectives, operators that only allocate (``empty`` and its kin), and
  operators that return no tensor (``prim.device``, a size).
* **Collectives**: each functional collective the mode sees (those that
  DTensor issues, ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
  ``all_reduce`` and ``all_to_all_single``, as ``CommDebugMode`` sees
  them) adds its output's bytes, at the local shape, under the
  reference's kind (``all-gather``, ``reduce-scatter``, ``all-reduce``,
  ``all-to-all``);
  ``collective_wire_bytes`` weighs them by ``WIRE_MULT`` (an all-reduce
  twice: the reduce-scatter and the all-gather of a ring).
* **Per rank.**  A plain tensor is counted at its own shape: inside
  ``models.layers.on_blocks`` and ``layers.replicated`` the operators run
  on each rank's local tensors.  A DTensor operator is seen once, at
  global shapes, and counts its global FLOPs divided by the product of the
  sizes of the mesh dims on which its output is ``Shard``,
  ``_StridedShard`` or ``Partial``: a product whose output is replicated
  on a mesh dim costs every rank on that dim the whole work, as the
  reference's partitioned module shows, and one whose output is split or
  a partial sum there costs each rank its share.  Its bytes are the local
  sizes of its operands and output.  What DTensor runs inside the operator
  (its shape propagation at global shapes, the local operator) is not
  counted again, but the collectives it issues to redistribute the
  operands are, as any operator is.  An operator that DTensor decomposes
  into other DTensor operators counts as those.
* **Memory**: the bytes of the storages alive on this rank (a DTensor's
  local storage), from the arguments' at the start, each operator's
  outputs added as they are made and each storage taken off when it is
  freed.  ``peak_bytes`` is the most alive at once, ``argument_bytes`` the
  arguments' storages, ``output_bytes`` the storages of the result that
  the arguments do not hold.  What DTensor allocates inside an operator
  counts only where it is a collective's output (an operand gathered for
  the operator): its shape propagation allocates at global shapes, which
  no rank holds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

#: The wire multiplier of each collective kind (``hlo_parse._WIRE_MULT``).
WIRE_MULT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
             "all-to-all": 1.0, "collective-permute": 1.0}

# the functional collectives (DTensor's, and their autograd forms) by the
# name of their operator
_COLLECTIVE_KIND = {"all_gather_into_tensor": "all-gather",
                    "reduce_scatter_tensor": "reduce-scatter",
                    "all_reduce": "all-reduce",
                    "all_to_all_single": "all-to-all"}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")

# operators that move no data besides the views (``OpOverload.is_view``)
_NO_TRAFFIC = {aten._unsafe_view.default, aten.empty.memory_format,
               aten.empty_strided.default, aten.empty_like.default,
               aten.new_empty.default, aten.new_empty_strided.default,
               aten.lift_fresh.default}

_WAIT = torch.ops._c10d_functional.wait_tensor.default

_MM = {aten.mm.default, aten.bmm.default, aten.addmm.default,
       aten.baddbmm.default, aten.dot.default, aten.vdot.default,
       aten.mv.default, aten.addmv.default}


@dataclasses.dataclass
class ModuleStats:
    """The reference's ``hlo_parse.ModuleStats`` fields, and this rank's
    storage bytes: the arguments', the result's and the most alive at
    once."""
    flops: float
    bytes_accessed: float
    collective_bytes_by_kind: dict
    collective_wire_bytes: float
    unknown_trip_loops: int
    dots: int
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _local(x: torch.Tensor) -> torch.Tensor:
    return x._local_tensor if _is_dtensor(x) else x


def _tensors(tree) -> list:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _nbytes(x: torch.Tensor) -> int:
    x = _local(x)
    return x.numel() * x.element_size()


def _collective_kind(func) -> str | None:
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    return _COLLECTIVE_KIND.get(func._overloadpacket.__name__)


def _matmul_flops(func, args, out) -> float:
    """2 * output elements * contraction of one product, at the shapes of
    its operands (global ones for a DTensor)."""
    if func in (aten.addmm.default, aten.baddbmm.default,
                aten.addmv.default):
        args = args[1:]                   # the added input is elementwise
    return 2.0 * out.numel() * args[0].shape[-1]


def _conv_flops(w_shape, out_numel: int) -> float:
    # the weight is (out channels, in channels / groups, *kernel)
    return 2.0 * out_numel * math.prod(w_shape[1:])


def op_flops(func, args, out) -> tuple[float, int]:
    """(FLOPs, products) of one operator call, at the shapes it sees."""
    if func in _MM:
        return _matmul_flops(func, args, out), 1
    if func is aten.convolution.default:
        return _conv_flops(args[1].shape, out.numel()), 0
    if func is aten.convolution_backward.default:
        # grad_output, input, weight, ..., output_mask (input, weight, bias)
        per = _conv_flops(args[2].shape, args[0].numel())
        return per * sum(bool(m) for m in args[-1][:2]), 0
    return 0.0, 0


def _shard_divisor(out) -> int:
    """The product of the mesh dim sizes on which the DTensor ``out`` is
    split or a partial sum; 1 for anything else."""
    from torch.distributed.tensor.placement_types import _StridedShard
    if not _is_dtensor(out):
        return 1
    mesh = out.device_mesh
    return math.prod(mesh.size(i) for i, p in enumerate(out.placements)
                     if p.is_shard() or p.is_partial()
                     or isinstance(p, _StridedShard))


class _Live:
    """The storages alive on this rank, by storage, with the most bytes
    alive at once.  ``held`` is an upper bound of the live bytes (storages
    freed since the last sweep are still in it); the sweep that finds the
    freed ones runs only when ``held`` passes the peak, the only time the
    peak can move."""

    def __init__(self):
        self.storages: dict[int, tuple[StorageWeakRef, int]] = {}
        self.held = 0
        self.peak = 0

    def add(self, tensors) -> int:
        """Track the storages of ``tensors``; the bytes newly tracked."""
        added = 0
        for t in tensors:
            t = _local(t)
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue                     # a tensor without storage
            key = st._cdata
            if key in self.storages:
                if not self.storages[key][0].expired():
                    continue
                # a freed storage's address, taken by a new one
                self.held -= self.storages.pop(key)[1]
            n = st.nbytes()
            self.storages[key] = (StorageWeakRef(st), n)
            added += n
        self.held += added
        if self.held > self.peak:
            self._sweep()
            self.peak = max(self.peak, self.held)
        return added

    def _sweep(self):
        dead = [k for k, (ref, _) in self.storages.items() if ref.expired()]
        for k in dead:
            self.held -= self.storages.pop(k)[1]


class CountingMode(TorchDispatchMode):
    """The dispatch mode of ``count``: it adds up every operator that runs
    under it, by the rules of the module docstring."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.coll: dict[str, float] = {}
        self.wire = 0.0
        self.dots = 0
        self.live = _Live()
        # the DTensor operators being run: one frame each, True once an
        # operator inside it has been counted as a DTensor operator
        self._frames: list[list[bool]] = []
        self._pass_next = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._pass_next:
                # the operator re-issued below: DTensor's own dispatch
                # runs it, with this mode on for what it issues inside
                self._pass_next = False
                return NotImplemented
            return self._dtensor_op(func, args, kwargs)
        out = func(*args, **kwargs)
        kind = _collective_kind(func)
        if self._frames and kind is None:
            # inside a DTensor operator: counted with it
            return out
        outs = _tensors(out)
        if kind is not None:
            b = sum(_nbytes(t) for t in outs)
            self.coll[kind] = self.coll.get(kind, 0.0) + b
            self.wire += b * WIRE_MULT[kind]
        self._count(func, args, kwargs, out, outs, 1)
        return out

    def _dtensor_op(self, func, args, kwargs):
        for frame in self._frames:
            frame[0] = True
        frame = [False]
        self._frames.append(frame)
        self._pass_next = True
        try:
            with self:
                out = func(*args, **kwargs)
        finally:
            self._pass_next = False
            self._frames.pop()
        if not frame[0]:
            outs = _tensors(out)
            first = next((t for t in outs if _is_dtensor(t)), None)
            self._count(func, args, kwargs, out, outs,
                        _shard_divisor(first))
        return out

    def _count(self, func, args, kwargs, out, outs, divisor):
        f, d = op_flops(func, args, out)
        self.flops += f / divisor
        self.dots += d
        if outs and not (func.is_view or func in _NO_TRAFFIC
                         or func is _WAIT):
            ins = _tensors((args, kwargs))
            self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        self.live.add(outs)

    def stats(self, argument_bytes: int, output_bytes: int) -> ModuleStats:
        return ModuleStats(
            flops=self.flops, bytes_accessed=self.bytes_accessed,
            collective_bytes_by_kind=dict(self.coll),
            collective_wire_bytes=self.wire, unknown_trip_loops=0,
            dots=self.dots, argument_bytes=argument_bytes,
            output_bytes=output_bytes, peak_bytes=self.live.peak)


def count(fn: Callable, *args, **kwargs) -> tuple[Any, ModuleStats]:
    """``fn(*args, **kwargs)`` under the counting mode: (its result, the
    counts of this rank)."""
    mode = CountingMode()
    arg_tensors = _tensors((args, kwargs))
    argument_bytes = mode.live.add(arg_tensors)
    with mode:
        result = fn(*args, **kwargs)
    held = {_local(t).untyped_storage()._cdata for t in arg_tensors}
    fresh = [t for t in _tensors(result)
             if _local(t).untyped_storage()._cdata not in held]
    output_bytes = _Live().add(fresh)
    return result, mode.stats(argument_bytes, output_bytes)
