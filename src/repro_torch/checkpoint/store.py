"""Atomic checkpoints of trees (lists, tuples and dicts) of NumPy arrays or
tensors on any device, in the JAX package's on-disk format (msgpack +
zstandard, or zlib where the zstandard package is missing).

Layout:  <dir>/step_<N>/manifest.msgpack   (leaf metadata in tree order
                                            + compression codec)
         <dir>/step_<N>/leaves.bin.zst     (concatenated raw leaf bytes;
                                            zstd or zlib, as the manifest
                                            records)

Leaves are ordered as ``jax.tree.leaves`` orders them (dict keys sorted,
sequences in order), so either package restores the other's checkpoints.

Guarantees:
  * atomic publish: data is written to ``step_<N>.tmp`` and ``os.replace``d,
    so a crash mid-save never corrupts the latest checkpoint;
  * async save: the host copy of every leaf is taken synchronously (a tensor
    is detached and copied even on the CPU, so a later in-place update
    cannot reach the writer); the compression and IO run on a background
    thread;
  * restore at ``like``'s types: tensors on each ``like`` tensor's device
    and dtype, NumPy arrays at each ``like`` array's dtype;
  * sharded state: a DTensor leaf is saved whole (``full_tensor``, a
    collective every rank of its mesh joins), and rank 0 alone writes;
    ``restore(..., shardings=...)`` places each leaf on a target mesh, which
    need not be the one it was saved from (an elastic restart on another
    layout), and a DTensor ``like`` leaf is restored onto its own mesh and
    placements;
  * ``keep_last`` retention.
"""
from __future__ import annotations

import os
import shutil
import threading
import zlib
from typing import Any, Optional

import msgpack
import numpy as np
import torch

from repro_torch.distributed.sharding import is_dtensor, place, whole
from repro_torch.tree import leaves, unflatten

try:
    import zstandard
except ImportError:          # no zstd bindings: zlib fallback
    zstandard = None

Tree = Any

_MANIFEST = "manifest.msgpack"
_DATA = "leaves.bin.zst"


class _ZlibWriter:
    def __init__(self, f, level):
        self._f = f
        self._c = zlib.compressobj(level)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.write(self._c.flush())

    def write(self, b):
        self._f.write(self._c.compress(b))


class _ZlibReader:
    def __init__(self, f):
        self._f = f
        self._d = zlib.decompressobj()
        self._buf = b""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def read(self, n):
        while len(self._buf) < n:
            chunk = self._f.read(1 << 20)
            if not chunk:
                self._buf += self._d.flush()
                break
            self._buf += self._d.decompress(chunk)
        out, self._buf = self._buf[:n], self._buf[n:]
        return out


def _writer(f):
    """Best available compressor and its codec tag (recorded in the
    manifest so restore never guesses)."""
    if zstandard is not None:
        return zstandard.ZstdCompressor(level=3).stream_writer(f), "zstd"
    return _ZlibWriter(f, 3), "zlib"


def _reader(f, codec: str):
    if codec == "zstd":
        if zstandard is None:
            raise RuntimeError(
                "checkpoint was written with zstd but the zstandard package "
                "is not installed in this environment")
        return zstandard.ZstdDecompressor().stream_reader(f)
    if codec == "zlib":
        return _ZlibReader(f)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


#: The manifest's name for bf16, as the JAX package writes it (NumPy has
#: no bf16 dtype of its own, so a bf16 leaf travels as its 16-bit words).
_BF16 = "bfloat16"


def _host_copy(leaf) -> tuple[np.ndarray, Optional[str]]:
    """A leaf as a host array of its own, and the dtype name the manifest
    records if not the array's: a tensor is detached and copied off its
    device (copied on the CPU too), a DTensor gathered whole first, an
    array copied; a bf16 tensor comes back as its raw 16-bit words under
    the name ``bfloat16``."""
    if isinstance(leaf, torch.Tensor):
        t = whole(leaf).detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16
        return t.numpy(), None
    return np.array(leaf), None


def sharded(tree: Tree) -> bool:
    """Whether ``tree`` holds a DTensor leaf (state on a mesh, which every
    rank saves together and rank 0 writes)."""
    return any(is_dtensor(x) for x in leaves(tree))


def _writes(tree: Tree) -> bool:
    """Whether this process writes ``tree``: always, unless the tree is on
    a mesh and this is not rank 0."""
    import torch.distributed as dist
    return not (sharded(tree) and dist.is_initialized()
                and dist.get_rank() != 0)


def save(directory: str, step: int, tree: Tree,
         keep_last: Optional[int] = None) -> str:
    """Synchronous checkpoint save.  Returns the published path.  State on
    a mesh: every rank calls this, rank 0 writes, and every rank returns
    once the checkpoint is published."""
    host = [_host_copy(x) for x in leaves(tree)]
    if _writes(tree):
        _write(directory, step, host, keep_last)
    if sharded(tree):
        import torch.distributed as dist
        if dist.is_initialized():
            dist.barrier()
    return _step_dir(directory, step)


def save_async(directory: str, step: int, tree: Tree,
               keep_last: Optional[int] = None) -> threading.Thread:
    """Copy every leaf to the host now; compress and write on a background
    thread, which is returned started (join it to wait for the publish).
    State on a mesh: every rank gathers, rank 0's thread writes, and the
    other ranks' threads do nothing (a reader joins, then waits at a
    barrier, as ``TrainSupervisor`` does)."""
    host = [_host_copy(x) for x in leaves(tree)]
    writes = _writes(tree)
    t = threading.Thread(target=_write if writes else (lambda *a: None),
                         args=(directory, step, host, keep_last),
                         daemon=True)
    t.start()
    return t


def _write(directory: str, step: int,
           host: list[tuple[np.ndarray, Optional[str]]],
           keep_last: Optional[int]) -> str:
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    meta, blobs = [], []
    for arr, name in host:
        # NB: np.ascontiguousarray promotes 0-d -> 1-d; record shape first
        shape = list(arr.shape)
        data = np.ascontiguousarray(arr)
        meta.append({"shape": shape, "dtype": name or str(data.dtype),
                     "nbytes": data.nbytes})
        blobs.append(data.tobytes())
    with open(os.path.join(tmp, _DATA), "wb") as f:
        w, codec = _writer(f)
        with w:
            for b in blobs:
                w.write(b)
    with open(os.path.join(tmp, _MANIFEST), "wb") as f:
        f.write(msgpack.packb({"step": step, "codec": codec, "leaves": meta}))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    if keep_last:
        for old in all_steps(directory)[:-keep_last]:
            shutil.rmtree(_step_dir(directory, old), ignore_errors=True)
    return final


def all_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name.split("_")[1]))
            except ValueError:
                pass
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _like_leaf(arr: np.ndarray, want, bf16: bool):
    """A restored leaf at ``want``'s type: a tensor on its device and dtype,
    else a NumPy array at its dtype.  ``bf16``: ``arr`` holds the 16-bit
    words of bf16 values."""
    if bf16:
        t = torch.from_numpy(np.array(arr)).view(torch.bfloat16)
        if isinstance(want, torch.Tensor):
            return t.to(device=want.device, dtype=want.dtype)
        arr = t.float().numpy()
    elif isinstance(want, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=want.device,
                                                  dtype=want.dtype)
    return np.asarray(arr, dtype=np.asarray(want).dtype)


def restore(directory: str, like: Tree, step: Optional[int] = None,
            shardings: Optional[Tree] = None) -> Tree:
    """Restore into the structure of ``like``: each leaf a tensor on the
    ``like`` tensor's device and dtype, or a NumPy array at the ``like``
    array's dtype; raises if the leaf count or a shape differs.

    ``shardings``: optional tree of ``sharding.NamedSharding`` for the
    TARGET mesh, shaped like ``like``: each tensor leaf is placed on it (an
    elastic restart on another layout).  Without it a DTensor ``like``
    leaf comes back on its own mesh and placements.  Every rank reads the
    checkpoint and keeps its blocks."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = _step_dir(directory, step)
    with open(os.path.join(path, _MANIFEST), "rb") as f:
        manifest = msgpack.unpackb(f.read())
    want = leaves(like)
    meta = manifest["leaves"]
    if len(meta) != len(want):
        raise ValueError(f"checkpoint has {len(meta)} leaves, target tree "
                         f"has {len(want)}")
    codec = manifest.get("codec", "zstd")     # pre-codec checkpoints: zstd
    out = []
    with open(os.path.join(path, _DATA), "rb") as f:
        with _reader(f, codec) as r:
            for m, w in zip(meta, want):
                buf = r.read(m["nbytes"])
                bf16 = m["dtype"] == _BF16
                arr = np.frombuffer(
                    buf, dtype=np.int16 if bf16 else np.dtype(m["dtype"])
                ).reshape(m["shape"])
                if tuple(arr.shape) != tuple(np.shape(w)):
                    raise ValueError(f"checkpoint leaf of shape {arr.shape} "
                                     f"where {tuple(np.shape(w))} is "
                                     f"expected")
                out.append(_like_leaf(arr, w, bf16))
    targets = _targets(like, shardings)
    if any(t is not None for t in targets):
        out = [place(x, t) if t is not None and isinstance(x, torch.Tensor)
               else x for x, t in zip(out, targets)]
    return unflatten(like, out)


def _targets(like: Tree, shardings: Optional[Tree]) -> list:
    """Each leaf's target ``NamedSharding``, or None: from ``shardings``
    when given, else a DTensor ``like`` leaf's own mesh and placements."""
    want = leaves(like)
    if shardings is not None:
        shs = leaves(shardings)
        if len(shs) != len(want):
            raise ValueError(f"{len(shs)} shardings for {len(want)} leaves")
        return shs
    return [_DTensorTarget(w) if is_dtensor(w) else None for w in want]


class _DTensorTarget:
    """A DTensor's own mesh and placements, as ``place`` reads a
    ``NamedSharding``."""

    def __init__(self, x):
        self.mesh, self.placements = x.device_mesh, tuple(x.placements)
