"""Atomic checkpoints of NumPy trees (lists, tuples and dicts of arrays), in
the JAX package's on-disk format (msgpack + zstandard, or zlib where the
zstandard package is missing).

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
  * ``keep_last`` retention.
"""
from __future__ import annotations

import os
import shutil
import zlib
from typing import Any, Optional

import msgpack
import numpy as np

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


def leaves(tree: Tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order: dict values by
    sorted key, list and tuple items in order; ``None`` holds no leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in leaves(item)]
    return [] if tree is None else [tree]


def _unflatten(like: Tree, it) -> Tree:
    if isinstance(like, dict):
        filled = {k: _unflatten(like[k], it) for k in sorted(like)}
        return {k: filled[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(item, it) for item in like)
    return None if like is None else next(it)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save(directory: str, step: int, tree: Tree,
         keep_last: Optional[int] = None) -> str:
    """Synchronous checkpoint save.  Returns the published path."""
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    meta, blobs = [], []
    for arr in leaves(tree):
        arr = np.asarray(arr)
        # NB: np.ascontiguousarray promotes 0-d -> 1-d; record shape first
        shape = list(arr.shape)
        data = np.ascontiguousarray(arr)
        meta.append({"shape": shape, "dtype": str(data.dtype),
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


def restore(directory: str, like: Tree, step: Optional[int] = None) -> Tree:
    """Restore into the structure of ``like`` as NumPy arrays at ``like``'s
    dtypes; raises if the leaf count or a shape differs."""
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
                arr = np.frombuffer(buf, dtype=np.dtype(m["dtype"])
                                    ).reshape(m["shape"])
                if tuple(arr.shape) != tuple(np.shape(w)):
                    raise ValueError(f"checkpoint leaf of shape {arr.shape} "
                                     f"where {np.shape(w)} is expected")
                out.append(np.asarray(arr, dtype=np.asarray(w).dtype))
    return _unflatten(like, iter(out))
