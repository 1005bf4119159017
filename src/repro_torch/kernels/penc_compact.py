"""PENC spike-address compaction on the card (``csrc/penc_compact.cu``).

Per row of (B, N) fp32 spikes: the ascending indices of the entries > 0,
packed to the front of a (B, capacity) int32 row, -1 padded and cut at
``capacity``; and the row's spike count, not cut, as (B,) int32 (the
paper's Event Control Unit priority-encodes a spike train into addresses
in this order).  ``ops.penc_compact`` is the public entry point and sends
CPU tensors to ``ref.penc_compact_ref`` instead.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: Kernel launches since the last reset (``ops.reset_launch_counts``).
launches = 0

_INT_MAX = 2 ** 31 - 1


@functools.cache
def _entry():
    fn = build.library("penc_compact").penc_compact_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def penc_compact_cuda(spikes: torch.Tensor, capacity: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream; raises on any operand the
    kernel does not take (device, dtype, shape, contiguity, sizes)."""
    global launches
    dev = build.cuda_device(spikes, "penc_compact")
    if spikes.dim() != 2:
        raise ValueError(f"penc_compact takes (B, N) spikes, got shape "
                         f"{tuple(spikes.shape)}")
    b, n = spikes.shape
    build.check_operand(spikes, "spikes", (b, n), dev)
    if not 0 <= capacity <= _INT_MAX or max(b, n) > _INT_MAX:
        raise ValueError(f"penc_compact takes 0 <= capacity and sizes below "
                         f"2**31, got capacity {capacity}, spikes {(b, n)}")
    idx = torch.empty((b, capacity), dtype=torch.int32, device=dev)
    counts = torch.empty((b,), dtype=torch.int32, device=dev)
    vectorized = int(n % 4 == 0 and spikes.data_ptr() % 16 == 0)
    err = _entry()(spikes.data_ptr(), idx.data_ptr(), counts.data_ptr(), b,
                   n, capacity, vectorized, build.stream_ptr(dev))
    build.check_launch(err, "penc_compact")
    launches += 1
    return idx, counts
