"""Spike GEMM on the card (``csrc/spike_gemm.cu``).

``out[M,N] = S[M,K] @ W[K,N]`` in fp32, skipping every
``TILE["block_m"] x TILE["block_k"]`` tile of ``S`` whose flag is 0 and
every zero spike inside the tiles it reads.  The flags come from
``ops.block_flags``; ``ops.spike_gemm`` is the public entry point and sends
CPU tensors to ``ref.spike_gemm_ref`` instead.

The kernel splits K across blocks (``csrc/dense_split.cuh``).
``split_plan`` picks the splits from the shapes alone, the wrapper gives the
kernel a ``(splits, M, N)`` fp32 workspace for the partial sums when there
is more than one, and the kernel adds them in ascending split order.  The
fused GEMM+LIF step (``spike_gemm_fused``) takes the same plan.

A slab of C cells, ``(C, M, K) @ (C, K, N)`` with ``(C, ...)`` flags, runs
in the same single launch: C independent products, each on the solo
shape's plan (the cell axis never folds into M, which would change the
splits and so the order of the sums).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import spans
from repro_torch.kernels import build

#: The block tile of the split kernels (``dense_split.cuh``: ``kRows``,
#: ``kCols``) and the depth of a slab of K, one flag column.
ROWS = 2 * build.TILE["block_m"]
COLS = build.DENSE_COLS
SLAB = build.TILE["block_k"]
#: Blocks to aim for: one wave on the H100's 132 SMs, one block each.  A
#: constant, not the card's SM count, so the split (and with it the order
#: of every sum) depends on the shapes alone.
WAVE = 132


def split_plan(m: int, n: int, k: int) -> tuple[int, int]:
    """``(splits, slabs per split)`` of an (m, k) @ (k, n) product: as many
    splits as fill about one wave of blocks, up to one a slab; then the
    fewest that cover K at that many slabs each, so no split is empty.
    fc1's 1,024 slabs on 2 column tiles take 64 splits of 16.  A block's
    time grows with its slabs and a layer of a few slabs runs on a few
    blocks, so even a small K is split: the reduction costs less than the
    slabs it takes off a block (PERF.md §6)."""
    slabs = -(-k // SLAB)
    tiles = -(-m // ROWS) * -(-n // COLS)
    splits = max(1, min(slabs, WAVE // max(1, tiles)))
    per = max(1, -(-slabs // splits))
    return max(1, -(-slabs // per)), per


def workspace(m: int, n: int, plan: tuple[int, int],
              device: torch.device, cells: tuple[int, ...] = ()
              ) -> torch.Tensor | None:
    """The ``cells + (splits, m, n)`` fp32 partial sums a ``plan`` of more
    than one split needs (``cells``: ``(C,)`` for a slab), or None.  The
    wrapper holds it until the launch is queued: freed before, its memory
    could go to the output the kernel writes."""
    if plan[0] == 1:
        return None
    return torch.empty(tuple(cells) + (plan[0], m, n), dtype=torch.float32,
                       device=device)


@functools.cache
def _entry():
    fn = build.library("spike_gemm").spike_gemm_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spike_gemm_cuda(spikes: torch.Tensor, weights: torch.Tensor,
                    flags: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream: (M, K) spikes, (K, N)
    weights, or a slab of C of each with a leading cell axis (and
    ``(C, ...)`` flags).  Raises on any operand the kernel does not take
    (device, dtype, shape, contiguity)."""
    dev = build.cuda_device(spikes, "spike_gemm")
    lead = build.cell_lead(spikes, 2, "spike_gemm")
    m, k = spikes.shape[-2:]
    n = weights.shape[-1]
    build.check_operand(spikes, "spikes", lead + (m, k), dev)
    build.check_operand(weights, "weights", lead + (k, n), dev)
    build.check_operand(flags, "flags", lead + build.tile_grid(m, k), dev,
                        torch.int32)
    splits, per = plan = split_plan(m, n, k)
    part = workspace(m, n, plan, dev, lead)
    out = torch.empty(lead + (m, n), dtype=torch.float32, device=dev)
    err = _entry()(spikes.data_ptr(), weights.data_ptr(), flags.data_ptr(),
                   0 if part is None else part.data_ptr(),
                   out.data_ptr(), lead[0] if lead else 1, m, n, k, splits,
                   per, build.stream_ptr(dev))
    build.check_launch(err, "spike_gemm")
    spans.count("launch.spike_gemm")
    return out
