"""Block-skip backward of the spike GEMM on the card
(``csrc/spike_gemm_bwd.cu``).

``dW[K,N] = Sᵀ @ g`` gated by the FORWARD's flags of ``S`` (read with the
reduction index first), and ``dS[M,K] = g @ Wᵀ`` gated by the any-nonzero
flags of ``g`` (``ops.cotangent_block_flags``), both at ``build.TILE``.
dW splits its reduction over M across blocks (``dw_splits``) and adds the
partials in a fixed order, so its result does not change from run to run.
``ops.spike_gemm_bwd_dw`` / ``ops.spike_gemm_bwd_ds`` are the public entry
points and send CPU tensors to the plain versions in ``ref.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: Kernel launches since the last reset (``ops.reset_launch_counts``), one
#: counter per kernel.
dw_launches = 0
ds_launches = 0

#: dW blocks to aim for: about one wave of 8 resident blocks on each of the
#: H100's 132 SMs.  A constant, not the card's SM count, so the split (and
#: with it the order of every sum) depends on the shapes alone.
DW_BLOCKS = 1024


def dw_splits(m: int, k: int, n: int) -> int:
    """Ranges of M that dW's reduction is split into: enough blocks to fill
    the card, never more ranges than M has row tiles."""
    m_tiles, k_tiles = build.tile_grid(m, k)
    n_tiles = -(-n // build.TILE["block_n"])
    want = -(-DW_BLOCKS // max(1, k_tiles * n_tiles))
    return max(1, min(m_tiles, want))


@functools.cache
def _dw_entry():
    fn = build.library("spike_gemm_bwd").spike_gemm_dw_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _ds_entry():
    fn = build.library("spike_gemm_bwd").spike_gemm_ds_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spike_gemm_dw_cuda(spikes: torch.Tensor, g: torch.Tensor,
                       flags: torch.Tensor) -> torch.Tensor:
    """``spikes.T @ g`` for (M, K) spikes, (M, N) g and the forward's
    (ceil(M/block_m), ceil(K/block_k)) flags.  Launches on the current
    stream; raises on any operand the kernel does not take."""
    global dw_launches
    dev = build.cuda_device(spikes, "spike_gemm_dw")
    m, k = spikes.shape
    n = g.shape[1]
    build.check_operand(spikes, "spikes", (m, k), dev)
    build.check_operand(g, "g", (m, n), dev)
    build.check_operand(flags, "flags", build.tile_grid(m, k), dev,
                        torch.int32)
    splits = dw_splits(m, k, n)
    out = torch.empty((k, n), dtype=torch.float32, device=dev)
    part = (torch.empty((splits, k, n), dtype=torch.float32, device=dev)
            if splits > 1 else out)
    err = _dw_entry()(spikes.data_ptr(), g.data_ptr(), flags.data_ptr(),
                      part.data_ptr(), out.data_ptr(), m, n, k, splits,
                      build.stream_ptr(dev))
    build.check_launch(err, "spike_gemm_dw")
    dw_launches += 1
    return out


def spike_gemm_ds_cuda(g: torch.Tensor, weights: torch.Tensor,
                       gflags: torch.Tensor) -> torch.Tensor:
    """``g @ weights.T`` for (M, N) g, (K, N) weights and g's
    (ceil(M/block_m), ceil(N/block_k)) any-nonzero flags.  Launches on the
    current stream; raises on any operand the kernel does not take."""
    global ds_launches
    dev = build.cuda_device(g, "spike_gemm_ds")
    m, n = g.shape
    k = weights.shape[0]
    build.check_operand(g, "g", (m, n), dev)
    build.check_operand(weights, "weights", (k, n), dev)
    build.check_operand(gflags, "gflags", build.tile_grid(m, n), dev,
                        torch.int32)
    out = torch.empty((m, k), dtype=torch.float32, device=dev)
    err = _ds_entry()(g.data_ptr(), weights.data_ptr(), gflags.data_ptr(),
                      out.data_ptr(), m, k, n, build.stream_ptr(dev))
    build.check_launch(err, "spike_gemm_ds")
    ds_launches += 1
    return out
