"""Backward of the spike layers on the card (``csrc/spike_gemm_bwd.cu``).

A Dense layer's ``dW[K,N] = Sᵀ @ g`` gated by the FORWARD's flags of ``S``
(read with the reduction index first), and ``dS[M,K] = g @ Wᵀ`` gated by
the any-nonzero flags of ``g`` (``ops.cotangent_block_flags``), both at
``build.TILE``.  A Conv layer's dW (KH, KW, C, F) from its (B, H, W, C)
input spikes and (B, OH, OW, F) cotangent, gathered by events from the
spikes themselves (``spike_conv_dw_cuda``); its dS is the matrix dS in
patch space.  Both dWs split their reduction across blocks (``dw_splits``,
``conv_dw_plan``) and add the partials in a fixed order, so their result
does not change from run to run; each call counts as one launch of
``spike_gemm_dw``.  ``ops.spike_gemm_bwd_dw``, ``ops.spike_conv_bwd_dw``
and ``ops.spike_gemm_bwd_ds`` are the public entry points and send CPU
tensors to the plain versions in ``ref.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, spike_conv

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


#: The H100's SMs: a constant, not the card's own number, so that the
#: order of dW's sums depends on the shapes alone.
SMS = 132
#: Warps of a conv dW block, at most (``csrc/spike_gemm_bwd.cu``).
CONV_DW_MAX_WARPS = 16


def conv_dw_plan(tiles: int, items: int, smem: int) -> tuple[int, int, int]:
    """(warps a block, splits, tiles per split) of a conv layer's dW over
    ``tiles`` output tiles: a warp per item, a tap and a word of 32
    channels (4 to ``CONV_DW_MAX_WARPS``), and as many splits, none of them
    empty, as blocks of ``smem`` bytes fit in one wave."""
    warps = min(max(items, 4), CONV_DW_MAX_WARPS)
    resident = max(1, min(2048 // (32 * warps),
                          spike_conv.SM_SMEM // (smem + 1024)))
    per = max(1, -(-tiles // (SMS * resident)))
    return warps, -(-tiles // per), per


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


@functools.cache
def _conv_dw_entry():
    fn = build.library("spike_gemm_bwd").spike_conv_dw_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 18 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spike_conv_dw_cuda(s_in: torch.Tensor, g: torch.Tensor, kh: int,
                       kw: int, stride: int, padding: str) -> torch.Tensor:
    """dW (KH, KW, C, F) of a convolution from its (B, H, W, C) fp32 input
    spikes and (B, OH, OW, F) fp32 cotangent.  Launches on the current
    stream; raises on any operand the kernel does not take."""
    global dw_launches
    dev = build.cuda_device(s_in, "spike_conv_dw")
    if s_in.dim() != 4 or g.dim() != 4:
        raise ValueError(f"spike_conv_dw takes (B, H, W, C) spikes and a "
                         f"(B, OH, OW, F) cotangent; got "
                         f"{tuple(s_in.shape)} and {tuple(g.shape)}")
    b, h, w, c = s_in.shape
    f = g.shape[-1]
    geo = spike_conv.conv_geometry(s_in.shape, (kh, kw, c, f), stride,
                                   padding, dw=True)
    oh, ow, tr, tw = geo[4], geo[5], geo[12], geo[13]
    build.check_operand(s_in, "s_in", (b, h, w, c), dev)
    build.check_operand(g, "g", (b, oh, ow, f), dev)
    warps, splits, per = conv_dw_plan(b * -(-oh // tr) * -(-ow // tw),
                                      kh * kw * -(-c // 32), geo[-1])
    out = torch.empty((kh, kw, c, f), dtype=torch.float32, device=dev)
    if c == 0:
        return out
    part = (torch.empty((splits, kh * kw * c * f), dtype=torch.float32,
                        device=dev) if splits > 1 else out)
    err = _conv_dw_entry()(s_in.data_ptr(), g.data_ptr(), part.data_ptr(),
                           out.data_ptr(), *geo[:-1], warps, splits, per,
                           geo[-1],
                           build.stream_ptr(dev))
    build.check_launch(err, "spike_conv_dw")
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
