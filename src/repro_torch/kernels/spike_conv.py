"""Block-skip spike convolution on the card (``csrc/spike_conv.cu``), and
the im2col lowering it runs on.

A Conv layer's accumulate is the block-skip GEMM run over the patch matrix
of its spike input: ``conv_patches`` turns (B, H, W, C) spikes into a
(B·OH·OW, KH·KW·C) {0,1} matrix whose features are ordered (dy, dx, c),
so the matching weights are the HWIO filter reshaped to (KH·KW·C, F).
``F.unfold`` orders features (c, dy, dx) and does not fit that reshape.
``ops.spike_conv`` is the public entry point.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

#: Kernel launches since the last reset (``ops.reset_launch_counts``).
launches = 0


def conv_out_size(size: int, kernel: int, stride: int,
                  padding: str) -> tuple[int, int, int]:
    """(output size, pad_lo, pad_hi) of one spatial dim, in XLA's SAME /
    VALID convention: SAME puts the odd pad on the high side."""
    if padding == "SAME":
        out = -(-size // stride)
        pad = max((out - 1) * stride + kernel - size, 0)
        return out, pad // 2, pad - pad // 2
    if padding == "VALID":
        return (size - kernel) // stride + 1, 0, 0
    raise ValueError(f"unknown padding {padding!r}; pick SAME or VALID")


def conv_patches(s_in: torch.Tensor, kh: int, kw: int, stride: int,
                 padding: str) -> torch.Tensor:
    """im2col: (B, H, W, C) -> contiguous (B·OH·OW, KH·KW·C).

    Row ``b·OH·OW + oh·OW + ow`` is output pixel (b, oh, ow)'s receptive
    field, features in (dy, dx, c) order."""
    b, h, w, c = s_in.shape
    oh, ph_lo, ph_hi = conv_out_size(h, kh, stride, padding)
    ow, pw_lo, pw_hi = conv_out_size(w, kw, stride, padding)
    xp = F.pad(s_in, (0, 0, pw_lo, pw_hi, ph_lo, ph_hi))
    cols = [xp[:, dy:dy + (oh - 1) * stride + 1:stride,
               dx:dx + (ow - 1) * stride + 1:stride, :]
            for dy in range(kh) for dx in range(kw)]
    return torch.cat(cols, dim=-1).reshape(b * oh * ow, kh * kw * c)


@functools.cache
def _entry():
    fn = build.library("spike_conv").spike_conv_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spike_conv_cuda(patches: torch.Tensor, weights: torch.Tensor,
                    flags: torch.Tensor) -> torch.Tensor:
    """``patches @ weights`` over the (M, K) patch matrix and the (K, F)
    reshaped filter, skipping empty patch tiles.  Launches on the current
    stream; raises on any operand the kernel does not take."""
    global launches
    dev = build.cuda_device(patches, "spike_conv")
    m, k = patches.shape
    n = weights.shape[1]
    build.check_operand(patches, "patches", (m, k), dev)
    build.check_operand(weights, "weights", (k, n), dev)
    build.check_operand(flags, "flags", build.tile_grid(m, k), dev,
                        torch.int32)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    err = _entry()(patches.data_ptr(), weights.data_ptr(), flags.data_ptr(),
                   out.data_ptr(), m, n, k, build.stream_ptr(dev))
    build.check_launch(err, "spike_conv")
    launches += 1
    return out
