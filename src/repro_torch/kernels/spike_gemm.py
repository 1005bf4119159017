"""Block-skip spike GEMM on the card (``csrc/spike_gemm.cu``).

``out[M,N] = S[M,K] @ W[K,N]`` in fp32, skipping every
``TILE["block_m"] x TILE["block_k"]`` tile of ``S`` whose flag is 0.
The flags come from ``ops.block_flags``; ``ops.spike_gemm`` is the public
entry point and sends CPU tensors to ``ref.spike_gemm_ref`` instead.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: Kernel launches since the last reset (``ops.reset_launch_counts``).
launches = 0


@functools.cache
def _entry():
    fn = build.library("spike_gemm").spike_gemm_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spike_gemm_cuda(spikes: torch.Tensor, weights: torch.Tensor,
                    flags: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream; raises on any operand the
    kernel does not take (device, dtype, shape, contiguity)."""
    global launches
    dev = build.cuda_device(spikes, "spike_gemm")
    m, k = spikes.shape
    n = weights.shape[1]
    build.check_operand(spikes, "spikes", (m, k), dev)
    build.check_operand(weights, "weights", (k, n), dev)
    build.check_operand(flags, "flags", build.tile_grid(m, k), dev,
                        torch.int32)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    err = _entry()(spikes.data_ptr(), weights.data_ptr(), flags.data_ptr(),
                   out.data_ptr(), m, n, k, build.stream_ptr(dev))
    build.check_launch(err, "spike_gemm")
    launches += 1
    return out
