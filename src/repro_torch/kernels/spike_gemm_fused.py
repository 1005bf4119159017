"""Fused spike GEMM + LIF scan step on the card
(``csrc/spike_gemm_fused.cu``).

``(u, s) = LIF(u_prev, s_prev, S @ W + b)`` in one launch: the block-skip
accumulate of ``spike_gemm``, then the bias add and membrane update on the
accumulator in registers, rounded exactly as ``ref.lif_step_ref`` rounds.
``ops.spike_gemm_lif_step`` is the public entry point.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: Kernel launches since the last reset (``ops.reset_launch_counts``).
launches = 0

RESETS = ("subtract", "zero")


@functools.cache
def _entry():
    fn = build.library("spike_gemm_fused").spike_gemm_lif_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def spike_gemm_lif_cuda(spikes: torch.Tensor, weights: torch.Tensor,
                        bias: torch.Tensor, u_prev: torch.Tensor,
                        s_prev: torch.Tensor, flags: torch.Tensor, *,
                        beta: float, threshold: float,
                        reset_mechanism: str = "subtract"
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream; raises on any operand the
    kernel does not take.  ``beta`` and ``threshold`` are rounded to fp32
    on the way in, as PyTorch rounds a Python scalar against an fp32
    tensor."""
    global launches
    if reset_mechanism not in RESETS:
        raise ValueError(f"unknown reset mechanism {reset_mechanism!r}")
    dev = build.cuda_device(spikes, "spike_gemm_lif")
    m, k = spikes.shape
    n = weights.shape[1]
    build.check_operand(spikes, "spikes", (m, k), dev)
    build.check_operand(weights, "weights", (k, n), dev)
    build.check_operand(bias, "bias", (n,), dev)
    build.check_operand(u_prev, "u_prev", (m, n), dev)
    build.check_operand(s_prev, "s_prev", (m, n), dev)
    build.check_operand(flags, "flags", build.tile_grid(m, k), dev,
                        torch.int32)
    u = torch.empty((m, n), dtype=torch.float32, device=dev)
    s = torch.empty((m, n), dtype=torch.float32, device=dev)
    err = _entry()(spikes.data_ptr(), weights.data_ptr(), flags.data_ptr(),
                   bias.data_ptr(), u_prev.data_ptr(), s_prev.data_ptr(),
                   u.data_ptr(), s.data_ptr(), m, n, k, beta, threshold,
                   int(reset_mechanism == "subtract"), build.stream_ptr(dev))
    build.check_launch(err, "spike_gemm_lif")
    launches += 1
    return u, s
