"""Fused spike GEMM + LIF scan step on the card
(``csrc/spike_gemm_fused.cu``).

``(u, s) = LIF(u_prev, s_prev, S @ W + b)`` in one launch: the split-K
accumulate of ``spike_gemm`` on ``spike_gemm.split_plan``'s splits, then the
bias add and membrane update on the sum of the splits, rounded exactly as
``ref.lif_step_ref`` rounds.  ``ops.spike_gemm_lif_step`` is the public
entry point.  A slab of C steps of one shape (every operand with a
leading cell axis) runs in the same single launch, each cell on the solo
shape's plan.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import spans
from repro_torch.kernels import build
from repro_torch.kernels.spike_gemm import split_plan, workspace

RESETS = ("subtract", "zero")


@functools.cache
def _entry():
    fn = build.library("spike_gemm_fused").spike_gemm_lif_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
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
    kernel does not take.  Every operand may carry a leading cell axis (a
    slab of C steps, one launch).  ``beta`` and ``threshold`` are rounded
    to fp32 on the way in, as PyTorch rounds a Python scalar against an
    fp32 tensor."""
    if reset_mechanism not in RESETS:
        raise ValueError(f"unknown reset mechanism {reset_mechanism!r}")
    dev = build.cuda_device(spikes, "spike_gemm_lif")
    lead = build.cell_lead(spikes, 2, "spike_gemm_lif")
    m, k = spikes.shape[-2:]
    n = weights.shape[-1]
    build.check_operand(spikes, "spikes", lead + (m, k), dev)
    build.check_operand(weights, "weights", lead + (k, n), dev)
    build.check_operand(bias, "bias", lead + (n,), dev)
    build.check_operand(u_prev, "u_prev", lead + (m, n), dev)
    build.check_operand(s_prev, "s_prev", lead + (m, n), dev)
    build.check_operand(flags, "flags", lead + build.tile_grid(m, k), dev,
                        torch.int32)
    splits, per = plan = split_plan(m, n, k)
    part = workspace(m, n, plan, dev, lead)
    u = torch.empty(lead + (m, n), dtype=torch.float32, device=dev)
    s = torch.empty(lead + (m, n), dtype=torch.float32, device=dev)
    err = _entry()(spikes.data_ptr(), weights.data_ptr(), flags.data_ptr(),
                   bias.data_ptr(), u_prev.data_ptr(), s_prev.data_ptr(),
                   0 if part is None else part.data_ptr(), u.data_ptr(),
                   s.data_ptr(), lead[0] if lead else 1, m, n, k, splits, per,
                   beta, threshold, int(reset_mechanism == "subtract"),
                   build.stream_ptr(dev))
    build.check_launch(err, "spike_gemm_lif")
    spans.count("launch.spike_gemm_lif")
    return u, s
