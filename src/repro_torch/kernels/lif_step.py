"""Elementwise LIF membrane update on the card (``csrc/lif_step.cu``).

``(u, s) = LIF(u_prev, s_prev, current)`` on (B, N) fp32 or bfloat16, with
the subtract or the zero reset, rounded exactly as ``ref.lif_step_ref``
rounds (in bfloat16: every operation in fp32, its result rounded to
bfloat16).  Forward only.  ``ops.lif_step`` is the public entry point and
sends CPU tensors to ``ref.lif_step_ref`` instead.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import spans
from repro_torch.kernels import build
from repro_torch.kernels.spike_gemm_fused import RESETS

#: dtype -> the C entry point that takes it.
ENTRIES = {torch.float32: "lif_step_f32_launch",
           torch.bfloat16: "lif_step_bf16_launch"}


@functools.cache
def _entry(symbol: str):
    fn = getattr(build.library("lif_step"), symbol)
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def lif_step_cuda(u_prev: torch.Tensor, s_prev: torch.Tensor,
                  current: torch.Tensor, *, beta: float, threshold: float,
                  reset_mechanism: str = "subtract"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream; raises on any operand the
    kernel does not take (device, dtype, shape, contiguity).  The kernel
    rounds ``beta`` and ``threshold`` to the operands' dtype first, as the
    plain version does."""
    if reset_mechanism not in RESETS:
        raise ValueError(f"unknown reset mechanism {reset_mechanism!r}")
    dev = build.cuda_device(u_prev, "lif_step")
    dtype = u_prev.dtype
    if dtype not in ENTRIES:
        raise TypeError(f"lif_step takes {sorted(map(str, ENTRIES))}, got "
                        f"{dtype}")
    if u_prev.dim() != 2:
        raise ValueError(f"lif_step takes (B, N) operands, got shape "
                         f"{tuple(u_prev.shape)}")
    shape = tuple(u_prev.shape)
    for t, name in ((u_prev, "u_prev"), (s_prev, "s_prev"),
                    (current, "current")):
        build.check_operand(t, name, shape, dev, dtype)
    u = torch.empty_like(u_prev)
    s = torch.empty_like(u_prev)
    tensors = (u_prev, s_prev, current, u, s)
    vectorized = int(all(t.data_ptr() % 16 == 0 for t in tensors))
    err = _entry(ENTRIES[dtype])(*(t.data_ptr() for t in tensors),
                                 u_prev.numel(), beta, threshold,
                                 int(reset_mechanism == "subtract"),
                                 vectorized, build.stream_ptr(dev))
    build.check_launch(err, "lif_step")
    spans.count("launch.lif_step")
    return u, s
