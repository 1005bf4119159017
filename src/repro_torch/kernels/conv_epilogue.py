"""The conv layer's elementwise epilogue on the card
(``csrc/conv_epilogue.cu``): bias, LIF update, spike and, where a MaxPool
follows, the OR-pool, in one forward launch and one backward call.

Forward: ``(u, s[, pooled, first])`` from the bias-free conv output, the
bias and the previous ``(u, s)``, rounded exactly as
``ref.conv_lif_ref`` rounds.  Backward: the cotangents of ``cur``,
``u_prev`` and ``s_prev``, equal to ``ref.conv_lif_bwd_ref``'s bit for
bit, and the bias gradient from per-block partial sums in a fixed order
(no float atomics).  ``ops.conv_lif_step`` is the public entry point.
Operands are (B, H, W, F) fp32 NHWC, or (C, B, H, W, F) with a bias (C, F)
for a slab of C cells, one launch for all, each cell on the solo shape's
plan.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch import spans
from repro_torch.kernels import build
from repro_torch.kernels.spike_gemm_fused import RESETS

#: The largest pooling window: its first-maximum index is one byte.
MAX_WINDOW = 16
#: Threads of a block, and the most blocks a cell's windows are cut into.
THREADS = 256
MAX_BLOCKS = 1024


def epilogue_plan(n_img: int, h: int, w: int, f: int, window: Optional[int]
                  ) -> tuple[int, int, int, int]:
    """(vec, tx, ty, gx) of one cell: float4s along C where F allows, a
    block of tx channel groups by ty windows, gx blocks over the cell's
    windows.  It depends on the solo shape alone, so a slab's cells sum
    their bias gradients in the solo call's order."""
    vec = 4 if f % 4 == 0 else 1
    tx = min(f // vec, 64)
    ty = max(1, THREADS // tx)
    k = window or 1
    windows = n_img * -(-h // k) * -(-w // k)
    gx = max(1, min(-(-windows // ty), MAX_BLOCKS))
    return vec, tx, ty, gx


@functools.cache
def _entry(symbol: str):
    fn = getattr(build.library("conv_epilogue"), symbol)
    pointers = 8 if symbol == "conv_epilogue_fwd_launch" else 12
    floats = 2 if symbol == "conv_epilogue_fwd_launch" else 3
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 10
                   + [ctypes.c_float] * floats
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else build.aligned16(t)


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _geometry(t: torch.Tensor, window: Optional[int], reset_mechanism: str):
    """(device, cell lead, cells, (B, H, W, F)) of a map the kernel takes;
    raises on a reset or window it does not."""
    if reset_mechanism not in RESETS:
        raise ValueError(f"unknown reset mechanism {reset_mechanism!r}")
    if window is not None and not 1 <= window <= MAX_WINDOW:
        raise ValueError(f"conv_epilogue pools windows of 1 to {MAX_WINDOW},"
                         f" got {window}")
    dev = build.cuda_device(t, "conv_epilogue")
    lead = build.cell_lead(t, 4, "conv_epilogue")
    return dev, lead, lead[0] if lead else 1, tuple(t.shape[-4:])


def conv_epilogue_fwd_cuda(cur: torch.Tensor, bias: torch.Tensor,
                           u_prev: torch.Tensor, s_prev: torch.Tensor, *,
                           beta: float, threshold: float,
                           reset_mechanism: str = "subtract",
                           window: Optional[int] = None,
                           save_first: bool = True):
    """Launch the forward on the current stream: ``(u, s, pooled, first)``,
    ``pooled`` and ``first`` None where ``window`` is None, ``first`` None
    where ``save_first`` is false.  Raises on any operand the kernel does
    not take."""
    dev, lead, cells, (b, h, w, f) = _geometry(cur, window, reset_mechanism)
    cur, bias, u_prev, s_prev = map(_aligned, (cur, bias, u_prev, s_prev))
    build.check_operand(bias, "bias", lead + (f,), dev)
    for t, name in ((cur, "cur"), (u_prev, "u_prev"), (s_prev, "s_prev")):
        build.check_operand(t, name, lead + (b, h, w, f), dev)
    u = torch.empty_like(cur)
    s = torch.empty_like(cur)
    pooled = first = None
    if window is not None:
        pshape = lead + (b, h // window, w // window, f)
        pooled = torch.empty(pshape, dtype=torch.float32, device=dev)
        if save_first:
            first = torch.empty(pshape, dtype=torch.uint8, device=dev)
    vec, tx, ty, gx = epilogue_plan(b, h, w, f, window)
    err = _entry("conv_epilogue_fwd_launch")(
        *map(_ptr, (cur, bias, u_prev, s_prev, u, s, pooled, first)),
        cells, b, h, w, f, window or 0, vec, tx, ty, gx, beta, threshold,
        int(reset_mechanism == "subtract"), build.stream_ptr(dev))
    build.check_launch(err, "conv_epilogue forward")
    spans.count("launch.conv_epilogue")
    return u, s, pooled, first


def conv_epilogue_bwd_cuda(gu: Optional[torch.Tensor],
                           gs: Optional[torch.Tensor],
                           gp: Optional[torch.Tensor],
                           first: Optional[torch.Tensor], u: torch.Tensor,
                           u_prev: Optional[torch.Tensor],
                           s_prev: Optional[torch.Tensor],
                           needs: tuple[bool, bool, bool, bool], *,
                           beta: float, threshold: float, slope: float,
                           reset_mechanism: str = "subtract",
                           window: Optional[int] = None):
    """Launch the backward on the current stream: ``(d_cur, d_b, d_u_prev,
    d_s_prev)``, each None where ``needs`` (the forward's
    ``needs_input_grad`` of cur, bias, u_prev, s_prev) does not ask for
    it.  ``gu``, ``gs`` and ``gp`` are the cotangents of u, s and the
    pooled map, None where none flowed; ``first`` comes with ``gp``.  The
    zero reset also reads ``u_prev`` and ``s_prev``."""
    zero = reset_mechanism == "zero"
    dev, lead, cells, (b, h, w, f) = _geometry(u, window, reset_mechanism)
    shape = lead + (b, h, w, f)
    gu, gs, gp, u, u_prev, s_prev = map(_aligned, (gu, gs, gp, u, u_prev,
                                                   s_prev))
    for t, name in ((gu, "gu"), (gs, "gs"), (u, "u"), (u_prev, "u_prev"),
                    (s_prev, "s_prev")):
        if t is not None:
            build.check_operand(t, name, shape, dev)
    if zero and (u_prev is None or s_prev is None):
        raise ValueError("the zero reset's backward reads u_prev and s_prev")
    if gp is not None:
        if window is None or first is None:
            raise ValueError("a pooled cotangent needs the window and the "
                             "first maxima")
        pshape = lead + (b, h // window, w // window, f)
        build.check_operand(gp, "gp", pshape, dev)
        build.check_operand(first, "first", pshape, dev, torch.uint8)
    vec, tx, ty, gx = epilogue_plan(b, h, w, f, window)
    out = [torch.empty(shape, dtype=torch.float32, device=dev) if need
           else None for need in (needs[0], needs[2], needs[3])]
    d_cur, d_u_prev, d_s_prev = out
    d_b = partial = None
    if needs[1]:
        d_b = torch.empty(lead + (f,), dtype=torch.float32, device=dev)
        partial = torch.empty((cells, gx, f), dtype=torch.float32,
                              device=dev)
    err = _entry("conv_epilogue_bwd_launch")(
        *map(_ptr, (gu, gs, gp, first if gp is not None else None, u,
                    u_prev if zero else None, s_prev if zero else None,
                    d_cur, d_u_prev, d_s_prev, partial, d_b)),
        cells, b, h, w, f, window or 0, vec, tx, ty, gx, beta, threshold,
        slope, int(not zero), build.stream_ptr(dev))
    build.check_launch(err, "conv_epilogue backward")
    spans.count("launch.conv_epilogue")
    return d_cur, d_b, d_u_prev, d_s_prev
