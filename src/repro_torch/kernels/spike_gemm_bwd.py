"""Backward of the spike layers on the card (``csrc/spike_gemm_bwd.cu``).

A Dense layer's ``dW[K,N] = Sᵀ @ g``, an event walk over the nonzero
spikes of each column of S (``spike_gemm_dw_cuda``), and ``dS[M,K] = g @
Wᵀ``, a tiled product that skips the all-zero chunks of g it stages
(``spike_gemm_ds_cuda``); neither reads tile flags.  A Conv layer's dW
(KH, KW, C, F) from its (B, H, W, C) input spikes and (B, OH, OW, F)
cotangent, gathered by events from the spikes themselves
(``spike_conv_dw_cuda``), and its dS (B, H, W, C) written directly from
the cotangent and the weights (``spike_conv_ds_cuda``): no patch-space
cotangent and no col2im.  Every sum runs in an order fixed by the shapes,
so no result changes from run to run; the conv dW splits its reduction
across blocks (``conv_dw_plan``) and adds the partials in a fixed order.
A call counts one launch of ``spike_gemm_dw`` (the dWs) or
``spike_gemm_ds`` (the dSs).  ``ops.spike_gemm_bwd_dw``,
``ops.spike_conv_bwd_dw``, ``ops.spike_gemm_bwd_ds`` and
``ops.spike_conv_bwd_ds`` are the public entry points and send CPU tensors
to the plain versions in ``ref.py``.  Which TPU kernel each replaces, what
bounds it on the H100 and what its design does about that: the header of
``csrc/spike_gemm_bwd.cu``.
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

#: The H100's SMs: a constant, not the card's own number, so that every
#: plan below depends on the shapes alone.
SMS = 132
#: Warps of a conv dW block, at most (``csrc/spike_gemm_bwd.cu``).
CONV_DW_MAX_WARPS = 16
#: The dense dW's block (``csrc/spike_gemm_bwd.cu``): 16 warps, 128 * f4
#: columns of N (f4 float4s a lane, f4 = 1, 2 or 4), strips of
#: ``DW_STRIP`` columns of K, double-buffered spike tiles of 64 x 33.
DW_STRIP = 32
DW_THREADS = 512
#: The dense dS's blocks, (rows of M, columns of K): the large one (4 warps
#: of 8 x 8 tiles a lane) and the small one (8 warps, 4 rows a warp).
DS_LARGE = (64, 128)
DS_SMALL = (32, 32)
#: The conv dS's strip kernel: a tile of ``DS_ROWS`` rows (a warp each) of
#: ``DS_STRIP`` input pixels, halo rows of ``DS_HALO_ROW`` floats, W's
#: channels padded to ``DS_CH``, and blocks an SM should hold.
DS_ROWS = 8
DS_STRIP = 32
DS_HALO_ROW = DS_STRIP + 4
DS_CH = 32 + 4
DS_BLOCKS_PER_SM = 1


def dw_plan(m: int, k: int, n: int) -> tuple[int, int, int]:
    """(f4, blocks along K, blocks along N) of a dense dW: a block owns
    128 * f4 columns of N, all of them up to 512 (a lane walks each event
    for f4 float4s of g, so the walk's bookkeeping is shared by more
    FMAs), and about one wave of blocks walks the strips of K.  The sums do
    not depend on the plan."""
    f4 = 4 if n > 256 else 2 if n > 128 else 1
    slices = max(1, -(-n // (128 * f4)))
    strips = max(1, -(-k // DW_STRIP))
    smem = 4 * 64 * (128 * f4 + 2 * (DW_STRIP + 1))
    per_sm = max(1, min(2048 // DW_THREADS,
                        spike_conv.SM_SMEM // (smem + 1024)))
    return f4, max(1, min(strips, SMS * per_sm // slices)), slices


def ds_plan(m: int, k: int) -> tuple[bool, int, int]:
    """(large, blocks along M, blocks along K) of a dense dS: the large
    block where its grid fills a wave of SMs (net-5's fc1), else the small
    one.  The sums do not depend on the plan."""
    large = -(-m // DS_LARGE[0]) * -(-k // DS_LARGE[1]) >= SMS
    bm, bk = DS_LARGE if large else DS_SMALL
    return large, -(-m // bm), -(-k // bk)


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


def ds_plane(kh: int) -> int:
    """Floats of one f of the conv dS's g halo (``csrc``: ds_plane): its
    rows, padded to 4 mod 32."""
    n = (DS_ROWS + kh - 1) * DS_HALO_ROW
    return n + (36 - n % 32) % 32


@functools.lru_cache(maxsize=256)
def conv_ds_plan(x_shape: tuple[int, ...], w_shape: tuple[int, ...],
                 stride: int, padding: str) -> tuple[int, ...]:
    """The ints a conv layer's dS launches with: (B, H, W, C, OH, OW, F,
    KH, KW, stride, pad_top, pad_left, TR, TW, shared-memory bytes, strip,
    blocks along the input's tiles or pixels), for (B, H, W, C) input
    spikes and a (KH, KW, C, F) filter.

    It raises where the forward does (``spike_conv.conv_geometry``).  The
    strip kernel takes 3-wide filters at stride 1 (``uses_strips``) on
    tiles of ``DS_ROWS`` x ``DS_STRIP`` input pixels; its shared memory, in
    4-byte words: W (KH·3·F·36), the g halo (F·``ds_plane(KH)``) and its
    busy pixels ((DS_ROWS+KH-1)·36).  Any other layer, or one whose block
    does not fit, takes the pixel kernel (TR = TW = shared memory = strip =
    0).  Neither kernel's sums depend on the plan."""
    geo = spike_conv.conv_geometry(x_shape, w_shape, stride, padding)
    b, h, w, c = x_shape
    kh, kw, _, f = w_shape
    head = geo[:12]
    chunks = max(1, -(-c // 32))
    smem = 4 * (kh * 3 * f * DS_CH + f * ds_plane(kh)
                + (DS_ROWS + kh - 1) * DS_HALO_ROW)
    if spike_conv.uses_strips(kw, stride) and f > 0 and \
            smem <= spike_conv.MAX_SMEM:
        ntiles = b * -(-h // DS_ROWS) * -(-w // DS_STRIP)
        per_sm = max(1, min(DS_BLOCKS_PER_SM,
                            spike_conv.SM_SMEM // (smem + 1024)))
        blocks = min(ntiles, SMS * per_sm // chunks)
        return head + (DS_ROWS, DS_STRIP, smem, 1, max(1, blocks))
    blocks = min(-(-b * h * w // 8), SMS * 8 // chunks)
    return head + (0, 0, 0, 0, max(1, blocks))


def _aligned(*tensors: torch.Tensor) -> bool:
    """Whether every tensor starts on 16 bytes (the kernels' float4 path)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


@functools.cache
def _dw_entry():
    fn = build.library("spike_gemm_bwd").spike_gemm_dw_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _ds_entry():
    fn = build.library("spike_gemm_bwd").spike_gemm_ds_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _conv_dw_entry():
    fn = build.library("spike_gemm_bwd").spike_conv_dw_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 18 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _conv_ds_entry():
    fn = build.library("spike_gemm_bwd").spike_conv_ds_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 17 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _matrices(what: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"{what} takes two matrices; got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")


def spike_gemm_dw_cuda(spikes: torch.Tensor, g: torch.Tensor
                       ) -> torch.Tensor:
    """``spikes.T @ g`` for (M, K) spikes and an (M, N) cotangent, walking
    the nonzero spikes.  Launches on the current stream; raises on any
    operand the kernel does not take."""
    global dw_launches
    dev = build.cuda_device(spikes, "spike_gemm_dw")
    _matrices("spike_gemm_dw", spikes, g)
    m, k = spikes.shape
    n = g.shape[1]
    build.check_operand(spikes, "spikes", (m, k), dev)
    build.check_operand(g, "g", (m, n), dev)
    f4, blocks, slices = dw_plan(m, k, n)
    if slices > 65535:
        raise ValueError(f"spike_gemm_dw takes N up to {65535 * 512}; "
                         f"got {n}")
    out = torch.empty((k, n), dtype=torch.float32, device=dev)
    vec = n % 4 == 0 and _aligned(g, out)
    err = _dw_entry()(spikes.data_ptr(), g.data_ptr(), out.data_ptr(), m, n,
                      k, f4, int(vec), blocks, build.stream_ptr(dev))
    build.check_launch(err, "spike_gemm_dw")
    dw_launches += 1
    return out


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


def spike_gemm_ds_cuda(g: torch.Tensor, weights: torch.Tensor
                       ) -> torch.Tensor:
    """``g @ weights.T`` for an (M, N) cotangent and (K, N) weights,
    skipping the all-zero chunks of g.  Launches on the current stream;
    raises on any operand the kernel does not take."""
    global ds_launches
    dev = build.cuda_device(g, "spike_gemm_ds")
    _matrices("spike_gemm_ds", g, weights)
    m, n = g.shape
    k = weights.shape[0]
    build.check_operand(g, "g", (m, n), dev)
    build.check_operand(weights, "weights", (k, n), dev)
    large, _, k_blocks = ds_plan(m, k)
    if k_blocks > 65535:
        raise ValueError(f"spike_gemm_ds takes at most 65535 blocks along "
                         f"K; K = {k} needs {k_blocks}")
    out = torch.empty((m, k), dtype=torch.float32, device=dev)
    vec = n % 4 == 0 and _aligned(g, weights)
    err = _ds_entry()(g.data_ptr(), weights.data_ptr(), out.data_ptr(), m, k,
                      n, int(large), int(vec), build.stream_ptr(dev))
    build.check_launch(err, "spike_gemm_ds")
    ds_launches += 1
    return out


def spike_conv_ds_cuda(g: torch.Tensor, weights: torch.Tensor,
                       x_shape: tuple[int, ...], stride: int,
                       padding: str) -> torch.Tensor:
    """dS (B, H, W, C) = ``x_shape`` of a convolution from its (B, OH, OW,
    F) fp32 cotangent and (KH, KW, C, F) fp32 weights, written directly:
    no patch-space cotangent and no col2im.  Launches on the current
    stream; raises on any operand the kernel does not take."""
    global ds_launches
    dev = build.cuda_device(g, "spike_conv_ds")
    x_shape = tuple(int(s) for s in x_shape)
    if g.dim() != 4 or weights.dim() != 4 or len(x_shape) != 4:
        raise ValueError(f"spike_conv_ds takes a (B, OH, OW, F) cotangent, "
                         f"(KH, KW, C, F) weights and a (B, H, W, C) input "
                         f"shape; got {tuple(g.shape)}, "
                         f"{tuple(weights.shape)} and {x_shape}")
    b, h, w, c = x_shape
    kh, kw, _, f = weights.shape
    if weights.shape[2] != c:
        raise ValueError(f"weights expect {weights.shape[2]} input channels, "
                         f"the input has {c}")
    plan = conv_ds_plan(x_shape, tuple(weights.shape), stride, padding)
    build.check_operand(g, "g", (b, plan[4], plan[5], f), dev)
    build.check_operand(weights, "weights", (kh, kw, c, f), dev)
    out = torch.empty(x_shape, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    err = _conv_ds_entry()(g.data_ptr(), weights.data_ptr(), out.data_ptr(),
                           *plan, build.stream_ptr(dev))
    build.check_launch(err, "spike_conv_ds")
    ds_launches += 1
    return out
