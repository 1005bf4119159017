"""Event-driven spike convolution on the card (``csrc/spike_conv.cu``), the
geometry its kernels share with dW of a conv layer, and the im2col pair
``conv_patches`` / ``conv_col2im``.

The kernels read the (B, H, W, C) spikes directly: a block owns a tile of
output pixels and stages the tile's input halo and its bitmasks in shared
memory (``csrc/conv_halo.cuh``), so no patch matrix is built on the card.
``conv_patches`` is the JAX package's im2col, a (B·OH·OW, KH·KW·C) matrix
with features in (dy, dx, c) order (the HWIO filter reshaped to
(KH·KW·C, F) is its weight matrix; ``F.unfold`` orders features
(c, dy, dx) and does not fit that reshape): the plain conv dW in
``ref.py`` runs on it.  ``conv_col2im`` is its adjoint, with which the
plain conv dS in ``ref.py`` folds the patch-space cotangent back to the
input (the card's conv dS writes the input's shape directly).
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

#: The output pixels a block of each conv kernel may own, largest first,
#: and how many of its blocks should fit in one SM's shared memory: a tile
#: is the largest whose block leaves room for that many (on the H100,
#: measured: conv1's 512 pixels, conv2's 128, in both kernels).
TILE_PIXELS = {"forward": (512, 256, 128, 64), "dw": (512, 256, 128, 64)}
BLOCKS_PER_SM = {"forward": 3, "dw": 2}
#: Shared memory of one H100 SM that blocks can hold (228 KiB, of which the
#: runtime keeps 1 KiB a block).
SM_SMEM = 233472
#: Warps of a forward block (``csrc/spike_conv.cu``: kWarps).
FORWARD_WARPS = 8
#: Output pixels of a row that a warp of the forward's strip kernel owns
#: (``csrc/spike_conv.cu``: kStrip); its tiles are whole strips wide.
STRIP = 16
#: Dynamic shared memory a block may take on the H100 (227 KiB).
MAX_SMEM = 232448


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


def conv_col2im(d_patches: torch.Tensor, x_shape: tuple[int, ...], kh: int,
                kw: int, stride: int, padding: str) -> torch.Tensor:
    """The adjoint of ``conv_patches``: a (B·OH·OW, KH·KW·C) patch-space
    cotangent folded back to a contiguous (B, H, W, C) one.  Each tap's
    slice of features is added into a zero-padded input at its strided
    place, taps in (dy, dx) order, and the pads are cut off; no patch
    matrix of the input is built."""
    b, h, w, c = x_shape
    oh, ph_lo, ph_hi = conv_out_size(h, kh, stride, padding)
    ow, pw_lo, pw_hi = conv_out_size(w, kw, stride, padding)
    d = d_patches.reshape(b, oh, ow, kh * kw, c)
    xp = d_patches.new_zeros((b, h + ph_lo + ph_hi, w + pw_lo + pw_hi, c))
    for dy in range(kh):
        for dx in range(kw):
            xp[:, dy:dy + (oh - 1) * stride + 1:stride,
               dx:dx + (ow - 1) * stride + 1:stride, :] += d[:, :, :,
                                                             dy * kw + dx]
    return xp[:, ph_lo:ph_lo + h, pw_lo:pw_lo + w].contiguous()


def conv_tile(oh: int, ow: int, pixels: int,
              multiple: int = 1) -> tuple[int, int]:
    """(rows, columns) of the tile of output pixels a block owns: whole
    rows, padded to a multiple of ``multiple`` columns, up to ``pixels``
    wide, as many as ``pixels`` allows."""
    tw = min(-(-ow // multiple) * multiple, max(multiple, pixels))
    return max(1, min(oh, pixels // tw)), tw


def uses_strips(kw: int, stride: int) -> bool:
    """Whether the forward runs the strip kernel (3-wide filters at stride
    1, every conv of the cells) rather than the pixel kernel."""
    return kw == 3 and stride == 1


@functools.lru_cache(maxsize=256)
def conv_geometry(x_shape: tuple[int, ...], w_shape: tuple[int, ...],
                  stride: int, padding: str, *, dw: bool = False
                  ) -> tuple[int, ...]:
    """The ints a conv kernel launches with: (B, H, W, C, OH, OW, F, KH,
    KW, stride, pad_top, pad_left, TR, TW, shared-memory bytes), for
    (B, H, W, C) spikes and a (KH, KW, C, F) filter; ``dw`` for dW's
    kernel, else the forward's.

    The tile is the largest of ``TILE_PIXELS`` whose block leaves room for
    ``BLOCKS_PER_SM`` blocks in an SM's shared memory, else the smallest.
    A block's shared memory, in 4-byte words: the filters (K·32, K =
    KH·KW·C) or dW's partial sums (K·33), the halo (HR·HC·C, the input
    pixels within reach of the tile) and its masks (HR·HC·CW, CW =
    ceil(C/32)); then dW's g rows (TR·TW·32), or the forward pixel
    kernel's offsets of the K events in the halo and its 8 warps' event
    lists (9·P, P = K rounded up to a multiple of 4).  The forward's strip
    kernel (``uses_strips``) takes tiles a whole number of strips wide.

    Raises where the kernels cannot take the layer: a stride below 1, an
    empty output, 2^31 or more output pixels, or a block that does not fit
    in shared memory."""
    b, h, w, c = x_shape
    kh, kw, _, f = w_shape
    if stride < 1:
        raise ValueError(f"stride {stride} < 1")
    oh, pt, _ = conv_out_size(h, kh, stride, padding)
    ow, pl, _ = conv_out_size(w, kw, stride, padding)
    if oh < 1 or ow < 1:
        raise ValueError(f"a {kh}x{kw} {padding} convolution of {h}x{w} "
                         f"inputs has no output")
    if b * oh * ow >= 2 ** 31:
        raise ValueError(f"the conv kernels index output pixels in 32 bits; "
                         f"{b}x{oh}x{ow} are too many")
    strips = not dw and uses_strips(kw, stride)
    kind = "dw" if dw else "forward"
    cw = -(-c // 32)

    def tile_and_smem(pixels):
        tr, tw = conv_tile(oh, ow, pixels, STRIP if strips else 1)
        hr, hc = (tr - 1) * stride + kh, (tw - 1) * stride + kw
        words = kh * kw * c * (33 if dw else 32) + hr * hc * (c + cw)
        if dw:
            words += tr * tw * 32
        elif not strips:
            words += (1 + FORWARD_WARPS) * (-(-kh * kw * c // 4) * 4)
        return tr, tw, 4 * words

    tiles = [tile_and_smem(px) for px in TILE_PIXELS[kind]]
    roomy = [t for t in tiles
             if t[2] + 1024 <= SM_SMEM // BLOCKS_PER_SM[kind]]
    tr, tw, smem = roomy[0] if roomy else tiles[-1]
    if smem > MAX_SMEM:
        raise ValueError(
            f"the conv kernels cannot take C={c}, {kh}x{kw} filters at "
            f"stride {stride}: a block needs {smem} bytes of shared memory "
            f"for its filters and masks, more than {MAX_SMEM}")
    return (b, h, w, c, oh, ow, f, kh, kw, stride, pt, pl, tr, tw, smem)


@functools.cache
def _entry():
    fn = build.library("spike_conv").spike_conv_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 16 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spike_conv_cuda(s_in: torch.Tensor, weights: torch.Tensor, stride: int,
                    padding: str) -> torch.Tensor:
    """The NHWC x HWIO convolution of (B, H, W, C) fp32 spikes with a
    (KH, KW, C, F) filter, (B, OH, OW, F) out, read from the spikes
    directly; every nonzero input is an event.  Launches on the current
    stream; raises on any operand the kernel does not take."""
    global launches
    dev = build.cuda_device(s_in, "spike_conv")
    if s_in.dim() != 4 or weights.dim() != 4:
        raise ValueError(f"spike_conv takes (B, H, W, C) spikes and a "
                         f"(KH, KW, C, F) filter; got {tuple(s_in.shape)} "
                         f"and {tuple(weights.shape)}")
    b, h, w, c = s_in.shape
    kh, kw, _, f = weights.shape
    build.check_operand(s_in, "s_in", (b, h, w, c), dev)
    build.check_operand(weights, "weights", (kh, kw, c, f), dev)
    geo = conv_geometry(s_in.shape, weights.shape, stride, padding)
    out = torch.empty((b, geo[4], geo[5], f), dtype=torch.float32,
                      device=dev)
    if c == 0:
        return out.zero_()
    err = _entry()(s_in.data_ptr(), weights.data_ptr(), out.data_ptr(),
                   *geo, int(uses_strips(kw, stride)), build.stream_ptr(dev))
    build.check_launch(err, "spike_conv")
    launches += 1
    return out
