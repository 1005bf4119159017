"""Plain PyTorch versions of the kernels.

Each function computes what its CUDA kernel computes, with separately
rounded fp32 operations in the order of ``repro/kernels/ref.py``.  On a CPU
tensor ``ops`` runs these; on the card they are the oracle the kernels are
held against (``chip_smoke.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.spike_conv import conv_out_size


def lif_step_ref(u_prev: torch.Tensor, s_prev: torch.Tensor,
                 current: torch.Tensor, *, beta: float, threshold: float,
                 reset_mechanism: str = "subtract"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """LIF membrane update, each operation rounded on its own:
    subtract reset ``((beta*u) + cur) - (thr*s)``, zero reset
    ``((beta*u) * (1-s)) + cur``; then ``s = u > thr``."""
    if reset_mechanism == "subtract":
        u = beta * u_prev + current - threshold * s_prev
    elif reset_mechanism == "zero":
        u = beta * u_prev * (1 - s_prev) + current
    else:
        raise ValueError(f"unknown reset mechanism {reset_mechanism!r}")
    return u, (u > threshold).to(u.dtype)


def spike_gemm_ref(spikes: torch.Tensor, weights: torch.Tensor
                   ) -> torch.Tensor:
    """Dense ``S @ W`` in fp32 (``spikes`` (M, K) in {0,1}, ``weights``
    (K, N)).  On the card TF32 must be off, as it is by default for
    matmuls."""
    return spikes.to(torch.float32) @ weights.to(torch.float32)


def spike_conv_ref(s_in: torch.Tensor, weights: torch.Tensor, *,
                   stride: int = 1, padding: str = "SAME") -> torch.Tensor:
    """NHWC x HWIO convolution with XLA's SAME/VALID pads.

    The pads come from ``conv_out_size`` and are applied with ``F.pad``
    (SAME may pad one more on the high side), then ``F.conv2d`` runs
    unpadded on the permuted NCHW/OIHW tensors.  cuDNN is switched off for
    the call: it may pick Winograd or FFT algorithms, which do not multiply
    and add the operands exactly, and the oracle must.  PyTorch's own
    im2col+GEMM convolution does, in fp32 with TF32 off.
    """
    _, h, w, _ = s_in.shape
    kh, kw, _, _ = weights.shape
    _, ph_lo, ph_hi = conv_out_size(h, kh, stride, padding)
    _, pw_lo, pw_hi = conv_out_size(w, kw, stride, padding)
    x = F.pad(s_in.permute(0, 3, 1, 2), (pw_lo, pw_hi, ph_lo, ph_hi))
    with torch.backends.cudnn.flags(enabled=False):
        out = F.conv2d(x, weights.permute(3, 2, 0, 1), stride=stride)
    return out.permute(0, 2, 3, 1).contiguous()


def block_flags_ref(spikes: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    """Per (row-tile, k-tile) occupancy: 1 where the tile's sum is > 0.
    Exact for nonnegative inputs such as spikes; ``spikes`` must already be
    padded to tile multiples."""
    m, k = spikes.shape
    if m % bm or k % bk:
        raise ValueError(f"spikes {tuple(spikes.shape)} are not padded to "
                         f"({bm}, {bk}) tiles")
    blocks = spikes.reshape(m // bm, bm, k // bk, bk)
    return (blocks.sum(dim=(1, 3)) > 0).to(torch.int32)


def block_flags_any_ref(x: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    """Per (row-tile, column-tile) occupancy of a SIGNED matrix: 1 where any
    entry of the tile is nonzero (the gate of dS on a cotangent; a tile of
    +x and -x sums to zero and still holds work).  ``x`` must already be
    padded to tile multiples."""
    m, k = x.shape
    if m % bm or k % bk:
        raise ValueError(f"matrix {tuple(x.shape)} is not padded to "
                         f"({bm}, {bk}) tiles")
    blocks = (x != 0).reshape(m // bm, bm, k // bk, bk)
    return blocks.any(dim=3).any(dim=1).to(torch.int32)


def spike_gemm_dw_ref(spikes: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Dense ``dW = Sᵀ @ g`` in fp32: (M, K) spikes, (M, N) cotangent."""
    return spikes.to(torch.float32).T @ g.to(torch.float32)


def spike_gemm_ds_ref(g: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Dense ``dS = g @ Wᵀ`` in fp32: (M, N) cotangent, (K, N) weights."""
    return g.to(torch.float32) @ weights.to(torch.float32).T


def spike_gemm_lif_ref(spikes: torch.Tensor, weights: torch.Tensor,
                       bias: torch.Tensor, u_prev: torch.Tensor,
                       s_prev: torch.Tensor, *, beta: float,
                       threshold: float, reset_mechanism: str = "subtract"
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused step unfused: ``lif_step_ref(u, s, S @ W + b)``."""
    cur = spike_gemm_ref(spikes, weights) + bias
    return lif_step_ref(u_prev, s_prev, cur, beta=beta, threshold=threshold,
                        reset_mechanism=reset_mechanism)
