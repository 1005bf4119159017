"""Plain PyTorch versions of the kernels.

Each function computes what its CUDA kernel computes, with separately
rounded fp32 operations in the order of ``repro/kernels/ref.py``.  On a CPU
tensor ``ops`` runs these; on the card they are the oracle the kernels are
held against (``chip_smoke.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.spike_conv import (conv_col2im, conv_out_size,
                                             conv_patches)


def lif_step_ref(u_prev: torch.Tensor, s_prev: torch.Tensor,
                 current: torch.Tensor, *, beta: float, threshold: float,
                 reset_mechanism: str = "subtract"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """LIF membrane update, each operation rounded on its own:
    subtract reset ``((beta*u) + cur) - (thr*s)``, zero reset
    ``((beta*u) * (1-s)) + cur``; then ``s = u > thr``.

    ``beta`` and ``threshold`` are first rounded to the dtype of ``u_prev``
    (as ``repro/kernels/ref.py`` does with ``jnp.asarray(beta, dt)``); in
    bfloat16 every operation runs in fp32 and rounds its result to
    bfloat16, as PyTorch's eager elementwise ops do.  The two constants are
    0-dim CPU tensors, which a CUDA op takes as scalars without a copy."""
    beta_t = torch.tensor(beta, dtype=u_prev.dtype)
    thr_t = torch.tensor(threshold, dtype=u_prev.dtype)
    if reset_mechanism == "subtract":
        u = beta_t * u_prev + current - thr_t * s_prev
    elif reset_mechanism == "zero":
        u = beta_t * u_prev * (1 - s_prev) + current
    else:
        raise ValueError(f"unknown reset mechanism {reset_mechanism!r}")
    return u, (u > thr_t).to(u.dtype)


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


def penc_compact_ref(spikes: torch.Tensor, capacity: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """PENC spike-address compaction: per row of (B, N) spikes, the
    ascending indices of the entries > 0 packed to the front, -1 padded
    and cut at ``capacity``, as (B, capacity) int32; and each row's true
    spike count, NOT cut at ``capacity``, as (B,) int32."""
    b, n = spikes.shape
    fired = spikes > 0
    counts = fired.sum(-1, dtype=torch.int32)
    # a stable sort of the "not fired" keys puts the fired columns first,
    # each group in ascending column order
    order = torch.sort((~fired).to(torch.uint8), dim=-1, stable=True)[1]
    width = min(capacity, n)
    idx = torch.full((b, capacity), -1, dtype=torch.int32,
                     device=spikes.device)
    slot = torch.arange(width, device=spikes.device)
    idx[:, :width] = torch.where(slot < counts[:, None],
                                 order[:, :width].to(torch.int32), -1)
    return idx, counts


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


def spike_conv_dw_ref(s_in: torch.Tensor, g: torch.Tensor, kh: int, kw: int,
                      *, stride: int = 1, padding: str = "SAME"
                      ) -> torch.Tensor:
    """dW (KH, KW, C, F) of the convolution from its (B, H, W, C) input and
    (B, OH, OW, F) cotangent: the JAX package's formula, the patch matrix's
    ``Pᵀ @ g`` in fp32."""
    c, f = s_in.shape[-1], g.shape[-1]
    patches = conv_patches(s_in.to(torch.float32), kh, kw, stride, padding)
    return (patches.T @ g.reshape(-1, f).to(torch.float32)).reshape(
        kh, kw, c, f)


def spike_gemm_ds_ref(g: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Dense ``dS = g @ Wᵀ`` in fp32: (M, N) cotangent, (K, N) weights."""
    return g.to(torch.float32) @ weights.to(torch.float32).T


def spike_conv_ds_ref(g: torch.Tensor, weights: torch.Tensor,
                      x_shape: tuple[int, ...], *, stride: int = 1,
                      padding: str = "SAME") -> torch.Tensor:
    """dS (B, H, W, C) = ``x_shape`` of the convolution from its
    (B, OH, OW, F) cotangent and (KH, KW, C, F) weights: the JAX package's
    formula, the matrix dS in patch space, ``g Wᵀ`` in fp32, folded back by
    ``conv_col2im``."""
    kh, kw, c, f = weights.shape
    d_patches = spike_gemm_ds_ref(g.reshape(-1, f),
                                  weights.reshape(kh * kw * c, f))
    return conv_col2im(d_patches, tuple(x_shape), kh, kw, stride, padding)


def spike_gemm_lif_ref(spikes: torch.Tensor, weights: torch.Tensor,
                       bias: torch.Tensor, u_prev: torch.Tensor,
                       s_prev: torch.Tensor, *, beta: float,
                       threshold: float, reset_mechanism: str = "subtract"
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused step unfused: ``lif_step_ref(u, s, S @ W + b)``."""
    cur = spike_gemm_ref(spikes, weights) + bias
    return lif_step_ref(u_prev, s_prev, cur, beta=beta, threshold=threshold,
                        reset_mechanism=reset_mechanism)
