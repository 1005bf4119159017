"""Public wrappers of the forward kernels: padding, occupancy flags, and
dispatch by the device of the tensors.

A CPU tensor runs the plain PyTorch version in ``ref.py``; a CUDA tensor
launches the hand-written kernel, or raises when the kernel cannot take it.
Nothing falls back from one to the other.  The flags are computed here with
a PyTorch reduction at the kernels' tile (``build.TILE``) and validated
against the tile grid on both devices, so a caller can compute them once
(``block_flags``) and pass them to the kernel and to ``skip_fraction``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels import spike_conv as conv_kernel
from repro_torch.kernels import spike_gemm as gemm_kernel
from repro_torch.kernels import spike_gemm_fused as fused_kernel
from repro_torch.kernels.build import TILE, tile_grid
from repro_torch.kernels.spike_conv import conv_out_size, conv_patches

KERNELS = {"spike_gemm": gemm_kernel, "spike_gemm_lif": fused_kernel,
           "spike_conv": conv_kernel}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last ``reset_launch_counts``."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def _pad_to(x: torch.Tensor, mults: tuple[int, ...]) -> torch.Tensor:
    """Zero-pad each dim up to a multiple; ``x`` itself when aligned."""
    pads = [(-s) % m for s, m in zip(x.shape, mults)]
    if not any(pads):
        return x
    flat = []
    for p in reversed(pads):              # F.pad lists the last dim first
        flat += [0, p]
    return F.pad(x, flat)


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no spike kernel for tensors on {x.device}")


def block_flags(spikes: torch.Tensor, *, block_m: int = TILE["block_m"],
                block_k: int = TILE["block_k"]) -> torch.Tensor:
    """(ceil(M/block_m), ceil(K/block_k)) int32 occupancy of ``spikes``."""
    s = _pad_to(spikes, (block_m, block_k))
    return ref.block_flags_ref(s, block_m, block_k)


def _check_flags(flags: torch.Tensor, want: tuple[int, int],
                 what: str) -> None:
    if tuple(flags.shape) != want:
        raise ValueError(
            f"flags shape {tuple(flags.shape)} does not match the {want} "
            f"tile grid of {what} at block_m={TILE['block_m']}, "
            f"block_k={TILE['block_k']}; build them with ops.block_flags on "
            f"the same spike matrix")


def spike_gemm(spikes: torch.Tensor, weights: torch.Tensor, *,
               flags: torch.Tensor = None) -> torch.Tensor:
    """Sparsity-aware ``S @ W`` with tile-level spike skipping.

    ``flags``: optional precomputed ``block_flags(spikes)``."""
    if flags is None:
        flags = block_flags(spikes)
    _check_flags(flags, tile_grid(*spikes.shape),
                 f"spikes {tuple(spikes.shape)}")
    if _on_cuda(spikes):
        return gemm_kernel.spike_gemm_cuda(
            spikes.contiguous(), weights.contiguous(), flags.contiguous())
    return ref.spike_gemm_ref(spikes, weights)


def _patch_shape(s_in: torch.Tensor, weights: torch.Tensor, stride: int,
                 padding: str) -> tuple[int, int, int, int]:
    """(rows, cols, OH, OW) of the im2col patch matrix of a convolution."""
    b, h, w, _ = s_in.shape
    kh, kw, cin, _ = weights.shape
    oh, _, _ = conv_out_size(h, kh, stride, padding)
    ow, _, _ = conv_out_size(w, kw, stride, padding)
    return b * oh * ow, kh * kw * cin, oh, ow


def _conv_lowered(s_in: torch.Tensor, weights: torch.Tensor, stride: int,
                  padding: str, flags, accumulate) -> torch.Tensor:
    """The convolution as the card runs it: patch matrix, its flags, one
    block-skip ``accumulate(patches, w2d, flags)``, reshape to NHWC."""
    kh, kw, cin, cout = weights.shape
    _, _, oh, ow = _patch_shape(s_in, weights, stride, padding)
    patches = conv_patches(s_in, kh, kw, stride, padding)
    if flags is None:
        flags = block_flags(patches)
    out = accumulate(patches, weights.reshape(kh * kw * cin, cout)
                     .contiguous(), flags.contiguous())
    return out.reshape(s_in.shape[0], oh, ow, cout)


def spike_conv(s_in: torch.Tensor, weights: torch.Tensor, *,
               stride: int = 1, padding: str = "SAME",
               flags: torch.Tensor = None) -> torch.Tensor:
    """Sparsity-aware NHWC x HWIO convolution with patch-tile skipping.

    ``flags``: optional precomputed occupancy of the PATCH matrix
    (``block_flags(conv_patches(s_in, ...))``).  Output (B, OH, OW, F)."""
    if weights.shape[2] != s_in.shape[-1]:
        raise ValueError(f"weights expect {weights.shape[2]} input channels, "
                         f"spikes have {s_in.shape[-1]}")
    if flags is not None:
        rows, cols, _, _ = _patch_shape(s_in, weights, stride, padding)
        _check_flags(flags, tile_grid(rows, cols),
                     f"the patch matrix {(rows, cols)}")
    if _on_cuda(s_in):
        return _conv_lowered(s_in, weights, stride, padding, flags,
                             conv_kernel.spike_conv_cuda)
    return ref.spike_conv_ref(s_in, weights, stride=stride, padding=padding)


def spike_gemm_lif_step(spikes: torch.Tensor, weights: torch.Tensor,
                        bias: torch.Tensor, u_prev: torch.Tensor,
                        s_prev: torch.Tensor, *, beta: float,
                        threshold: float, reset_mechanism: str = "subtract"
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused scan step ``(u, s) = LIF(u, s, S @ W + b)`` (forward only).

    Equal to ``spike_gemm(S, W) + b`` composed with ``lif.lif_step``: the
    same accumulate and the same separately rounded epilogue."""
    if reset_mechanism not in fused_kernel.RESETS:
        raise ValueError(f"unknown reset mechanism {reset_mechanism!r}")
    flags = block_flags(spikes)
    if _on_cuda(spikes):
        return fused_kernel.spike_gemm_lif_cuda(
            spikes.contiguous(), weights.contiguous(), bias.contiguous(),
            u_prev.contiguous(), s_prev.contiguous(), flags, beta=beta,
            threshold=threshold, reset_mechanism=reset_mechanism)
    return ref.spike_gemm_lif_ref(spikes, weights, bias, u_prev, s_prev,
                                  beta=beta, threshold=threshold,
                                  reset_mechanism=reset_mechanism)


def skip_fraction(spikes: torch.Tensor, block_m: int = TILE["block_m"],
                  block_k: int = TILE["block_k"]) -> float:
    """Fraction of (block_m, block_k) tiles of ``spikes`` the kernels
    skip."""
    flags = block_flags(spikes, block_m=block_m, block_k=block_k)
    return 1.0 - int(flags.sum()) / flags.numel()


# Profile-guided neuron permutation: sorting the pre-synaptic axis by
# profiled firing rate clusters cold neurons into tiles that are empty on
# most steps; the product is unchanged (``S[:, p] @ W[p, :] == S @ W``).

def firing_rate_permutation(rates: torch.Tensor) -> torch.Tensor:
    """Permutation placing rarely-firing pre-synaptic neurons first (stable,
    as ``jnp.argsort``)."""
    return torch.argsort(rates, stable=True)


def apply_permutation(spikes: torch.Tensor, weights: torch.Tensor,
                      perm: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    return spikes[:, perm], weights[perm, :]
