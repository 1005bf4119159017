"""Public wrappers of the kernels: padding, occupancy flags, dispatch by
the device of the tensors, and the autograd Functions of the training path.

A CPU tensor runs the plain PyTorch version in ``ref.py``; a CUDA tensor
launches the hand-written kernel, or raises when the kernel cannot take it.
Nothing falls back from one to the other.  The dense kernels' flags are
computed here with a PyTorch reduction at the kernels' tile
(``build.TILE``) and validated against the tile grid on both devices, so a
caller can compute them once (``block_flags``) and pass them to the kernel
and to ``skip_fraction``.  The conv kernels find their own events in the
spikes and take no flags.

``spike_gemm_train``, ``spike_conv_train`` and ``spike_gemm_lif_step`` are
differentiable.  The dense Functions' backward runs the event-driven dW
and the tiled dS (``spike_gemm_bwd_dw`` / ``_ds``), which find their own
zeros (the forward's flags ride the saved tensors and are checked against
the tile grid); the conv Function saves its input spikes and runs the conv
dW (``spike_conv_bwd_dw``) and the conv dS (``spike_conv_bwd_ds``), which
writes the (B, H, W, C) input cotangent directly: on the card no
patch-space cotangent exists and no col2im runs.  All run on the card as
kernels and on the CPU as their plain versions (there the conv dS is the
matrix dS in patch space folded back by ``conv_col2im``).  dS runs only
where ``ctx.needs_input_grad`` asks for it (a net's input spikes need
none).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import lif_step as lif_kernel
from repro_torch.kernels import penc_compact as penc_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import spike_conv as conv_kernel
from repro_torch.kernels import spike_gemm as gemm_kernel
from repro_torch.kernels import spike_gemm_bwd as bwd_kernel
from repro_torch.kernels import spike_gemm_fused as fused_kernel
from repro_torch.kernels.build import TILE, tile_grid
from repro_torch.kernels.spike_conv import conv_out_size

#: Kernel name -> (its binding module, the name of its launch counter).
KERNELS = {"spike_gemm": (gemm_kernel, "launches"),
           "spike_gemm_lif": (fused_kernel, "launches"),
           "spike_conv": (conv_kernel, "launches"),
           "spike_gemm_dw": (bwd_kernel, "dw_launches"),
           "spike_gemm_ds": (bwd_kernel, "ds_launches"),
           "lif_step": (lif_kernel, "launches"),
           "penc_compact": (penc_kernel, "launches")}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last ``reset_launch_counts``."""
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)


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


def lif_step(u_prev: torch.Tensor, s_prev: torch.Tensor,
             current: torch.Tensor, *, beta: float, threshold: float,
             reset_mechanism: str = "subtract"
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Elementwise LIF update on (B, N) fp32 or bfloat16 operands, forward
    only; ``(u, s)`` come back in the operands' dtype.  The kernel picks its
    own launch shape (the JAX package's ``block_b``/``block_n`` are TPU
    tiles and are not taken)."""
    lif = dict(beta=beta, threshold=threshold,
               reset_mechanism=reset_mechanism)
    if _on_cuda(u_prev):
        return lif_kernel.lif_step_cuda(u_prev.contiguous(),
                                        s_prev.contiguous(),
                                        current.contiguous(), **lif)
    return ref.lif_step_ref(u_prev, s_prev, current, **lif)


def penc_compact(spikes: torch.Tensor, capacity: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Spike-address extraction (the ECU's PENC) on (B, N) {0,1} spike
    rows: ``(indices (B, capacity) int32, -1 padded; counts (B,) int32)``,
    where a count is the row's true number of spikes, not cut at
    ``capacity``."""
    capacity = int(capacity)
    if _on_cuda(spikes):
        return penc_kernel.penc_compact_cuda(spikes.contiguous(), capacity)
    return ref.penc_compact_ref(spikes, capacity)


def block_flags(spikes: torch.Tensor, *, block_m: int = TILE["block_m"],
                block_k: int = TILE["block_k"]) -> torch.Tensor:
    """(ceil(M/block_m), ceil(K/block_k)) int32 occupancy of ``spikes``."""
    s = _pad_to(spikes, (block_m, block_k))
    return ref.block_flags_ref(s, block_m, block_k)


def cotangent_block_flags(g: torch.Tensor) -> torch.Tensor:
    """(ceil(M/block_m), ceil(N/block_k)) int32 any-nonzero occupancy of a
    SIGNED (M, N) cotangent: the JAX package's gate of dS, whose reduction
    runs over N in chunks of ``block_k`` (the card's dS tests the chunks it
    stages itself; these flags are only checked).  Not ``block_flags``: a
    tile whose entries cancel to a zero sum still holds work."""
    bm, bk = TILE["block_m"], TILE["block_k"]
    return ref.block_flags_any_ref(_pad_to(g, (bm, bk)), bm, bk)


def _check_flags(flags: torch.Tensor, want: tuple[int, int],
                 what: str) -> None:
    if tuple(flags.shape) != want:
        raise ValueError(
            f"flags shape {tuple(flags.shape)} does not match the {want} "
            f"tile grid of {what} at block_m={TILE['block_m']}, "
            f"block_k={TILE['block_k']}; build them with ops.block_flags "
            f"(ops.cotangent_block_flags for a cotangent) on the same matrix")


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
                 padding: str) -> tuple[int, int]:
    """(rows, cols) of the im2col patch matrix of a convolution."""
    b, h, w, _ = s_in.shape
    kh, kw, cin, _ = weights.shape
    oh, _, _ = conv_out_size(h, kh, stride, padding)
    ow, _, _ = conv_out_size(w, kw, stride, padding)
    return b * oh * ow, kh * kw * cin


def spike_conv(s_in: torch.Tensor, weights: torch.Tensor, *,
               stride: int = 1, padding: str = "SAME",
               flags: torch.Tensor = None) -> torch.Tensor:
    """Sparsity-aware NHWC x HWIO convolution.  Output (B, OH, OW, F).

    ``flags``: the JAX package's optional occupancy of the PATCH matrix
    (``block_flags(conv_patches(s_in, ...))``), checked against its tile
    grid and otherwise unused: the kernel finds its own events in
    ``s_in``, and a CPU tensor runs the plain convolution."""
    if weights.shape[2] != s_in.shape[-1]:
        raise ValueError(f"weights expect {weights.shape[2]} input channels, "
                         f"spikes have {s_in.shape[-1]}")
    if flags is not None:
        rows, cols = _patch_shape(s_in, weights, stride, padding)
        _check_flags(flags, tile_grid(rows, cols),
                     f"the patch matrix {(rows, cols)}")
    if _on_cuda(s_in):
        return conv_kernel.spike_conv_cuda(s_in.contiguous(),
                                           weights.contiguous(), stride,
                                           padding)
    return ref.spike_conv_ref(s_in, weights, stride=stride, padding=padding)


# ---------------------------------------------------------------------------
# Backward (the two cotangent products of BPTT)
# ---------------------------------------------------------------------------

def spike_gemm_bwd_dw(spikes: torch.Tensor, g: torch.Tensor, *,
                      flags: torch.Tensor = None) -> torch.Tensor:
    """``dW[K,N] = Sᵀ @ g``; on the card only the nonzero spikes are walked.

    ``flags``: optional, the FORWARD's ``block_flags(spikes)``, checked
    against the tile grid; the kernel finds the events itself (a tile the
    forward skipped holds none)."""
    if flags is not None:
        _check_flags(flags, tile_grid(*spikes.shape),
                     f"spikes {tuple(spikes.shape)}")
    if _on_cuda(spikes):
        return bwd_kernel.spike_gemm_dw_cuda(spikes.contiguous(),
                                             g.contiguous())
    return ref.spike_gemm_dw_ref(spikes, g)


def spike_conv_bwd_dw(s_in: torch.Tensor, g: torch.Tensor, *,
                      kernel_size: tuple[int, int], stride: int = 1,
                      padding: str = "SAME") -> torch.Tensor:
    """dW (KH, KW, C, F) of ``spike_conv`` from its (B, H, W, C) input
    spikes and (B, OH, OW, F) cotangent.  On the card the kernel walks the
    input's events; no patch matrix is built."""
    kh, kw = kernel_size
    if _on_cuda(s_in):
        return bwd_kernel.spike_conv_dw_cuda(s_in.contiguous(),
                                             g.contiguous(), kh, kw, stride,
                                             padding)
    return ref.spike_conv_dw_ref(s_in, g, kh, kw, stride=stride,
                                 padding=padding)


def spike_gemm_bwd_ds(g: torch.Tensor, weights: torch.Tensor, *,
                      gflags: torch.Tensor = None) -> torch.Tensor:
    """``dS[M,K] = g @ Wᵀ``; on the card the all-zero chunks of the
    cotangent are skipped.

    ``gflags``: optional ``cotangent_block_flags(g)``, checked against the
    tile grid; the kernel tests the chunks it stages itself."""
    if gflags is not None:
        _check_flags(gflags, tile_grid(*g.shape), f"g {tuple(g.shape)}")
    if _on_cuda(g):
        return bwd_kernel.spike_gemm_ds_cuda(g.contiguous(),
                                             weights.contiguous())
    return ref.spike_gemm_ds_ref(g, weights)


def spike_conv_bwd_ds(g: torch.Tensor, weights: torch.Tensor,
                      x_shape: tuple[int, ...], *, stride: int = 1,
                      padding: str = "SAME") -> torch.Tensor:
    """dS (B, H, W, C) = ``x_shape`` of ``spike_conv`` from its
    (B, OH, OW, F) cotangent and (KH, KW, C, F) weights.  On the card the
    kernel writes it directly, with no patch-space cotangent and no col2im;
    on the CPU it is the matrix dS in patch space folded back by
    ``conv_col2im``."""
    x_shape = tuple(int(s) for s in x_shape)
    if _on_cuda(g):
        return bwd_kernel.spike_conv_ds_cuda(g.contiguous(),
                                             weights.contiguous(), x_shape,
                                             stride, padding)
    return ref.spike_conv_ds_ref(g, weights, x_shape, stride=stride,
                                 padding=padding)


def _gemm_cotangents(needs: tuple[bool, bool], g: torch.Tensor,
                     spikes: torch.Tensor, weights: torch.Tensor,
                     flags: torch.Tensor):
    """(dS, dW) of ``S @ W``, each only where its input needs a gradient."""
    g = g.contiguous()
    d_s = spike_gemm_bwd_ds(g, weights) if needs[0] else None
    d_w = spike_gemm_bwd_dw(spikes, g, flags=flags) if needs[1] else None
    return d_s, d_w


class _SpikeGemmTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spikes, weights):
        flags = block_flags(spikes)
        ctx.save_for_backward(spikes, weights, flags)
        return spike_gemm(spikes, weights, flags=flags)

    @staticmethod
    def backward(ctx, g):
        spikes, weights, flags = ctx.saved_tensors
        return _gemm_cotangents(ctx.needs_input_grad, g, spikes, weights,
                                flags)


def spike_gemm_train(spikes: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Differentiable ``S @ W``: the block-skip forward, then the
    event-driven dW and the dS that skips zero chunks of the cotangent."""
    return _SpikeGemmTrain.apply(spikes, weights)


class _SpikeConvTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s_in, weights, stride, padding):
        ctx.save_for_backward(s_in, weights)
        ctx.conv = (stride, padding)
        return spike_conv(s_in, weights, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        s_in, weights = ctx.saved_tensors
        stride, padding = ctx.conv
        kh, kw = weights.shape[:2]
        need_s, need_w = ctx.needs_input_grad[:2]
        g = g.contiguous()
        d_s = d_w = None
        if need_s:
            d_s = spike_conv_bwd_ds(g, weights, tuple(s_in.shape),
                                    stride=stride, padding=padding)
        if need_w:
            d_w = spike_conv_bwd_dw(s_in, g, kernel_size=(kh, kw),
                                    stride=stride, padding=padding)
        return d_s, d_w, None, None


def spike_conv_train(s_in: torch.Tensor, weights: torch.Tensor, *,
                     stride: int = 1, padding: str = "SAME") -> torch.Tensor:
    """Differentiable convolution: ``spike_conv``'s forward, then the conv
    dW on the input spikes and the conv dS, (B, H, W, C), on the
    cotangent."""
    return _SpikeConvTrain.apply(s_in, weights, int(stride), str(padding))


class _SpikeGemmLifStep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spikes, weights, bias, u_prev, s_prev, beta, threshold,
                slope, reset_mechanism):
        flags = block_flags(spikes)
        lif = dict(beta=beta, threshold=threshold,
                   reset_mechanism=reset_mechanism)
        if _on_cuda(spikes):
            u, s = fused_kernel.spike_gemm_lif_cuda(
                spikes.contiguous(), weights.contiguous(), bias.contiguous(),
                u_prev.contiguous(), s_prev.contiguous(), flags, **lif)
        else:
            u, s = ref.spike_gemm_lif_ref(spikes, weights, bias, u_prev,
                                          s_prev, **lif)
        ctx.save_for_backward(spikes, weights, u_prev, s_prev, u, flags)
        ctx.lif = (beta, threshold, slope, reset_mechanism)
        return u, s

    @staticmethod
    def backward(ctx, gu, gs):
        spikes, weights, u_prev, s_prev, u, flags = ctx.saved_tensors
        beta, threshold, slope, reset_mechanism = ctx.lif
        # the fast-sigmoid surrogate through s = H(u - theta), then the LIF
        # chain rule, term for term as autograd derives them on the unfused
        # lif.lif_step
        surr = 1.0 / torch.square(1.0 + slope * torch.abs(u - threshold))
        g = gu + gs * surr
        if reset_mechanism == "subtract":
            d_u_prev = beta * g
            d_s_prev = -threshold * g
        else:
            d_u_prev = beta * (1.0 - s_prev) * g
            d_s_prev = -(beta * u_prev) * g
        needs = ctx.needs_input_grad
        d_s, d_w = _gemm_cotangents(needs[:2], g, spikes, weights, flags)
        d_b = g.sum(0) if needs[2] else None
        return d_s, d_w, d_b, d_u_prev, d_s_prev, None, None, None, None


def spike_gemm_lif_step(spikes: torch.Tensor, weights: torch.Tensor,
                        bias: torch.Tensor, u_prev: torch.Tensor,
                        s_prev: torch.Tensor, *, beta: float,
                        threshold: float, slope: float = 25.0,
                        reset_mechanism: str = "subtract"
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable fused scan step ``(u, s) = LIF(u, s, S @ W + b)``.

    Its forward equals ``spike_gemm(S, W) + b`` composed with
    ``lif.lif_step``: the same accumulate and the same separately rounded
    epilogue.  Its backward applies the fast-sigmoid surrogate of slope
    ``slope`` and the LIF chain rule, then the dense dW and dS."""
    if reset_mechanism not in fused_kernel.RESETS:
        raise ValueError(f"unknown reset mechanism {reset_mechanism!r}")
    return _SpikeGemmLifStep.apply(spikes, weights, bias, u_prev, s_prev,
                                   float(beta), float(threshold),
                                   float(slope), reset_mechanism)


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


def spike_gemm_profiled(spikes: torch.Tensor, weights: torch.Tensor,
                        perm: torch.Tensor, **kw) -> torch.Tensor:
    """``spike_gemm`` with a profile-guided pre-synaptic permutation; equal
    to the unpermuted product (a permutation of the sum's terms)."""
    s, w = apply_permutation(spikes, weights, perm)
    return spike_gemm(s, w, **kw)
