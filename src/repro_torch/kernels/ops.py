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

``spike_gemm_train``, ``spike_conv_train``, ``spike_gemm_lif_step`` and
``conv_lif_step`` are differentiable.  The dense Functions' backward runs
the event-driven dW and the tiled dS (``spike_gemm_bwd_dw`` / ``_ds``),
which find their own zeros (the forward's flags ride the saved tensors and
are checked against the tile grid); the conv epilogue (``conv_lif_step``:
bias, LIF, spike and OR-pool) runs one kernel each way; the conv Function
saves its input spikes and runs the conv dW (``spike_conv_bwd_dw``) and
the conv dS (``spike_conv_bwd_ds``), which writes the (B, H, W, C) input
cotangent directly: on the card no patch-space cotangent exists and no
col2im runs.  All run on the card as
kernels and on the CPU as their plain versions (there the conv dS is the
matrix dS in patch space folded back by ``conv_col2im``).  dS runs only
where ``ctx.needs_input_grad`` asks for it (a net's input spikes need
none).

A cell axis.  A DSE slab (``distributed/cellstack.py``) trains C cells of
one shape at once, each with its own weights.  Every op the model's paths
call (``spike_gemm``, ``spike_conv``, the four backward products,
``spike_gemm_lif_step`` and the two train Functions) also takes its
operands with a leading cell axis: on the card one launch serves the slab,
each cell on the solo shape's plan, so each cell's result is the solo
call's bit for bit; on the CPU the plain version runs per cell on the solo
shape.  Flags are per cell, (C, ...): a tile never mixes two cells.  The
bias gradient of the fused step is reduced per cell over the solo shape
(``cell_sum_to``), as autograd reduces a solo one.

Counting.  Each binding module counts its kernel's launches in
``repro_torch.spans`` (``launch.<kernel>``, one counter per entry of
``KERNELS``); ``launch_counts`` reads them.  The Functions' backwards run
in ``bwd.dense``, ``bwd.conv`` and ``bwd.epilogue`` spans.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.kernels import conv_epilogue as epilogue_kernel
from repro_torch.kernels import lif_step as lif_kernel
from repro_torch.kernels import penc_compact as penc_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import spike_conv as conv_kernel
from repro_torch.kernels import spike_gemm as gemm_kernel
from repro_torch.kernels import spike_gemm_bwd as bwd_kernel
from repro_torch.kernels import spike_gemm_fused as fused_kernel
from repro_torch.kernels.build import TILE, aligned16, cell_lead, tile_grid
from repro_torch.kernels.spike_conv import conv_out_size

#: The hand-written kernels, each with its counter ``launch.<name>`` in
#: ``spans``.
KERNELS = ("spike_gemm", "spike_gemm_lif", "spike_conv", "spike_gemm_dw",
           "spike_gemm_ds", "lif_step", "penc_compact", "conv_epilogue")


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last ``reset_launch_counts``."""
    counted = spans.counts()
    return {name: counted.get(f"launch.{name}", 0) for name in KERNELS}


def reset_launch_counts() -> None:
    spans.reset_counts("launch.")


def _pad_to(x: torch.Tensor, mults: tuple[int, ...]) -> torch.Tensor:
    """Zero-pad each dim up to a multiple; ``x`` itself when aligned."""
    pads = [(-s) % m for s, m in zip(x.shape, mults)]
    if not any(pads):
        return x
    flat = []
    for p in reversed(pads):              # F.pad lists the last dim first
        flat += [0, p]
    return F.pad(x, flat)


def _per_cell(fn, *operands, **kw) -> torch.Tensor:
    """A plain version over a slab: ``fn`` on each cell's operands at the
    solo shape, stacked.  CPU tensors only (``ops`` sends CUDA tensors to
    the kernels)."""
    return torch.stack([fn(*(o[c] for o in operands), **kw)
                        for c in range(operands[0].shape[0])])


def cell_sum_to(g: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Per cell of a slab ``g`` (C, ...), ``g[c].sum_to_size(shape)``: the
    reduction autograd runs for a solo broadcast operand of ``shape``, on
    the solo shape, so each cell's sum is the solo sum bit for bit (one
    (C, ...) reduction need not sum in that order)."""
    return torch.stack([aligned16(g[c]).sum_to_size(shape)
                        for c in range(g.shape[0])])


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
    """(ceil(M/block_m), ceil(K/block_k)) int32 occupancy of (M, K)
    ``spikes``; (C, ...) for a slab of C cells, each cell's tiles its own
    (a cell's ragged last tile row is padded inside the cell)."""
    lead = cell_lead(spikes, 2, "block_flags")
    s = _pad_to(spikes, (1,) * len(lead) + (block_m, block_k))
    return ref.block_flags_ref(s, block_m, block_k)


def cotangent_block_flags(g: torch.Tensor) -> torch.Tensor:
    """(ceil(M/block_m), ceil(N/block_k)) int32 any-nonzero occupancy of a
    SIGNED (M, N) cotangent: the JAX package's gate of dS, whose reduction
    runs over N in chunks of ``block_k`` (the card's dS tests the chunks it
    stages itself; these flags are only checked).  Not ``block_flags``: a
    tile whose entries cancel to a zero sum still holds work."""
    bm, bk = TILE["block_m"], TILE["block_k"]
    lead = cell_lead(g, 2, "cotangent_block_flags")
    return ref.block_flags_any_ref(_pad_to(g, (1,) * len(lead) + (bm, bk)),
                                   bm, bk)


def _check_flags(flags: torch.Tensor, want: tuple[int, ...],
                 what: str) -> None:
    if tuple(flags.shape) != want:
        raise ValueError(
            f"flags shape {tuple(flags.shape)} does not match the {want} "
            f"tile grid of {what} at block_m={TILE['block_m']}, "
            f"block_k={TILE['block_k']}; build them with ops.block_flags "
            f"(ops.cotangent_block_flags for a cotangent) on the same matrix")


def spike_gemm(spikes: torch.Tensor, weights: torch.Tensor, *,
               flags: torch.Tensor = None) -> torch.Tensor:
    """Sparsity-aware ``S @ W`` with tile-level spike skipping; a slab of C
    products with a leading cell axis on both operands.

    ``flags``: optional precomputed ``block_flags(spikes)``."""
    lead = cell_lead(spikes, 2, "spike_gemm")
    if flags is None:
        flags = block_flags(spikes)
    _check_flags(flags, lead + tile_grid(*spikes.shape[-2:]),
                 f"spikes {tuple(spikes.shape)}")
    if _on_cuda(spikes):
        return gemm_kernel.spike_gemm_cuda(
            spikes.contiguous(), weights.contiguous(), flags.contiguous())
    if lead:
        return _per_cell(ref.spike_gemm_ref, spikes, weights)
    return ref.spike_gemm_ref(spikes, weights)


def _patch_shape(s_in: torch.Tensor, weights: torch.Tensor, stride: int,
                 padding: str) -> tuple[int, int]:
    """(rows, cols) of the im2col patch matrix of a convolution (of each
    cell's, for a slab)."""
    b, h, w, _ = s_in.shape[-4:]
    kh, kw, cin, _ = weights.shape[-4:]
    oh, _, _ = conv_out_size(h, kh, stride, padding)
    ow, _, _ = conv_out_size(w, kw, stride, padding)
    return b * oh * ow, kh * kw * cin


def spike_conv(s_in: torch.Tensor, weights: torch.Tensor, *,
               stride: int = 1, padding: str = "SAME",
               flags: torch.Tensor = None) -> torch.Tensor:
    """Sparsity-aware NHWC x HWIO convolution.  Output (B, OH, OW, F); a
    slab of C convolutions with a leading cell axis on both operands.

    ``flags``: the JAX package's optional occupancy of the PATCH matrix
    (``block_flags(conv_patches(s_in, ...))``), checked against its tile
    grid and otherwise unused: the kernel finds its own events in
    ``s_in``, and a CPU tensor runs the plain convolution."""
    lead = cell_lead(s_in, 4, "spike_conv")
    if weights.shape[-2] != s_in.shape[-1]:
        raise ValueError(f"weights expect {weights.shape[-2]} input "
                         f"channels, spikes have {s_in.shape[-1]}")
    if flags is not None:
        rows, cols = _patch_shape(s_in, weights, stride, padding)
        _check_flags(flags, lead + tile_grid(rows, cols),
                     f"the patch matrix {(rows, cols)}")
    if _on_cuda(s_in):
        return conv_kernel.spike_conv_cuda(s_in.contiguous(),
                                           weights.contiguous(), stride,
                                           padding)
    if lead:
        return _per_cell(ref.spike_conv_ref, s_in, weights, stride=stride,
                         padding=padding)
    return ref.spike_conv_ref(s_in, weights, stride=stride, padding=padding)


# ---------------------------------------------------------------------------
# Backward (the two cotangent products of BPTT)
# ---------------------------------------------------------------------------

def spike_gemm_bwd_dw(spikes: torch.Tensor, g: torch.Tensor, *,
                      flags: torch.Tensor = None) -> torch.Tensor:
    """``dW[K,N] = Sᵀ @ g``; on the card only the nonzero spikes are walked.
    A slab of C with a leading cell axis gives (C, K, N).

    ``flags``: optional, the FORWARD's ``block_flags(spikes)``, checked
    against the tile grid; the kernel finds the events itself (a tile the
    forward skipped holds none)."""
    lead = cell_lead(spikes, 2, "spike_gemm_bwd_dw")
    if flags is not None:
        _check_flags(flags, lead + tile_grid(*spikes.shape[-2:]),
                     f"spikes {tuple(spikes.shape)}")
    if _on_cuda(spikes):
        return bwd_kernel.spike_gemm_dw_cuda(spikes.contiguous(),
                                             g.contiguous())
    if lead:
        return _per_cell(ref.spike_gemm_dw_ref, spikes, g)
    return ref.spike_gemm_dw_ref(spikes, g)


def spike_conv_bwd_dw(s_in: torch.Tensor, g: torch.Tensor, *,
                      kernel_size: tuple[int, int], stride: int = 1,
                      padding: str = "SAME") -> torch.Tensor:
    """dW (KH, KW, C, F) of ``spike_conv`` from its (B, H, W, C) input
    spikes and (B, OH, OW, F) cotangent; (C, KH, KW, C, F) for a slab.  On
    the card the kernel walks the input's events; no patch matrix is
    built."""
    kh, kw = kernel_size
    if _on_cuda(s_in):
        return bwd_kernel.spike_conv_dw_cuda(s_in.contiguous(),
                                             g.contiguous(), kh, kw, stride,
                                             padding)
    if cell_lead(s_in, 4, "spike_conv_bwd_dw"):
        return _per_cell(ref.spike_conv_dw_ref, s_in, g, kh=kh, kw=kw,
                         stride=stride, padding=padding)
    return ref.spike_conv_dw_ref(s_in, g, kh, kw, stride=stride,
                                 padding=padding)


def spike_gemm_bwd_ds(g: torch.Tensor, weights: torch.Tensor, *,
                      gflags: torch.Tensor = None) -> torch.Tensor:
    """``dS[M,K] = g @ Wᵀ``; on the card the all-zero chunks of the
    cotangent are skipped (each cell's own, for a slab with a leading cell
    axis).

    ``gflags``: optional ``cotangent_block_flags(g)``, checked against the
    tile grid; the kernel tests the chunks it stages itself."""
    lead = cell_lead(g, 2, "spike_gemm_bwd_ds")
    if gflags is not None:
        _check_flags(gflags, lead + tile_grid(*g.shape[-2:]),
                     f"g {tuple(g.shape)}")
    if _on_cuda(g):
        return bwd_kernel.spike_gemm_ds_cuda(g.contiguous(),
                                             weights.contiguous())
    if lead:
        return _per_cell(ref.spike_gemm_ds_ref, g, weights)
    return ref.spike_gemm_ds_ref(g, weights)


def spike_conv_bwd_ds(g: torch.Tensor, weights: torch.Tensor,
                      x_shape: tuple[int, ...], *, stride: int = 1,
                      padding: str = "SAME") -> torch.Tensor:
    """dS (B, H, W, C) = ``x_shape`` of ``spike_conv`` from its
    (B, OH, OW, F) cotangent and (KH, KW, C, F) weights; a slab of C with
    a leading cell axis on all three.  On the card the kernel writes it
    directly, with no patch-space cotangent and no col2im; on the CPU it is
    the matrix dS in patch space folded back by ``conv_col2im``."""
    x_shape = tuple(int(s) for s in x_shape)
    if _on_cuda(g):
        return bwd_kernel.spike_conv_ds_cuda(g.contiguous(),
                                             weights.contiguous(), x_shape,
                                             stride, padding)
    if cell_lead(g, 4, "spike_conv_bwd_ds"):
        return _per_cell(ref.spike_conv_ds_ref, g, weights,
                         x_shape=x_shape[1:], stride=stride, padding=padding)
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
    @spans.spanned("bwd.dense")
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
    @spans.spanned("bwd.conv")
    def backward(ctx, g):
        s_in, weights = ctx.saved_tensors
        stride, padding = ctx.conv
        kh, kw = weights.shape[-4:-2]
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
        elif cell_lead(spikes, 2, "spike_gemm_lif_step"):
            # the accumulate per cell at the solo shape, the elementwise
            # epilogue over the slab
            cur = _per_cell(lambda s_c, w_c, b_c: ref.spike_gemm_ref(s_c, w_c)
                            + b_c, spikes, weights, bias)
            u, s = ref.lif_step_ref(u_prev, s_prev, cur, **lif)
        else:
            u, s = ref.spike_gemm_lif_ref(spikes, weights, bias, u_prev,
                                          s_prev, **lif)
        ctx.save_for_backward(spikes, weights, u_prev, s_prev, u, flags)
        ctx.lif = (beta, threshold, slope, reset_mechanism)
        return u, s

    @staticmethod
    @spans.spanned("bwd.dense")
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
        d_b = None
        if needs[2] and cell_lead(g, 2, "spike_gemm_lif_step"):
            # per cell, on the solo shape
            d_b = torch.stack([aligned16(g[c]).sum(0)
                               for c in range(g.shape[0])])
        elif needs[2]:
            d_b = g.sum(0)
        return d_s, d_w, d_b, d_u_prev, d_s_prev, None, None, None, None


def spike_gemm_lif_step(spikes: torch.Tensor, weights: torch.Tensor,
                        bias: torch.Tensor, u_prev: torch.Tensor,
                        s_prev: torch.Tensor, *, beta: float,
                        threshold: float, slope: float = 25.0,
                        reset_mechanism: str = "subtract"
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable fused scan step ``(u, s) = LIF(u, s, S @ W + b)``;
    a slab of C steps with a leading cell axis on every operand.

    Its forward equals ``spike_gemm(S, W) + b`` composed with
    ``lif.lif_step``: the same accumulate and the same separately rounded
    epilogue.  Its backward applies the fast-sigmoid surrogate of slope
    ``slope`` and the LIF chain rule, then the dense dW and dS."""
    if reset_mechanism not in fused_kernel.RESETS:
        raise ValueError(f"unknown reset mechanism {reset_mechanism!r}")
    return _SpikeGemmLifStep.apply(spikes, weights, bias, u_prev, s_prev,
                                   float(beta), float(threshold),
                                   float(slope), reset_mechanism)


class _ConvLifStep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cur, bias, u_prev, s_prev, beta, threshold, slope,
                reset_mechanism, window):
        ctx.set_materialize_grads(False)
        u, s, pooled, first = _conv_lif_forward(
            cur, bias, u_prev, s_prev, beta, threshold, reset_mechanism,
            window, True)
        if reset_mechanism == "subtract":
            ctx.save_for_backward(u, first)
        else:
            ctx.save_for_backward(u, first, u_prev, s_prev)
        ctx.lif = dict(beta=beta, threshold=threshold, slope=slope,
                       reset_mechanism=reset_mechanism, window=window)
        return (u, s) if window is None else (u, s, pooled)

    @staticmethod
    @spans.spanned("bwd.epilogue")
    def backward(ctx, gu, gs, gp=None):
        u, first, *prev = ctx.saved_tensors
        u_prev, s_prev = prev or (None, None)
        needs = tuple(ctx.needs_input_grad[:4])
        if gu is None and gs is None and gp is None:
            return (None,) * 9
        if _on_cuda(u):
            d_cur, d_b, d_u_prev, d_s_prev = \
                epilogue_kernel.conv_epilogue_bwd_cuda(
                    gu, gs, gp, first, u, u_prev, s_prev, needs, **ctx.lif)
        else:
            d_cur, d_u_prev, d_s_prev = ref.conv_lif_bwd_ref(
                gu, gs, gp, first, u, u_prev, s_prev, **ctx.lif)
            d_b = None
            if needs[1] and u.dim() == 5:     # per cell, on the solo shape
                d_b = cell_sum_to(d_cur, tuple(u.shape[-1:]))
            elif needs[1]:
                d_b = d_cur.sum_to_size(u.shape[-1:])
        return (d_cur if needs[0] else None, d_b,
                d_u_prev if needs[2] else None,
                d_s_prev if needs[3] else None, None, None, None, None, None)


def _conv_lif_forward(cur, bias, u_prev, s_prev, beta, threshold,
                      reset_mechanism, window, first):
    lif = dict(beta=beta, threshold=threshold,
               reset_mechanism=reset_mechanism)
    if _on_cuda(cur):
        return epilogue_kernel.conv_epilogue_fwd_cuda(
            cur, bias, u_prev, s_prev, window=window, save_first=first, **lif)
    return ref.conv_lif_ref(cur, bias, u_prev, s_prev, window=window,
                            first=first, **lif)


def conv_lif_step(cur: torch.Tensor, bias: torch.Tensor,
                  u_prev: torch.Tensor, s_prev: torch.Tensor, *, beta: float,
                  threshold: float, slope: float = 25.0,
                  reset_mechanism: str = "subtract",
                  pool_window: int = None) -> tuple[torch.Tensor, ...]:
    """A conv layer's epilogue as one differentiable step: from the
    bias-free conv output ``cur`` (B, H, W, F), its bias (F,) and the
    previous ``(u, s)``, the LIF update of ``cur + b`` and its spikes
    ``(u, s)``, and where ``pool_window`` is set also the OR-pooled spikes
    (B, H // k, W // k, F) (VALID: a ragged edge is dropped; k up to 16).
    A slab takes a leading cell axis on every operand, the bias (C, F).

    Its forward equals ``snn._add_bias``, ``lif.lif_step`` and
    ``snn._OrPool`` in a row bit for bit; its backward equals the
    cotangents autograd derives on that chain (the fast-sigmoid surrogate
    of slope ``slope``, the gradient of a window to its first maximum), but
    for the bias gradient's order of summation on the card.  One kernel
    each way on the card (``launch.conv_epilogue``), the plain version on
    the CPU.  Outside autograd (no_grad, or no operand needing a gradient)
    it saves nothing and keeps no first maxima."""
    if reset_mechanism not in epilogue_kernel.RESETS:
        raise ValueError(f"unknown reset mechanism {reset_mechanism!r}")
    window = None if pool_window is None else int(pool_window)
    if window is not None and not 1 <= window <= epilogue_kernel.MAX_WINDOW:
        raise ValueError(f"conv_lif_step pools windows of 1 to "
                         f"{epilogue_kernel.MAX_WINDOW}, got {window}")
    args = (float(beta), float(threshold))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (cur, bias, u_prev, s_prev)):
        return _ConvLifStep.apply(cur, bias, u_prev, s_prev, *args,
                                  float(slope), reset_mechanism, window)
    u, s, pooled, _ = _conv_lif_forward(cur, bias, u_prev, s_prev, *args,
                                        reset_mechanism, window, False)
    return (u, s) if window is None else (u, s, pooled)


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
