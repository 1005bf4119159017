"""Spiking network definition in PyTorch.

Networks are declared as a sequence of layer specs (``Dense``, ``Conv``,
``MaxPool``) mirroring the paper's Table I topologies; layouts are those of
the JAX package (NHWC activations, HWIO conv weights, (K, N) dense
weights).  Time is a Python loop over ``step``; every spiking layer's
output train can be returned, so the accelerator model can be driven by the
model's actual spike traffic (``spike_counts_per_layer``).

Backends of the accumulate phase: ``"torch"`` (plain PyTorch ops),
``"spike_gemm"`` (block-skip kernels for Dense and Conv) and
``"spike_gemm_fused"`` (the fused GEMM+LIF kernel for Dense layers, the
block-skip conv for Conv layers).  On both kernel backends a Conv layer's
epilogue (bias, LIF update, spike and, where a MaxPool follows it, the
OR-pool) is one step, ``ops.conv_lif_step``, and that MaxPool layer takes
its pooled spikes (``SNNConfig.conv_pool_windows``).  All three give the
same spikes, so the default is the kernel path.  Every path is
differentiable: on the kernel backends the layers are ``kernels.ops``'
autograd Functions, whose backward runs the dW and dS kernels.

A slab of cells.  ``step``, ``apply`` and the trace functions also run C
cells of one topology at once (``distributed/cellstack.py``): params whose
every leaf leads with a cell axis (``cells_of``), spike trains (T, C, B,
...), states (C, B, ...).  The kernels take the cell axis in one launch
each; the OR-pool, the LIF update and the bias add are elementwise over
(C·B, ...) views; the plain ``torch`` backend runs each cell's product at
its solo shape; and a bias gradient is reduced per cell over the solo
shape.  So each cell's spikes and gradients equal its solo run's bit for
bit.

Spans (``repro_torch.spans``).  ``step`` runs each layer in a span named
by ``SNNConfig.span_names`` (``fwd.conv0``, ``fwd.pool1``, ...), but for a
MaxPool pooled by the conv before it, which does no work of its own; the
OR-pool's backward runs in ``bwd.pool``, the conv epilogue's in
``bwd.epilogue``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Optional, Sequence, Union

import torch

from repro_torch import spans
from repro_torch.core.lif import LIFParams, lif_step
from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref as kernel_ref
from repro_torch.kernels.conv_epilogue import MAX_WINDOW as MAX_FUSED_POOL

Params = list[dict[str, torch.Tensor]]

MATMUL_BACKENDS = ("torch", "spike_gemm", "spike_gemm_fused")
#: Its own variable, so a process that holds both packages cannot set the
#: JAX package's REPRO_MATMUL_BACKEND for this one by mistake.
MATMUL_BACKEND_ENV = "REPRO_TORCH_MATMUL_BACKEND"
DEFAULT_BACKEND = "spike_gemm_fused"


def resolve_matmul_backend(backend: Optional[str] = None) -> str:
    """An explicit backend, else ``REPRO_TORCH_MATMUL_BACKEND``, else
    ``"spike_gemm_fused"``."""
    backend = backend or os.environ.get(MATMUL_BACKEND_ENV) or DEFAULT_BACKEND
    if backend not in MATMUL_BACKENDS:
        raise ValueError(f"unknown matmul backend {backend!r}; "
                         f"pick from {MATMUL_BACKENDS}")
    return backend


# ---------------------------------------------------------------------------
# Layer specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Dense:
    features: int
    lif: LIFParams = LIFParams()


@dataclasses.dataclass(frozen=True)
class Conv:
    features: int
    kernel: int = 3
    stride: int = 1
    padding: str = "SAME"
    lif: LIFParams = LIFParams()


@dataclasses.dataclass(frozen=True)
class MaxPool:
    """Spike OR-pooling, non-overlapping (a 2x2 OR gate in hardware)."""
    window: int = 2


LayerSpec = Union[Dense, Conv, MaxPool]


@dataclasses.dataclass(frozen=True)
class SNNConfig:
    """A full spiking model: topology + coding hyper-parameters."""
    name: str
    input_shape: tuple[int, ...]          # (H, W, C) for conv nets, (D,) for MLPs
    layers: tuple[LayerSpec, ...]
    num_classes: int
    pcr: int = 1                          # population-coding ratio (neurons/class)
    num_steps: int = 25                   # spike-train length T

    @property
    def output_features(self) -> int:
        return self.num_classes * self.pcr

    def layer_sizes(self) -> list[int]:
        """Logical neuron count of every *spiking* layer (used for LHR sizing)."""
        sizes = []
        shape = self.input_shape
        for spec in self.layers:
            shape = _out_shape(spec, shape)
            if isinstance(spec, (Dense, Conv)):
                sizes.append(int(math.prod(shape)))
        return sizes

    def spiking_layers(self) -> list[LayerSpec]:
        return [l for l in self.layers if isinstance(l, (Dense, Conv))]

    @functools.cached_property
    def span_names(self) -> tuple[str, ...]:
        """The name of each layer's span in ``step``: ``fwd.`` + its kind
        + its index (``fwd.conv0``, ``fwd.pool1``, ...), made once."""
        kinds = {Dense: "dense", Conv: "conv", MaxPool: "pool"}
        return tuple(f"fwd.{kinds[type(spec)]}{i}"
                     for i, spec in enumerate(self.layers))

    @functools.cached_property
    def conv_pool_windows(self) -> tuple[Optional[int], ...]:
        """For each layer, the window of the MaxPool right after it that its
        epilogue pools on the kernel backends (``ops.conv_lif_step``): a
        Conv followed by a MaxPool of a window up to 16; else None."""
        return tuple(
            nxt.window if isinstance(spec, Conv) and isinstance(nxt, MaxPool)
            and nxt.window <= MAX_FUSED_POOL else None
            for spec, nxt in zip(self.layers, self.layers[1:] + (None,)))


def _out_shape(spec: LayerSpec, in_shape: tuple[int, ...]) -> tuple[int, ...]:
    if isinstance(spec, Dense):
        return (spec.features,)
    if isinstance(spec, Conv):
        h, w, _ = in_shape
        if spec.padding == "SAME":
            oh, ow = -(-h // spec.stride), -(-w // spec.stride)
        else:
            oh = (h - spec.kernel) // spec.stride + 1
            ow = (w - spec.kernel) // spec.stride + 1
        return (oh, ow, spec.features)
    if isinstance(spec, MaxPool):
        h, w, c = in_shape
        return (h // spec.window, w // spec.window, c)
    raise TypeError(spec)


def cells_of(cfg: SNNConfig, params: Params) -> Optional[int]:
    """C where ``params`` are a slab of C cells (every leaf with a leading
    cell axis), None for one cell's."""
    for spec, p in zip(cfg.layers, params):
        if isinstance(spec, (Dense, Conv)):
            rank = 2 if isinstance(spec, Dense) else 4
            return int(p["w"].shape[0]) if p["w"].dim() == rank + 1 else None
    return None


def output_shapes(cfg: SNNConfig) -> list[tuple[int, ...]]:
    shapes, shape = [], cfg.input_shape
    for spec in cfg.layers:
        shape = _out_shape(spec, shape)
        shapes.append(shape)
    return shapes


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: SNNConfig, *,
                device: DeviceLike = None,
                dtype: torch.dtype = torch.float32) -> Params:
    """Normal weights scaled by 1/sqrt(fan_in), zero biases.  ``generator``
    is a CPU generator: the draws are made on the CPU and moved, so a seed
    gives the same weights on every device."""
    dev = resolve(device)
    params: Params = []
    shape = cfg.input_shape
    for spec in cfg.layers:
        if isinstance(spec, Dense):
            fan_in = int(math.prod(shape))
            wshape = (fan_in, spec.features)
        elif isinstance(spec, Conv):
            fan_in = spec.kernel * spec.kernel * shape[-1]
            wshape = (spec.kernel, spec.kernel, shape[-1], spec.features)
        else:
            wshape = None
        if wshape is None:
            params.append({})
        else:
            w = torch.randn(wshape, generator=generator, dtype=dtype)
            params.append({"w": (w / math.sqrt(fan_in)).to(dev),
                           "b": torch.zeros(spec.features, dtype=dtype,
                                            device=dev)})
        shape = _out_shape(spec, shape)
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

class _CellBias(torch.autograd.Function):
    """``x + b`` for a slab: x (C, ..., N), b (C, N).  The add is
    elementwise; the bias gradient is each cell's ``sum_to_size`` of its
    slice, the reduction autograd runs for a solo broadcast bias, on the
    solo shape (``ops.cell_sum_to``)."""

    @staticmethod
    def forward(ctx, x, b):
        ctx.shape = tuple(b.shape[1:])
        return x + b.reshape((b.shape[0],) + (1,) * (x.dim() - 2)
                             + ctx.shape)

    @staticmethod
    def backward(ctx, g):
        d_b = (kernel_ops.cell_sum_to(g, ctx.shape)
               if ctx.needs_input_grad[1] else None)
        return g, d_b


def _add_bias(x: torch.Tensor, b: torch.Tensor,
              cells: Optional[int]) -> torch.Tensor:
    return x + b if cells is None else _CellBias.apply(x, b)


def _layer_current(spec: LayerSpec, p: dict, s_in: torch.Tensor,
                   matmul_backend: str = DEFAULT_BACKEND,
                   perm: Optional[torch.Tensor] = None,
                   cells: Optional[int] = None) -> torch.Tensor:
    """Synaptic current of one layer from its pre-synaptic spikes.

    Dense layers run the block-skip GEMM on ``"spike_gemm"`` and a plain
    matmul on ``"torch"`` (``"spike_gemm_fused"`` never reaches here for a
    Dense layer: ``step`` runs the fused kernel).  Conv layers reach here
    on ``"torch"`` alone (``step`` runs ``_conv_step`` on the kernel
    backends).  The GEMM is the differentiable ``ops.spike_gemm_train``.
    ``perm`` is an optional pre-synaptic permutation of a Dense layer,
    ``S[:, perm] @ W[perm, :]``, which leaves the product unchanged.
    ``cells``: C for a slab (operands with a leading cell axis); the plain
    products then run per cell at the solo shape.
    """
    lead = 1 if cells is None else 2
    if isinstance(spec, Dense):
        flat = s_in.reshape(s_in.shape[:lead] + (-1,))
        w = p["w"]
        if matmul_backend == "spike_gemm":
            if perm is not None:
                flat, w = kernel_ops.apply_permutation(flat, w, perm)
            cur = kernel_ops.spike_gemm_train(flat, w)
        elif cells is None:
            cur = flat @ w
        else:
            cur = torch.stack([flat[c] @ w[c] for c in range(cells)])
        return _add_bias(cur, p["b"], cells)
    if isinstance(spec, Conv):
        conv = dict(stride=spec.stride, padding=spec.padding)
        if cells is None:
            out = kernel_ref.spike_conv_ref(s_in, p["w"], **conv)
        else:
            out = torch.stack([kernel_ref.spike_conv_ref(s_in[c], p["w"][c],
                                                         **conv)
                               for c in range(cells)])
        return _add_bias(out, p["b"], cells)
    raise TypeError(spec)


def _fused_dense_step(spec: Dense, p: dict, s_in: torch.Tensor,
                      state: tuple[torch.Tensor, torch.Tensor],
                      perm: Optional[torch.Tensor],
                      cells: Optional[int] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Accumulate + bias + LIF update in one kernel launch
    (``matmul_backend="spike_gemm_fused"``), for one cell or a slab."""
    lead = 1 if cells is None else 2
    flat = s_in.reshape(s_in.shape[:lead] + (-1,))
    w = p["w"]
    if perm is not None:
        flat, w = kernel_ops.apply_permutation(flat, w, perm)
    u_prev, s_prev = state
    lif = spec.lif
    return kernel_ops.spike_gemm_lif_step(
        flat, w, p["b"], u_prev, s_prev, beta=lif.beta,
        threshold=lif.threshold, slope=lif.slope,
        reset_mechanism=lif.reset_mechanism)


def _conv_step(spec: Conv, p: dict, s_in: torch.Tensor,
               state: tuple[torch.Tensor, torch.Tensor],
               pool_window: Optional[int]
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A Conv layer on the kernel backends, for one cell or a slab: the
    block-skip conv, then its epilogue in one step (``ops.conv_lif_step``),
    pooled where ``pool_window`` is set.  Returns ``(u, s, out)``: ``out``
    the pooled spikes, or ``s`` without a pool."""
    cur = kernel_ops.spike_conv_train(s_in, p["w"], stride=spec.stride,
                                      padding=spec.padding)
    u_prev, s_prev = state
    lif = spec.lif
    out = kernel_ops.conv_lif_step(
        cur, p["b"], u_prev, s_prev, beta=lif.beta, threshold=lif.threshold,
        slope=lif.slope, reset_mechanism=lif.reset_mechanism,
        pool_window=pool_window)
    return out if pool_window is not None else (*out, out[1])


class _OrPool(torch.autograd.Function):
    """Non-overlapping max over (B, H, W, C) windows, VALID.  Its gradient
    goes whole to the FIRST maximum of each window in row-major (dy, dx)
    order, as XLA's ``reduce_window`` max does; ``amax`` would split it
    among tied maxima, and spike windows tie all the time (every all-zero
    window, every window with more than one spike).  Only that position is
    saved, one byte per output for windows of up to 16 x 16."""

    @staticmethod
    def forward(ctx, s, window):
        b, h, w, c = s.shape
        oh, ow = h // window, w // window
        x = s[:, :oh * window, :ow * window, :].reshape(
            b, oh, window, ow, window, c)
        if not ctx.needs_input_grad[0]:       # inference: no position
            return x.amax(dim=(2, 4))
        win = x.permute(0, 1, 3, 5, 2, 4).reshape(b, oh, ow, c,
                                                  window * window)
        out, first = win.max(dim=-1)          # ties: the lowest index
        ctx.save_for_backward(first.to(
            torch.uint8 if window * window <= 256 else torch.int64))
        ctx.geometry = (tuple(s.shape), window)
        return out

    @staticmethod
    @spans.spanned("bwd.pool")
    def backward(ctx, g):
        (first,) = ctx.saved_tensors
        (b, h, w, c), window = ctx.geometry
        oh, ow = h // window, w // window
        win = g.new_zeros((b, oh, ow, c, window * window))
        win.scatter_(-1, first.long().unsqueeze(-1), g.unsqueeze(-1))
        d = win.reshape(b, oh, ow, c, window, window).permute(
            0, 1, 4, 2, 5, 3).reshape(b, oh * window, ow * window, c)
        if (oh * window, ow * window) != (h, w):   # the dropped edge: zero
            d = torch.nn.functional.pad(
                d, (0, 0, 0, w - ow * window, 0, h - oh * window))
        return d, None


def _or_pool(s: torch.Tensor, window: int) -> torch.Tensor:
    """Spike OR-pooling (non-overlapping max) over (..., H, W, C), VALID: a
    ragged right or bottom edge is dropped.  Leading dims (time, cells,
    batch) fold into one image axis; every window is pooled on its own."""
    flat = s.reshape((-1,) + tuple(s.shape[-3:]))
    pooled = _OrPool.apply(flat, window)
    return pooled.reshape(tuple(s.shape[:-3]) + tuple(pooled.shape[1:]))


def init_states(cfg: SNNConfig, batch: int, device: torch.device,
                dtype: torch.dtype = torch.float32,
                cells: Optional[int] = None) -> list:
    """Zero (u, s) of every spiking layer, (batch, ...) each, or
    (cells, batch, ...) for a slab."""
    lead = (batch,) if cells is None else (cells, batch)
    states, shape = [], cfg.input_shape
    for spec in cfg.layers:
        shape = _out_shape(spec, shape)
        if isinstance(spec, (Dense, Conv)):
            z = torch.zeros(lead + shape, dtype=dtype, device=device)
            states.append((z, z))
        else:
            states.append(None)
    return states


def step(cfg: SNNConfig, params: Params, states: list, s_in: torch.Tensor,
         matmul_backend: str = DEFAULT_BACKEND,
         layer_perms: Optional[Sequence] = None
         ) -> tuple[list, list[torch.Tensor]]:
    """One time step through all layers.

    Returns (new_states, per-spiking-layer output spikes).  ``layer_perms``:
    optional per-layer pre-synaptic permutations aligned with
    ``cfg.layers`` (``None`` entries for unpermuted layers).  Slab params
    (``cells_of``) take (C, B, ...) input spikes and states.
    """
    if layer_perms is not None and len(layer_perms) != len(cfg.layers):
        raise ValueError(f"layer_perms has {len(layer_perms)} entries for "
                         f"{len(cfg.layers)} layers")
    cells = cells_of(cfg, params)
    if cells is not None and layer_perms is not None:
        raise ValueError("a slab of cells takes no layer_perms")
    perms = layer_perms or (None,) * len(cfg.layers)
    new_states, spikes = [], []
    x = s_in
    fused = matmul_backend == "spike_gemm_fused"
    kernels = matmul_backend != "torch"
    windows = cfg.conv_pool_windows if kernels else (None,) * len(cfg.layers)
    pooled = False
    for name, spec, p, st, perm, window in zip(
            cfg.span_names, cfg.layers, params, states, perms, windows):
        if pooled:                  # a MaxPool the conv before it ran
            pooled = False
            new_states.append(None)
            continue
        with spans.span(name):
            if isinstance(spec, MaxPool):
                x = _or_pool(x, spec.window)
                new_states.append(None)
                continue
            if isinstance(spec, Conv) and kernels:
                u, s, x = _conv_step(spec, p, x, st, window)
                pooled = window is not None
            else:
                if isinstance(spec, Dense) and fused:
                    u, s = _fused_dense_step(spec, p, x, st, perm, cells)
                elif isinstance(spec, (Dense, Conv)):
                    cur = _layer_current(spec, p, x, matmul_backend, perm,
                                         cells)
                    u, s = lif_step(st[0], st[1], cur, spec.lif)
                else:
                    raise TypeError(spec)
                x = s
        new_states.append((u, s))
        spikes.append(s)
    return new_states, spikes


def apply(cfg: SNNConfig, params: Params, spike_input: torch.Tensor,
          return_all_layers: bool = False,
          matmul_backend: Optional[str] = None,
          layer_perms: Optional[Sequence] = None):
    """Run the net over a (T, B, ...) input spike train, or a slab's
    (T, C, B, ...) with slab params.

    Returns the output layer's (T, B, n_out) spike train ((T, C, B, n_out)
    for a slab); with ``return_all_layers`` the list of every spiking
    layer's train.  The trains are written into tensors allocated at the
    first step, so the peak memory is one copy of them.  Under autograd
    each write is a ``CopySlices`` node whose backward hands step t its
    slice of the train's gradient.
    """
    backend = resolve_matmul_backend(matmul_backend)
    cells = cells_of(cfg, params)
    num_steps = spike_input.shape[0]
    batch = spike_input.shape[1 if cells is None else 2]
    states = init_states(cfg, batch, spike_input.device, cells=cells)
    trains = None
    for t in range(num_steps):
        states, spikes = step(cfg, params, states, spike_input[t],
                              matmul_backend=backend, layer_perms=layer_perms)
        if not return_all_layers:
            spikes = spikes[-1:]
        if trains is None:
            trains = [s.new_empty((num_steps,) + tuple(s.shape))
                      for s in spikes]
        for train, s in zip(trains, spikes):
            train[t] = s
    return trains if return_all_layers else trains[0]


def layer_input_trains(cfg: SNNConfig, params: Params,
                       spike_input: torch.Tensor,
                       matmul_backend: Optional[str] = None
                       ) -> list[torch.Tensor]:
    """The (T, B, ...) spike train **entering** each spiking layer ((T, C,
    B, ...) for a slab).

    Entry 0 is the encoded input train; pooling between layers is applied
    first, because the hardware's ECU sees the pooled train.
    """
    all_spikes = apply(cfg, params, spike_input, return_all_layers=True,
                       matmul_backend=matmul_backend)
    trains = [spike_input]
    spiking_idx = 0
    layer_list = list(cfg.layers)
    for i, spec in enumerate(layer_list):
        if isinstance(spec, (Dense, Conv)):
            train = all_spikes[spiking_idx]
            j = i + 1
            while j < len(layer_list) and isinstance(layer_list[j], MaxPool):
                train = _or_pool(train, layer_list[j].window)
                j += 1
            trains.append(train)
            spiking_idx += 1
    # drop the final output train: it feeds no further layer
    return trains[:-1]


def spike_counts_per_layer(cfg: SNNConfig, params: Params,
                           spike_input: torch.Tensor,
                           matmul_backend: Optional[str] = None
                           ) -> list[torch.Tensor]:
    """Per-layer **input** spike counts, (T, B) each ((T, C, B) for a
    slab): the traffic statistic that drives the accelerator cycle model
    (entry 0 counts the encoded input train)."""
    trains = layer_input_trains(cfg, params, spike_input,
                                matmul_backend=matmul_backend)
    lead = 2 if cells_of(cfg, params) is None else 3
    return [t.reshape(t.shape[:lead] + (-1,)).sum(-1) for t in trains]
