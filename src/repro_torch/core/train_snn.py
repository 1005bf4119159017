"""Training and evaluation of an SNN: surrogate-gradient BPTT,
``evaluate``, and ``dump_traces`` of the spike traffic for the accelerator
model.

Training runs the T-step loop of ``snn.apply`` forward and lets autograd
run it backward (BPTT): the fast-sigmoid surrogate of ``lif.spike_fn`` (or
of the fused kernel's backward), then on the kernel backends the block-skip
dW and dS kernels for every Dense and Conv layer.  The optimizer is
``optim.adam`` with the JAX package's arithmetic.  On the card the whole
step, forward, BPTT and update, is captured into one CUDA graph at its
second call and replayed after (``step_graph``); on the CPU it runs
eagerly.

Every entry point threads ``matmul_backend`` (one of
``snn.MATMUL_BACKENDS``) down to ``snn.apply``.  The backends give the same
spikes, so the traces a DSE reads do not depend on which one ran.  Random
bits (rate encoding) come from explicit ``torch.Generator``s; batches come
from ``synthetic.batches`` as in the JAX package, so both see the same
batches in the same order.

``make_stacked_train_step`` is the train step of a slab of C cells
(``distributed/cellstack.py``): params and Adam state with a leading cell
axis, one generator per cell, (C, B, ...) batches.  Each cell's rate code
is drawn from its own generator at the solo shape, and each cell's loss is
the solo loss on its slice; their sum is differentiated, so each cell's
gradient is its solo gradient bit for bit (times 1.0).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import optim, spans
from repro_torch.core import encoding, snn, step_graph
from repro_torch.core.accelerator import cycle_model
from repro_torch.data import synthetic
from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels import ops as kernel_ops


@dataclasses.dataclass
class TrainResult:
    params: snn.Params
    train_loss: list[float]
    test_accuracy: float
    cfg: snn.SNNConfig


def _encode_input(generator: torch.Generator, x: torch.Tensor,
                  num_steps: int) -> torch.Tensor:
    if x.ndim == 5:        # pre-encoded event data (B, T, H, W, C)
        return x.permute(1, 0, 2, 3, 4)
    return encoding.rate_encode(generator, x, num_steps)


def encode_cells(generators, x: torch.Tensor,
                 num_steps: int) -> torch.Tensor:
    """(T, C, B, ...) input spikes of a slab's (C, B, ...) inputs: each
    cell's rate code from its own generator at the solo shape, or each
    cell's pre-encoded events."""
    return torch.stack([_encode_input(gen, x[c], num_steps)
                        for c, gen in enumerate(generators)], dim=1)


def encode_shared(generator: torch.Generator, x: torch.Tensor,
                  num_steps: int) -> torch.Tensor:
    """(T, C, B, ...) input spikes of a slab's (C, B, ...) inputs from one
    generator that every cell's solo run seeds alike (``evaluate``,
    ``dump_traces``): one draw at the solo shape serves every cell."""
    if x.ndim == 6:        # pre-encoded events (C, B, T, H, W, Ch)
        return x.permute(2, 0, 1, 3, 4, 5)
    u = encoding.rate_uniforms(generator, x.shape[1:], num_steps, x.device)
    return torch.stack([encoding.rate_code(u, x[c])
                        for c in range(x.shape[0])], dim=1)


def loss_fn(cfg: snn.SNNConfig, params: snn.Params,
            generator: torch.Generator, x: torch.Tensor, y: torch.Tensor,
            matmul_backend: Optional[str] = None) -> torch.Tensor:
    """Rate cross-entropy of the population-pooled output spike counts."""
    spikes_in = _encode_input(generator, x, cfg.num_steps)
    out_train = snn.apply(cfg, params, spikes_in,
                          matmul_backend=matmul_backend)
    return encoding.rate_loss(out_train, y, cfg.num_classes)


def stacked_loss_fn(cfg: snn.SNNConfig, params: snn.Params, generators,
                    x: torch.Tensor, y: torch.Tensor,
                    matmul_backend: Optional[str] = None) -> torch.Tensor:
    """(C,) losses of a slab: each cell's ``loss_fn`` on its own inputs,
    generator and slice of the slab's output train, at the solo shape."""
    spikes_in = encode_cells(generators, x, cfg.num_steps)
    out_train = snn.apply(cfg, params, spikes_in,
                          matmul_backend=matmul_backend)
    return torch.stack([encoding.rate_loss(out_train[:, c], y[c],
                                           cfg.num_classes)
                        for c in range(len(generators))])


def _step_on(loss_of, tx: optim.GradientTransform):
    """A train step on ``loss_of(params, generator(s), x, y)``, a scalar
    loss or a slab's (C,) losses, whose sum is differentiated.  On the card
    it runs as one CUDA graph a signature after an eager warm-up
    (``step_graph.StepGraphs``).  Every call runs in a ``step`` span
    (``repro_torch.spans``); the eager call and the capture open its
    children ``forward``, ``backward`` and ``optimizer``, a replay none."""

    def eager(params, opt_state, generator, x, y):
        leaves = [{k: v.detach().requires_grad_() for k, v in p.items()}
                  for p in params]
        with spans.span("forward"):
            loss = loss_of(leaves, generator, x, y)
        flat = [v for p in leaves for v in p.values()]
        with spans.span("backward"):
            grads_flat = iter(torch.autograd.grad(
                loss if loss.dim() == 0 else loss.sum(), flat))
        grads = [{k: next(grads_flat) for k in p} for p in leaves]
        with torch.no_grad(), spans.span("optimizer"):
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optim.apply_updates(params, updates)
        # the graph, held by ``loss``, is freed here, inside the step
        return params, opt_state, loss.detach()

    graphs = step_graph.StepGraphs(eager)

    def train_step(params, opt_state, generator, x, y):
        with spans.span(spans.STEP):
            return graphs(params, opt_state, generator, x, y)

    # a test hook: tests reach the step's graphs and its eager ``fn`` here
    train_step.graphs = graphs
    return train_step


def make_train_step(cfg: snn.SNNConfig, tx: optim.GradientTransform,
                    matmul_backend: Optional[str] = None):
    """One step of the training loop, ``(params, opt_state, generator, x,
    y) -> (params, opt_state, loss)``: the loss and its gradient by BPTT,
    then the optimizer's update; on the card, a CUDA graph replayed from
    the second call of each signature on.  Returns new parameter tensors;
    the arguments are not changed in place."""
    backend = snn.resolve_matmul_backend(matmul_backend)
    return _step_on(lambda p, gen, x, y: loss_fn(cfg, p, gen, x, y,
                                                 matmul_backend=backend), tx)


def make_stacked_train_step(cfg: snn.SNNConfig, tx: optim.GradientTransform,
                            matmul_backend: Optional[str] = None):
    """``make_train_step`` of a slab of C cells: ``(params, opt_state,
    generators, x, y) -> (params, opt_state, losses)`` with every param and
    optimizer leaf (C, ...), C generators, (C, B, ...) inputs and (C,)
    losses.  The optimizer's arithmetic is elementwise, so one update of
    the slab is each cell's solo update."""
    backend = snn.resolve_matmul_backend(matmul_backend)
    return _step_on(lambda p, gens, x, y: stacked_loss_fn(
        cfg, p, gens, x, y, matmul_backend=backend), tx)


def init_cell(cfg: snn.SNNConfig, tx: optim.GradientTransform, seed: int,
              device: DeviceLike = None):
    """The exact (params, opt_state, generator) that ``train`` starts from:
    weights from a CPU generator seeded with ``seed`` (the same weights on
    every device), and the rate encoder's generator on ``device``, seeded
    with ``seed`` too."""
    dev = resolve(device)
    params = snn.init_params(torch.Generator().manual_seed(seed), cfg,
                             device=dev)
    return params, tx.init(params), torch.Generator(device=dev).manual_seed(
        seed)


def train(cfg: snn.SNNConfig, data: synthetic.Dataset, *,
          steps: int = 300, batch_size: int = 64, lr: float = 2e-3,
          seed: int = 0, log_every: int = 50, verbose: bool = False,
          matmul_backend: Optional[str] = None,
          device: DeviceLike = None) -> TrainResult:
    """Train ``cfg`` on ``data`` with Adam for ``steps`` batches, then
    measure test accuracy.  Deterministic: the same arguments give the same
    parameters bit for bit on the same device."""
    dev = resolve(device)
    backend = snn.resolve_matmul_backend(matmul_backend)
    tx = optim.adam(lr)
    params, opt_state, gen = init_cell(cfg, tx, seed, device=dev)
    train_step = make_train_step(cfg, tx, backend)

    losses = []
    it = synthetic.batches(data.x_train, data.y_train, batch_size,
                           seed=seed, epochs=10_000)
    for step_i in range(steps):
        xb, yb = next(it)
        params, opt_state, loss = train_step(
            params, opt_state, gen, torch.as_tensor(xb, device=dev),
            torch.as_tensor(yb, device=dev))
        losses.append(float(loss))
        if verbose and step_i % log_every == 0:
            print(f"step {step_i:4d}  loss {losses[-1]:.4f}")

    acc = evaluate(cfg, params, data.x_test, data.y_test,
                   matmul_backend=backend, device=dev)
    return TrainResult(params=params, train_loss=losses, test_accuracy=acc,
                       cfg=cfg)


def evaluate(cfg: snn.SNNConfig, params: snn.Params, x: np.ndarray,
             y: np.ndarray, batch_size: int = 256, seed: int = 1234,
             matmul_backend: Optional[str] = None,
             device: DeviceLike = None) -> float:
    """Test accuracy of population-decoded predictions over ``x``."""
    dev = resolve(device)
    backend = snn.resolve_matmul_backend(matmul_backend)
    gen = torch.Generator(device=dev).manual_seed(seed)
    correct, total = 0, 0
    with torch.inference_mode():
        for i in range(0, len(x), batch_size):
            xb = torch.as_tensor(x[i:i + batch_size], device=dev)
            spikes_in = _encode_input(gen, xb, cfg.num_steps)
            out_train = snn.apply(cfg, params, spikes_in,
                                  matmul_backend=backend)
            pred = encoding.population_decode(out_train, cfg.num_classes)
            correct += int((pred.cpu().numpy() == y[i:i + batch_size]).sum())
            total += len(y[i:i + batch_size])
    return correct / max(total, 1)


def dump_traces(cfg: snn.SNNConfig, params: snn.Params, x: np.ndarray,
                seed: int = 7, max_samples: int = 64,
                matmul_backend: Optional[str] = None,
                device: DeviceLike = None) -> dict:
    """Spike-traffic statistics for the accelerator model: per-layer input
    spike counts of shape (T, N) for N = ``min(len(x), max_samples)``."""
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.inference_mode():
        xb = torch.as_tensor(x[:max_samples], device=dev)
        spikes_in = _encode_input(gen, xb, cfg.num_steps)
        counts = snn.spike_counts_per_layer(cfg, params, spikes_in,
                                            matmul_backend=matmul_backend)
        counts = [c.cpu().numpy() for c in counts]
    return {"layer_input_spike_counts": counts,
            "layer_sizes": cfg.layer_sizes(),
            "num_steps": cfg.num_steps}


def trace_counts(cfg: snn.SNNConfig, params: snn.Params, x: np.ndarray,
                 seed: int = 7, max_samples: int = 64,
                 matmul_backend: Optional[str] = None,
                 device: DeviceLike = None) -> list[np.ndarray]:
    """``dump_traces`` reduced to the per-layer (T,) mean traffic the cycle
    model consumes."""
    traces = dump_traces(cfg, params, x, seed=seed, max_samples=max_samples,
                         matmul_backend=matmul_backend, device=device)
    return cycle_model.counts_from_traces(traces["layer_input_spike_counts"])


def train_firing_permutation(train: torch.Tensor) -> torch.Tensor:
    """Per-input-neuron mean firing rate of a (T, B, ...) spike train,
    sorted cold-first (``ops.firing_rate_permutation``)."""
    flat = train.reshape(-1, int(np.prod(train.shape[2:])))
    return kernel_ops.firing_rate_permutation(flat.mean(0))


def profiled_permutations(cfg: snn.SNNConfig, params: snn.Params,
                          x: np.ndarray, seed: int = 7,
                          max_samples: int = 64,
                          device: DeviceLike = None) -> list:
    """Per-layer pre-synaptic permutations from profiled firing rates: a
    profiling pass over ``x`` sorts each Dense layer's input axis by
    observed rate, so cold neurons cluster into skippable tiles.  A list
    aligned with ``cfg.layers`` (``None`` for Conv and MaxPool), ready for
    ``snn.apply(..., layer_perms=...)``."""
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.inference_mode():
        xb = torch.as_tensor(x[:max_samples], device=dev)
        spikes_in = _encode_input(gen, xb, cfg.num_steps)
        trains = iter(snn.layer_input_trains(cfg, params, spikes_in))
        perms: list = []
        for spec in cfg.layers:
            perm = None
            if isinstance(spec, (snn.Dense, snn.Conv)):
                train = next(trains)
                if isinstance(spec, snn.Dense):
                    perm = train_firing_permutation(train)
            perms.append(perm)
    return perms
