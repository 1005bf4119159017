"""Training and evaluation of an SNN: surrogate-gradient BPTT,
``evaluate``, and ``dump_traces`` of the spike traffic for the accelerator
model.

Training runs the T-step loop of ``snn.apply`` forward and lets autograd
run it backward (BPTT): the fast-sigmoid surrogate of ``lif.spike_fn`` (or
of the fused kernel's backward), then on the kernel backends the block-skip
dW and dS kernels for every Dense and Conv layer.  The optimizer is
``optim.adam`` with the JAX package's arithmetic.

Every entry point threads ``matmul_backend`` (one of
``snn.MATMUL_BACKENDS``) down to ``snn.apply``.  The backends give the same
spikes, so the traces a DSE reads do not depend on which one ran.  Random
bits (rate encoding) come from explicit ``torch.Generator``s; batches come
from ``synthetic.batches`` as in the JAX package, so both see the same
batches in the same order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import optim
from repro_torch.core import encoding, snn
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


def loss_fn(cfg: snn.SNNConfig, params: snn.Params,
            generator: torch.Generator, x: torch.Tensor, y: torch.Tensor,
            matmul_backend: Optional[str] = None) -> torch.Tensor:
    """Rate cross-entropy of the population-pooled output spike counts."""
    spikes_in = _encode_input(generator, x, cfg.num_steps)
    out_train = snn.apply(cfg, params, spikes_in,
                          matmul_backend=matmul_backend)
    return encoding.rate_loss(out_train, y, cfg.num_classes)


def make_train_step(cfg: snn.SNNConfig, tx: optim.GradientTransform,
                    matmul_backend: Optional[str] = None):
    """One step of the training loop, ``(params, opt_state, generator, x,
    y) -> (params, opt_state, loss)``: the loss and its gradient by BPTT,
    then the optimizer's update.  Returns new parameter tensors; the
    arguments are not changed in place."""
    backend = snn.resolve_matmul_backend(matmul_backend)

    def train_step(params, opt_state, generator, x, y):
        leaves = [{k: v.detach().requires_grad_() for k, v in p.items()}
                  for p in params]
        loss = loss_fn(cfg, leaves, generator, x, y, matmul_backend=backend)
        flat = [v for p in leaves for v in p.values()]
        grads_flat = iter(torch.autograd.grad(loss, flat))
        grads = [{k: next(grads_flat) for k in p} for p in leaves]
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optim.apply_updates(params, updates)
        return params, opt_state, loss.detach()

    return train_step


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
