"""Spike encoding and population decoding.

* **Rate coding**: pixel intensity is the Bernoulli spike probability of
  every time step.
* **Constant-current, time-to-first-spike and burst coding**: the other
  codes of the paper's Sec. II-A, used for ablations; all three are
  deterministic.
* **Population coding**: the classification layer holds ``pcr`` neurons
  per class, laid out class-major; the predicted class is the argmax of the
  summed spike counts of each class's pool.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rate_uniforms(generator: torch.Generator, shape: tuple[int, ...],
                  num_steps: int, device: torch.device) -> torch.Tensor:
    """The (T, *shape) uniforms of a rate code, drawn from ``generator``
    (on ``device``)."""
    return torch.rand((num_steps,) + tuple(shape), generator=generator,
                      device=device, dtype=torch.float32)


def rate_code(u: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Spikes ``u < x`` of (T, B, ...) uniforms and (B, ...) intensities."""
    return (u < x).to(torch.float32)


def rate_encode(generator: torch.Generator, x: torch.Tensor,
                num_steps: int) -> torch.Tensor:
    """Bernoulli rate code: ``x`` in [0, 1], shape (B, ...) -> (T, B, ...)
    spikes in {0, 1}.  ``generator`` lives on ``x``'s device."""
    return rate_code(rate_uniforms(generator, x.shape, num_steps, x.device),
                     x)


def constant_current_encode(x: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Direct (constant-current) encoding: the analog input is the synaptic
    current of every step.  (B, ...) -> (T, B, ...), a broadcast view."""
    return x.expand((num_steps,) + tuple(x.shape))


def _step_index(num_steps: int, ndim: int, device) -> torch.Tensor:
    return torch.arange(num_steps, dtype=torch.int32, device=device).reshape(
        (num_steps,) + (1,) * ndim)


def ttfs_encode(x: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Time-to-first-spike coding: x in [0, 1] -> (T, B, ...) with one
    spike at step floor((1 - x) * (T - 1)); x == 0 never spikes."""
    t_spike = torch.floor((1.0 - x) * (num_steps - 1)).to(torch.int32)
    steps = _step_index(num_steps, x.ndim, x.device)
    spikes = (steps == t_spike[None]).to(torch.float32)
    return spikes * (x[None] > 0)


def burst_encode(generator: torch.Generator, x: torch.Tensor, num_steps: int,
                 max_burst: int = 4) -> torch.Tensor:
    """Burst coding: intensity maps to the number of leading spikes,
    round(x * max_burst), halves to even.  ``generator`` is taken for the
    reference's signature (it takes a key) and draws nothing."""
    del generator
    n_spikes = torch.round(x * max_burst).to(torch.int32)
    steps = _step_index(num_steps, x.ndim, x.device)
    return (steps < n_spikes[None]).to(torch.float32)


def population_pool(spike_counts: torch.Tensor,
                    num_classes: int) -> torch.Tensor:
    """(..., num_classes*pcr) counts -> (..., num_classes) pooled counts."""
    *lead, n = spike_counts.shape
    if n % num_classes:
        raise ValueError(f"{n} output neurons do not split into "
                         f"{num_classes} class pools")
    return spike_counts.reshape(*lead, num_classes, n // num_classes).sum(-1)


def _argmax_first(x: torch.Tensor) -> torch.Tensor:
    """argmax over the last dim, ties to the lowest index (as
    ``jnp.argmax``); an untrained net ties often."""
    top = x.max(dim=-1, keepdim=True).values
    idx = torch.arange(x.shape[-1], device=x.device)
    return torch.where(x == top, idx, x.shape[-1]).min(dim=-1).values


def population_decode(spike_train: torch.Tensor,
                      num_classes: int) -> torch.Tensor:
    """(T, B, num_classes*pcr) spike train -> (B,) predicted class."""
    return _argmax_first(population_pool(spike_train.sum(0), num_classes))


def rate_loss(spike_train: torch.Tensor, labels: torch.Tensor,
              num_classes: int) -> torch.Tensor:
    """Cross-entropy on population-pooled spike counts as logits."""
    logits = population_pool(spike_train.sum(0), num_classes)
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()
