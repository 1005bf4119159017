"""Spike encoding and population decoding.

* **Rate coding**: pixel intensity is the Bernoulli spike probability of
  every time step.
* **Population coding**: the classification layer holds ``pcr`` neurons
  per class, laid out class-major; the predicted class is the argmax of the
  summed spike counts of each class's pool.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rate_encode(generator: torch.Generator, x: torch.Tensor,
                num_steps: int) -> torch.Tensor:
    """Bernoulli rate code: ``x`` in [0, 1], shape (B, ...) -> (T, B, ...)
    spikes in {0, 1}.  ``generator`` lives on ``x``'s device."""
    u = torch.rand((num_steps,) + tuple(x.shape), generator=generator,
                   device=x.device, dtype=torch.float32)
    return (u < x).to(torch.float32)


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
