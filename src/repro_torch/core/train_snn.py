"""The inference half of the SNN driver: ``evaluate`` a model and
``dump_traces`` of its spike traffic for the accelerator model.

Every entry point threads ``matmul_backend`` (one of
``snn.MATMUL_BACKENDS``) down to ``snn.apply``.  The backends give the same
spikes, so the traces a DSE reads do not depend on which one ran.
Training (surrogate-gradient BPTT) is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import encoding, snn
from repro_torch.core.accelerator import cycle_model
from repro_torch.device import DeviceLike, resolve


def _encode_input(generator: torch.Generator, x: torch.Tensor,
                  num_steps: int) -> torch.Tensor:
    if x.ndim == 5:        # pre-encoded event data (B, T, H, W, C)
        return x.permute(1, 0, 2, 3, 4)
    return encoding.rate_encode(generator, x, num_steps)


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
