"""Layer-wise sparsity instrumentation (reproduces the paper's Fig. 1 and the
Table-I caption's "average spike events per layer").
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import snn
from repro_torch.core.accelerator import cycle_model


@dataclasses.dataclass(frozen=True)
class LayerSparsity:
    layer: int
    logical_neurons: int
    avg_spikes_per_step: float      # mean over time steps & samples
    firing_ratio: float             # avg_spikes / logical_neurons
    static_to_firing: float         # paper Fig. 1 companion metric


def analyze(cfg: snn.SNNConfig, params,
            spike_input: torch.Tensor) -> list[LayerSparsity]:
    """Firing statistics for every spiking layer's *input* traffic.

    ``spike_input``: (T, B, ...) encoded input train on any device (or a
    NumPy array); the forward runs without autograd on the device of
    ``params``.
    Entry 0 describes the input layer (encoded pixels); entry ``l`` describes
    the traffic entering spiking layer ``l`` — exactly what sizes the ECU /
    NU workload in the accelerator.
    """
    dev = next(v.device for p in params for v in p.values())
    with torch.inference_mode():
        counts = snn.spike_counts_per_layer(
            cfg, params, torch.as_tensor(spike_input, device=dev))
    # list[(T, B)] -> list[(T,)]
    traffic = cycle_model.counts_from_traces([c.cpu().numpy()
                                              for c in counts])
    sizes = _input_sizes(cfg)
    out = []
    for l, (c, n) in enumerate(zip(traffic, sizes)):
        avg = float(np.mean(c))
        ratio = avg / n
        out.append(LayerSparsity(
            layer=l, logical_neurons=n, avg_spikes_per_step=avg,
            firing_ratio=ratio,
            static_to_firing=(n - avg) / max(avg, 1e-9),
        ))
    return out


def _input_sizes(cfg: snn.SNNConfig) -> list[int]:
    """Size of the spike train entering each spiking layer (post-pooling)."""
    import math
    sizes = [int(math.prod(cfg.input_shape))]
    shapes = snn.output_shapes(cfg)
    layer_list = list(cfg.layers)
    for i, spec in enumerate(layer_list):
        if isinstance(spec, (snn.Dense, snn.Conv)):
            shape = shapes[i]
            j = i + 1
            while j < len(layer_list) and isinstance(layer_list[j], snn.MaxPool):
                shape = shapes[j]
                j += 1
            sizes.append(int(math.prod(shape)))
    return sizes[:-1]


def firing_table(stats: Sequence[LayerSparsity]) -> str:
    lines = [f"{'layer':>5} {'neurons':>8} {'avg spikes':>11} "
             f"{'firing ratio':>13} {'static:firing':>14}"]
    for s in stats:
        lines.append(f"{s.layer:>5} {s.logical_neurons:>8} "
                     f"{s.avg_spikes_per_step:>11.1f} {s.firing_ratio:>13.4f} "
                     f"{s.static_to_firing:>14.2f}")
    return "\n".join(lines)
