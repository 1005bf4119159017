"""AcceleratorConfig constructors for the paper's five benchmark networks
(Table I), plus their published traffic statistics as cycle-model inputs."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.accelerator import paper_data
from repro_torch.core.accelerator.arch import (AcceleratorConfig, LayerHW,
                                         TimingModel, from_layer_sizes)
from repro_torch.core.accelerator.cycle_model import counts_from_averages

# Spike-train lengths: net-5's T=124 is stated in the paper (Sec. VI-B);
# net-1..4 are not disclosed per row and are calibrated (calibrate.py).
DEFAULT_T = {"net-1": 60, "net-2": 73, "net-3": 51, "net-4": 70, "net-5": 124}


def build(net: str, lhr: Sequence[int] | None = None,
          timing: TimingModel = TimingModel(),
          num_steps: int | None = None) -> AcceleratorConfig:
    spec = paper_data.NETS[net]
    T = num_steps or DEFAULT_T[net]
    if not spec.conv:
        cfg = from_layer_sizes(net, spec.layer_sizes, timing=timing, num_steps=T)
    else:
        # net-5: 128x128 - 32C3 - P2 - 32C3 - P2 - 512 - 256 (- 11)
        layers = (
            LayerHW(kind="conv", logical=32, fan_in_size=128 * 128, lhr=1,
                    kernel=3, out_positions=128 * 128),
            LayerHW(kind="conv", logical=32, fan_in_size=64 * 64 * 32, lhr=1,
                    kernel=3, out_positions=64 * 64),
            LayerHW(kind="fc", logical=512, fan_in_size=32 * 32 * 32, lhr=1),
            LayerHW(kind="fc", logical=256, fan_in_size=512, lhr=1),
        )
        cfg = AcceleratorConfig(name=net, layers=layers, timing=timing,
                                num_steps=T)
    if lhr is not None:
        cfg = cfg.with_lhr(lhr)
    return cfg


def pool_before_flags(net: str) -> list[bool]:
    if net == "net-5":
        return [False, True, True, False]
    return [False] * (len(paper_data.NETS[net].layer_sizes) - 1)


def paper_counts(net: str, cfg: AcceleratorConfig) -> list[np.ndarray]:
    """Constant per-step traffic from the Table-I caption averages."""
    spec = paper_data.NETS[net]
    return counts_from_averages(cfg, spec.avg_spikes,
                                num_steps=cfg.num_steps,
                                pool_before=pool_before_flags(net))
