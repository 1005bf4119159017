"""Hardware architecture configuration (paper Sec. V).

One ``LayerHW`` per spiking layer mirrors the paper's generated RTL: an Event
Control Unit (chunked priority encoder + shift-register address array), a
pool of Neural Units (``ceil(logical / lhr)`` of them), and a Memory Unit
(block RAM holding synapse rows).  ``AcceleratorConfig`` aggregates the
layers plus the global timing constants of the component library.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import snn


def per_layer_col(matrix, l: int):
    """Column ``l`` of a (C, L) per-layer candidate matrix, or a (C,)
    global vector applied to every layer — the batched-DSE axis convention
    shared by ``cycle_model`` and ``resources``."""
    if matrix is None:
        return None
    m = np.asarray(matrix)
    return m[:, l] if m.ndim == 2 else m


@dataclasses.dataclass(frozen=True)
class LayerHW:
    kind: str                   # "fc" | "conv"
    logical: int                # logical neurons (fc) / output channels (conv)
    fan_in_size: int            # pre-synaptic spike-train size in bits (post-pool)
    lhr: int                    # logical-to-hardware ratio (paper Sec. VI-B)
    kernel: int = 0             # conv only
    out_positions: int = 0      # conv only: out_h * out_w
    penc_width: int = 100       # PENC chunk width (paper: ~100-bit FPGA limit)
    mem_blocks: int = 0         # 0 => one block per NU (no port contention)
    weight_bits: int = 8

    def __post_init__(self):
        if self.lhr < 1 or self.lhr > self.logical:
            raise ValueError(
                f"lhr={self.lhr} out of range for layer with {self.logical} "
                f"logical units")

    @property
    def num_nus(self) -> int:
        return -(-self.logical // self.lhr)

    @property
    def num_mem_blocks(self) -> int:
        return self.mem_blocks if self.mem_blocks else self.num_nus

    @property
    def contention(self) -> int:
        """Serialization factor when several NUs share one memory block."""
        return -(-self.num_nus // self.num_mem_blocks)

    @property
    def penc_chunks(self) -> int:
        return -(-self.fan_in_size // self.penc_width)

    @property
    def neurons_per_nu(self) -> int:
        if self.kind == "fc":
            return self.lhr
        return self.out_positions * self.lhr

    @property
    def synapses(self) -> int:
        """Total weights this layer stores."""
        if self.kind == "fc":
            return self.fan_in_size * self.logical
        return self.kernel * self.kernel * self.fan_in_channels * self.logical

    @property
    def fan_in_channels(self) -> int:
        if self.kind != "conv":
            return 0
        # fan_in_size = in_h * in_w * in_c and out_positions = out_h * out_w;
        # with stride-1 SAME conv, in_h*in_w == out_positions.
        return max(1, self.fan_in_size // max(self.out_positions, 1))


@dataclasses.dataclass(frozen=True)
class TimingModel:
    """Calibrated component-library timing constants (see calibrate.py).

    * ``acc_cycles_per_op`` — cycles per single weight accumulate (BRAM
      read-modify-write, pipelined; the Table-I fit lands on 1).
    * ``act_cycles``        — cycles per neuron membrane update in the
      activation phase.
    * ``sync_cycles``       — ECU handshake per layer per time step.
    * ``conv_event_driven_act`` — if True the conv activation phase visits
      only *affected* neuron addresses (lazy leak), the only reading of
      Table I under which net-5's LHR sweep is self-consistent; see
      EXPERIMENTS.md §Reproduction.
    """
    acc_cycles_per_op: int = 1
    act_cycles: int = 1
    sync_cycles: int = 4
    conv_event_driven_act: bool = True
    pool_retention: float = 1.0      # OR-pool spike survival fraction
    clock_mhz: float = 100.0


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    name: str
    layers: tuple[LayerHW, ...]
    timing: TimingModel = TimingModel()
    num_steps: int = 25

    @property
    def lhr(self) -> tuple[int, ...]:
        return tuple(l.lhr for l in self.layers)

    def with_lhr(self, lhr: Sequence[int]) -> "AcceleratorConfig":
        assert len(lhr) == len(self.layers)
        layers = tuple(dataclasses.replace(l, lhr=r)
                       for l, r in zip(self.layers, lhr))
        return dataclasses.replace(self, layers=layers)

    def with_updates(self,
                     lhr: Sequence[int] | None = None,
                     mem_blocks: Sequence[int] | None = None,
                     weight_bits: Sequence[int] | int | None = None,
                     penc_width: Sequence[int] | int | None = None,
                     clock_mhz: float | None = None) -> "AcceleratorConfig":
        """Materialize one DSE candidate row as a concrete config.

        Per-layer arguments take a length-L sequence; ``weight_bits`` and
        ``penc_width`` also accept a single value applied to every layer.
        """
        def expand(v):
            if v is None:
                return None
            if hasattr(v, "__len__"):
                assert len(v) == len(self.layers), (v, len(self.layers))
                return [int(x) for x in v]
            return [int(v)] * len(self.layers)

        per_layer = {"lhr": expand(lhr), "mem_blocks": expand(mem_blocks),
                     "weight_bits": expand(weight_bits),
                     "penc_width": expand(penc_width)}
        layers = []
        for i, l in enumerate(self.layers):
            kw = {k: v[i] for k, v in per_layer.items() if v is not None}
            layers.append(dataclasses.replace(l, **kw) if kw else l)
        timing = (dataclasses.replace(self.timing, clock_mhz=float(clock_mhz))
                  if clock_mhz is not None else self.timing)
        return dataclasses.replace(self, layers=tuple(layers), timing=timing)


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

def from_layer_sizes(name: str, sizes: Sequence[int],
                     lhr: Optional[Sequence[int]] = None,
                     timing: TimingModel = TimingModel(),
                     num_steps: int = 25, **kw) -> AcceleratorConfig:
    """Fully-connected accelerator from layer sizes (input first).

    ``sizes = (784, 500, 500, 300)`` builds 3 FC layer engines.
    """
    lhr = tuple(lhr) if lhr is not None else (1,) * (len(sizes) - 1)
    assert len(lhr) == len(sizes) - 1
    layers = tuple(
        LayerHW(kind="fc", logical=sizes[i + 1], fan_in_size=sizes[i],
                lhr=lhr[i], **kw)
        for i in range(len(sizes) - 1))
    return AcceleratorConfig(name=name, layers=layers, timing=timing,
                             num_steps=num_steps)


def from_snn_config(cfg: snn.SNNConfig,
                    lhr: Optional[Sequence[int]] = None,
                    timing: TimingModel = TimingModel(),
                    penc_width: int = 100,
                    weight_bits: int = 8) -> AcceleratorConfig:
    """Build the hardware description straight from a trained model's
    topology — the paper's Architecture Generation Phase."""
    import math as _m
    shapes = snn.output_shapes(cfg)
    layer_list = list(cfg.layers)
    hw = []
    in_shape = cfg.input_shape
    for i, spec in enumerate(layer_list):
        if isinstance(spec, snn.Dense):
            hw.append(LayerHW(
                kind="fc", logical=spec.features,
                fan_in_size=int(_m.prod(in_shape)), lhr=1,
                penc_width=penc_width, weight_bits=weight_bits))
            in_shape = shapes[i]
        elif isinstance(spec, snn.Conv):
            out_shape = shapes[i]
            hw.append(LayerHW(
                kind="conv", logical=spec.features,
                fan_in_size=int(_m.prod(in_shape)), lhr=1,
                kernel=spec.kernel,
                out_positions=out_shape[0] * out_shape[1],
                penc_width=penc_width, weight_bits=weight_bits))
            in_shape = out_shape
        elif isinstance(spec, snn.MaxPool):
            in_shape = shapes[i]
        else:
            raise TypeError(spec)
    acc = AcceleratorConfig(name=cfg.name, layers=tuple(hw), timing=timing,
                            num_steps=cfg.num_steps)
    return acc.with_lhr(lhr) if lhr is not None else acc
