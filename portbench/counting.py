"""The work one training step needs, from shapes and spike counts: the
yardstick of ``step_mfu_pct`` and the kernel rooflines.

Counted element by element, the same whatever implements it:

* operations: in a forward product and in dW, 2 x each input spike x its
  fan-out (the output positions it reaches times the layer's features);
  in dS, the dense product, wherever the step computes an input gradient
  (every spiking layer but the first, whose input is data);
* bytes, fp32 throughout: each operand read once and each output written
  once, but for the weight rows of a dense forward that no spike of the
  batch selects, which no arithmetic needs.  The fused dense step also
  reads the bias and the previous (u, s) and writes the new (u, s).

``launches`` lists one entry a launch of the model's products: (group,
kind, layer, time step, operations, bytes), a slab's cells summed into
the launch that serves them all.  The statistics come from
``reference.snn.spike_stats``: per layer and step (events,
events x fan-out positions, dense weight rows needed).
"""
from __future__ import annotations

import dataclasses
import math

from portbench.net import Net, fanout_positions

F32 = 4
#: NVIDIA's data sheet, H100 SXM, dense rates, at the 700 W power limit.
PEAK_FP32_FLOPS = 67e12            # float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12         # HBM3


@dataclasses.dataclass(frozen=True)
class Launch:
    group: str          # "conv" or "dense"
    kind: str           # "forward", "dw" or "ds"
    layer: int          # index among the spiking layers
    step: int           # time step
    flops: float
    bytes: float

    @property
    def least_s(self) -> float:
        """The least time the chip could take: the larger of the
        operations at peak FLOP/s and the bytes at peak bandwidth."""
        return max(self.flops / PEAK_FP32_FLOPS,
                   self.bytes / PEAK_BYTES_PER_S)


def layer_launches(net: Net, batch: int, index: int, step: int,
                   stats) -> list[Launch]:
    """The forward, dW and (but for the first layer) dS launches of spiking
    layer ``index`` at one time step; ``stats`` = (events, events x fan-out
    positions, dense weight rows needed), summed over the slab's cells,
    with ``cells`` the number of cells (operand sizes scale with it)."""
    events, reach, rows, cells = stats
    layer = net.spiking[index]
    x_in = batch * math.prod(layer.in_shape)
    y_out = batch * math.prod(layer.out_shape)
    fan_in = math.prod(layer.in_shape) if layer.kind == "dense" else (
        layer.kernel * layer.kernel * layer.in_shape[-1])
    w = fan_in * layer.features
    fwd_flops = 2.0 * reach * layer.features
    out = []
    if layer.kind == "conv":
        group = "conv"
        fwd_bytes = F32 * cells * (x_in + w + y_out)
        # the dense transposed product: every (input pixel, covering
        # output pixel, in-channel, out-channel)
        ds_flops = 2.0 * cells * batch * layer.in_shape[-1] * \
            layer.features * _covered_pixels(layer)
    else:
        group = "dense"
        n = layer.features
        # S, the weight rows a spike selects, the bias, (u, s) in and out
        fwd_bytes = F32 * (cells * (x_in + n + 4 * y_out) + rows * n)
        ds_flops = 2.0 * cells * batch * fan_in * n
    out.append(Launch(group, "forward", index, step, fwd_flops, fwd_bytes))
    out.append(Launch(group, "dw", index, step, fwd_flops,
                      F32 * cells * (x_in + y_out + w)))
    if index > 0:
        out.append(Launch(group, "ds", index, step, ds_flops,
                          F32 * cells * (y_out + w + x_in)))
    return out


def _covered_pixels(layer) -> float:
    """Sum over input pixels of the output pixels whose window covers it."""
    h, w, _ = layer.in_shape
    return float(sum(fanout_positions(h, layer.kernel, layer.stride,
                                      layer.padding))
                 * sum(fanout_positions(w, layer.kernel, layer.stride,
                                        layer.padding)))


def step_launches(net: Net, batch: int, cell_stats: list) -> list[Launch]:
    """Every product launch of one training step.  ``cell_stats``: per
    cell, per spiking layer, the (T, 3) list of ``spike_stats``."""
    cells = len(cell_stats)
    out = []
    for i in range(len(net.spiking)):
        for t in range(net.num_steps):
            summed = [sum(cs[i][t][k] for cs in cell_stats)
                      for k in range(3)]
            out += layer_launches(net, batch, i, t, (*summed, cells))
    return out
