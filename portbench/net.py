"""A configuration file read into layer geometry, and the cell's initial
weights made on the device from the seed.

The geometry is what the reference, the counting functions and the
program's adapter share: (H, W, C) activations and HWIO conv weights,
(K, N) dense weights, XLA's SAME and VALID pads, non-overlapping OR-pools.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from portbench.traffic import generator


@dataclasses.dataclass(frozen=True)
class Layer:
    kind: str                         # "conv", "pool" or "dense"
    features: int = 0
    kernel: int = 0
    stride: int = 1
    padding: str = "SAME"
    window: int = 0
    in_shape: tuple = ()
    out_shape: tuple = ()

    @property
    def spiking(self) -> bool:
        return self.kind != "pool"


@dataclasses.dataclass(frozen=True)
class LIF:
    beta: float
    threshold: float
    slope: float
    reset: str


@dataclasses.dataclass(frozen=True)
class Net:
    layers: tuple
    input_shape: tuple
    num_classes: int
    pcr: int
    num_steps: int
    lif: LIF

    @property
    def spiking(self) -> list:
        return [l for l in self.layers if l.spiking]


def conv_pads(size: int, k: int, stride: int, padding: str
              ) -> tuple[int, int, int]:
    """(output size, low pad, high pad) of one axis, as XLA pads."""
    if padding == "SAME":
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        return out, total // 2, total - total // 2
    if padding == "VALID":
        return (size - k) // stride + 1, 0, 0
    raise ValueError(f"unknown padding {padding!r}")


def parse(config: dict, num_steps: Optional[int] = None) -> Net:
    shape = tuple(config["input_shape"])
    layers = []
    for spec in config["layers"]:
        kind = spec["kind"]
        if kind == "conv":
            h, w, _ = shape
            oh = conv_pads(h, spec["kernel"], spec["stride"],
                           spec["padding"])[0]
            ow = conv_pads(w, spec["kernel"], spec["stride"],
                           spec["padding"])[0]
            out = (oh, ow, spec["features"])
            layer = Layer("conv", spec["features"], spec["kernel"],
                          spec["stride"], spec["padding"])
        elif kind == "pool":
            h, w, c = shape
            win = spec["window"]
            out = (h // win, w // win, c)
            layer = Layer("pool", window=win)
        elif kind == "dense":
            out = (spec["features"],)
            layer = Layer("dense", spec["features"])
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
        layers.append(dataclasses.replace(layer, in_shape=shape,
                                          out_shape=out))
        shape = out
    lif = config["lif"]
    net = Net(tuple(layers), tuple(config["input_shape"]),
              config["num_classes"], config["pcr"],
              int(num_steps or config["num_steps"]),
              LIF(lif["beta"], lif["threshold"], lif["slope"], lif["reset"]))
    if math.prod(shape) != net.num_classes * net.pcr:
        raise ValueError(f"{shape} output neurons for {net.num_classes} "
                         f"classes x {net.pcr}")
    return net


def fanout_positions(size: int, k: int, stride: int,
                     padding: str) -> list[int]:
    """For each input position of one axis of a convolution, the output
    positions whose window covers it."""
    out, lo, _ = conv_pads(size, k, stride, padding)
    cover = [0] * size
    for o in range(out):
        for d in range(k):
            pos = o * stride - lo + d
            if 0 <= pos < size:
                cover[pos] += 1
    return cover


def weight_shape(layer: Layer) -> tuple:
    if layer.kind == "conv":
        return (layer.kernel, layer.kernel, layer.in_shape[-1],
                layer.features)
    return (math.prod(layer.in_shape), layer.features)


def init_params(net: Net, init: dict, cells: Optional[int], seed: int,
                device) -> list[dict]:
    """Normal weights times ``gain / sqrt(fan_in)`` per spiking layer
    (``init["gains"]``), rounded to the grid of ``2 ** -init["grid_bits"]``,
    and zero biases; one dict a layer (empty for a pool), drawn on
    ``device`` in one call, a leading cell axis of ``cells`` when it is
    given.

    On the grid, a product of 0/1 spikes and these weights sums exactly in
    fp32 in any order while every weight column's absolute sum stays under
    ``2 ** (24 - grid_bits)``, which is checked: the first step's forward
    is then the same on both sides of the correctness check, whatever
    order the kernels add in."""
    gains, bits = init["gains"], init["grid_bits"]
    shapes = [weight_shape(l) for l in net.spiking]
    if len(gains) != len(shapes):
        raise ValueError(f"{len(gains)} gains for {len(shapes)} layers")
    sizes = [math.prod(s) for s in shapes]
    lead = (cells or 1,)
    draw = torch.randn(lead + (sum(sizes),), generator=generator(
        device, seed, "weights"), device=device, dtype=torch.float32)
    params, at = [], 0
    leaves = iter(zip(shapes, sizes, gains))
    for layer in net.layers:
        if not layer.spiking:
            params.append({})
            continue
        shape, size, gain = next(leaves)
        fan_in = math.prod(shape[:-1])
        w = torch.round(draw[:, at:at + size].reshape(lead + shape) * (
            gain / math.sqrt(fan_in) * 2 ** bits)) / 2 ** bits
        colsum = float(w.abs().reshape(lead + (-1, shape[-1])).sum(1).max())
        if not colsum < 2 ** (24 - bits):
            raise ValueError(f"a weight column sums to {colsum}: the "
                             f"2^-{bits} grid no longer sums exactly")
        b = torch.zeros(lead + (shape[-1],), dtype=torch.float32,
                        device=device)
        at += size
        params.append({"w": w if cells else w[0],
                       "b": b if cells else b[0]})
    return params
