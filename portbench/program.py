"""The system under test: the port's train step, built from a
configuration file.  Everything the benchmark takes from ``repro_torch``
goes through this module: the model's config, the optimizer, the step
entries ``train_snn.make_train_step`` (one cell) and
``make_stacked_train_step`` (a slab of cells), and the first moments of
Adam's state, from which the first step's gradient is read.
"""
from __future__ import annotations

from repro_torch import optim
from repro_torch.core import lif, snn, train_snn

from portbench.net import Net


def snn_config(name: str, net: Net) -> snn.SNNConfig:
    """The port's ``SNNConfig`` of ``net``."""
    neuron = lif.LIFParams(beta=net.lif.beta, threshold=net.lif.threshold,
                           slope=net.lif.slope,
                           reset_mechanism=net.lif.reset)
    layers = []
    for layer in net.layers:
        if layer.kind == "conv":
            layers.append(snn.Conv(layer.features, layer.kernel,
                                   layer.stride, layer.padding, neuron))
        elif layer.kind == "pool":
            layers.append(snn.MaxPool(layer.window))
        else:
            layers.append(snn.Dense(layer.features, neuron))
    return snn.SNNConfig(name, tuple(net.input_shape), tuple(layers),
                         num_classes=net.num_classes, pcr=net.pcr,
                         num_steps=net.num_steps)


def train_step(name: str, net: Net, config: dict, slab: bool):
    """(step, optimizer): ``step(params, opt_state, generator(s), x, y) ->
    (params, opt_state, loss(es))``."""
    opt = config["optimizer"]
    if opt["name"] != "adam":
        raise ValueError(f"unknown optimizer {opt['name']!r}")
    tx = optim.adam(opt["lr"], b1=opt["b1"], b2=opt["b2"], eps=opt["eps"])
    make = (train_snn.make_stacked_train_step if slab
            else train_snn.make_train_step)
    return make(snn_config(name, net), tx, config["backend"]), tx


def first_moments(opt_state) -> list:
    """The ``mu`` tree of the Adam state inside ``opt_state``."""
    for part in opt_state:
        if isinstance(part, optim.AdamState):
            return part.mu
    raise TypeError("the optimizer state holds no Adam state")
