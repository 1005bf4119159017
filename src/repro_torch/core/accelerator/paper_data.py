"""The paper's published measurements (Table I + caption), used to
(a) calibrate the component cost library and (b) benchmark reproduction
fidelity.  Every number below is transcribed from Aliyev et al. 2023,
Table I and its caption.

Caption spike statistics = average spike events entering each layer
(pre-synaptic traffic), e.g. net-1 "784(95) - 500(81) - 500(86) - 300" means:
input layer 784 neurons with 95 avg spikes/step, hidden-0 500 neurons firing
81/step, hidden-1 500 firing 86/step, population output layer 300 neurons.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class NetSpec:
    """Topology + measured traffic of one paper network."""
    name: str
    dataset: str
    # spiking-layer sizes, input first (input is not a spiking layer but its
    # traffic drives layer 0's ECU); output layer = population size.
    layer_sizes: tuple[int, ...]
    # avg spikes/step entering each *spiking* layer (len == len(layer_sizes)-1)
    avg_spikes: tuple[float, ...]
    population: int
    accuracy: float
    conv: bool = False
    # conv nets: (channels, kernel) per conv layer, None for fc entries
    conv_layers: tuple = ()


@dataclasses.dataclass(frozen=True)
class TableRow:
    net: str
    work: str               # "TW" or citation key of prior work
    lhr: Optional[tuple[int, ...]]
    lut: Optional[float]    # K LUTs
    reg: Optional[float]    # K registers
    cycles: float           # clock cycles / image
    energy_mj: Optional[float]


NETS = {
    "net-1": NetSpec("net-1", "mnist", (784, 500, 500, 300), (95, 81, 86),
                     population=300, accuracy=97.52),
    "net-2": NetSpec("net-2", "mnist", (784, 300, 300, 300, 200), (118, 98, 56, 56),
                     population=200, accuracy=98.02),
    "net-3": NetSpec("net-3", "fmnist", (784, 1024, 1024, 300), (186, 321, 304),
                     population=300, accuracy=84.41),
    "net-4": NetSpec("net-4", "fmnist", (784, 512, 256, 128, 64, 150),
                     (316, 169, 87, 37, 20), population=150, accuracy=76.4),
    # net-5: 128x128(135) - 32C3(240) - P2 - 32C3(1250) - P2 - 512(21) - 256 - 11
    "net-5": NetSpec("net-5", "dvsgesture",
                     (128 * 128, 32, 32, 512, 256),
                     (135, 240, 1250, 21),
                     population=0, accuracy=71.23, conv=True,
                     conv_layers=((32, 3), (32, 3), None, None)),
}

# net-2 caption lists 4 traffic figures for a 784-300-300-300-200 stack; the
# last hidden's 56 is reused for the output layer's input (paper gives
# "784(118) - 300(98) - 300(56) - 200" for a net labelled 784-300-300-300-10;
# we take the caption layout as authoritative for traffic).

TABLE1: list[TableRow] = [
    # --- net-1 (MNIST, vs Fang et al. [12]) ---
    TableRow("net-1", "[12]", None, 124.6, 185.2, 65000, 2.34),
    TableRow("net-1", "TW", (1, 1, 1), 157.6, 103.1, 10583, 0.09),
    TableRow("net-1", "TW", (2, 1, 1), 127.2, 83.2, 16807, 0.12),
    TableRow("net-1", "TW", (1, 2, 1), 127.2, 83.2, 15561, 0.11),
    TableRow("net-1", "TW", (4, 4, 4), 60.8, 39.7, 31583, 0.17),
    TableRow("net-1", "TW", (4, 8, 8), 30.7, 63.4, 53308, 0.27),
    # --- net-2 (MNIST, vs Abderrahmane et al. [11]) ---
    TableRow("net-2", "[11]", None, 22.8, 9.3, 1660, None),
    TableRow("net-2", "TW", (1, 1, 1, 1), 136.5, 86.1, 18710, 0.14),
    TableRow("net-2", "TW", (4, 4, 4, 1), 54.9, 33.2, 67586, 0.39),
    TableRow("net-2", "TW", (4, 4, 8, 1), 50.5, 30.2, 68542, 0.39),
    TableRow("net-2", "TW", (2, 2, 16, 8), 45.7, 27.2, 69998, 0.37),
    TableRow("net-2", "TW", (4, 4, 16, 8), 27.5, 15.4, 72330, 0.36),
    # --- net-3 (FMNIST, vs Liu et al. [33]) ---
    TableRow("net-3", "[33]", None, 124.6, 185.2, 65000, 2.23),
    TableRow("net-3", "TW", (1, 1, 1), 287.6, 185.5, 34563, 1.12),
    TableRow("net-3", "TW", (2, 1, 1), 225.7, 145.2, 35011, 0.97),
    TableRow("net-3", "TW", (8, 2, 4), 90.8, 56.2, 96827, 1.37),
    TableRow("net-3", "TW", (16, 8, 4), 35.8, 21.4, 187099, 1.45),
    TableRow("net-3", "TW", (32, 32, 8), 13.9, 8.7, 388897, 2.21),
    # --- net-4 (FMNIST, vs Ye et al. [34]) ---
    TableRow("net-4", "[34]", None, 13.7, 12.4, 1562000, None),
    TableRow("net-4", "TW", (1, 1, 1, 1, 1), 137.8, 90.3, 40142, 0.56),
    TableRow("net-4", "TW", (1, 4, 4, 1, 1), 103.1, 69.8, 61724, 0.73),
    TableRow("net-4", "TW", (2, 8, 4, 16, 8), 45.1, 67.2, 114266, 0.9),
    TableRow("net-4", "TW", (4, 2, 8, 8, 64), 37.7, 24.6, 69534, 0.48),
    TableRow("net-4", "TW", (32, 16, 8, 16, 64), 6.6, 63.4, 843518, 4.3),
    # --- net-5 (DVSGesture, vs Di Mauro et al. [35] ASIC) ---
    TableRow("net-5", "[35]", None, None, None, 6044000, 0.17),
    TableRow("net-5", "TW", (1, 1, 8, 32), 137.5, 361.5, 2481000, 14.93),
    TableRow("net-5", "TW", (1, 1, 16, 16), 128.1, 352.1, 2493000, 13.41),
    TableRow("net-5", "TW", (1, 1, 32, 32), 119.2, 343.7, 4475000, 20.5),
    TableRow("net-5", "TW", (1, 1, 16, 256), 123.4, 347.5, 2521000, 7.21),
    TableRow("net-5", "TW", (16, 1, 16, 256), 93.5, 267.5, 2486000, 6.24),
]


def tw_rows(net: str) -> list[TableRow]:
    return [r for r in TABLE1 if r.net == net and r.work == "TW"]


def baseline_row(net: str) -> TableRow:
    return next(r for r in TABLE1 if r.net == net and r.work != "TW")
