"""Tiny cells of both configurations for the CPU tests, and a fixture that
lets the harness's timing and memory calls run on the CPU."""
from __future__ import annotations

import json
import time

import sys

import pytest
import torch

from portbench import catalog, harness

_CONV = {"kind": "conv", "kernel": 3, "stride": 1, "padding": "SAME"}


def _tiny_net5() -> dict:
    cfg = _file("configs", "net5.json")
    cfg.update(input_shape=[12, 12, 2], num_steps=6, reference_rows=3,
               layers=[dict(_CONV, features=4), {"kind": "pool", "window": 2},
                       dict(_CONV, features=4), {"kind": "pool", "window": 2},
                       {"kind": "dense", "features": 16},
                       {"kind": "dense", "features": 8},
                       {"kind": "dense", "features": 11}],
               init={"gains": [3.0, 3.0, 2.0, 2.0, 2.0], "grid_bits": 15})
    return cfg


def _tiny_net3() -> dict:
    cfg = _file("configs", "net3.json")
    cfg.update(input_shape=[36], num_steps=5, pcr=2, reference_rows=2,
               layers=[{"kind": "dense", "features": 24},
                       {"kind": "dense", "features": 16},
                       {"kind": "dense", "features": 20}],
               init={"gains": [2.5, 2.0, 1.5], "grid_bits": 15})
    return cfg


def _file(*parts) -> dict:
    return catalog.load_json(catalog.HERE.joinpath(*parts))


def tiny_cell(which: str, cells: int = 2) -> catalog.Cell:
    """A cell like ``net5-train-dvs`` ("net5") or a slab of ``cells`` net-3
    cells like the ``fmnist-slab16`` mix ("net3"), at a size the CPU runs in
    a second, with the limits and the metrics of ``net5-train-dvs``."""
    real = catalog.cell("net5-train-dvs")
    if which == "net5":
        name, mix = real.name, dict(
            real.traffic, pool=12, batch=4, bins=6, height=12, width=12,
            blob=3, noise_p=0.05, trace_steps=1)
        config = _tiny_net5()
    else:
        name, mix = "net3-slab", dict(
            _file("traffic", "fmnist-slab16.json"), pool=16, batch=4,
            cells=cells, height=6, width=6, blobs=2, trace_steps=1)
        config = _tiny_net3()
    return catalog.Cell(name, config["name"], config, mix, 1, real.limits,
                        real.end_to_end, real.per_layer)


class _HostEvent:
    def __init__(self, enable_timing=False):
        self.at = None

    def record(self, stream=None):
        self.at = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return (end.at - self.at) * 1e3


def _loaded() -> set:
    return {m.split(".")[0] for m in list(sys.modules)}


@pytest.fixture
def card_on_cpu(monkeypatch):
    """The ``torch.cuda`` calls of the harness, made harmless on the CPU;
    and its look for JAX made to see only what was loaded since the test
    began (a test process may hold JAX for the JAX package's own tests)."""
    before = _loaded()
    monkeypatch.setattr(harness, "forbidden_modules", lambda: sorted(
        (_loaded() - before) & set(harness.FORBIDDEN)))
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    return torch.device("cpu")


def result_line(out: dict) -> dict:
    """``out`` as the run prints it and a reader parses it back."""
    return json.loads(json.dumps(out))
