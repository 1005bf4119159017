"""What ``BENCHMARK.json`` names, found by name: a cell's configuration
(the file its ``configs`` entry gives), its traffic mix
(``traffic/<traffic>.json``), its correctness limits
(``limits/<cell>.json``) and the readers of its per-layer metrics
(``metrics/<metric>.py``, each with ``read(ctx)``).
"""
from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = ROOT / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict
    end_to_end: list        # the BENCHMARK.json entries this cell reports
    per_layer: list


def _for(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, spec_path: Path = SPEC) -> Cell:
    spec = load_json(spec_path)
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {spec_path.name}: "
                       f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return Cell(name=name, config_name=w["config"],
                config=load_json(ROOT / conf["file"]),
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                chips=w["chips"],
                limits=load_json(HERE / "limits" / f"{name}.json"),
                end_to_end=[m for m in spec["end_to_end"] if _for(m, name)],
                per_layer=[m for m in spec["per_layer"] if _for(m, name)])


def reader(metric: str):
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    return importlib.import_module(f"portbench.metrics.{metric}").read
