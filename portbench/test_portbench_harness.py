"""The harness on the CPU: every entry of BENCHMARK.json resolves to its
files, the runner refuses without a card, nothing imports JAX or the JAX
package, and a tiny run of each configuration goes end to end."""
from __future__ import annotations

import ast
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import types

import pytest

from portbench import catalog, check, devtrace, harness
from portbench.conftest import result_line, tiny_cell

SPEC = catalog.load_json(catalog.SPEC)
#: The harness's own look, before a fixture narrows it.
FORBIDDEN_LOOK = harness.forbidden_modules
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_workload_resolves_to_its_files(workload):
    cell = catalog.cell(workload)
    assert cell.config["name"] == cell.config_name
    assert cell.traffic["kind"] in ("events", "images")
    assert set(check.NAMES) <= set(cell.limits)
    assert cell.limits["loss_steps"]
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for metric in cell.per_layer:
        assert callable(catalog.reader(metric["name"]))
        assert metric["moves"] in names


def test_benchmark_json_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    for conf in SPEC["configs"]:
        assert set(conf) == {"name", "source", "file", "reduced", "why"}
        assert conf["file"].startswith("portbench/")
        assert (catalog.ROOT / conf["file"]).is_file()
    configs = {c["name"] for c in SPEC["configs"]}
    assert configs == {w["config"] for w in SPEC["workloads"]}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_the_runner_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", WORKLOADS[0],
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=catalog.ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
    assert "no result" in proc.stderr


def _top_level_imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(catalog.HERE.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        found = _top_level_imports(path) & set(harness.FORBIDDEN)
        assert not found, f"{path.name} imports {found}"
    # whole top-level names: the port's package is not the JAX package's
    assert "repro_torch" in _top_level_imports(catalog.HERE / "program.py")


def test_the_jax_look_compares_whole_top_level_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    import repro_torch  # noqa: F401  (its name begins with the JAX package's)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("core"))
    assert harness.forbidden_modules() == ["jax", "repro"]


def _runner():
    """``portbench/run.py`` as a module (it is a script, not a package
    module)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_run", catalog.HERE / "run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_a_reader_that_loads_jax_stops_the_run(card_on_cpu, monkeypatch,
                                               capsys):
    """The look for forbidden modules comes after the per-layer readers and
    the reference: a reader that loads one leaves the run without a
    result.  The process may hold JAX already, for the JAX package's own
    tests: it is taken out of ``sys.modules`` for the run."""
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setattr(harness, "forbidden_modules", FORBIDDEN_LOOK)

    def loads_jax(ctx):
        monkeypatch.setitem(sys.modules, "jax.numpy",
                            types.ModuleType("jax.numpy"))
        return 1.0

    monkeypatch.setattr(harness, "reader", lambda name: loads_jax)
    # the profiler traces no CPU-only run with the device activity alone
    trace = devtrace.Trace([("k", 0.0, 10.0)], 2e-5, 1e-5, 1e-5, [])
    monkeypatch.setattr(harness, "trace_steps", lambda run, steps: (trace,
                                                                    []))
    out = harness.run_cell(tiny_cell("net5"), 2 ** 31 + 3, 0.05, True, 0.0,
                           card_on_cpu)
    assert out["correct"] is True
    capsys.readouterr()
    assert _runner().report(out) == 3
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "jax" in captured.err and "no result" in captured.err


def test_a_clean_run_prints_its_line_last(card_on_cpu, capsys):
    out = harness.run_cell(tiny_cell("net3"), 2 ** 31 + 5, 0.05, False, 0.0,
                           card_on_cpu)
    capsys.readouterr()
    assert _runner().report(out) == 0
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert line["correct"] is True and list(line)[-1] == "checks"
    assert captured.err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("which", ["net5", "net3"])
def test_a_tiny_run_is_correct_and_prints_its_numbers(card_on_cpu, which):
    cell = tiny_cell(which)
    out = result_line(harness.run_cell(cell, 2 ** 31 + 11, 0.2, False, 0.0,
                                       card_on_cpu))
    assert out["correct"] is True
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(math.isfinite(m["value"]) for m in out["metrics"].values())
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(check.NAMES)


def test_a_seed_gives_the_same_inputs(card_on_cpu):
    cell = tiny_cell("net3")
    a = harness.Run(cell, 5, card_on_cpu)
    b = harness.Run(cell, 5, card_on_cpu)
    rows = a.feed.next()
    assert rows.equal(b.feed.next())
    assert a.feed.pool.equal(b.feed.pool)
    for p, q in zip(a.params, b.params):
        assert all(p[k].equal(q[k]) for k in p)
    c = harness.Run(cell, 6, card_on_cpu)
    assert not a.feed.pool.equal(c.feed.pool)


@pytest.mark.parametrize("ring,ahead_s", [(4096, 4.0), (2, 0.0)])
def test_the_window_reads_every_late_loss_once(card_on_cpu, monkeypatch,
                                               ring, ahead_s):
    """Every step sent counts, and each loss that is not finite is counted
    once, whether it is read late, when the ring of slots wraps, or after
    the close."""
    import time

    import torch

    monkeypatch.setattr(harness, "RING", ring)
    monkeypatch.setattr(harness, "AHEAD_S", ahead_s)

    class Steps:
        cells, device, taken = None, card_on_cpu, 0

        def take(self):
            self.taken += 1
            time.sleep(0.002)
            bad = self.taken % 3 == 0
            return None, torch.tensor(float("nan") if bad else 1.0)

    run = Steps()
    steps, elapsed, step_ms, failed, _ = harness.window(run, 0.05)
    assert steps == run.taken == len(step_ms) and steps >= 3
    assert failed == steps // 3
    assert elapsed >= 0.05
