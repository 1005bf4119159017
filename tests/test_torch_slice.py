"""The inference leg of a DSE cell end to end, port against JAX package:
workload -> evaluate / dump_traces -> accelerator model -> dse.search.

The cell is the registry's ``dvs-conv`` workload cut to T = 8 and 16 test
samples.  Its inputs are pre-encoded events, so no random bits are drawn,
and its weights are JAX's ``init_params`` on a 2^-8 grid, so the currents
are exact; accuracy and traces must then be equal, and the frontier, which
the accelerator model computes in NumPy from those traces, equal bit for
bit.  Also here: the import isolation of the port, and that its entry
points never quietly fall back to the CPU.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import dse as jdse
from repro.core import snn as jsnn
from repro.core import train_snn as jtrain
from repro.core import workloads as jworkloads
from repro.core.accelerator import arch as jarch
from repro.core.accelerator import cycle_model as jcycle
from repro.core.accelerator import resources as jresources
from repro_torch import convert, optim
from repro_torch.core import dse, snn, train_snn, workloads
from repro_torch.core.accelerator import arch, cycle_model, resources
from repro_torch.core.workloads import registry

torch.set_num_threads(2)

GRID = 2.0 ** -8
T = 8


def _cell(wl_module):
    wl = dataclasses.replace(wl_module.get("dvs-conv"), n_train=2,
                             n_test=16)
    return wl, wl.build(T, 1.0), wl.make_data(T)


@pytest.fixture(scope="module")
def cell():
    jwl, jcfg, jdata = _cell(jworkloads)
    params = jsnn.init_params(jax.random.key(3), jcfg)
    npp = [{k: (np.round(np.asarray(v) * 3 / GRID) * GRID).astype(np.float32)
            for k, v in p.items()} for p in params]
    jp = [{k: jax.numpy.asarray(v) for k, v in p.items()} for p in npp]
    traces = jtrain.dump_traces(jcfg, jp, jdata.x_test, matmul_backend="jnp")
    acc = jtrain.evaluate(jcfg, jp, jdata.x_test, jdata.y_test,
                          matmul_backend="jnp")
    counts = jtrain.trace_counts(jcfg, jp, jdata.x_test,
                                 matmul_backend="jnp")
    return dict(jcfg=jcfg, jdata=jdata, npp=npp, traces=traces, acc=acc,
                counts=counts)


class TestWorkloads:
    def test_registry_matches_jax(self):
        assert registry.names() == jworkloads.names()
        for name in registry.names():
            got, want = registry.get(name), jworkloads.get(name)
            assert got.signature() == want.signature()
            for t in got.num_steps_choices:
                for pop in got.population_choices:
                    g, w = got.build(t, pop), want.build(t, pop)
                    assert g.name == w.name
                    assert g.layer_sizes() == w.layer_sizes()
                    assert snn.output_shapes(g) == jsnn.output_shapes(w)

    @pytest.mark.parametrize("name", ["mnist-mlp", "dvs-conv"])
    def test_make_data_matches_jax(self, name):
        small = dict(n_train=3, n_test=2)
        got = dataclasses.replace(registry.get(name), **small).make_data(4)
        want = dataclasses.replace(jworkloads.get(name), **small).make_data(4)
        for field in ("x_train", "y_train", "x_test", "y_test"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))

    def test_unknown_backend_is_refused(self):
        with pytest.raises(ValueError, match="matmul backend"):
            dataclasses.replace(registry.get("dvs-conv"),
                                matmul_backend="jnp")


class TestInferenceLeg:
    @pytest.mark.parametrize("backend", snn.MATMUL_BACKENDS)
    def test_accuracy_and_traces_equal_jax(self, cell, backend):
        _, cfg, data = _cell(registry)
        np.testing.assert_array_equal(data.x_test, cell["jdata"].x_test)
        params = convert.params_from_numpy(cell["npp"], device="cpu")
        acc = train_snn.evaluate(cfg, params, data.x_test, data.y_test,
                                 matmul_backend=backend, device="cpu")
        assert acc == cell["acc"]
        traces = train_snn.dump_traces(cfg, params, data.x_test,
                                       matmul_backend=backend, device="cpu")
        want = cell["traces"]
        assert traces["layer_sizes"] == want["layer_sizes"]
        assert traces["num_steps"] == want["num_steps"] == T
        got_c, want_c = (traces["layer_input_spike_counts"],
                         want["layer_input_spike_counts"])
        assert len(got_c) == len(want_c) == 4
        for g, w in zip(got_c, want_c):
            assert g.shape == (T, 16)
            np.testing.assert_array_equal(g, np.asarray(w))
        assert all(c.sum() > 0 for c in got_c)
        counts = train_snn.trace_counts(cfg, params, data.x_test,
                                        matmul_backend=backend, device="cpu")
        for g, w in zip(counts, cell["counts"]):
            np.testing.assert_array_equal(g, w)


class TestAcceleratorAndSearch:
    def _configs(self, cell):
        _, cfg, _ = _cell(registry)
        return arch.from_snn_config(cfg), jarch.from_snn_config(cell["jcfg"])

    def test_accelerator_model_matches_jax(self, cell):
        acc, jacc = self._configs(cell)
        assert [dataclasses.asdict(l) for l in acc.layers] == \
            [dataclasses.asdict(l) for l in jacc.layers]
        assert acc.num_steps == jacc.num_steps == T
        assert cycle_model.latency_cycles(acc, cell["counts"]) == \
            jcycle.latency_cycles(jacc, cell["counts"])
        assert dataclasses.asdict(resources.estimate(acc)) == \
            dataclasses.asdict(jresources.estimate(jacc))

    @pytest.mark.parametrize("strategy", ["grid", "random", "evolutionary"])
    def test_frontier_equals_jax_bit_for_bit(self, cell, strategy):
        acc, jacc = self._configs(cell)
        make = {"grid": lambda m: "grid",
                "random": lambda m: m.RandomSearch(200, seed=1),
                "evolutionary": lambda m: m.EvolutionarySearch(
                    population=16, generations=3, seed=2)}[strategy]
        got = dse.search(acc, cell["counts"], strategy=make(dse),
                         chunk_size=97)
        want = jdse.search(jacc, cell["counts"], strategy=make(jdse),
                           chunk_size=97)
        assert got.n_evaluated == want.n_evaluated > 0
        assert got.objectives == want.objectives
        assert got.frontier.columns.keys() == want.frontier.columns.keys()
        for k, v in want.frontier.columns.items():
            assert got.frontier.columns[k].dtype == v.dtype
            np.testing.assert_array_equal(got.frontier.columns[k], v)
        assert got.best_under("lut", cycles=float(np.median(
            want.frontier.columns["cycles"]))) == want.best_under(
            "lut", cycles=float(np.median(want.frontier.columns["cycles"])))

    def test_keep_all_table_equals_jax(self, cell):
        acc, jacc = self._configs(cell)
        got = dse.search(acc, cell["counts"], keep_all=True)
        want = jdse.search(jacc, cell["counts"], keep_all=True)
        for k, v in want.table.columns.items():
            np.testing.assert_array_equal(got.table.columns[k], v)
        assert got.min_energy() == want.min_energy()

    def test_search_refuses_model_axes_and_bad_objectives(self, cell):
        acc, _ = self._configs(cell)
        space = dse.SearchSpace.product_lhr(acc).add_model("num_steps",
                                                           (4, 8))
        with pytest.raises(ValueError, match="model axes"):
            dse.search(acc, cell["counts"], space=space)
        with pytest.raises(ValueError, match="unknown objective"):
            dse.search(acc, cell["counts"], objectives=("speed",))


ISOLATION = textwrap.dedent("""
    import importlib, pkgutil, sys

    def blocked(name):
        return any(name == p or name.startswith(p + ".")
                   for p in ("jax", "jaxlib", "repro"))

    class Block:
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    loaded = sorted(n for n in sys.modules if blocked(n))
    assert not loaded, loaded
    print(len(names))
""")


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).resolve().parents[1] / "src"),
         env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-c", ISOLATION], check=True,
                         capture_output=True, text=True, env=env)
    assert int(out.stdout.strip()) >= 25


@pytest.mark.parametrize("entry", [
    lambda cfg, x, y: snn.init_params(torch.Generator(), cfg),
    lambda cfg, x, y: convert.params_from_numpy([{}]),
    lambda cfg, x, y: train_snn.evaluate(cfg, [], x, y),
    lambda cfg, x, y: train_snn.dump_traces(cfg, [], x),
    lambda cfg, x, y: train_snn.trace_counts(cfg, [], x),
    lambda cfg, x, y: train_snn.train(cfg, None),
    lambda cfg, x, y: train_snn.init_cell(cfg, optim.adam(1e-3), 0),
    lambda cfg, x, y: train_snn.profiled_permutations(cfg, [], x),
    lambda cfg, x, y: convert.adam_state_from_numpy({"count": 0}),
    lambda cfg, x, y: workloads.TraceCache(),
])
def test_entry_points_refuse_a_silent_cpu(monkeypatch, entry):
    """Without a card, an entry point called without device="cpu" raises
    before it touches any data."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg, data = _cell(registry)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry(cfg, data.x_test, data.y_test)
