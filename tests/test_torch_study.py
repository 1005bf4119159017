"""The paper's study loop in the port against the JAX package's, on the
CPU: the Fig.-1 firing analysis (``sparsity``), ``dse.explore`` in its
hardware, cells and joint modes, ``coexplore``, the seed API (``compat``),
``search``/``auto_select`` as wrappers, checkpoint and resume.

The DSE modules are NumPy in both packages, so on equal counts every
frontier column must be equal bit for bit.  Model cells: the two caches
share the cell key and the store format, so the tiny workloads train once
in torch (CPU) and a JAX ``TraceCache`` pointed at the same root reads
them as hits; both studies then run on the same cells and must agree in
frontier, cell records and budget accounting.  The firing analysis runs
on grid weights with ``beta = 0.5``, where every membrane value is exact
in fp32, so the spike counts and the statistics are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dse as jdse
from repro.core import lif as jlif
from repro.core import snn as jsnn
from repro.core import sparsity as jsparsity
from repro.core import workloads as jworkloads
from repro.core.accelerator import arch as jarch
from repro_torch import convert
from repro_torch.core import dse, lif, snn, sparsity, workloads
from repro_torch.core.accelerator import arch

torch.set_num_threads(2)

GRID = 2.0 ** -8


def _frontier_equal(got, want):
    assert got.columns.keys() == want.columns.keys()
    for k, v in want.columns.items():
        assert got.columns[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got.columns[k], v)


def _records(study, cache_hit=True):
    out = [dataclasses.asdict(c) for c in study.cells]
    if not cache_hit:
        for r in out:
            del r["cache_hit"]
    return out


def _without_cache(summary):
    return {k: v for k, v in summary.items() if k != "cache"}


# ---------------------------------------------------------------------------
# Hardware mode and the wrappers over it
# ---------------------------------------------------------------------------

def _hw(mod_arch, mod_dse, max_lhr=8):
    cfg = mod_arch.from_layer_sizes("t", (64, 32, 16), num_steps=3)
    space = mod_dse.SearchSpace.product_lhr(cfg, max_lhr=max_lhr)
    return cfg, space


def _counts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 40, size=3).astype(np.float64) for _ in range(2)]


STRATEGIES = {
    "grid": lambda m: "grid",
    "random": lambda m: m.RandomSearch(40, seed=1),
    "evolutionary": lambda m: m.EvolutionarySearch(population=8,
                                                   generations=3, seed=2)}


class TestHardwareMode:
    @pytest.mark.parametrize("strategy", sorted(STRATEGIES))
    def test_explore_equals_jax_bit_for_bit(self, strategy):
        _, space = _hw(arch, dse)
        _, jspace = _hw(jarch, jdse)
        got = dse.explore(space, counts=_counts(), chunk_size=7,
                          strategy=STRATEGIES[strategy](dse))
        want = jdse.explore(jspace, counts=_counts(), chunk_size=7,
                            strategy=STRATEGIES[strategy](jdse))
        assert got.summary == want.summary
        assert got.n_evaluated > 0 and got.done
        _frontier_equal(got.frontier, want.frontier)

    def test_search_is_explore_and_auto_select_equals_jax(self):
        cfg, space = _hw(arch, dse)
        jcfg, jspace = _hw(jarch, jdse)
        got = dse.search(cfg, _counts(), space=space, chunk_size=5)
        _frontier_equal(got.frontier, dse.explore(
            space, counts=_counts(), chunk_size=5).frontier)
        _frontier_equal(got.frontier, jdse.search(
            jcfg, _counts(), space=jspace, chunk_size=5).frontier)
        cycles = float(np.median(got.frontier.columns["cycles"]))
        lut = float(np.median(got.frontier.columns["lut"]))
        for caps in ({"max_cycles": cycles}, {"max_lut": lut}, {},
                     {"max_cycles": 1.0}):
            mine = dse.auto_select(cfg, _counts(), **caps)
            theirs = jdse.auto_select(jcfg, _counts(), **caps)
            if theirs is None:
                assert mine is None
                continue
            assert dataclasses.asdict(mine[0]) == \
                dataclasses.asdict(theirs[0])
            assert mine[1].keys() == theirs[1].keys()
            for k in theirs[1]:
                np.testing.assert_array_equal(mine[1][k], theirs[1][k])

    def test_seed_api_equals_jax(self):
        cfg, _ = _hw(arch, dse)
        jcfg, _ = _hw(jarch, jdse)
        counts = _counts()
        np.testing.assert_array_equal(dse.lhr_grid(cfg, 8),
                                      jdse.lhr_grid(jcfg, 8))
        got, want = dse.sweep(cfg, counts, 8, chunk_size=9), \
            jdse.sweep(jcfg, counts, 8, chunk_size=9)
        assert [dataclasses.asdict(c) for c in got.candidates] == \
            [dataclasses.asdict(c) for c in want.candidates]
        assert got.frontier and got.min_energy() == \
            dse.Candidate(**dataclasses.asdict(want.min_energy()))
        assert [dataclasses.asdict(c) for c in dse.sweep_memory_blocks(
            cfg, counts)] == [dataclasses.asdict(c) for c in
                              jdse.sweep_memory_blocks(jcfg, counts)]
        assert dse.sweep_weight_bits(cfg) == jdse.sweep_weight_bits(jcfg)
        per_t = {t: [np.full(t, 5.0), np.full(t, 3.0)] for t in (2, 3, 5)}
        assert dse.sweep_spike_train_length(cfg, per_t, (2, 1)) == \
            jdse.sweep_spike_train_length(jcfg, per_t, (2, 1))

    def test_checkpoint_resume_equals_an_uninterrupted_run(self, tmp_path):
        _, space = _hw(arch, dse)
        make = STRATEGIES["evolutionary"]
        ref = dse.explore(space, counts=_counts(), chunk_size=5,
                          strategy=make(dse))
        ck = str(tmp_path / "study")
        study = dse.explore(space, counts=_counts(), chunk_size=5,
                            strategy=make(dse), checkpoint_dir=ck, run=False)
        for _ in range(2):
            assert study.step()
        study.checkpoint()
        resumed = dse.explore(space, counts=_counts(), chunk_size=5,
                              strategy=make(dse), checkpoint_dir=ck,
                              resume=True)
        assert resumed.done and resumed.summary == ref.summary
        _frontier_equal(resumed.frontier, ref.frontier)


# ---------------------------------------------------------------------------
# The Fig.-1 firing analysis
# ---------------------------------------------------------------------------

def _nets(kind):
    """The same topology, beta = 0.5, as a JAX and a port SNNConfig."""
    cfgs = []
    for mod, lp in ((jsnn, jlif.LIFParams), (snn, lif.LIFParams)):
        p = lp(beta=0.5)
        if kind == "mlp":
            layers = (mod.Dense(24, p), mod.Dense(16, p), mod.Dense(8, p))
            cfgs.append(mod.SNNConfig("mlp", (30,), layers, num_classes=4,
                                      pcr=2, num_steps=6))
        else:
            layers = (mod.Conv(4, 3, lif=p), mod.MaxPool(2),
                      mod.Conv(8, 3, lif=p), mod.MaxPool(2),
                      mod.Dense(16, p), mod.Dense(8, p))
            cfgs.append(mod.SNNConfig("conv", (16, 16, 2), layers,
                                      num_classes=4, pcr=2, num_steps=6))
    return cfgs


@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_sparsity_analysis_equals_jax(kind):
    jcfg, cfg = _nets(kind)
    npp = [{k: (np.round(np.asarray(v) * 2.5 / GRID) * GRID + (
        0.0625 if k == "b" else 0.0)).astype(np.float32)
        for k, v in p.items()}
        for p in jsnn.init_params(jax.random.key(1), jcfg)]
    rng = np.random.default_rng(2)
    x = (rng.random((6, 3) + jcfg.input_shape) < 0.2).astype(np.float32)
    want = jsparsity.analyze(
        jcfg, [{k: jnp.asarray(v) for k, v in p.items()} for p in npp],
        jnp.asarray(x))
    got = sparsity.analyze(cfg, convert.params_from_numpy(npp, "cpu"),
                           torch.from_numpy(x))
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in want]
    assert all(s.avg_spikes_per_step > 0 for s in got)     # not silent
    assert sparsity.firing_table(got) == jsparsity.firing_table(want)
    assert sparsity._input_sizes(cfg) == jsparsity._input_sizes(jcfg)
    assert sparsity.analyze(cfg, convert.params_from_numpy(npp, "cpu"),
                            x) == got                     # NumPy input


# ---------------------------------------------------------------------------
# Model cells: joint and cells modes on cells both packages read
# ---------------------------------------------------------------------------

def _tiny_mlp(mod_wl, mod_snn):
    return dataclasses.replace(
        mod_wl.get("mnist-mlp"), name="torch-study-mlp",
        layers=(mod_snn.Dense(12),), pcr=1, n_train=128, n_test=64,
        train_steps=4, trace_samples=16)


def _tiny_conv(mod_wl, mod_snn):
    return dataclasses.replace(
        mod_wl.get("dvs-conv"), name="torch-study-dvs",
        layers=(mod_snn.Conv(2, 3), mod_snn.MaxPool(2), mod_snn.Dense(6)),
        num_classes=4, pcr=1, n_train=32, n_test=16, train_steps=2,
        batch_size=16, trace_samples=8)


def _joint_space(mod_dse, mod_arch, wl):
    tmpl = mod_arch.from_snn_config(wl.build(2, 1.0))
    return (mod_dse.SearchSpace(tmpl)
            .add_model("num_steps", (2, 3))
            .add_model("population", (0.5, 1.0))
            .add_per_layer("lhr", [[1, 2, 4] for _ in tmpl.layers])
            .add_global("weight_bits", (4, 8)))


def _evo(mod_dse):
    return mod_dse.EvolutionarySearch(population=8, generations=4, seed=1)


@pytest.fixture
def wls():
    return {"torch": (_tiny_mlp(workloads, snn), _tiny_conv(workloads, snn)),
            "jax": (_tiny_mlp(jworkloads, jsnn), _tiny_conv(jworkloads, jsnn))}


def _caches(root):
    return (workloads.TraceCache(root=str(root), device="cpu"),
            jworkloads.TraceCache(root=str(root)))


class TestModelCells:
    def test_tiny_workloads_share_the_cell_key(self, wls):
        for (t, j) in zip(wls["torch"], wls["jax"]):
            for asn in ({"num_steps": 2, "population": 0.5},
                        {"num_steps": 3}):
                assert workloads.cell_key(t, asn, 0) == \
                    jworkloads.cell_key(j, asn, 0)

    def test_budgeted_joint_explore_equals_jax(self, wls, tmp_path):
        """Torch trains the cells its budget allows; the JAX study, on the
        same root with its budget already spent, may only hit and so makes
        the same choices.  A repeat torch study with a budget of 0 is all
        hits and equals the JAX one record for record."""
        (wl, _), (jwl, _) = wls["torch"], wls["jax"]
        cache, jcache = _caches(tmp_path)
        got = dse.explore(_joint_space(dse, arch, wl), workload=wl,
                          cache=cache, train_budget=2, chunk_size=8,
                          strategy=_evo(dse))
        spent = jworkloads.TrainingBudget(2)
        spent.charge(2)
        want = jdse.explore(_joint_space(jdse, jarch, jwl), workload=jwl,
                            cache=jcache, train_budget=spent, chunk_size=8,
                            strategy=_evo(jdse))
        assert got.mode == want.mode == "joint"
        assert _without_cache(got.summary) == _without_cache(want.summary)
        assert got.summary["train_budget"] == {"limit": 2, "spent": 2,
                                               "remaining": 0}
        assert got.summary["cells_skipped"] > 0        # the budget bit
        assert (cache.misses, cache.hits) == (2, 0)
        assert (jcache.misses, jcache.hits) == (0, 2)
        assert got.skipped == want.skipped
        assert _records(got, False) == _records(want, False)
        _frontier_equal(got.frontier, want.frontier)

        again_cache, _ = _caches(tmp_path)
        again = dse.explore(_joint_space(dse, arch, wl), workload=wl,
                            cache=again_cache, train_budget=0, chunk_size=8,
                            strategy=_evo(dse))
        assert (again_cache.misses, again_cache.hits) == (0, 2)
        assert _records(again) == _records(want)
        _frontier_equal(again.frontier, want.frontier)

    def test_coexplore_equals_jax_on_hits(self, wls, tmp_path):
        """Cells mode over two topologies (per-layer columns padded with
        -1): torch trains every cell, then both packages run on hits."""
        cache, jcache = _caches(tmp_path)
        kw = dict(num_steps=(2, 3), max_lhr=4, weight_bits=(4, 8),
                  chunk_size=16)
        first = dse.coexplore(datasets=wls["torch"], cache=cache, **kw)
        assert cache.misses == 4 and first.study.mode == "cells"
        hit_cache, _ = _caches(tmp_path)
        got = dse.coexplore(datasets=wls["torch"], cache=hit_cache, **kw)
        want = jdse.coexplore(datasets=wls["jax"], cache=jcache, **kw)
        assert (hit_cache.misses, jcache.misses) == (0, 0)
        assert got.n_evaluated == want.n_evaluated == first.n_evaluated
        assert got.summary == want.summary
        assert _records(got) == _records(want)
        assert _records(first, False) == _records(want, False)
        assert (got.frontier.columns["lhr"] == -1).any()
        _frontier_equal(got.frontier, want.frontier)
        _frontier_equal(first.frontier, want.frontier)

    def test_joint_checkpoint_resume_equals_an_uninterrupted_run(
            self, wls, tmp_path):
        wl, _ = wls["torch"]
        space = _joint_space(dse, arch, wl)
        ref = dse.explore(space, workload=wl, train_budget=2, chunk_size=8,
                          strategy=_evo(dse),
                          cache=workloads.TraceCache(
                              root=str(tmp_path / "ref"), device="cpu"))
        root, ck = str(tmp_path / "mid"), str(tmp_path / "study")
        mid = workloads.TraceCache(root=root, device="cpu")
        study = dse.explore(space, workload=wl, cache=mid, train_budget=2,
                            chunk_size=8, strategy=_evo(dse),
                            checkpoint_dir=ck, run=False)
        for _ in range(2):
            assert study.step()
        study.checkpoint()
        fresh = workloads.TraceCache(root=root, device="cpu")
        resumed = dse.explore(space, workload=wl, cache=fresh,
                              train_budget=2, chunk_size=8,
                              strategy=_evo(dse), checkpoint_dir=ck,
                              resume=True)
        assert resumed.done and fresh.misses == 0      # nothing retrains
        assert _without_cache(resumed.summary) == _without_cache(ref.summary)
        assert _records(resumed) == _records(ref)
        _frontier_equal(resumed.frontier, ref.frontier)

    @pytest.mark.parametrize("farm", [dict(workers=2), dict(stack=True),
                                      dict(workers="cluster")])
    def test_the_cell_farm_is_refused(self, wls, tmp_path, farm,
                                      monkeypatch):
        """No part of the JAX package's cell farm is refused: ``workers=2``
        and ``stack=True`` train the cell through the farm (one job: in
        process, no spawn), and ``workers="cluster"`` through the fleet,
        where with no worker enrolled the submitter reclaims it after the
        no-progress window.  Either way the study's own cache sees a hit
        and the cell counts as a farmed miss."""
        monkeypatch.setenv("REPRO_FLEET_TIMEOUT", "0.2")
        monkeypatch.setenv("REPRO_FLEET_POLL", "0.02")
        wl, _ = wls["torch"]
        cache, _ = _caches(tmp_path)
        one = dse.coexplore(wl, num_steps=(2,), max_lhr=2, cache=cache,
                            **farm)
        assert one.summary["cache"] == {"hits": 1, "misses": 0,
                                        "farmed_misses": 1}

    def test_default_cache_is_the_ports_own_root_on_the_card(
            self, wls, tmp_path, monkeypatch):
        wl, _ = wls["torch"]
        monkeypatch.setenv("REPRO_TORCH_WORKLOAD_CACHE", str(tmp_path))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dse.explore(_joint_space(dse, arch, wl), workload=wl,
                        strategy=_evo(dse), run=False)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        study = dse.explore(_joint_space(dse, arch, wl), workload=wl,
                            strategy=_evo(dse), run=False)
        assert study.cache.root == str(tmp_path)
        assert study.cache.root != jworkloads.default_root()
        assert study.cache.device.type == "cuda"


def test_exports_the_jax_dse_api():
    assert dse.__all__ == jdse.__all__
    for name in dse.__all__:
        assert hasattr(dse, name)
