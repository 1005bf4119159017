"""The port's cell farm (``repro_torch.distributed.cellfarm``) and the
study's farming front end, on the CPU.

``stack=True`` trains in process and never builds a pool; ``workers=2``
spawns one pool of two processes on ``device="cpu"`` whose artifacts equal
solo training bit for bit; a job that raises ships as an outcome, never as
an exception; ``coexplore(stack=True)`` gives the serial frontier with the
cells counted as farmed misses; ``workers="cluster"`` with no fleet worker
enrolled trains the cell through the submitter's reclaim, a farmed miss.  The workloads are the JAX package's own farm tests'
tiny ones (``tests/test_cellstack.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import dse, snn, workloads
from repro_torch.core.accelerator import arch
from repro_torch.core.workloads.cache import cell_key
from repro_torch.distributed import cellfarm

torch.set_num_threads(2)


def _mlp(name="farm-mlp", **kw):
    base = dict(name=name, layers=(snn.Dense(12),), pcr=1,
                input_shape=(12, 12), n_train=96, n_test=32,
                train_steps=4, batch_size=32, trace_samples=16)
    base.update(kw)
    return dataclasses.replace(workloads.get("mnist-mlp"), **base)


def _job(wl, T=2, seed=0):
    return cellfarm.CellJob(workload=wl,
                            assignment={"num_steps": T, "population": 1.0},
                            seed=seed)


def _keys(jobs):
    return [cell_key(j.workload, j.assignment, j.seed) for j in jobs]


def _cache(path):
    return workloads.TraceCache(root=str(path), device="cpu")


def _assert_same_cell(a, b):
    for pa, pb in zip(a.params, b.params):
        for k in pa:
            np.testing.assert_array_equal(pa[k], pb[k])
    for ca, cb in zip(a.counts, b.counts):
        np.testing.assert_array_equal(ca, cb)
    assert a.accuracy == b.accuracy


@pytest.fixture
def no_pool(monkeypatch):
    def boom(_):
        raise AssertionError("a pool was built")
    monkeypatch.setattr(cellfarm, "_get_pool", boom)


class TestResolveCells:
    def test_stack_true_without_workers_never_spawns(self, tmp_path,
                                                     no_pool):
        """workers=0, stack=True: every cell, the mixed-signature singleton
        included, trains in process as a slab."""
        wl = _mlp()
        jobs = [_job(wl, seed=0), _job(wl, seed=1), _job(wl, T=3)]
        outcomes = cellfarm.resolve_cells(jobs, str(tmp_path), workers=0,
                                          stack=True, device="cpu")
        assert all(o.trained and o.error is None for o in outcomes)
        assert [o.key for o in outcomes] == _keys(jobs)
        cache = _cache(tmp_path)
        assert all(cache.contains(j.workload, j.assignment, seed=j.seed)
                   for j in jobs)

    def test_stack_true_with_pool_farms_only_singletons(
            self, tmp_path, no_pool, monkeypatch):
        """With a usable pool only groups of two or more stack; the lone
        leftover job resolves in process (one job never spawns)."""
        monkeypatch.setattr(cellfarm.multiprocessing, "cpu_count",
                            lambda: 4)
        wl = _mlp()
        jobs = [_job(wl, seed=0), _job(wl, T=3), _job(wl, seed=1)]
        outcomes = cellfarm.resolve_cells(jobs, str(tmp_path), workers=2,
                                          stack=True, device="cpu")
        assert all(o.trained for o in outcomes)
        assert [o.key for o in outcomes] == _keys(jobs)

    def test_two_workers_spawn_once_and_equal_solo(self, tmp_path,
                                                   monkeypatch):
        """workers=2 spawns one pool of two CPU workers, reused by the
        next call (all hits there); the farmed cells equal solo ones bit
        for bit."""
        monkeypatch.setattr(cellfarm.multiprocessing, "cpu_count",
                            lambda: 4)
        cellfarm.shutdown_pool()
        wl = _mlp()
        jobs = [_job(wl, seed=0), _job(wl, seed=1)]
        root = str(tmp_path / "farm")
        try:
            out = cellfarm.resolve_cells(jobs, root, workers=2,
                                         device="cpu")
            pool = cellfarm._pool
            assert pool is not None and cellfarm._pool_size == 2
            again = cellfarm.resolve_cells(jobs, root, workers=2,
                                           device="cpu")
            assert cellfarm._pool is pool
        finally:
            cellfarm.shutdown_pool()
        assert [o.trained for o in out] == [True, True]
        assert [o.trained for o in again] == [False, False]
        assert all(o.error is None for o in out + again)
        farmed, solo = _cache(root), _cache(tmp_path / "solo")
        for job in jobs:
            got = farmed.resolve(job.workload, job.assignment, seed=job.seed)
            assert got.cache_hit
            _assert_same_cell(got, solo.resolve(job.workload, job.assignment,
                                                seed=job.seed))

    def test_worker_count_caps(self, monkeypatch):
        monkeypatch.setattr(cellfarm.multiprocessing, "cpu_count",
                            lambda: 16)
        monkeypatch.setattr(cellfarm, "MAX_POOL_WORKERS", 2)
        assert cellfarm._worker_count(10, None) == 2      # module cap
        assert cellfarm._worker_count(10, 1) == 1         # explicit request
        assert cellfarm._worker_count(1, 8) == 1          # never > jobs
        monkeypatch.setattr(cellfarm, "MAX_POOL_WORKERS", 64)
        monkeypatch.setattr(cellfarm.multiprocessing, "cpu_count",
                            lambda: 3)
        assert cellfarm._worker_count(10, None) == 3      # cpu cap

    def test_shutdown_pool_is_idempotent(self):
        cellfarm.shutdown_pool()
        assert cellfarm._pool is None
        cellfarm.shutdown_pool()
        assert cellfarm._pool is None and cellfarm._pool_size == 0

    def test_a_raising_job_ships_as_an_error(self, tmp_path, monkeypatch):
        def fail(*args, **kw):
            raise RuntimeError("card on fire")
        monkeypatch.setattr(cellfarm.TraceCache, "resolve", fail)
        job = _job(_mlp())
        out = cellfarm._resolve_job((job, str(tmp_path), "cpu"))
        assert out.error == "RuntimeError: card on fire"
        assert out.key == cellfarm._job_key(job) and not out.trained
        outcomes = cellfarm.resolve_cells([job], str(tmp_path), workers=0,
                                          retries=1, device="cpu")
        assert outcomes[0].error == "RuntimeError: card on fire"

    def test_cluster_is_refused_naming_the_fleet(self, tmp_path,
                                                 monkeypatch):
        """``workers="cluster"`` goes to the fleet: with no worker
        enrolled, the submitter reclaims the cell after the no-progress
        window and trains it in process on ``device``, a trained outcome.
        Any other string is refused, naming ``'cluster'``."""
        monkeypatch.setenv("REPRO_FLEET_TIMEOUT", "0.2")
        monkeypatch.setenv("REPRO_FLEET_POLL", "0.02")
        job = _job(_mlp())
        [out] = cellfarm.resolve_cells([job], str(tmp_path),
                                       workers="cluster", device="cpu")
        assert out.trained and out.error is None
        assert out.key == _keys([job])[0]
        assert _cache(tmp_path).contains(job.workload, job.assignment,
                                         seed=job.seed)
        with pytest.raises(ValueError, match="'cluster'"):
            cellfarm.resolve_cells([_job(_mlp())], str(tmp_path),
                                   workers="many", device="cpu")


def _rows(table):
    cols = [np.asarray(table.columns[k], np.float64).reshape(len(table), -1)
            for k in sorted(table.columns) if k != "dataset"]
    a = np.concatenate(cols, axis=1)
    return a[np.lexsort(a.T)]


class TestStudyFarm:
    def test_coexplore_stack_matches_serial(self, tmp_path, no_pool):
        """A datasets axis of two same-shape workload variants under
        stack=True gives the serial frontier exactly and counts both cells
        as farmed misses: the study's own cache sees only hits."""
        wl_a = _mlp(name="stack-co-a")
        wl_b = _mlp(name="stack-co-b", data_seed=17, noise=0.35)
        kw = dict(datasets=(wl_a, wl_b), num_steps=(2,), max_lhr=2)
        serial_cache = _cache(tmp_path / "a")
        serial = dse.coexplore(cache=serial_cache, **kw)
        stack_cache = _cache(tmp_path / "b")
        stacked = dse.coexplore(cache=stack_cache, stack=True, **kw)
        assert stacked.study.farmed_misses == 2
        assert stack_cache.misses == 0 and stack_cache.hits == 2
        assert serial_cache.misses == 2
        np.testing.assert_array_equal(_rows(stacked.frontier),
                                      _rows(serial.frontier))

    def test_hardware_only_explore_rejects_stack(self):
        cfg = arch.from_layer_sizes("hw", (16, 8), num_steps=2)
        space = dse.SearchSpace.product_lhr(cfg, max_lhr=2)
        with pytest.raises(ValueError, match="hardware-only"):
            dse.explore(space, counts=[np.full(2, 2.0)], stack=True)

    def test_cluster_is_refused_by_explore(self, tmp_path, monkeypatch):
        """``coexplore(workers="cluster")`` with no fleet worker completes
        through the reclaim; the cell counts as a farmed miss and the
        study's own cache sees a hit."""
        monkeypatch.setenv("REPRO_FLEET_TIMEOUT", "0.2")
        monkeypatch.setenv("REPRO_FLEET_POLL", "0.02")
        one = dse.coexplore(_mlp(), num_steps=(2,), max_lhr=2,
                            cache=_cache(tmp_path), workers="cluster")
        assert one.summary["cache"] == {"hits": 1, "misses": 0,
                                        "farmed_misses": 1}
