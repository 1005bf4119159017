"""The port's elastic cell fleet (``repro_torch.distributed.fleet``) on the
CPU: the lease protocol (exclusive create, heartbeat renewal, stale break,
ownership-checked renew/release), the wire-format job spool, the
``FleetWorker`` claim/train/publish loop, the submitter's
``resolve_cluster`` (fallback, error sidecar, stale leases), and two
spawned-process cases: a worker SIGKILL'd mid-cell whose study completes,
and ``explore(workers="cluster")`` over two workers, bit for bit the serial
frontier with each cell trained once.  Cases mirrored from
``tests/test_fleet.py`` keep their names.

Parity with the JAX package: a ``CellJob`` gives the same wire JSON in both
packages, and a job that either package spools parses in the other."""
import dataclasses
import json
import multiprocessing
import os
import signal
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from repro.core import snn as jax_snn
from repro.core import workloads as jax_workloads
from repro.distributed import cellfarm as jax_cellfarm
from repro.distributed import fleet as jax_fleet
from repro.serve import protocol as jax_protocol
from repro_torch.core import dse, snn, workloads
from repro_torch.distributed import cellfarm, fleet
from repro_torch.serve import protocol

torch.set_num_threads(2)


def _tiny_wl(name="fleet-test-wl"):
    return dataclasses.replace(
        workloads.get("mnist-mlp"), name=name,
        layers=(snn.Dense(12),), pcr=1, input_shape=(12, 12),
        n_train=96, n_test=32, train_steps=4, batch_size=32,
        trace_samples=16)


def _jobs(wl, steps=(2,), pops=(1.0,)):
    return [cellfarm.CellJob(workload=wl,
                             assignment={"num_steps": t, "population": p})
            for t in steps for p in pops]


def _cache(root):
    return workloads.TraceCache(root=str(root), device="cpu")


def _worker(root, worker_id, **kw):
    return fleet.FleetWorker(str(root), worker_id=worker_id, poll=0.01,
                             device="cpu", **kw)


def _rows(table):
    """All columns flattened to sortable float rows (strings via crc32)."""
    cols = []
    for k in sorted(table.columns):
        v = np.asarray(table.columns[k])
        if v.dtype.kind in "USO":
            v = np.array([float(zlib.crc32(str(x).encode())) for x in v])
        cols.append(np.asarray(v, np.float64).reshape(len(table), -1))
    a = np.concatenate(cols, axis=1)
    return a[np.lexsort(a.T)]


def _backdate(path, by=3600.0):
    old = time.time() - by
    os.utime(path, (old, old))


class TestLease:
    def test_exclusive_acquire_and_release(self, tmp_path):
        root = str(tmp_path)
        a = fleet.acquire(root, "cell", "w-a", ttl=30)
        assert a is not None
        # a live lease blocks every other claimant
        assert fleet.acquire(root, "cell", "w-b", ttl=30) is None
        a.release()
        b = fleet.acquire(root, "cell", "w-b", ttl=30)
        assert b is not None and b.worker_id == "w-b"

    def test_renew_touches_heartbeat(self, tmp_path):
        lease = fleet.acquire(str(tmp_path), "cell", "w-a", ttl=30)
        _backdate(lease.path)
        stale = os.stat(lease.path).st_mtime
        assert lease.renew()
        assert os.stat(lease.path).st_mtime > stale
        assert not lease.lost

    def test_stale_lease_broken_and_reclaimed(self, tmp_path):
        root = str(tmp_path)
        dead = fleet.acquire(root, "cell", "w-dead", ttl=30)
        _backdate(dead.path)                 # heartbeat long past the TTL
        live = fleet.acquire(root, "cell", "w-live", ttl=30)
        assert live is not None and live.worker_id == "w-live"
        # the demoted holder notices on its next renewal and must not
        # touch (renew) or unlink (release) the new owner's lease
        assert not dead.renew()
        assert dead.lost
        dead.release()
        with open(live.path) as f:
            assert f.read() == "w-live"
        assert live.renew()

    def test_fresh_lease_not_breakable(self, tmp_path):
        root = str(tmp_path)
        fleet.acquire(root, "cell", "w-a", ttl=30)
        for _ in range(3):
            assert fleet.acquire(root, "cell", "w-b", ttl=30) is None

    def test_heartbeat_thread_keeps_lease_live(self, tmp_path):
        root = str(tmp_path)
        lease = fleet.acquire(root, "cell", "w-a", ttl=0.4)
        hb = fleet._Heartbeat(lease, ttl=0.4)
        hb.start()
        try:
            time.sleep(1.2)                  # 3x the TTL: would be stale
            assert fleet.acquire(root, "cell", "w-b", ttl=0.4) is None
        finally:
            hb.stop()


#: the JAX package's twin of each wire-format case's workload
_WIRE_CASES = {
    "dense": (lambda: _tiny_wl(),
              lambda: dataclasses.replace(
                  jax_workloads.get("mnist-mlp"), name="fleet-test-wl",
                  layers=(jax_snn.Dense(12),), pcr=1,
                  input_shape=(12, 12), n_train=96, n_test=32,
                  train_steps=4, batch_size=32, trace_samples=16)),
    "conv-pool": (lambda: workloads.get("dvs-conv"),
                  lambda: jax_workloads.get("dvs-conv")),
}


def _twin_jobs(case):
    """The same job built in each package: (port's, reference's)."""
    port_wl, jax_wl = (make() for make in _WIRE_CASES[case])
    kw = dict(assignment={"num_steps": 4, "population": 0.5}, seed=3,
              quant_bits=(4, 8))
    return (cellfarm.CellJob(workload=port_wl, **kw),
            jax_cellfarm.CellJob(workload=jax_wl, **kw))


class TestWireFormat:
    def test_cell_job_round_trips_exactly(self):
        job = cellfarm.CellJob(
            workload=_tiny_wl(), seed=3, quant_bits=(4, 8),
            assignment={"num_steps": 2, "population": 0.5})
        wire = protocol.to_wire(job)
        assert wire["event"] == "CellJob"
        back = protocol.from_wire(json.loads(json.dumps(wire)))
        assert back == job                   # frozen dataclass equality

    def test_conv_pool_workload_round_trips(self):
        job = cellfarm.CellJob(workload=workloads.get("dvs-conv"),
                               assignment={"num_steps": 4})
        assert protocol.from_wire(
            json.loads(json.dumps(protocol.to_wire(job)))) == job

    def test_unknown_kind_lists_cell_job(self):
        with pytest.raises(ValueError, match="CellJob"):
            protocol.from_wire({"event": "NoSuchKind"})

    @pytest.mark.parametrize("case", sorted(_WIRE_CASES))
    def test_wire_json_equals_the_reference(self, case):
        mine, theirs = _twin_jobs(case)
        assert json.dumps(protocol.to_wire(mine), sort_keys=True) == \
            json.dumps(jax_protocol.to_wire(theirs), sort_keys=True)
        assert cellfarm._job_key(mine) == jax_cellfarm._job_key(theirs)

    @pytest.mark.parametrize("case", sorted(_WIRE_CASES))
    def test_spooled_job_parses_in_the_other_package(self, tmp_path, case):
        mine, theirs = _twin_jobs(case)
        [key] = fleet.spool(str(tmp_path / "port"), [mine])
        assert jax_fleet._read_job(
            jax_fleet._spool_path(str(tmp_path / "port"), key)) == theirs
        [key] = jax_fleet.spool(str(tmp_path / "jax"), [theirs])
        assert fleet._read_job(
            fleet._spool_path(str(tmp_path / "jax"), key)) == mine


class TestSpool:
    def test_spool_idempotent_and_clears_stale_error(self, tmp_path):
        root = str(tmp_path)
        jobs = _jobs(_tiny_wl(), steps=(2, 3))
        keys = fleet.spool(root, jobs)
        assert len(set(keys)) == 2
        fleet._write_error(root, keys[0], "old failure")
        assert fleet.spool(root, jobs) == keys      # re-spool: same keys
        assert fleet._read_error(root, keys[0]) is None
        for key in keys:
            assert fleet._read_job(fleet._spool_path(root, key)) == \
                jobs[keys.index(key)]

    def test_unreadable_job_skipped(self, tmp_path):
        root = str(tmp_path)
        key = fleet.spool(root, _jobs(_tiny_wl()))[0]
        path = fleet._spool_path(root, key)
        with open(path, "w") as f:
            f.write("{not json")
        assert fleet._read_job(path) is None
        assert fleet._read_job(path + ".gone") is None


class TestFleetWorker:
    def test_worker_claims_trains_publishes_drains(self, tmp_path):
        root = str(tmp_path)
        wl = _tiny_wl("fleet-worker-wl")
        key = fleet.spool(root, _jobs(wl))[0]
        worker = _worker(root, "w-0")
        stats = worker.run(max_cells=1)
        assert stats["cells_trained"] == 1 and stats["cells_failed"] == 0
        assert worker.cache.contains_key(key)
        assert worker.cache.device == torch.device("cpu")
        assert not os.path.exists(fleet._spool_path(root, key))
        assert not os.path.exists(fleet._lease_path(root, key))

    def test_worker_drains_already_published(self, tmp_path):
        root = str(tmp_path)
        wl = _tiny_wl("fleet-drain-wl")
        jobs = _jobs(wl)
        _cache(root).resolve(jobs[0].workload, jobs[0].assignment)
        key = fleet.spool(root, jobs)[0]
        stats = _worker(root, "w-0").run(idle_timeout=0.2)
        assert stats == {"cells_trained": 0, "cells_failed": 0,
                         "cells_skipped": 0, "lease_takeovers": 0}
        assert not os.path.exists(fleet._spool_path(root, key))

    def test_worker_failure_writes_error_sidecar(self, tmp_path,
                                                 monkeypatch):
        root = str(tmp_path)
        key = fleet.spool(root, _jobs(_tiny_wl("fleet-fail-wl")))[0]
        worker = _worker(root, "w-0")

        def boom(*a, **kw):
            raise RuntimeError("injected training failure")

        monkeypatch.setattr(worker.cache, "resolve", boom)
        stats = worker.run(max_cells=1)
        assert stats["cells_failed"] == 1 and stats["cells_trained"] == 0
        assert "injected training failure" in fleet._read_error(root, key)
        assert not os.path.exists(fleet._spool_path(root, key))
        assert not os.path.exists(fleet._lease_path(root, key))

    def test_worker_counts_takeover_of_stale_lease(self, tmp_path):
        root = str(tmp_path)
        wl = _tiny_wl("fleet-takeover-wl")
        key = fleet.spool(root, _jobs(wl))[0]
        dead = fleet.acquire(root, key, "w-dead", ttl=30)
        _backdate(dead.path)                 # the dead worker's last beat
        worker = _worker(root, "w-1")
        stats = worker.run(max_cells=1)
        assert stats["lease_takeovers"] == 1
        assert stats["cells_trained"] == 1
        assert worker.cache.contains_key(key)

    def test_two_workers_race_one_cell_exactly_one_trains(self, tmp_path):
        root = str(tmp_path)
        wl = _tiny_wl("fleet-race-wl")
        key = fleet.spool(root, _jobs(wl))[0]
        workers = [_worker(root, f"w-{i}") for i in range(2)]
        threads = [threading.Thread(
            target=w.run, kwargs=dict(max_cells=1, idle_timeout=2.0))
            for w in workers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        trained = sum(w.stats["cells_trained"] for w in workers)
        failed = sum(w.stats["cells_failed"] for w in workers)
        assert trained == 1 and failed == 0  # O_EXCL picked one claimant
        assert workers[0].cache.contains_key(key)

    def test_no_device_means_the_card_and_raises_without_one(
            self, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fleet.FleetWorker(str(tmp_path), worker_id="w-0")


class TestResolveCluster:
    def test_zero_workers_falls_back_in_process(self, tmp_path):
        root = str(tmp_path)
        jobs = _jobs(_tiny_wl("fleet-fallback-wl"), steps=(2, 3))
        out = fleet.resolve_cluster(jobs, root, timeout=0.3, ttl=0.5,
                                    poll=0.05, device="cpu")
        assert [o.error for o in out] == [None, None]
        assert all(o.trained for o in out)
        cache = _cache(root)
        assert all(cache.contains_key(o.key) for o in out)
        # resolving again: every cell is a pure hit, nothing re-spooled
        again = fleet.resolve_cluster(jobs, root, timeout=0.3, ttl=0.5,
                                      device="cpu")
        assert not any(o.trained for o in again)
        assert not any(os.path.exists(fleet._spool_path(root, o.key))
                       for o in again)

    def test_reclaim_trains_on_the_submitters_device(self, tmp_path,
                                                     monkeypatch):
        """The in-process reclaim hands ``device`` to the cell farm's job
        runner as the triple's third member, never a device of its own."""
        seen = []
        real = cellfarm._resolve_job

        def spy(args):
            seen.append(args[2])
            return real(args)

        monkeypatch.setattr(cellfarm, "_resolve_job", spy)
        out = fleet.resolve_cluster(_jobs(_tiny_wl("fleet-dev-wl")),
                                    str(tmp_path), timeout=0.2, ttl=0.5,
                                    poll=0.05, device="cpu")
        assert out[0].trained and seen == ["cpu"]

    def test_error_sidecar_ships_as_failed_outcome(self, tmp_path):
        root = str(tmp_path)
        jobs = _jobs(_tiny_wl("fleet-errship-wl"))
        key = cellfarm._job_key(jobs[0])
        # the sidecar must land mid-resolution: spooling (which
        # resolve_cluster does first) clears stale errors by design
        t = threading.Timer(0.3, fleet._write_error,
                            args=(root, key, "ValueError: worker exploded"))
        t.start()
        out = fleet.resolve_cluster(jobs, root, timeout=5.0, ttl=5.0,
                                    poll=0.05, fallback=False, device="cpu")
        t.join()
        assert out[0].error == "ValueError: worker exploded"
        assert not out[0].trained
        assert not os.path.exists(fleet._error_path(root, key))

    def test_no_progress_without_fallback_errors(self, tmp_path):
        root = str(tmp_path)
        jobs = _jobs(_tiny_wl("fleet-noprog-wl"))
        out = fleet.resolve_cluster(jobs, root, timeout=0.2, ttl=0.3,
                                    poll=0.05, fallback=False, device="cpu")
        assert "no progress" in out[0].error

    def test_dead_workers_stale_lease_reclaimed(self, tmp_path):
        """Every cell is leased by a worker that died without a trace
        (stale heartbeats, nothing published): the submitter must break
        the leases and complete the study with zero failed outcomes."""
        root = str(tmp_path)
        jobs = _jobs(_tiny_wl("fleet-deadlease-wl"), steps=(2, 3))
        keys = fleet.spool(root, jobs)
        for key in keys:
            lease = fleet.acquire(root, key, "w-dead", ttl=30)
            _backdate(lease.path)
        out = fleet.resolve_cluster(jobs, root, timeout=0.5, ttl=1.0,
                                    poll=0.05, device="cpu")
        assert [o.error for o in out] == [None, None]
        cache = _cache(root)
        assert all(cache.contains_key(k) for k in keys)


class TestFleetProcesses:
    """Fault injection and equivalence with real spawned worker processes
    on the CPU (each pays a fresh interpreter and torch import)."""

    def _spawn(self, root, worker_id, **kw):
        ctx = multiprocessing.get_context("spawn")   # CUDA is not fork-safe
        p = ctx.Process(target=fleet.run_worker,
                        kwargs=dict(root=root, worker_id=worker_id,
                                    device="cpu", **kw))
        p.start()
        return p

    def test_worker_sigkilled_mid_train_study_completes(self, tmp_path,
                                                        monkeypatch):
        """kill -9 on a worker mid-study: its lease goes stale, the cell
        is reclaimed, and the study completes with every cell resolved
        and zero failed outcomes."""
        root = str(tmp_path)
        wl = _tiny_wl("fleet-kill-wl")
        jobs = _jobs(wl, steps=(2, 3))
        keys = fleet.spool(root, jobs)
        proc = self._spawn(root, "w-victim", idle_timeout=300)
        try:
            deadline = time.time() + 120
            while time.time() < deadline:    # wait for the first claim
                if any(os.path.exists(fleet._lease_path(root, k))
                       for k in keys):
                    break
                time.sleep(0.01)
            else:
                pytest.fail("worker never claimed a cell")
            os.kill(proc.pid, signal.SIGKILL)
        finally:
            proc.join(timeout=30)
        assert not proc.is_alive()
        # short TTL so the orphaned lease ages out fast
        monkeypatch.setenv("REPRO_FLEET_LEASE_TTL", "1.0")
        monkeypatch.setenv("REPRO_FLEET_TIMEOUT", "2.0")
        cache = _cache(root)
        study = dse.explore(workload=wl, num_steps=(2, 3),
                            population=(1.0,), max_lhr=4, weight_bits=(4,),
                            chunk_size=4096, cache=cache, workers="cluster")
        assert study.summary["cells_resolved"] == 2
        assert all(cache.contains_key(k) for k in keys)
        assert len(study.frontier) > 0

    def test_cluster_explore_bit_identical_to_serial(self, tmp_path):
        """``explore(workers="cluster")`` with two live FleetWorker
        processes produces a frontier bit-identical to the serial run, and
        no cell is trained twice across the fleet."""
        wl = _tiny_wl("fleet-e2e-wl")
        kw = dict(workload=wl, num_steps=(2, 3), population=(0.5, 1.0),
                  max_lhr=4, weight_bits=(4, 8), chunk_size=4096)
        serial = dse.explore(cache=_cache(tmp_path / "serial"), **kw)
        fa = _rows(serial.frontier)

        root = os.path.join(str(tmp_path), "cluster")
        os.makedirs(root)
        stats_paths = [os.path.join(root, f"stats-{i}.json")
                       for i in range(2)]
        procs = [self._spawn(root, f"w-{i}", idle_timeout=8, stats_path=p)
                 for i, p in enumerate(stats_paths)]
        try:
            cache = _cache(root)
            study = dse.explore(cache=cache, workers="cluster", **kw)
        finally:
            for p in procs:
                p.join(timeout=120)
                assert not p.is_alive()
        fb = _rows(study.frontier)
        np.testing.assert_array_equal(fa, fb)       # bit-identical frontier

        stats = []
        for path in stats_paths:
            with open(path) as f:
                stats.append(json.load(f))
        trained = sum(s["cells_trained"] for s in stats)
        duplicated = sum(s["cells_skipped"] for s in stats)
        # the parent only ever loads published cells; the fleet trained
        # each of the 4 cells exactly once between the two workers
        assert cache.misses == 0
        assert trained == 4 and duplicated == 0
        assert sum(s["cells_failed"] for s in stats) == 0
        assert study.farmed_misses == 4             # budget unit: publishes
