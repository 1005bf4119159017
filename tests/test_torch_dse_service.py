"""The port's multi-tenant DSE service (``repro_torch.serve``) on the CPU:
the typed event protocol, admission control, the cooperative scheduler,
cross-tenant training dedup over one shared cache, checkpoint, eviction
and restart, and the study hooks the service builds on.  Cases mirrored
from ``tests/test_dse_service.py`` keep their names; every cache is a
``TraceCache`` on ``device="cpu"``.

Parity with the JAX package: one hardware-only submission through both
packages' services gives equal events (as ``to_wire`` dicts; no event
carries a time) and a bit-for-bit equal frontier, since the DSE is NumPy
in both.  ``DSEService(workers="cluster")`` with no fleet worker completes
through the submitter's reclaim."""
import dataclasses
import json

import numpy as np
import pytest
import torch
import zlib

from repro.core import dse as jax_dse
from repro.core import workloads as jax_workloads
from repro.core.accelerator import arch as jax_arch
from repro.serve import DSEService as JaxDSEService
from repro.serve import Submission as JaxSubmission
from repro.serve import to_wire as jax_to_wire
from repro_torch.core import dse, snn, workloads
from repro_torch.core.accelerator import arch
from repro_torch.core.dse.pareto import ParetoAccumulator, any_dominates
from repro_torch.core.dse.table import CandidateTable
from repro_torch.serve import (DSEService, FrontierUpdate, Progress,
                               StudyAccepted, StudyCompleted, StudyEvicted,
                               StudyFailed, StudyHandle, StudyRejected,
                               StudyStarted, Submission, from_wire,
                               is_terminal, to_wire)

torch.set_num_threads(2)


def _tiny_wl(name="service-test-wl"):
    return dataclasses.replace(
        workloads.get("mnist-mlp"), name=name,
        layers=(snn.Dense(12),), pcr=1, input_shape=(12, 12),
        n_train=96, n_test=32, train_steps=4, batch_size=32,
        trace_samples=16)


def _hw_setup(max_lhr=4, package=(arch, dse)):
    arch_, dse_ = package
    cfg = arch_.from_layer_sizes("t", (64, 32, 16), num_steps=3)
    counts = [np.full(3, 8.0)] * 2
    space = dse_.SearchSpace.product_lhr(cfg, max_lhr=max_lhr)
    return cfg, counts, space


def _hw_submission(tenant, name, **over):
    cfg, counts, space = _hw_setup()
    kw = dict(tenant=tenant, name=name, space=space, config=cfg,
              counts=counts, chunk_size=64)
    kw.update(over)
    return Submission(**kw)


#: the tiny cells-mode grid both tenants submit: 2 T x 2 pop = 4 cells
CELL_GRID = dict(num_steps=(2, 3), population=(0.5, 1.0), max_lhr=2,
                 weight_bits=(4,))


def _cells_submission(tenant, name, wl, **over):
    kw = dict(tenant=tenant, name=name, workload=wl, **CELL_GRID)
    kw.update(over)
    return Submission(**kw)


def _cpu_cache(root):
    return workloads.TraceCache(root=str(root), device="cpu")


@pytest.fixture
def cpu_service(tmp_path):
    """A service over a CPU cache of its own (hardware-only studies never
    touch it, but a cache with no device would mean the card)."""
    def make(**kw):
        return DSEService(_cpu_cache(tmp_path / "hw-cells"), **kw)
    return make


def _rows(table_or_cols):
    """All columns flattened to sortable float rows (strings via crc32)."""
    columns = getattr(table_or_cols, "columns", table_or_cols)
    cols = []
    n = len(next(iter(columns.values())))
    for k in sorted(columns):
        v = np.asarray(columns[k])
        if v.dtype.kind in "USO":
            v = np.array([float(zlib.crc32(str(x).encode())) for x in v])
        cols.append(np.asarray(v, np.float64).reshape(n, -1))
    a = np.concatenate(cols, axis=1)
    return a[np.lexsort(a.T)]


def _objective_matrix(update: FrontierUpdate) -> np.ndarray:
    return np.stack([np.asarray(update.frontier[k], np.float64)
                     for k in update.objectives], axis=1)


def assert_monotone(updates):
    """Every point of each FrontierUpdate is still present in — or strictly
    dominated by — the next one (the streaming contract)."""
    assert updates, "study emitted no frontier updates"
    for prev, cur in zip(updates, updates[1:]):
        assert cur.round > prev.round
        a, b = _objective_matrix(prev), _objective_matrix(cur)
        for p in a:
            present = np.isclose(b, p).all(axis=1).any()
            assert present or any_dominates(b, p[None])[0], (
                f"frontier regressed between rounds {prev.round} and "
                f"{cur.round}: {p} vanished undominated")


@pytest.fixture(scope="module")
def shared_cache(tmp_path_factory):
    """One cache for the whole module so each cell trains exactly once."""
    return _cpu_cache(tmp_path_factory.mktemp("cells"))


# ---- protocol ---------------------------------------------------------------

class TestProtocol:
    EVENTS = [
        StudyAccepted("t/a", "t", position=2),
        StudyRejected("t/a", "t", reason="queue full"),
        StudyStarted("t/a", "t", resumed=True),
        FrontierUpdate("t/a", "t", round=3, n_evaluated=128,
                       frontier_size=2, objectives=("edp", "area_mm2"),
                       frontier={"edp": [1.0, 2.0], "area_mm2": [3.0, 1.5]}),
        Progress("t/a", "t", round=3, n_evaluated=128, frontier_size=2,
                 cells_resolved=4, cells_skipped=1,
                 cache={"hits": 3, "misses": 4},
                 budget={"limit": 8, "spent": 4, "remaining": 4}),
        StudyEvicted("t/a", "t", checkpoint_dir="/tmp/x"),
        StudyEvicted("t/a", "t", checkpoint_dir=None),
        StudyFailed("t/a", "t", error="ValueError: boom"),
        StudyCompleted("t/a", "t", summary={"mode": "cells", "rounds": 4}),
    ]

    def test_wire_round_trip_survives_json(self):
        for event in self.EVENTS:
            wire = json.loads(json.dumps(to_wire(event)))
            assert wire["event"] == type(event).__name__
            assert from_wire(wire) == event      # tuples re-tupled

    def test_unknown_kind_and_fields_rejected(self):
        with pytest.raises(ValueError, match="unknown event kind"):
            from_wire({"event": "Nope", "study_id": "a", "tenant": "t"})
        with pytest.raises(ValueError, match="does not take"):
            from_wire({"event": "StudyStarted", "study_id": "a",
                       "tenant": "t", "resumed": False, "bogus": 1})

    def test_terminal_classification(self):
        terminal = {type(e) for e in self.EVENTS if is_terminal(e)}
        assert terminal == {StudyRejected, StudyFailed, StudyCompleted}

    def test_submission_validates_ids(self):
        Submission(tenant="team-a", name="run_1.2")         # ok
        for bad in ("", "a/b", "a b", "x\n"):
            with pytest.raises(ValueError, match="non-empty"):
                Submission(tenant=bad, name="ok")
            with pytest.raises(ValueError, match="non-empty"):
                Submission(tenant="ok", name=bad)
        assert Submission(tenant="a", name="b").study_id == "a/b"


# ---- admission control ------------------------------------------------------

class TestAdmission:
    def test_duplicate_id_rejected_while_live(self, cpu_service):
        service = cpu_service(max_active=1)
        h1 = service.submit(_hw_submission("t", "s"))
        h2 = service.submit(_hw_submission("t", "s"))
        assert h1.status == "pending" and h2.status == "rejected"
        [event] = [e for e in h2.events() if isinstance(e, StudyRejected)]
        assert "already pending" in event.reason
        # a different tenant may reuse the study *name*
        assert service.submit(_hw_submission("u", "s")).status == "pending"
        service.run_until_idle()
        assert h1.status == "completed"
        # ...and after the terminal state the id is reusable again
        assert service.submit(_hw_submission("t", "s")).status == "pending"
        service.run_until_idle()

    def test_queue_full_rejected(self, cpu_service):
        service = cpu_service(max_active=1, max_pending=2)
        handles = [service.submit(_hw_submission("t", f"s{i}"))
                   for i in range(4)]
        # 2 queued; the rest bounced at the door
        statuses = [h.status for h in handles]
        assert statuses == ["pending", "pending", "rejected", "rejected"]
        [event] = [e for e in handles[2].events()
                   if isinstance(e, StudyRejected)]
        assert "queue is full" in event.reason
        assert service.stats["rejected"] == 2
        service.run_until_idle()
        assert [h.status for h in handles[:2]] == ["completed"] * 2

    def test_accepted_position_reflects_queue(self, cpu_service):
        service = cpu_service(max_active=1)
        positions = []
        for i in range(3):
            h = service.submit(_hw_submission("t", f"p{i}"))
            [acc] = [e for e in h.events() if isinstance(e, StudyAccepted)]
            positions.append(acc.position)
        assert positions == [0, 1, 2]
        service.run_until_idle()

    def test_tenant_quota_mapping(self, cpu_service):
        service = cpu_service(tenant_quota=5, tenant_quotas={"big": 100})
        assert service.budget("small").limit == 5
        assert service.budget("big").limit == 100
        # one budget object per tenant, shared across that tenant's studies
        assert service.budget("small") is service.budget("small")
        assert cpu_service().budget("anyone") is None     # unmetered

    def test_reject_over_quota(self, shared_cache):
        wl = _tiny_wl()
        service = DSEService(shared_cache, tenant_quota=1,
                             reject_over_quota=True)
        service.budget("t").charge()                      # exhaust it
        h = service.submit(_cells_submission("t", "s", wl))
        assert h.status == "rejected"
        [event] = [e for e in h.events() if isinstance(e, StudyRejected)]
        assert "quota exhausted" in event.reason
        # without the flag the submission queues (cells may still be hits)
        lax = DSEService(shared_cache, tenant_quota=1)
        lax.budget("t").charge()
        assert lax.submit(_cells_submission("t", "s", wl)).status == "pending"

    def test_default_cache_means_the_card(self, tmp_path, monkeypatch):
        """No cache given: the port's own root with cells on the card,
        which raises where there is none instead of running on the CPU."""
        monkeypatch.setenv("REPRO_TORCH_WORKLOAD_CACHE", str(tmp_path))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DSEService()


# ---- scheduling: hardware-only studies (fast, no training) ------------------

class TestScheduler:
    def test_hardware_study_lifecycle_events(self, cpu_service):
        service = cpu_service()
        handle = service.submit(_hw_submission("t", "hw"))
        service.run_until_idle()
        events = handle.events()
        kinds = [type(e).__name__ for e in events]
        assert kinds[0] == "StudyAccepted"
        assert kinds[1] == "StudyStarted" and not events[1].resumed
        assert kinds[-1] == "StudyCompleted"
        assert any(isinstance(e, FrontierUpdate) for e in events)
        assert any(isinstance(e, Progress) for e in events)
        assert events[-1].summary["done"]
        # the handle's frontier matches a plain explore() of the same space
        cfg, counts, space = _hw_setup()
        solo = dse.explore(space, config=cfg, counts=counts, chunk_size=64)
        assert np.allclose(_rows(handle.frontier), _rows(solo.frontier))

    def test_interleaving_bounded_by_max_active(self, cpu_service):
        service = cpu_service(max_active=2)
        seen = []
        handles = [service.submit(_hw_submission("t", f"i{i}"))
                   for i in range(3)]
        while service.tick():
            with service._lock:
                seen.append(tuple(h.study_id for h in service._active))
        assert all(len(s) <= 2 for s in seen)
        # the first two studies ran concurrently at some point
        assert any(len(s) == 2 for s in seen)
        assert all(h.status == "completed" for h in handles)

    def test_build_failure_is_contained(self, cpu_service):
        service = cpu_service()
        cfg, counts, space = _hw_setup()
        # joint kwargs on a hardware-only space -> explore raises at build
        bad = Submission(tenant="t", name="bad", space=space, config=cfg,
                         counts=counts, num_steps=(2,))
        good = service.submit(_hw_submission("t", "good"))
        h = service.submit(bad)
        service.run_until_idle()
        assert h.status == "failed"
        [event] = [e for e in h.events() if isinstance(e, StudyFailed)]
        assert "ValueError" in event.error
        assert good.status == "completed"      # neighbor unaffected
        assert service.stats["failed"] == 1

    def test_threaded_stream_subscription(self, cpu_service):
        service = cpu_service()
        service.start()
        try:
            handle = service.submit(_hw_submission("t", "bg"))
            events = list(handle.stream(timeout=30.0))
        finally:
            service.stop()
        assert isinstance(events[-1], StudyCompleted)
        assert handle.wait(timeout=1.0)
        assert handle.status == "completed"

    def test_frontier_before_activation_raises(self):
        handle = StudyHandle(_hw_submission("t", "x"))
        with pytest.raises(RuntimeError, match="never activated"):
            handle.frontier
        assert handle.summary == {"status": "pending"}


# ---- the acceptance E2E: two tenants, one shared cache ----------------------

class TestMultiTenantDedup:
    def test_overlapping_cells_train_once_and_frontiers_match_serial(
            self, shared_cache, tmp_path):
        wl = _tiny_wl("service-dedup-wl")
        service = DSEService(shared_cache, max_active=2)
        h_a = service.submit(_cells_submission("tenant-a", "sweep", wl))
        h_b = service.submit(_cells_submission("tenant-b", "sweep", wl))
        misses0, hits0 = shared_cache.misses, shared_cache.hits
        service.run_until_idle()
        assert h_a.status == h_b.status == "completed"

        n_cells = len(CELL_GRID["num_steps"]) * len(CELL_GRID["population"])
        # every overlapping cell trained exactly once...
        assert shared_cache.misses - misses0 <= n_cells
        # ...so at least one full grid's worth of resolutions were hits
        assert shared_cache.hits - hits0 >= n_cells
        # tenant-b (admitted second, round-robin behind a) was pure replay
        sb = h_b.study.summary
        assert sb["cells_resolved"] == n_cells

        # both streams were monotone
        for h in (h_a, h_b):
            assert_monotone([e for e in h.events()
                             if isinstance(e, FrontierUpdate)])

        # and both frontiers equal a serial explore() over a fresh cache
        solo = dse.explore(workload=wl, strategy="grid",
                           cache=_cpu_cache(tmp_path / "solo"), **CELL_GRID)
        want = _rows(solo.frontier)
        assert np.allclose(_rows(h_a.frontier), want)
        assert np.allclose(_rows(h_b.frontier), want)

        stats = service.stats
        assert stats["completed"] == 2 and stats["cache"]["hit_rate"] > 0

    def test_second_tenant_all_hits_on_warm_cache(self, shared_cache):
        wl = _tiny_wl("service-dedup-wl")     # same cells as the test above
        service = DSEService(shared_cache)
        handle = service.submit(_cells_submission("tenant-c", "sweep", wl))
        misses0 = shared_cache.misses
        service.run_until_idle()
        assert handle.status == "completed"
        assert shared_cache.misses == misses0        # zero retraining
        assert handle.study.summary["cache"]["hits"] >= 4

    def test_cluster_service_without_workers_completes_by_reclaim(
            self, tmp_path, monkeypatch):
        """``workers="cluster"`` with no fleet worker enrolled: every
        spooled cell is reclaimed by the submitter after the no-progress
        window and trained in process on the cache's device, counted as
        a farmed miss; the frontier is the serial one."""
        monkeypatch.setenv("REPRO_FLEET_LEASE_TTL", "0.5")
        monkeypatch.setenv("REPRO_FLEET_TIMEOUT", "0.2")
        monkeypatch.setenv("REPRO_FLEET_POLL", "0.02")
        wl = _tiny_wl("service-cluster-wl")
        cache = _cpu_cache(tmp_path / "cells")
        service = DSEService(cache, workers="cluster")
        handle = service.submit(_cells_submission("t", "fleet", wl))
        service.run_until_idle()
        assert handle.status == "completed"
        n_cells = len(CELL_GRID["num_steps"]) * len(CELL_GRID["population"])
        assert handle.study.farmed_misses == n_cells
        assert cache.misses == 0 and cache.hits == n_cells
        solo = dse.explore(workload=wl, strategy="grid",
                           cache=_cpu_cache(tmp_path / "solo"), **CELL_GRID)
        np.testing.assert_array_equal(_rows(handle.frontier),
                                      _rows(solo.frontier))


# ---- eviction, restart, resume ----------------------------------------------

class TestRestart:
    def test_evict_then_resubmit_resumes(self, shared_cache, tmp_path):
        wl = _tiny_wl("service-dedup-wl")
        root = str(tmp_path / "svc")
        service = DSEService(shared_cache, checkpoint_root=root)
        sub = _cells_submission("t", "evicted", wl)
        handle = service.submit(sub)
        service.tick()                        # activate + one cell
        assert handle.status == "active"
        ck = service.evict(handle.study_id)
        assert ck and "t" in ck and "evicted" in ck
        [event] = [e for e in handle.events()
                   if isinstance(e, StudyEvicted)]
        assert event.checkpoint_dir == ck
        assert service.stats["evicted"] == 1 and service.stats["active"] == 0

        h2 = service.submit(sub)
        service.run_until_idle()
        assert h2.status == "completed"
        [started] = [e for e in h2.events() if isinstance(e, StudyStarted)]
        assert started.resumed

    def test_service_restart_resumes_with_zero_retraining(
            self, shared_cache, tmp_path):
        wl = _tiny_wl("service-restart-wl")   # fresh cells: must train once
        root = str(tmp_path / "svc")
        misses0 = shared_cache.misses
        service = DSEService(shared_cache, checkpoint_root=root,
                             tenant_quota=16, checkpoint_every=1)
        sub = _cells_submission("t", "restart", wl)
        h1 = service.submit(sub)
        for _ in range(3):                    # activate + two cells
            service.tick()
        assert h1.status == "active" and h1.study.rounds >= 2
        service.shutdown()                    # evicts + checkpoints
        assert h1.status == "evicted"
        spent = service.budget("t").spent
        assert spent == shared_cache.misses - misses0 >= 2

        revived = DSEService(shared_cache, checkpoint_root=root,
                             tenant_quota=16)
        # budget accounting round-tripped through service.json
        assert revived.budget("t").spent == spent
        h2 = revived.submit(sub)
        revived.run_until_idle()
        assert h2.status == "completed"
        [started] = [e for e in h2.events() if isinstance(e, StudyStarted)]
        assert started.resumed
        # zero retraining across the restart: each of this workload's cells
        # trained exactly once, whether before or after the kill
        n_cells = len(CELL_GRID["num_steps"]) * len(CELL_GRID["population"])
        assert shared_cache.misses - misses0 == n_cells
        # the resumed frontier is bit-for-bit the serial one
        solo = dse.explore(workload=wl, strategy="grid", cache=shared_cache,
                           **CELL_GRID)
        assert set(h2.frontier.columns) == set(solo.frontier.columns)
        for k, v in solo.frontier.columns.items():
            got = h2.frontier.columns[k]
            assert np.asarray(got).dtype == np.asarray(v).dtype
        assert np.allclose(_rows(h2.frontier), _rows(solo.frontier))

    def test_evict_without_checkpoint_root(self, cpu_service):
        service = cpu_service()
        handle = service.submit(_hw_submission("t", "noroot",
                                               chunk_size=16))
        service.tick()
        ck = service.evict(handle.study_id)
        assert ck is None
        with pytest.raises(ValueError, match="not active"):
            service.evict(handle.study_id)


# ---- Study stepping hooks the service builds on -----------------------------

class TestStudyHooks:
    def test_listeners_fire_per_round_and_version_tracks_changes(self):
        cfg, counts, space = _hw_setup()
        study = dse.explore(space, config=cfg, counts=counts, chunk_size=32,
                            run=False)
        rounds_seen = []
        study.listeners.append(lambda s: rounds_seen.append(
            (s.rounds, s.frontier_version)))
        study.run()
        assert [r for r, _ in rounds_seen] == list(
            range(1, study.rounds + 1))
        versions = [v for _, v in rounds_seen]
        assert versions == sorted(versions)          # never regresses
        assert versions[0] >= 1                      # first chunk changed it
        assert study.frontier_version == versions[-1]

    def test_pareto_update_reports_change(self):
        acc = ParetoAccumulator(("x", "y"))
        assert acc.update(CandidateTable(
            {"x": np.array([1.0, 2.0]), "y": np.array([2.0, 1.0])}))
        # strictly dominated chunk: no change
        assert not acc.update(CandidateTable(
            {"x": np.array([5.0]), "y": np.array([5.0])}))
        # an improving chunk flips it back on
        assert acc.update(CandidateTable(
            {"x": np.array([0.5]), "y": np.array([0.5])}))
        assert not acc.update(CandidateTable({"x": np.empty(0),
                                              "y": np.empty(0)}))


# ---- parity with the JAX package's service ----------------------------------

class TestParityWithReference:
    def test_hardware_submission_events_and_frontier_equal(self, tmp_path):
        """The same hardware-only submission (config and counts from a
        seed) through both services: equal event streams and a bit-for-bit
        equal frontier."""
        rng = np.random.default_rng(7)
        counts = [rng.integers(0, 48, size=3).astype(np.float64)
                  for _ in range(2)]
        runs = {}
        for label, (arch_, dse_, service_, sub_, wire_) in {
                "torch": (arch, dse, DSEService(
                    _cpu_cache(tmp_path / "cells")), Submission, to_wire),
                "jax": (jax_arch, jax_dse, JaxDSEService(
                    jax_workloads.TraceCache(root=str(tmp_path / "jax"))),
                        JaxSubmission, jax_to_wire)}.items():
            cfg, _, space = _hw_setup(package=(arch_, dse_))
            handle = service_.submit(sub_(
                tenant="t", name="hw", space=space, config=cfg,
                counts=[c.copy() for c in counts], chunk_size=48))
            service_.run_until_idle()
            assert handle.status == "completed"
            runs[label] = ([wire_(e) for e in handle.events()],
                           handle.frontier.columns)
        (ev_t, cols_t), (ev_j, cols_j) = runs["torch"], runs["jax"]
        assert len(ev_t) > 3 and ev_t == ev_j
        assert cols_t.keys() == cols_j.keys()
        for k in cols_t:
            assert np.asarray(cols_t[k]).dtype == np.asarray(cols_j[k]).dtype
            np.testing.assert_array_equal(cols_t[k], cols_j[k])
