"""Elastic multi-host cell farm: workers coordinate through the cache root.

``cellfarm`` scales cell training to one machine's process pool; this
module scales it to a *fleet*.  The only shared substrate is the trace
cache root (``repro_torch.core.workloads.cache``) — an NFS-style
directory every enrolled host mounts — and every coordination primitive
lives inside it:

* **Job spool** — ``<root>/queue/<key>.job`` holds one wire-format
  :class:`~repro_torch.distributed.cellfarm.CellJob`
  (``serve.protocol.to_wire`` JSON, atomically published via tmp +
  ``os.replace``).  Submitting studies
  spool their pending cells; any worker on any host may pick one up.  A
  ``<key>.error`` sidecar in the same directory carries a training failure
  back to the submitter.
* **Lease** — ``<root>/<key>/.lease``, created with ``O_CREAT | O_EXCL``
  (atomic on POSIX and on NFSv3+ for exclusive create), carries the worker
  id; its **mtime is the heartbeat**, renewed by the holder every
  ``ttl / 4``.  Exactly one claimant wins a cell.  Any party — another
  worker or the submitting study — may *break* a lease whose heartbeat is
  older than ``lease_ttl()`` (``REPRO_FLEET_LEASE_TTL``, seconds) and
  reclaim the cell: this is the ``fault_tolerance.TrainSupervisor`` restart
  idiom (missing heartbeat => restore + retry) lifted from one training
  loop to the fleet.
* **Publish** — unchanged: the content-addressed ``TraceCache`` write path
  (checkpoint first, ``meta.msgpack`` last, both atomic).  A published cell
  is the *commit record*; leases and spool files are advisory and may be
  lost at any time without corrupting anything, because duplicate training
  is deterministic and the last atomic publish wins.

``FleetWorker.run()`` is the worker loop (claim -> heartbeat -> train ->
publish -> release); ``resolve_cluster`` is the submitter side
(``cellfarm.resolve_cells(..., workers="cluster")`` delegates here): spool
pending jobs, block on lease/publish progress, break stale leases, and
fall back to in-process training for any cell the fleet shows no progress
on within ``timeout`` seconds — so ``explore(workers="cluster")`` always
completes even with zero live workers.

Failure matrix (DESIGN.md §16): worker killed mid-train -> heartbeat goes
stale -> lease broken -> cell reclaimed; two claimants race -> ``O_EXCL``
picks one; torn meta on the network store -> quarantined as missing
(``TraceCache._read_meta``); submitter dies -> spool files remain and any
worker (or the resubmitted study) drains them.

Devices: a worker trains on its ``device`` and the submitter's in-process
reclaim on the ``device`` it was given (``None`` means the card for both).
A worker whose kernels fail to build or launch ships the error as the
``.error`` sidecar; nothing retries a cell on the CPU.  A fleet's workers
and its submitter use one package's root: the JAX package's cell under a
key is not this package's bytes, and both packages share this wire format.
"""
from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
import uuid
from typing import Optional, Sequence

from repro_torch.core.workloads.cache import TraceCache
from repro_torch.device import DeviceLike
from repro_torch.distributed.cellfarm import CellJob, CellOutcome, _job_key
from repro_torch.serve import protocol

log = logging.getLogger(__name__)

_LEASE = ".lease"
_QUEUE = "queue"
_JOB_SUFFIX = ".job"
_ERROR_SUFFIX = ".error"


def lease_ttl() -> float:
    """Seconds without a heartbeat before a lease is breakable
    (``REPRO_FLEET_LEASE_TTL``; resolved per call so tests and deployments
    can retune a running process)."""
    return float(os.environ.get("REPRO_FLEET_LEASE_TTL", "30"))


def poll_interval() -> float:
    """Queue/progress polling period (``REPRO_FLEET_POLL``)."""
    return float(os.environ.get("REPRO_FLEET_POLL", "0.1"))


def cluster_timeout(ttl: float) -> float:
    """Submitter-side no-progress window before the in-process fallback
    (``REPRO_FLEET_TIMEOUT``; default twice the lease TTL so a live
    worker's heartbeat always lands inside it)."""
    env = os.environ.get("REPRO_FLEET_TIMEOUT")
    return float(env) if env else 2.0 * ttl


def default_worker_id() -> str:
    return f"{socket.gethostname()}-{os.getpid()}-{uuid.uuid4().hex[:6]}"


# ---------------------------------------------------------------------------
# Leases
# ---------------------------------------------------------------------------

class Lease:
    """A held claim on one cell.  The file's mtime is the heartbeat;
    ``renew`` touches it.  ``lost`` flips when a renewal finds the file
    gone — someone judged us dead and broke the lease.  The holder keeps
    training anyway: publish is atomic and training deterministic, so the
    worst case is duplicate work, never corruption."""

    def __init__(self, path: str, worker_id: str):
        self.path = path
        self.worker_id = worker_id
        self.lost = False

    def renew(self) -> bool:
        try:
            with open(self.path) as f:
                if f.read() != self.worker_id:
                    self.lost = True     # broken and re-claimed: the file
                    return False         # at this path is someone else's
            os.utime(self.path)
            return True
        except FileNotFoundError:
            self.lost = True
            return False

    def release(self) -> None:
        try:
            with open(self.path) as f:
                if f.read() != self.worker_id:
                    return               # re-claimed: not ours to unlink
            os.unlink(self.path)
        except FileNotFoundError:
            pass


def _lease_path(root: str, key: str) -> str:
    return os.path.join(root, key, _LEASE)


def _try_break(path: str, ttl: float) -> bool:
    """Break the lease at ``path`` iff its heartbeat is older than ``ttl``.
    The steal is a rename to a unique name, so concurrent breakers race on
    ``os.rename`` and exactly one wins; the winner re-checks the stolen
    file's mtime to shrink the stat->rename TOCTOU window from the full TTL
    to microseconds.  Returns True when the named lease no longer exists
    (broken here or already gone)."""
    try:
        st = os.stat(path)
    except FileNotFoundError:
        return True
    if time.time() - st.st_mtime < ttl:
        return False
    steal = f"{path}.stale-{uuid.uuid4().hex[:8]}"
    try:
        os.rename(path, steal)
    except FileNotFoundError:
        return True                     # another breaker won the race
    fresh = False
    try:
        fresh = time.time() - os.stat(steal).st_mtime < ttl
    except FileNotFoundError:
        pass
    os.unlink(steal)
    if fresh:
        # the holder renewed between our stat and rename; its lease file is
        # gone now (it will see lost=True and keep training — benign
        # duplicate work at worst), but do NOT claim we broke a dead lease
        log.warning("stole a live lease %s; holder demoted to leaseless "
                    "(duplicate training possible, publish stays atomic)",
                    path)
        return False
    return True


def acquire(root: str, key: str, worker_id: str,
            ttl: Optional[float] = None) -> Optional[Lease]:
    """Atomically claim the cell ``key``: create ``<root>/<key>/.lease``
    with ``O_CREAT | O_EXCL``.  A stale existing lease (heartbeat older
    than ``ttl``) is broken first.  Returns the held lease, or None when a
    live claimant holds it."""
    ttl = lease_ttl() if ttl is None else ttl
    path = _lease_path(root, key)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    for _ in range(2):                   # once, plus once after a break
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            if not _try_break(path, ttl):
                return None
            continue
        with os.fdopen(fd, "w") as f:
            f.write(worker_id)
        return Lease(path, worker_id)
    return None


class _Heartbeat(threading.Thread):
    """Renew a lease every ``ttl / 4`` until stopped (daemon thread, so a
    hung training step cannot outlive the process and keep the lease
    fresh forever)."""

    def __init__(self, lease: Lease, ttl: float):
        super().__init__(name=f"lease-heartbeat-{lease.worker_id}",
                         daemon=True)
        self.lease = lease
        self.period = max(ttl / 4.0, 0.01)
        # NB: not named _stop — threading.Thread has a private _stop method
        # that join() calls internally
        self._halt = threading.Event()

    def run(self) -> None:
        while not self._halt.wait(self.period):
            if not self.lease.renew():
                return                   # lease broken under us; stop

    def stop(self) -> None:
        self._halt.set()
        self.join()


# ---------------------------------------------------------------------------
# Job spool
# ---------------------------------------------------------------------------

def _queue_dir(root: str) -> str:
    return os.path.join(root, _QUEUE)


def _spool_path(root: str, key: str) -> str:
    return os.path.join(_queue_dir(root), key + _JOB_SUFFIX)


def _error_path(root: str, key: str) -> str:
    return os.path.join(_queue_dir(root), key + _ERROR_SUFFIX)


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass


def spool(root: str, jobs: Sequence[CellJob]) -> list[str]:
    """Publish ``jobs`` into ``<root>/queue/`` (idempotent: an already
    spooled key is left alone; a stale ``.error`` sidecar from a previous
    attempt is cleared).  Returns the job keys, in job order."""
    qdir = _queue_dir(root)
    os.makedirs(qdir, exist_ok=True)
    keys = []
    for job in jobs:
        key = _job_key(job)
        keys.append(key)
        _unlink(_error_path(root, key))
        path = _spool_path(root, key)
        if os.path.exists(path):
            continue
        tmp = f"{path}.tmp-{uuid.uuid4().hex[:8]}"
        with open(tmp, "w") as f:
            json.dump(protocol.to_wire(job), f)
        os.replace(tmp, path)
    return keys


def _read_job(path: str) -> Optional[CellJob]:
    try:
        with open(path) as f:
            return protocol.from_wire(json.load(f))
    except FileNotFoundError:
        return None
    except (json.JSONDecodeError, ValueError, TypeError, KeyError) as e:
        log.warning("unreadable spooled job %s (%s: %s); skipping",
                    path, type(e).__name__, e)
        return None


def _write_error(root: str, key: str, message: str) -> None:
    path = _error_path(root, key)
    tmp = f"{path}.tmp-{uuid.uuid4().hex[:8]}"
    with open(tmp, "w") as f:
        f.write(message)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Worker
# ---------------------------------------------------------------------------

class FleetWorker:
    """One elastic cell-farm worker: poll the spool, claim a cell by
    lease, train-or-load it through the shared ``TraceCache``, publish,
    release.  Enroll a host by running any number of these against the
    shared root — no registration, no coordinator process."""

    def __init__(self, root: str, worker_id: Optional[str] = None,
                 ttl: Optional[float] = None,
                 poll: Optional[float] = None,
                 device: DeviceLike = None):
        self.root = root
        self.worker_id = worker_id or default_worker_id()
        self.ttl = lease_ttl() if ttl is None else float(ttl)
        self.poll = poll_interval() if poll is None else float(poll)
        self.cache = TraceCache(root=root, device=device)
        self.stats = {"cells_trained": 0, "cells_failed": 0,
                      "cells_skipped": 0, "lease_takeovers": 0}

    # ---- claim -------------------------------------------------------------
    def _claim(self) -> Optional[tuple[CellJob, Lease, str]]:
        qdir = _queue_dir(self.root)
        if not os.path.isdir(qdir):
            return None
        try:
            names = sorted(os.listdir(qdir))
        except FileNotFoundError:
            return None
        for name in names:
            if not name.endswith(_JOB_SUFFIX):
                continue
            key = name[:-len(_JOB_SUFFIX)]
            path = os.path.join(qdir, name)
            if self.cache.contains_key(key):
                _unlink(path)            # already published; drain the spool
                continue
            lease_existed = os.path.exists(_lease_path(self.root, key))
            lease = acquire(self.root, key, self.worker_id, ttl=self.ttl)
            if lease is None:
                continue                 # live claimant; try the next job
            if lease_existed:
                self.stats["lease_takeovers"] += 1
            job = _read_job(path)
            if job is None:              # drained or torn since listing
                lease.release()
                continue
            return job, lease, path
        return None

    # ---- work --------------------------------------------------------------
    def _work(self, job: CellJob, lease: Lease, spool_path: str) -> None:
        hb = _Heartbeat(lease, self.ttl)
        hb.start()
        try:
            art = self.cache.resolve(job.workload, job.assignment,
                                     seed=job.seed,
                                     quant_bits=job.quant_bits)
        except KeyboardInterrupt:
            raise
        except BaseException as e:                       # noqa: BLE001
            self.stats["cells_failed"] += 1
            msg = f"{type(e).__name__}: {e}"
            log.warning("cell %s failed on %s: %s",
                        _job_key(job), self.worker_id, msg)
            _write_error(self.root, _job_key(job), msg)
        else:
            if art.cache_hit:            # raced a concurrent publisher
                self.stats["cells_skipped"] += 1
            else:
                self.stats["cells_trained"] += 1
        finally:
            hb.stop()
            _unlink(spool_path)
            lease.release()

    def run(self, max_cells: Optional[int] = None,
            idle_timeout: Optional[float] = None) -> dict:
        """The worker loop: claim and train until ``max_cells`` cells were
        worked (trained or failed) or the spool stayed empty for
        ``idle_timeout`` seconds (None = run forever).  Returns ``stats``.
        """
        idle_since = time.time()
        while True:
            worked = self.stats["cells_trained"] + self.stats["cells_failed"]
            if max_cells is not None and worked >= max_cells:
                return self.stats
            claimed = self._claim()
            if claimed is None:
                if (idle_timeout is not None
                        and time.time() - idle_since > idle_timeout):
                    return self.stats
                time.sleep(self.poll)
                continue
            self._work(*claimed)
            idle_since = time.time()


def run_worker(root: str, worker_id: Optional[str] = None,
               max_cells: Optional[int] = None,
               idle_timeout: Optional[float] = None,
               ttl: Optional[float] = None,
               stats_path: Optional[str] = None,
               device: DeviceLike = None) -> dict:
    """Module-level worker entry point (spawnable by ``multiprocessing``
    and importable from a shell:
    ``python -c "from repro_torch.distributed.fleet import run_worker; ..."``).
    Writes ``stats`` as JSON to ``stats_path`` on exit when given.  The
    worker trains on ``device``, the card unless told otherwise."""
    worker = FleetWorker(root, worker_id=worker_id, ttl=ttl, device=device)
    try:
        return worker.run(max_cells=max_cells, idle_timeout=idle_timeout)
    finally:
        if stats_path is not None:
            tmp = f"{stats_path}.tmp"
            with open(tmp, "w") as f:
                json.dump({"worker_id": worker.worker_id, **worker.stats}, f)
            os.replace(tmp, stats_path)


# ---------------------------------------------------------------------------
# Submitter side: cluster resolution
# ---------------------------------------------------------------------------

def resolve_cluster(jobs: Sequence[CellJob], root: str,
                    timeout: Optional[float] = None,
                    ttl: Optional[float] = None,
                    poll: Optional[float] = None,
                    fallback: bool = True,
                    device: DeviceLike = None) -> list[CellOutcome]:
    """Resolve ``jobs`` through the fleet: spool the pending ones and block
    until every cell is published (by any worker on any host) or errored.
    One outcome per job, in job order — the contract of
    ``cellfarm.resolve_cells``, which delegates here for
    ``workers="cluster"``.

    **Progress** for a cell is a fresh lease heartbeat or its publish; a
    cell with no progress for ``timeout`` seconds (default
    ``cluster_timeout``: twice the lease TTL) is *reclaimed* by the
    submitter — the stale lease is broken, the spool entry withdrawn, and
    with ``fallback=True`` the cell trains in-process (under its own
    heartbeated lease), so the study completes even when every worker died
    or none ever existed.  ``trained`` in the outcome means the cell was
    published during this resolution (by the fleet or the fallback) — the
    unit the caller's budget accounting charges, exactly as for the
    process farm.  The reclaim trains on ``device``, the submitter's cache
    device (the card unless told otherwise)."""
    jobs = list(jobs)
    if not jobs:
        return []
    ttl = lease_ttl() if ttl is None else float(ttl)
    timeout = cluster_timeout(ttl) if timeout is None else float(timeout)
    poll = poll_interval() if poll is None else float(poll)
    cache = TraceCache(root=root, device=device)
    my_id = f"submitter-{default_worker_id()}"

    outcomes: list[Optional[CellOutcome]] = [None] * len(jobs)
    keys = [_job_key(job) for job in jobs]
    for i, key in enumerate(keys):
        if cache.contains_key(key):
            outcomes[i] = CellOutcome(key=key, trained=False)
    pending = [i for i, out in enumerate(outcomes) if out is None]
    spool(root, [jobs[i] for i in pending])
    log.info("fleet: %d cell(s) spooled to %s (%d already published)",
             len(pending), _queue_dir(root), len(jobs) - len(pending))

    now = time.time()
    last_progress = {i: now for i in pending}
    last_beat: dict[int, float] = {}
    while pending:
        still = []
        for i in pending:
            key = keys[i]
            if cache.contains_key(key):
                # published during this resolution: a miss happened for
                # this resolution round (fleet-trained counts as farmed)
                outcomes[i] = CellOutcome(key=key, trained=True)
                _unlink(_error_path(root, key))
                _unlink(_spool_path(root, key))
                continue
            err = _read_error(root, key)
            if err is not None:
                outcomes[i] = CellOutcome(key=key, trained=False, error=err)
                _unlink(_error_path(root, key))
                continue
            try:
                beat = os.stat(_lease_path(root, key)).st_mtime
            except FileNotFoundError:
                beat = None
            if beat is not None and beat != last_beat.get(i):
                last_beat[i] = beat
                last_progress[i] = time.time()
            if time.time() - last_progress[i] > timeout:
                out = _reclaim(jobs[i], key, root, my_id, ttl, fallback,
                               device)
                if out is None:          # a live claimant appeared mid-break
                    last_progress[i] = time.time()
                    still.append(i)
                else:
                    outcomes[i] = out
                continue
            still.append(i)
        pending = still
        if pending:
            time.sleep(poll)
    return outcomes


def _read_error(root: str, key: str) -> Optional[str]:
    try:
        with open(_error_path(root, key)) as f:
            return f.read() or "fleet worker failed (no message)"
    except FileNotFoundError:
        return None


def _reclaim(job: CellJob, key: str, root: str, my_id: str, ttl: float,
             fallback: bool, device: DeviceLike = None
             ) -> Optional[CellOutcome]:
    """No fleet progress on ``key`` within the window: break its stale
    lease and train in-process (the submitting study is just another
    claimant).  None means a live lease blocked the reclaim — treat as
    progress and keep waiting."""
    lease = acquire(root, key, my_id, ttl=ttl)
    if lease is None:
        return None
    if not fallback:
        lease.release()
        return CellOutcome(key=key, trained=False,
                           error=f"fleet made no progress on {key} "
                                 f"(fallback disabled)")
    log.warning("fleet: no progress on cell %s; reclaiming for in-process "
                "training", key)
    _unlink(_spool_path(root, key))      # withdrawn: workers must not race
    hb = _Heartbeat(lease, ttl)
    hb.start()
    try:
        from repro_torch.distributed.cellfarm import _resolve_job
        return _resolve_job((job, root, device))
    finally:
        hb.stop()
        lease.release()
