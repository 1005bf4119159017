"""Parallel model-cell training: shard pending cells across processes.

The co-exploration trace cache (``repro_torch.core.workloads.cache``) is
content-addressed and publishes atomically, so concurrent trainers of the
same cell race benignly and trainers of *different* cells never interact;
that makes farming the cell list across worker processes safe without any
coordination beyond a shared cache root.  This module does that: give it
the pending ``(workload, assignment)`` jobs and a cache root, and it
shards them over a spawned-process pool; afterwards every farmed cell
resolves as a cache hit in the parent.

Pool discipline: workers are spawned, not forked (CUDA is not fork-safe
once initialized), and each makes its own CUDA context; on one card the
workers share it.  The pool size is capped at ``min(jobs, cpu_count,
MAX_POOL_WORKERS)``, the pool is REUSED across calls within one process
(the steps of one ``explore()`` share the already-imported workers;
``atexit`` tears it down), and job submission is chunked so each worker
unpickles one slab of jobs.  The kernels' libraries are built once per
checkout: a worker that finds them missing builds them under a temporary
name and renames it into place (``kernels/build.py``), so two workers never
load half a library.

``stack=True`` prefers *stacked* training over process farming: jobs are
grouped by ``cellstack.stack_signature`` and every group that can share a
slab (two or more cells, or every group when too few workers make farming
moot) trains in-process as one slab (``repro_torch.distributed.cellstack``);
only leftover singletons go to the pool.

``device`` is the device every cache of the farm trains on, the parent's
(``Study`` passes its cache's); ``None`` means the card.

Fault containment: ``resolve_cells`` never raises on a bad cell.  A
worker's exception returns as a failed ``CellOutcome``, a hard pool crash
tears the pool down and rebuilds it, and both are retried up to
``MAX_RETRIES`` rounds before the failure ships in ``CellOutcome.error``
for the caller to fall back on.

``workers="cluster"`` farms across hosts instead: the jobs spool to the
cache root, where lease-holding ``fleet.FleetWorker`` processes train them
(``repro_torch.distributed.fleet``).
"""
from __future__ import annotations

import atexit
import dataclasses
import logging
import multiprocessing
import os
from typing import Optional, Sequence, Union

from repro_torch.core.workloads.cache import TraceCache, cell_key
from repro_torch.core.workloads.registry import Workload
from repro_torch.device import DeviceLike

log = logging.getLogger(__name__)

#: hard cap on spawned workers: each is a full interpreter with its own
#: torch import and CUDA context, so "one per job" stops paying off long
#: before the CPU count on big hosts
MAX_POOL_WORKERS = int(os.environ.get("REPRO_CELLFARM_MAX_WORKERS", "8"))

#: bounded-retry budget for failed cells: a crashed worker or a raising job
#: is retried this many extra rounds before its outcome ships with
#: ``error`` set; it never raises through the caller (``Study._farm_chunk``)
MAX_RETRIES = int(os.environ.get("REPRO_CELLFARM_MAX_RETRIES", "2"))

_pool = None
_pool_size = 0


@dataclasses.dataclass(frozen=True)
class CellJob:
    """One cell to train-or-load: everything a worker needs, picklable."""
    workload: Workload
    assignment: dict               # {"num_steps": T, "population": p}
    seed: int = 0
    quant_bits: tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class CellOutcome:
    key: str                       # content address in the shared cache
    trained: bool                  # True = this worker trained it (a miss)
    #: set when the cell could not be resolved after ``MAX_RETRIES`` retry
    #: rounds: the cache holds nothing for it and nothing was charged;
    #: callers fall back to in-process resolution (or skip)
    error: Optional[str] = None


def _job_key(job: CellJob) -> str:
    norm = {"num_steps": int(job.assignment["num_steps"]),
            "population": float(job.assignment.get("population", 1.0))}
    return cell_key(job.workload, norm, job.seed)


def _resolve_job(args: tuple[CellJob, str, Optional[str]]) -> CellOutcome:
    """Worker entry point: resolve one cell against the shared cache root
    on ``device``.  Module-level so the spawn pickler can import it by
    reference.  Any job-level failure is *returned* as a failed outcome,
    never raised: a worker must not poison the whole slab it was mapped."""
    job, root, device = args
    try:
        cache = TraceCache(root=root, device=device)
        art = cache.resolve(job.workload, job.assignment, seed=job.seed,
                            quant_bits=job.quant_bits)
        return CellOutcome(key=art.key, trained=not art.cache_hit)
    except KeyboardInterrupt:
        raise
    except BaseException as e:                           # noqa: BLE001
        return CellOutcome(key=_job_key(job), trained=False,
                           error=f"{type(e).__name__}: {e}")


def _worker_count(n_jobs: int, workers: Optional[int]) -> int:
    """Effective pool size: explicit request, else one per job, both
    capped at the CPU count and the module-level ``MAX_POOL_WORKERS``."""
    return min(workers if workers is not None else n_jobs,
               n_jobs, multiprocessing.cpu_count(), MAX_POOL_WORKERS)


def _get_pool(workers: int):
    """The shared spawn pool, rebuilt only when the requested size changes:
    repeated ``resolve_cells`` calls reuse the already-imported workers
    instead of paying a fresh interpreter and torch import per call."""
    global _pool, _pool_size
    if _pool is not None and _pool_size != workers:
        shutdown_pool()
    if _pool is None:
        ctx = multiprocessing.get_context("spawn")   # CUDA is not fork-safe
        _pool = ctx.Pool(processes=workers)
        _pool_size = workers
    return _pool


def shutdown_pool() -> None:
    """Tear down the shared worker pool (idempotent; re-created lazily)."""
    global _pool, _pool_size
    if _pool is not None:
        _pool.terminate()
        _pool.join()
        _pool = None
        _pool_size = 0


atexit.register(shutdown_pool)


def _farm_attempt(args: Sequence[tuple[CellJob, str, Optional[str]]],
                  workers: Optional[int]) -> list[CellOutcome]:
    """One farming round.  Job-level failures come back as failed outcomes
    from ``_resolve_job``; a *pool*-level crash (a worker process died hard
    enough to break the map) marks every in-flight job failed and tears the
    poisoned pool down, so the next attempt gets a fresh one."""
    args = list(args)
    n = _worker_count(len(args), workers)
    if n <= 1 or len(args) == 1:
        return [_resolve_job(a) for a in args]
    # chunked submission: one slab per worker, not one pickle round-trip
    # per job
    chunksize = max(1, (len(args) + n - 1) // n)
    try:
        return _get_pool(n).map(_resolve_job, args, chunksize=chunksize)
    except Exception as e:                               # noqa: BLE001
        shutdown_pool()
        err = f"worker pool crashed: {type(e).__name__}: {e}"
        log.warning("%s (%d cell(s) in flight)", err, len(args))
        return [CellOutcome(key=_job_key(job), trained=False, error=err)
                for job, _, _ in args]


def resolve_cells(jobs: Sequence[CellJob], root: str,
                  workers: Union[int, str, None] = None,
                  stack: bool = False,
                  max_stack: Optional[int] = None,
                  retries: Optional[int] = None,
                  device: DeviceLike = None) -> list[CellOutcome]:
    """Resolve ``jobs`` into the cache at ``root`` on ``device``; returns
    one outcome per job, in job order.  ``workers`` bounds the process pool
    (default: one per job, capped at the CPU count and
    ``MAX_POOL_WORKERS``).

    ``workers="cluster"`` farms across *hosts* instead of processes: jobs
    spool to ``<root>/queue/`` and any ``fleet.FleetWorker`` enrolled on
    the shared root claims them by lease (``repro_torch.distributed.fleet``).
    The call blocks on lease/publish progress and falls back to in-process
    training on ``device`` for cells the fleet makes no progress on, so it
    completes even with zero live workers.  Failed outcomes ship with
    ``CellOutcome.error`` exactly like the process farm (the fleet path
    has its own reclaim machinery, so the local retry loop does not
    re-enter it); ``stack`` does not apply.

    ``stack=True`` routes same-signature groups through the in-process
    slab trainer first (``cellstack.resolve_stacked``): with a usable pool
    (two or more effective workers) only groups of two or more cells stack
    and singletons still farm in parallel; without one, everything stacks
    in-process (a slab of one cell is the solo loop, minus the spawn).

    This function **never raises on a bad cell**: a crashed worker, a
    poisoned pool, or a job that errors is retried up to ``retries``
    (default ``MAX_RETRIES``) extra rounds and then returned with
    ``CellOutcome.error`` set, so one bad cell cannot kill a study.  A
    failed stack group falls back to farming before counting as a retry.

    The parent's own ``TraceCache`` counters are untouched; count
    ``trained`` outcomes for miss accounting."""
    jobs = list(jobs)
    if not jobs:
        return []
    if workers == "cluster":
        from repro_torch.distributed import fleet   # fleet imports this
        return fleet.resolve_cluster(jobs, root, device=device)
    if isinstance(workers, str):
        raise ValueError(f"workers must be an int or 'cluster', "
                         f"got {workers!r}")
    dev = None if device is None else str(device)
    retries = MAX_RETRIES if retries is None else int(retries)
    outcomes: list[Optional[CellOutcome]] = [None] * len(jobs)

    if stack:
        from repro_torch.distributed import cellstack   # imports this module
        groups = cellstack.group_jobs(jobs)
        if _worker_count(len(jobs), workers) >= 2:
            stacked_idx = sorted(i for idxs in groups.values()
                                 if len(idxs) >= 2 for i in idxs)
        else:
            stacked_idx = list(range(len(jobs)))
        if stacked_idx:
            kw = {} if max_stack is None else {"max_stack": max_stack}
            try:
                got = cellstack.resolve_stacked(
                    [jobs[i] for i in stacked_idx], root, device=dev, **kw)
            except Exception as e:                       # noqa: BLE001
                # a failed in-process slab is not fatal: its cells fall
                # through to the farm/serial path below untouched
                log.warning("stacked training failed (%s: %s); falling "
                            "back to farming %d cell(s)",
                            type(e).__name__, e, len(stacked_idx))
            else:
                for i, out in zip(stacked_idx, got):
                    outcomes[i] = out

    pending = [i for i in range(len(jobs)) if outcomes[i] is None]
    attempt = 0
    while pending:
        got = _farm_attempt([(jobs[i], root, dev) for i in pending], workers)
        for i, out in zip(pending, got):
            outcomes[i] = out
        pending = [i for i in pending if outcomes[i].error is not None]
        if not pending:
            break
        attempt += 1
        if attempt > retries:
            log.warning("giving up on %d cell(s) after %d retry round(s): "
                        "%s", len(pending), retries,
                        [outcomes[i].error for i in pending[:3]])
            break
        log.warning("retrying %d failed cell(s), round %d/%d",
                    len(pending), attempt, retries)
    return outcomes


__all__ = ["CellJob", "CellOutcome", "MAX_POOL_WORKERS", "MAX_RETRIES",
           "resolve_cells", "shutdown_pool"]
