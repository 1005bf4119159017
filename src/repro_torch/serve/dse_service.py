"""DSE-as-a-service: a long-running, multi-tenant exploration service.

``dse.explore`` is a blocking library call on one interpreter; this module
is the service layer the ROADMAP's "heavy traffic" story needs on top of
it, built entirely from existing library contracts:

* **Concurrency** — every admitted study is driven cooperatively through
  incremental ``Study.step()`` rounds on one scheduler loop (round-robin,
  one round per study per turn), so N tenants' studies interleave without
  thread-per-study state.  Pending cell training still fans out over the
  shared ``cellfarm`` process pool / ``cellstack`` vmapped stacks when the
  service is constructed with ``workers``/``stack`` — and over *hosts*
  with ``workers="cluster"``: a service whose ``TraceCache`` root sits on
  an NFS-style mount spools every study's pending cells to the root's job
  queue, where lease-holding ``fleet.FleetWorker`` processes on every
  enrolled machine drain them (``repro_torch.distributed.fleet``),
  saturating the whole fleet from one scheduler.
* **Dedup for free** — all tenants share one content-addressed
  ``TraceCache``: the first study to reach a model cell trains it, every
  later study (any tenant) resolves it as a hit.  Overlapping cells across
  concurrent studies train at most once — the cross-tenant ``hit_rate`` in
  ``Progress`` events measures exactly this.
* **Admission control** — a bounded pending queue (past ``max_pending``:
  rejected), at most ``max_active`` concurrently stepping studies (past
  capacity: queued), and per-tenant training quotas mapped onto shared
  ``TrainingBudget`` objects (all of one tenant's studies charge the same
  budget; ``reject_over_quota`` optionally bounces submissions from
  exhausted tenants at the door).  Budgets are thread-safe, so tenant
  studies stepping from other drivers share them safely.
* **Streaming** — each handle owns a thread-safe event queue fed by the
  scheduler: monotone ``FrontierUpdate`` snapshots (the incremental Pareto
  merge never regresses) plus ``Progress`` cache/budget counters, typed per
  ``repro_torch.serve.protocol`` so a network transport is a serialization
  away.
* **Restart** — with a ``checkpoint_root``, studies checkpoint on eviction,
  on completion, and every ``checkpoint_every`` rounds (through ``Study``'s
  atomic sidecar protocol); resubmitting the same ``(tenant, name)`` —
  after an eviction or a full service restart — resumes via
  ``explore(..., resume=True)`` with **zero retraining**, and the tenant
  budgets round-trip through a ``service.json`` sidecar (written after
  study checkpoints, so it is always at least as fresh as any per-study
  budget copy).

Devices: cells train on the cache's device.  ``TraceCache()``, the
default, is the port's own root with cells on the card, and raises when
no card is present.  The background scheduler thread enters the cache's
card before it steps a study, since the CUDA runtime's current device is
per thread and the kernels launch on its current stream.

See DESIGN.md §15 and ``examples/torch_serve_dse.py``.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import queue
import threading
import time
from typing import Iterator, Optional, Union

import torch

from repro_torch.core import dse
from repro_torch.core.workloads import TraceCache, TrainingBudget
from repro_torch.serve.protocol import (Event, FrontierUpdate, Progress,
                                        StudyAccepted, StudyCompleted,
                                        StudyEvicted, StudyFailed,
                                        StudyRejected, StudyStarted,
                                        Submission, is_terminal)

_SERVICE_SIDECAR = "service.json"


class StudyHandle:
    """A client's view of one submitted study: its status, its event
    stream, and (after completion) the frontier/result surface."""

    def __init__(self, submission: Submission):
        self.submission = submission
        self.study_id = submission.study_id
        self.tenant = submission.tenant
        self.status = "pending"      # pending|active|completed|failed|
        #                              evicted|rejected
        self.study: Optional[dse.Study] = None
        self.error: Optional[str] = None
        self._events: "queue.Queue[Event]" = queue.Queue()
        self._seen_frontier_version = 0
        self._terminal = threading.Event()

    # ---- event stream ------------------------------------------------------
    def events(self) -> list[Event]:
        """Drain every event queued so far (non-blocking)."""
        out = []
        while True:
            try:
                out.append(self._events.get_nowait())
            except queue.Empty:
                return out

    def next_event(self, timeout: Optional[float] = None) -> Optional[Event]:
        """Next event, waiting up to ``timeout`` seconds (None = forever);
        None on timeout."""
        try:
            return self._events.get(timeout=timeout)
        except queue.Empty:
            return None

    def stream(self, timeout: Optional[float] = None) -> Iterator[Event]:
        """Yield events until (and including) a terminal event.  With the
        scheduler on a background thread this blocks like a subscription;
        ``timeout`` bounds each wait, raising on silence."""
        while True:
            event = self.next_event(timeout)
            if event is None:
                raise TimeoutError(
                    f"no event from {self.study_id} within {timeout}s")
            yield event
            if is_terminal(event):
                return

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the study reaches a terminal state."""
        return self._terminal.wait(timeout)

    # ---- results -----------------------------------------------------------
    @property
    def frontier(self):
        if self.study is None:
            raise RuntimeError(f"study {self.study_id} was never activated "
                               f"(status: {self.status})")
        return self.study.frontier

    @property
    def summary(self) -> dict:
        if self.study is None:
            return {"status": self.status}
        return {"status": self.status, **self.study.summary}

    # ---- service-side ------------------------------------------------------
    def _emit(self, event: Event) -> None:
        self._events.put(event)
        if is_terminal(event):
            self._terminal.set()


class DSEService:
    """The multi-tenant exploration service.  Drive it cooperatively
    (``tick()`` / ``run_until_idle()``) or on a background thread
    (``start()`` / ``stop()``); both paths share the same scheduler."""

    def __init__(self, cache: Optional[TraceCache] = None, *,
                 checkpoint_root: Optional[str] = None,
                 max_active: int = 2,
                 max_pending: int = 64,
                 tenant_quota: Optional[int] = None,
                 tenant_quotas: Optional[dict[str, int]] = None,
                 reject_over_quota: bool = False,
                 workers: Union[int, str] = 0,
                 stack: bool = False,
                 checkpoint_every: Optional[int] = None,
                 progress_every: int = 1):
        if max_active < 1:
            raise ValueError(f"max_active must be >= 1, got {max_active}")
        if max_pending < 0:
            raise ValueError(f"max_pending must be >= 0, got {max_pending}")
        self.cache = cache if cache is not None else TraceCache()
        self.checkpoint_root = checkpoint_root
        self.max_active = max_active
        self.max_pending = max_pending
        self.tenant_quota = tenant_quota
        self.tenant_quotas = dict(tenant_quotas or {})
        self.reject_over_quota = reject_over_quota
        self.workers = workers
        self.stack = stack
        self.checkpoint_every = checkpoint_every
        self.progress_every = max(1, int(progress_every))

        self._budgets: dict[str, Optional[TrainingBudget]] = {}
        self._handles: dict[str, StudyHandle] = {}
        self._pending: collections.deque[StudyHandle] = collections.deque()
        self._active: list[StudyHandle] = []
        self._lock = threading.Lock()        # guards queues + registries
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._counters = collections.Counter()
        self._persisted_budgets = self._read_sidecar()

    # ---- submission / admission -------------------------------------------
    def submit(self, submission: Submission) -> StudyHandle:
        """Admission control: reject on duplicate id, full queue, or (with
        ``reject_over_quota``) an exhausted tenant; otherwise queue.  The
        scheduler activates queued studies as slots free up."""
        handle = StudyHandle(submission)
        with self._lock:
            self._counters["submitted"] += 1
            reason = self._admission_reason(submission)
            if reason is not None:
                handle.status = "rejected"
                self._counters["rejected"] += 1
                self._handles.setdefault(handle.study_id, handle)
                self._emit(handle, StudyRejected(
                    handle.study_id, handle.tenant, reason=reason))
                return handle
            self._handles[handle.study_id] = handle
            self._pending.append(handle)
            self._emit(handle, StudyAccepted(
                handle.study_id, handle.tenant,
                position=len(self._pending) - 1))
        return handle

    def _admission_reason(self, sub: Submission) -> Optional[str]:
        live = self._handles.get(sub.study_id)
        if live is not None and live.status in ("pending", "active"):
            return f"study {sub.study_id} is already {live.status}"
        if len(self._pending) >= self.max_pending:
            return (f"pending queue is full "
                    f"({len(self._pending)}/{self.max_pending})")
        if self.reject_over_quota:
            budget = self._budget_for(sub.tenant)
            if budget is not None and budget.remaining <= 0:
                return (f"tenant {sub.tenant!r} training quota exhausted "
                        f"({budget.spent}/{budget.limit} misses)")
        return None

    def handle(self, study_id: str) -> StudyHandle:
        return self._handles[study_id]

    def budget(self, tenant: str) -> Optional[TrainingBudget]:
        """The tenant's shared training budget (None = unmetered)."""
        return self._budget_for(tenant)

    def _budget_for(self, tenant: str) -> Optional[TrainingBudget]:
        if tenant not in self._budgets:
            quota = self.tenant_quotas.get(tenant, self.tenant_quota)
            budget = None if quota is None else TrainingBudget(int(quota))
            if budget is not None and tenant in self._persisted_budgets:
                budget.load_state_dict(self._persisted_budgets[tenant])
            self._budgets[tenant] = budget
        return self._budgets[tenant]

    # ---- scheduling --------------------------------------------------------
    def tick(self) -> bool:
        """One scheduling turn: admit from the queue into free slots, then
        step every active study one round (emitting events).  Returns False
        when there is nothing active and nothing pending — idle."""
        self._admit()
        with self._lock:
            turn = list(self._active)
        for handle in turn:
            self._step_one(handle)
        self._admit()
        with self._lock:
            return bool(self._active or self._pending)

    def run_until_idle(self) -> None:
        """Drive the scheduler inline until every submitted study reached a
        terminal state (the cooperative single-thread mode)."""
        while self.tick():
            pass

    def start(self) -> None:
        """Run the scheduler on a background thread until ``stop()``."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="dse-service", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _loop(self) -> None:
        dev = self.cache.device
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            while not self._stop.is_set():
                if not self.tick():
                    time.sleep(0.005)      # idle: poll the submission queue

    def _admit(self) -> None:
        while True:
            with self._lock:
                if not self._pending or len(self._active) >= self.max_active:
                    return
                handle = self._pending.popleft()
                self._active.append(handle)
            self._activate(handle)

    def _activate(self, handle: StudyHandle) -> None:
        sub = handle.submission
        ck_dir = self._study_dir(sub)
        resume = (ck_dir is not None
                  and os.path.exists(os.path.join(ck_dir, "study.json")))
        try:
            strategy = (sub.strategy() if callable(sub.strategy)
                        else sub.strategy)
            kwargs = dict(strategy=strategy, objectives=sub.objectives,
                          chunk_size=sub.chunk_size, checkpoint_dir=ck_dir,
                          resume=resume, run=False)
            if self._is_joint(sub):
                kwargs.update(
                    workload=sub.workload, datasets=sub.datasets,
                    num_steps=sub.num_steps, population=sub.population,
                    max_lhr=sub.max_lhr, weight_bits=sub.weight_bits,
                    cache=self.cache, seed=sub.seed,
                    train_budget=self._budget_for(sub.tenant),
                    workers=self.workers, stack=self.stack)
            else:
                kwargs.update(config=sub.config, counts=sub.counts)
            study = dse.explore(sub.space, **kwargs)
        except Exception as e:                           # noqa: BLE001
            self._fail(handle, e)
            return
        if resume:
            # Study.load restored the checkpoint's budget copy into the
            # shared tenant budget; the service sidecar (written after
            # every study checkpoint) is at least as fresh — reapply it.
            self._restore_tenant_budget(sub.tenant)
        handle.study = study
        handle._seen_frontier_version = study.frontier_version
        handle.status = "active"
        handle._emit(StudyStarted(handle.study_id, handle.tenant,
                                  resumed=resume))
        if resume and study.frontier_version:
            self._emit_frontier(handle)     # restored frontier, first event
        if study.done:                      # resumed an already-done study
            self._complete(handle)

    @staticmethod
    def _is_joint(sub: Submission) -> bool:
        return (sub.workload is not None or sub.datasets is not None
                or sub.num_steps is not None or sub.population is not None
                or (sub.space is not None and bool(sub.space.model_axes)))

    def _step_one(self, handle: StudyHandle) -> None:
        if handle.status != "active":
            return
        study = handle.study
        try:
            advanced = study.step()
        except Exception as e:                           # noqa: BLE001
            self._fail(handle, e)
            return
        if not advanced:
            self._complete(handle)
            return
        if study.frontier_version != handle._seen_frontier_version:
            self._emit_frontier(handle)
        if study.rounds % self.progress_every == 0:
            self._emit_progress(handle)
        if (self.checkpoint_every and study.checkpoint_dir
                and study.rounds % self.checkpoint_every == 0):
            study.checkpoint()
            self._write_sidecar()

    # ---- lifecycle transitions --------------------------------------------
    def _complete(self, handle: StudyHandle) -> None:
        study = handle.study
        if study.checkpoint_dir:
            study.checkpoint()
        handle.status = "completed"
        with self._lock:
            self._deactivate(handle)
            self._counters["completed"] += 1
        self._emit(handle, StudyCompleted(handle.study_id, handle.tenant,
                                          summary=study.summary))
        self._write_sidecar()

    def _fail(self, handle: StudyHandle, error: Exception) -> None:
        handle.status = "failed"
        handle.error = f"{type(error).__name__}: {error}"
        with self._lock:
            self._deactivate(handle)
            self._counters["failed"] += 1
        self._emit(handle, StudyFailed(handle.study_id, handle.tenant,
                                       error=handle.error))

    def evict(self, study_id: str) -> Optional[str]:
        """Checkpoint and deactivate one active study, freeing its slot
        (capacity reclaim / shutdown).  Resubmitting the same (tenant,
        name) resumes it with zero retraining.  Returns the checkpoint
        directory (None when the service has no checkpoint_root — progress
        beyond the trained cells is dropped)."""
        handle = self._handles[study_id]
        if handle.status != "active":
            raise ValueError(f"study {study_id} is not active "
                             f"(status: {handle.status})")
        ck_dir = None
        if handle.study is not None and handle.study.checkpoint_dir:
            ck_dir = handle.study.checkpoint()
        handle.status = "evicted"
        with self._lock:
            self._deactivate(handle)
            self._counters["evicted"] += 1
        self._emit(handle, StudyEvicted(handle.study_id, handle.tenant,
                                        checkpoint_dir=ck_dir))
        self._write_sidecar()
        return ck_dir

    def shutdown(self) -> None:
        """Stop the scheduler and evict every active study (each one
        checkpoints when a checkpoint_root is set); pending studies stay
        pending in their handles but are dropped from the queue.  A new
        service on the same checkpoint_root + cache resumes resubmitted
        studies without retraining."""
        self.stop()
        with self._lock:
            active = list(self._active)
            self._pending.clear()
        for handle in active:
            self.evict(handle.study_id)
        self._write_sidecar()

    def _deactivate(self, handle: StudyHandle) -> None:
        if handle in self._active:
            self._active.remove(handle)

    # ---- event emission ----------------------------------------------------
    def _emit(self, handle: StudyHandle, event: Event) -> None:
        self._counters["events_emitted"] += 1
        handle._emit(event)

    def _emit_frontier(self, handle: StudyHandle) -> None:
        study = handle.study
        handle._seen_frontier_version = study.frontier_version
        frontier = {k: (v.tolist() if hasattr(v, "tolist") else list(v))
                    for k, v in study.frontier.columns.items()}
        self._emit(handle, FrontierUpdate(
            handle.study_id, handle.tenant, round=study.rounds,
            n_evaluated=study.n_evaluated,
            frontier_size=len(study.frontier),
            objectives=study.objectives, frontier=frontier))

    def _emit_progress(self, handle: StudyHandle) -> None:
        study = handle.study
        s = study.summary
        self._emit(handle, Progress(
            handle.study_id, handle.tenant, round=study.rounds,
            n_evaluated=study.n_evaluated,
            frontier_size=len(study.frontier),
            cells_resolved=s.get("cells_resolved", 0),
            cells_skipped=s.get("cells_skipped", 0),
            cache=s.get("cache", {}),
            budget=s.get("train_budget")))

    # ---- persistence -------------------------------------------------------
    def _study_dir(self, sub: Submission) -> Optional[str]:
        if self.checkpoint_root is None:
            return None
        return os.path.join(self.checkpoint_root, sub.tenant, sub.name)

    def _restore_tenant_budget(self, tenant: str) -> None:
        budget = self._budgets.get(tenant)
        if budget is not None and tenant in self._persisted_budgets:
            budget.load_state_dict(self._persisted_budgets[tenant])

    def _write_sidecar(self) -> None:
        """Persist the tenant budget states (atomically, after any study
        checkpoints) so a restarted service resumes quota accounting."""
        if self.checkpoint_root is None:
            return
        with self._lock:
            state = {"tenants": {t: b.state_dict()
                                 for t, b in self._budgets.items()
                                 if b is not None}}
            self._persisted_budgets.update(state["tenants"])
        os.makedirs(self.checkpoint_root, exist_ok=True)
        path = os.path.join(self.checkpoint_root, _SERVICE_SIDECAR)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, path)

    def _read_sidecar(self) -> dict:
        if self.checkpoint_root is None:
            return {}
        path = os.path.join(self.checkpoint_root, _SERVICE_SIDECAR)
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return dict(json.load(f).get("tenants", {}))

    # ---- introspection -----------------------------------------------------
    @property
    def stats(self) -> dict:
        """Service-level counters + the shared cache's hit/miss accounting
        (``hit_rate`` is the cross-tenant deduplication measure)."""
        with self._lock:
            out = {k: self._counters[k]
                   for k in ("submitted", "rejected", "completed", "failed",
                             "evicted", "events_emitted")}
            out["active"] = len(self._active)
            out["pending"] = len(self._pending)
        cache = dict(self.cache.stats)
        total = cache.get("hits", 0) + cache.get("misses", 0)
        cache["hit_rate"] = cache.get("hits", 0) / total if total else 0.0
        out["cache"] = cache
        return out
