"""Typed protocol for the DSE service: submissions in, events out.

The service (``repro_torch.serve.dse_service``) is transport-agnostic: clients
hand it a :class:`Submission` and read a stream of event dataclasses from
the returned handle.  Every event is **plain data** — frozen dataclasses of
ints/floats/strings/dicts — so the in-process queue transport used today
and a network transport later (JSON over a socket, a log stream, a pub/sub
topic) serialize the exact same objects: ``to_wire`` flattens an event to a
``{"event": kind, ...}`` dict and ``from_wire`` parses it back, round-trip
exact (tests/test_torch_dse_service.py).

Event lifecycle of one submission::

    StudyAccepted ─┬─> StudyStarted ──> (FrontierUpdate | Progress)* ─┐
                   │                                                  │
    StudyRejected ─┘          StudyEvicted <── evict() ───────────────┤
      (terminal)                (resubmit to resume)                  │
                                          StudyCompleted | StudyFailed
                                                   (terminal)

``FrontierUpdate`` events are **monotone**: the driver's incremental
Pareto merge only ever improves the frontier, so in any two successive
updates every earlier point is either still present or dominated by a
newer one — clients can render each snapshot as-is, no reconciliation.
``Progress`` events carry the evaluation/cache/budget counters
(cross-tenant dedup shows up here as hits on cells another tenant
trained).

The :class:`Submission` mirrors ``dse.explore``'s surface.  In-process it
carries live objects (``SearchSpace``, ``Workload``, strategy); a network
transport would serialize these — the *event* side needs no such work.
``strategy`` may be a zero-arg factory: the service calls it per study
construction, so a resubmission after a service restart gets the fresh,
identically-configured instance ``Study.load``'s signature guard demands.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Union


@dataclasses.dataclass(frozen=True)
class Submission:
    """One tenant's study request: which space to explore, under what
    training quota accounting (the service attaches the tenant's shared
    ``TrainingBudget``), against the service-wide shared trace cache.

    ``(tenant, name)`` identifies the study; resubmitting the same pair
    after an eviction or a service restart resumes from its checkpoint.
    """
    tenant: str
    name: str
    # the exploration definition (mirrors dse.explore)
    space: Any = None                      # SearchSpace | None
    workload: Any = None                   # str | Workload | None
    datasets: Optional[Sequence] = None
    num_steps: Optional[Sequence[int]] = None
    population: Optional[Sequence[float]] = None
    max_lhr: Optional[int] = None
    weight_bits: Optional[Sequence[int]] = None
    # hardware-only evaluation context
    config: Any = None                     # AcceleratorConfig | None
    counts: Optional[Sequence] = None
    # search
    strategy: Union[str, Callable, Any] = "grid"   # instance | factory | name
    objectives: Optional[tuple[str, ...]] = None
    chunk_size: int = 65536
    seed: int = 0

    def __post_init__(self):
        for field in ("tenant", "name"):
            value = getattr(self, field)
            if not value or not str(value).replace("-", "").replace(
                    "_", "").replace(".", "").isalnum():
                raise ValueError(
                    f"{field} must be a non-empty [A-Za-z0-9._-] string "
                    f"(it names the study's checkpoint directory), "
                    f"got {value!r}")

    @property
    def study_id(self) -> str:
        return f"{self.tenant}/{self.name}"


# ---- events ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Event:
    """Base event: every event names the study and tenant it belongs to."""
    study_id: str
    tenant: str


@dataclasses.dataclass(frozen=True)
class StudyAccepted(Event):
    """Admission control let the submission in; ``position`` is its place
    in the pending queue (0 = will activate on the next scheduling turn)."""
    position: int


@dataclasses.dataclass(frozen=True)
class StudyRejected(Event):
    """Admission control bounced the submission (queue full, duplicate id,
    or tenant over quota with ``reject_over_quota``).  Terminal."""
    reason: str


@dataclasses.dataclass(frozen=True)
class StudyStarted(Event):
    """The study was activated; ``resumed`` means it restored a checkpoint
    (service restart / readmission after eviction) instead of starting
    fresh — resumed studies retrain nothing (content-addressed cache)."""
    resumed: bool


@dataclasses.dataclass(frozen=True)
class FrontierUpdate(Event):
    """The study's Pareto frontier changed this round.  ``frontier`` is the
    full snapshot (column name -> list of values; per-layer columns nest).
    Successive snapshots are monotone — see the module docstring."""
    round: int
    n_evaluated: int
    frontier_size: int
    objectives: tuple[str, ...]
    frontier: dict


@dataclasses.dataclass(frozen=True)
class Progress(Event):
    """Periodic bookkeeping: evaluation counters plus the shared-cache and
    training-budget accounting (``cache`` holds hits/misses/farmed_misses;
    ``budget`` holds limit/spent/remaining or None when unmetered)."""
    round: int
    n_evaluated: int
    frontier_size: int
    cells_resolved: int
    cells_skipped: int
    cache: dict
    budget: Optional[dict]


@dataclasses.dataclass(frozen=True)
class StudyEvicted(Event):
    """The study was checkpointed and deactivated (capacity reclaim or
    service shutdown).  Resubmit the same (tenant, name) to resume from
    ``checkpoint_dir``; None means there was no checkpoint_root and the
    in-flight progress (not the trained cells — those live in the cache)
    was dropped."""
    checkpoint_dir: Optional[str]


@dataclasses.dataclass(frozen=True)
class StudyFailed(Event):
    """The study raised; other tenants' studies are unaffected.  Terminal."""
    error: str


@dataclasses.dataclass(frozen=True)
class StudyCompleted(Event):
    """The study ran to completion; ``summary`` is ``Study.summary``
    (mode, counters, cache/budget accounting).  Terminal."""
    summary: dict


#: event classes that end a submission's stream
TERMINAL_EVENTS = (StudyRejected, StudyFailed, StudyCompleted)

#: wire-kind -> event class (the "event" discriminator of ``to_wire``)
EVENT_KINDS = {cls.__name__: cls for cls in
               (StudyAccepted, StudyRejected, StudyStarted, FrontierUpdate,
                Progress, StudyEvicted, StudyFailed, StudyCompleted)}


#: wire kind for a spooled fleet training job (repro_torch.distributed.fleet):
#: not an event, but it rides the same ``to_wire``/``from_wire`` envelope so
#: the job spool and a future network transport share one serializer
_JOB_KIND = "CellJob"


def is_terminal(event: Event) -> bool:
    return isinstance(event, TERMINAL_EVENTS)


def to_wire(obj) -> dict:
    """Event (or ``cellfarm.CellJob``) -> flat JSON-safe dict with an
    ``"event"`` kind discriminator (what a network transport would
    serialize, e.g. ``json.dumps``)."""
    if isinstance(obj, Event):
        return {"event": type(obj).__name__, **dataclasses.asdict(obj)}
    from repro_torch.distributed.cellfarm import CellJob   # lazy: pulls torch
    if isinstance(obj, CellJob):
        return {"event": _JOB_KIND,
                "workload": _workload_to_wire(obj.workload),
                "assignment": {k: (int(v) if k == "num_steps" else float(v))
                               for k, v in obj.assignment.items()},
                "seed": int(obj.seed),
                "quant_bits": [int(b) for b in obj.quant_bits]}
    raise TypeError(f"to_wire takes an Event or a CellJob, "
                    f"got {type(obj).__name__}")


def from_wire(wire: dict) -> "Event":
    """Inverse of :func:`to_wire` (tuple fields re-tupled so the round
    trip survives a JSON hop, which turns tuples into lists)."""
    wire = dict(wire)
    kind = wire.pop("event")
    if kind == _JOB_KIND:
        from repro_torch.distributed.cellfarm import CellJob
        return CellJob(workload=_workload_from_wire(wire["workload"]),
                       assignment=dict(wire["assignment"]),
                       seed=int(wire["seed"]),
                       quant_bits=tuple(int(b) for b in wire["quant_bits"]))
    cls = EVENT_KINDS.get(kind)
    if cls is None:
        raise ValueError(f"unknown event kind {kind!r}; "
                         f"known: {sorted(EVENT_KINDS) + [_JOB_KIND]}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(wire) - set(fields)
    if unknown:
        raise ValueError(f"{kind} does not take fields {sorted(unknown)}")
    for name, value in wire.items():
        if fields[name].type.startswith("tuple") and isinstance(value, list):
            wire[name] = tuple(value)
    return cls(**wire)


# ---- workload wire format ---------------------------------------------------
# A Workload is all primitives except ``layers`` (snn.Dense/Conv/MaxPool
# dataclasses), which serialize with a "kind" tag.  Exact round trip:
# frozen-dataclass equality holds across the JSON hop.

def _workload_to_wire(wl) -> dict:
    from repro_torch.core import snn
    d = dataclasses.asdict(wl)
    d["layers"] = [_layer_to_wire(spec, snn) for spec in wl.layers]
    return d


def _layer_to_wire(spec, snn) -> dict:
    if isinstance(spec, snn.MaxPool):
        return {"kind": "pool", "window": spec.window}
    kind = "dense" if isinstance(spec, snn.Dense) else "conv"
    d = {"kind": kind, **dataclasses.asdict(spec)}
    return d


def _workload_from_wire(d: dict):
    from repro_torch.core import snn
    from repro_torch.core.workloads.registry import Workload
    d = dict(d)
    d["layers"] = tuple(_layer_from_wire(ld, snn) for ld in d["layers"])
    for name in ("input_shape", "num_steps_choices", "population_choices"):
        d[name] = tuple(d[name])
    return Workload(**d)


def _layer_from_wire(ld: dict, snn):
    ld = dict(ld)
    kind = ld.pop("kind")
    if kind == "pool":
        return snn.MaxPool(**ld)
    if "lif" in ld:
        ld["lif"] = snn.LIFParams(**ld["lif"])
    return {"dense": snn.Dense, "conv": snn.Conv}[kind](**ld)
