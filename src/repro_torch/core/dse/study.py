"""Unified ask/tell exploration front end: ``explore(...) -> Study``.

One front end subsumes the hardware-only ``search`` loop and the model-hardware
``coexplore`` loop.  The strategy (``dse.strategies``) owns only the
*choice* of candidates through the pull-style ``ask(n)``/``tell(digits,
obj)`` contract; the ``Study`` owns chunked evaluation, the
incremental Pareto merge, model-cell resolution through the workload trace
cache, training-budget accounting, and checkpoint/resume.

Three modes, picked from the space and strategy:

* **hardware** — no model axes: digits assemble against one fixed
  ``AcceleratorConfig`` and stream through the chunked evaluator.  This is
  ``dse.search`` (now an exact thin wrapper).
* **cells** — model axes with ``GridSearch``: the joint space factors into
  (model cell) x (hardware subspace) and every cell's subspace is swept
  exhaustively — ``dse.coexplore``'s classic behaviour, one cell per
  ``step()``.
* **joint** — model axes with ``RandomSearch``/``EvolutionarySearch``: the
  strategy samples digits over the *full* joint space (model axes
  included).  The study groups each asked chunk by model cell, resolves
  new cells through the cache, and charges a **training budget in cache
  misses** (``train_budget=k``): once the budget is spent, candidates in
  untrained cells are returned to the strategy as ``+inf`` rows instead of
  being trained — the NAS-style loop where the search decides which
  expensive network evaluations to spend (cache hits stay free).  Per-cell
  subspace rebinding keeps template digit cardinalities
  (``hardware_subspace(cfg, dedup=False)``), so one digit encoding is valid
  in every cell.

``Study`` is checkpointable (``checkpoint/store.py`` holds the frontier
arrays; a ``study.json`` sidecar holds strategy RNG state, cursors,
evaluated count, budget, and cell records) and resumable via
``explore(..., checkpoint_dir=..., resume=True)`` — cells never retrain on
resume because the trace cache is content-addressed.  ``workers=N`` shards
pending cell training across spawned processes and ``stack=True`` trains
same-signature cells as one slab (``repro_torch.distributed.cellfarm``,
``cellstack``), safe because the cache publish is atomic;
``workers="cluster"`` spools them to lease-holding fleet workers
(``repro_torch.distributed.fleet``).

Cells train on the cache's device; the default cache is the port's own
``TraceCache()`` (root ``REPRO_TORCH_WORKLOAD_CACHE``, the card).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from typing import Callable, Optional, Sequence, Union

import numpy as np

from repro_torch.checkpoint import store
from repro_torch.core import workloads
from repro_torch.core.accelerator import arch, cycle_model, resources
from repro_torch.core.dse.evaluate import (AXIS_NAMES, METRICS,
                                           evaluate_columns)
from repro_torch.core.dse.pareto import ParetoAccumulator
from repro_torch.core.dse.space import MODEL_AXES, SearchSpace, iter_cells
from repro_torch.core.dse.strategies import GridSearch, Strategy
from repro_torch.core.dse.table import CandidateTable
from repro_torch.core.workloads import TraceCache, TrainingBudget, Workload
from repro_torch.distributed import cellfarm

DEFAULT_OBJECTIVES = ("cycles", "lut", "bram", "energy")
DEFAULT_CO_OBJECTIVES = ("error", "cycles", "lut", "energy")

#: metric columns a co-exploration row carries beyond the hardware METRICS
CO_METRICS = METRICS + ("accuracy", "error")

HwSpaceFn = Callable[[arch.AcceleratorConfig], SearchSpace]

_SIDECAR = "study.json"


class FrontierQueries:
    """Query surface shared by every result that retains a Pareto frontier
    (and optionally the full table): expects ``objectives``, ``frontier``
    and ``table`` attributes on the subclass."""

    objectives: tuple[str, ...]
    frontier: CandidateTable
    table: Optional[CandidateTable]

    def _rows(self, needed: Sequence[str]) -> CandidateTable:
        """Full table when kept; else the frontier — which is only a valid
        search set when every queried column was a search objective (a
        non-objective optimum may live off-frontier)."""
        if self.table is not None:
            return self.table
        missing = [c for c in needed if c not in self.objectives]
        if missing:
            raise ValueError(
                f"columns {missing} were not search objectives "
                f"{self.objectives}; the retained frontier is only optimal "
                f"over the objectives — re-search with them included, or "
                f"with keep_all=True")
        return self.frontier

    def best_under(self, minimize: str, **caps: float) -> Optional[dict]:
        """Row minimizing ``minimize`` among rows with col <= cap for every
        kwarg — e.g. ``best_under("lut", cycles=20e3)``."""
        t = self._rows((minimize, *caps))
        if len(t) == 0:
            return None
        ok = np.ones(len(t), dtype=bool)
        for col, cap in caps.items():
            ok &= np.asarray(t.columns[col], np.float64) <= cap
        if not ok.any():
            return None
        sub = t.take(ok)
        return sub.row(sub.argmin(minimize))


@dataclasses.dataclass
class CellRecord:
    """One resolved model cell and its hardware sub-sweep summary."""
    workload: str
    assignment: dict                     # model-axis values for this cell
    key: str                             # trace-cache content address
    accuracy: float                      # float-datapath accuracy
    quant_acc: dict[int, float]          # weight_bits -> fixed-point accuracy
    cache_hit: bool
    n_evaluated: int                     # hardware candidates streamed
    layer_sizes: list[int]


def _model_axis_list(space: Optional[SearchSpace],
                     workload: Optional[Union[str, Workload]],
                     num_steps, population, datasets,
                     resolve: Callable[[Union[str, Workload]], Workload]
                     ) -> list[tuple]:
    """Canonical (name, values) list in MODEL_AXES order."""
    if space is not None and space.model_axes:
        given = [n for n, v in (("num_steps", num_steps),
                                ("population", population),
                                ("datasets", datasets)) if v is not None]
        if given:
            raise ValueError(
                f"model axes declared both in the space "
                f"({[ax.name for ax in space.model_axes]}) and via kwargs "
                f"{given}; pick one declaration style")
        by_name = {ax.name: tuple(ax.values) for ax in space.model_axes}
        if "dataset" in by_name:          # normalize instances to names
            by_name["dataset"] = tuple(
                resolve(d).name for d in by_name["dataset"])
    else:
        by_name = {}
        if datasets is not None:
            by_name["dataset"] = tuple(resolve(d).name for d in datasets)
        if num_steps is not None:
            by_name["num_steps"] = tuple(int(t) for t in num_steps)
        if population is not None:
            by_name["population"] = tuple(float(p) for p in population)
    if "num_steps" not in by_name:
        wls = ([resolve(d) for d in by_name["dataset"]]
               if "dataset" in by_name else [resolve(workload)])
        choices = {wl.name: tuple(wl.num_steps_choices) for wl in wls}
        if len(set(choices.values())) > 1:
            raise ValueError(
                f"the swept workloads declare different num_steps_choices "
                f"({choices}); pass num_steps=... explicitly")
        by_name["num_steps"] = next(iter(choices.values()))
    return [(n, by_name[n]) for n in MODEL_AXES if n in by_name]


def _bits_values(sub: SearchSpace) -> list[int]:
    vals: set[int] = set()
    for ax in sub.axes:
        if ax.name != "weight_bits":
            continue
        for v in ax.values:
            if ax.is_vector:
                vals.update(int(x) for x in v)
            else:
                vals.add(int(v))
    return sorted(vals)


def _row_bits(cols: dict[str, np.ndarray]) -> Optional[np.ndarray]:
    """Per-candidate effective weight precision: the global column, or the
    per-layer minimum (the precision that bounds datapath accuracy)."""
    wb = cols.get("weight_bits")
    if wb is None:
        return None
    wb = np.asarray(wb)
    return wb.min(axis=1) if wb.ndim == 2 else wb


def _pad_layers(col: np.ndarray, width: int) -> np.ndarray:
    """Pad a (n, L) per-layer column to (n, width) with -1 (absent layer)."""
    if col.ndim != 2 or col.shape[1] == width:
        return col
    pad = np.full((len(col), width - col.shape[1]), -1, dtype=col.dtype)
    return np.concatenate([col, pad], axis=1)


def _check_subspace(sub: SearchSpace, what: str) -> None:
    if sub.model_axes:
        raise ValueError("hardware subspace must not contain model axes")
    if not sub.axes:
        raise ValueError(f"hardware subspace for {what} has no "
                         f"axes — nothing to sweep")
    unknown = {ax.name for ax in sub.axes} - AXIS_NAMES
    if unknown:
        raise ValueError(f"hardware subspace for {what} has axes "
                         f"{sorted(unknown)} the evaluator does not "
                         f"know; known: {sorted(AXIS_NAMES)}")


@dataclasses.dataclass
class _LiveCell:
    """A resolved model cell's in-memory evaluation context."""
    record: CellRecord
    assignment: dict                  # model-axis values, dataset as name
    accel: arch.AcceleratorConfig
    sub: SearchSpace                  # rebound hw subspace (template digits)
    counts: list[np.ndarray]
    accuracy: float
    quant_acc: dict[int, float]


class Study(FrontierQueries):
    """A (possibly in-flight) exploration: frontier so far, evaluated count,
    resolved model cells, budget/cache accounting, and the lifecycle verbs
    ``step``/``run``/``checkpoint``.  Construct through ``explore``."""

    def __init__(self, *, mode: str, space: Optional[SearchSpace],
                 strategy: Strategy, objectives: tuple[str, ...],
                 chunk_size: int, keep_all: bool,
                 lib: Optional[resources.CostLibrary],
                 # hardware mode
                 config: Optional[arch.AcceleratorConfig] = None,
                 counts: Optional[Sequence[np.ndarray]] = None,
                 # cells / joint modes
                 cache: Optional[TraceCache] = None,
                 budget: Optional[TrainingBudget] = None,
                 seed: int = 0,
                 resolve_wl: Optional[Callable] = None,
                 model_axes: Optional[list[tuple]] = None,
                 cell_plan: Optional[list[tuple]] = None,
                 l_max: int = 0,
                 workers: Union[int, str] = 0,
                 stack: bool = False,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: Optional[int] = None):
        self.mode = mode
        self.space = space
        self.strategy = strategy
        self.objectives = tuple(objectives)
        self.chunk_size = chunk_size
        self.keep_all = keep_all
        self.lib = lib
        self.config = config
        self.counts = counts
        self.cache = cache
        self.budget = budget
        self.seed = seed
        self.workers = workers
        self.stack = stack
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self._resolve_wl = resolve_wl
        self._model_axes = model_axes or []
        self._cell_plan = cell_plan or []       # cells mode prepass output
        self._l_max = l_max

        self.done = False
        self.n_evaluated = 0
        self.rounds = 0
        self.cells: list[CellRecord] = []
        self.skipped: list[dict] = []
        #: cells trained by the farm or a slab (``workers``/``stack``),
        #: published outside ``self.cache`` and charged here
        self.farmed_misses = 0
        #: bumped whenever the Pareto frontier actually changes — streaming
        #: consumers diff this across steps instead of comparing frontier
        #: tables
        self.frontier_version = 0
        #: cooperative-stepping hooks: each is called as ``fn(study)`` after
        #: every counted step (and never after the terminal False step)
        self.listeners: list[Callable[["Study"], None]] = []
        self._acc = ParetoAccumulator(self.objectives)
        self._kept: Optional[list[CandidateTable]] = [] if keep_all else None
        self._table: Optional[CandidateTable] = None
        self._cell_cursor = 0                   # cells mode
        self._live: dict[str, Optional[_LiveCell]] = {}   # joint mode
        self._prefetched = False
        if mode in ("hardware", "joint"):
            strategy.bind(space, self.objectives)

    # ---- results -----------------------------------------------------------
    @property
    def frontier(self) -> CandidateTable:
        return self._acc.frontier

    @property
    def table(self) -> Optional[CandidateTable]:
        if self._kept is None:
            return None
        if self._table is None or len(self._table) != sum(
                len(t) for t in self._kept):
            self._table = CandidateTable.concat(self._kept)
        return self._table

    @property
    def cache_stats(self) -> dict:
        stats = dict(self.cache.stats) if self.cache is not None else {}
        if self.cache is not None:
            stats["farmed_misses"] = self.farmed_misses
        return stats

    @property
    def summary(self) -> dict:
        """Auditable run summary: evaluation counts, workload-cache hit/miss
        counters, and the remaining training budget."""
        out = {"mode": self.mode, "done": self.done,
               "n_evaluated": self.n_evaluated,
               "frontier_size": len(self.frontier),
               "rounds": self.rounds}
        if self.cache is not None:
            out["cells_resolved"] = len(self.cells)
            out["cells_skipped"] = len(self.skipped)
            out["cache"] = self.cache_stats
            out["train_budget"] = (
                None if self.budget is None else
                {"limit": self.budget.limit, "spent": self.budget.spent,
                 "remaining": self.budget.remaining})
        return out

    # ---- lifecycle ---------------------------------------------------------
    def run(self) -> "Study":
        """Drive to completion, checkpointing every ``checkpoint_every``
        steps (and once at the end) when a checkpoint_dir is set."""
        while self.step():
            if (self.checkpoint_dir and self.checkpoint_every
                    and self.rounds % self.checkpoint_every == 0):
                self.checkpoint()
        if self.checkpoint_dir:
            self.checkpoint()
        return self

    def step(self) -> bool:
        """One unit of work: an ask/evaluate/tell round (hardware/joint
        modes) or one full model cell (cells mode).  False when done."""
        if self.done:
            return False
        if self.mode == "cells":
            advanced = self._step_cells()
        else:
            advanced = self._step_ask_tell()
        if advanced:
            self.rounds += 1
            for fn in self.listeners:
                fn(self)
        else:
            self.done = True
        return advanced

    # ---- hardware + joint rounds ------------------------------------------
    def _step_ask_tell(self) -> bool:
        digits = self.strategy.ask(self.chunk_size)
        if len(digits) == 0:
            return False
        if self.mode == "hardware":
            obj = self._evaluate_hardware(digits)
        else:
            obj = self._evaluate_joint(digits)
        self.strategy.tell(digits, obj)
        return True

    def _objective_matrix(self, chunk: CandidateTable) -> np.ndarray:
        return np.stack([np.asarray(chunk.columns[k], np.float64)
                         for k in self.objectives], axis=1)

    def _accumulate(self, chunk: CandidateTable) -> None:
        if self._acc.update(chunk):
            self.frontier_version += 1
        if self._kept is not None:
            self._kept.append(chunk)
        self.n_evaluated += len(chunk)

    def _evaluate_hardware(self, digits: np.ndarray) -> np.ndarray:
        cols = self.space.assemble(digits)
        metrics = evaluate_columns(self.config, self.counts, cols,
                                   lib=self.lib)
        chunk = CandidateTable({**cols, **metrics})
        self._accumulate(chunk)
        return self._objective_matrix(chunk)

    # ---- joint (candidate-major) mode -------------------------------------
    def _evaluate_joint(self, digits: np.ndarray) -> np.ndarray:
        model_d, hw_d = self.space.split_digits(digits)
        obj = np.full((len(digits), len(self.objectives)), np.inf)
        # np.unique gives a deterministic (lexicographic) cell order, so the
        # budget spends identically across runs and worker counts
        uniq, inverse = np.unique(model_d, axis=0, return_inverse=True)
        self._farm_chunk(uniq)
        for u, row in enumerate(uniq):
            cell = self._joint_cell(row)
            if cell is None:
                continue                        # over budget: rows stay +inf
            idx = np.flatnonzero(inverse == u)
            cols = cell.sub.assemble(hw_d[idx])
            metrics = evaluate_columns(cell.accel, cell.counts, cols,
                                       lib=self.lib)
            chunk = self._joint_chunk(cell, cols, metrics)
            self._accumulate(chunk)
            cell.record.n_evaluated += len(idx)
            obj[idx] = self._objective_matrix(chunk)
        return obj

    def _joint_chunk(self, cell: _LiveCell, cols: dict,
                     metrics: dict) -> CandidateTable:
        n = len(next(iter(metrics.values())))
        row_bits = _row_bits(cols)
        if row_bits is None or not cell.quant_acc:
            acc_col = np.full(n, cell.accuracy)
        else:
            uniq = np.unique(row_bits)
            by_bits = np.array([cell.quant_acc.get(int(b), cell.accuracy)
                                for b in uniq])
            acc_col = by_bits[np.searchsorted(uniq, row_bits)]
        out_cols = {k: (_pad_layers(v, self._l_max) if v.ndim == 2 else v)
                    for k, v in cols.items()}
        for name, v in cell.assignment.items():
            out_cols[name] = np.full(
                n, v, dtype=(np.int64 if name == "num_steps" else
                             np.float64 if name == "population" else None))
        return CandidateTable({**out_cols, **metrics,
                               "accuracy": acc_col, "error": 1.0 - acc_col})

    def _cell_assignment(self, model_row: np.ndarray) -> dict:
        """Model digit row -> assignment dict, dataset normalized to name."""
        raw = self.space.model_assignment(model_row)
        if "dataset" in raw:
            raw["dataset"] = self._resolve_wl(raw["dataset"]).name
        if "num_steps" in raw:
            raw["num_steps"] = int(raw["num_steps"])
        if "population" in raw:
            raw["population"] = float(raw["population"])
        return raw

    def _digit_key(self, model_row) -> str:
        return ",".join(str(int(d)) for d in model_row)

    def _joint_cell(self, model_row: np.ndarray) -> Optional[_LiveCell]:
        """Resolve (or look up) the cell for one model digit row; None when
        the cell was skipped for budget (and it stays skipped for the whole
        study, so a resumed run matches an uninterrupted one)."""
        key = self._digit_key(model_row)
        if key in self._live:
            return self._live[key]
        assignment = self._cell_assignment(model_row)
        wl = (self._resolve_wl(assignment["dataset"])
              if "dataset" in assignment else self._resolve_wl(None))
        cell_asn = {"num_steps": assignment["num_steps"],
                    "population": assignment.get("population", 1.0)}
        affordable = (self.budget is None or self.budget.can_spend()
                      or self.cache.contains(wl, cell_asn, seed=self.seed))
        if not affordable:
            self.skipped.append({"workload": wl.name, **assignment})
            self._live[key] = None
            return None
        cell = self._materialize(wl, assignment, cell_asn)
        self._live[key] = cell
        self.cells.append(cell.record)
        return cell

    def _materialize(self, wl: Workload, assignment: dict,
                     cell_asn: dict,
                     record: Optional[CellRecord] = None) -> _LiveCell:
        """Build a cell's evaluation context, training through the cache if
        needed.  ``record`` is passed on resume to keep the original
        cache_hit/n_evaluated bookkeeping."""
        snn_cfg = wl.build(int(cell_asn["num_steps"]),
                           float(cell_asn["population"]))
        accel = arch.from_snn_config(snn_cfg)
        sub = self.space.hardware_subspace(accel, dedup=False)
        _check_subspace(sub, f"cell {assignment}")
        bits = _bits_values(sub)
        artifact = self.cache.resolve(wl, cell_asn, seed=self.seed,
                                      quant_bits=bits,
                                      budget=self.budget)
        if record is None:
            record = CellRecord(
                workload=wl.name, assignment=dict(assignment),
                key=artifact.key, accuracy=artifact.accuracy,
                quant_acc=dict(artifact.quant_acc),
                cache_hit=artifact.cache_hit, n_evaluated=0,
                layer_sizes=snn_cfg.layer_sizes())
        return _LiveCell(record=record, assignment=assignment, accel=accel,
                         sub=sub,
                         counts=cycle_model.counts_from_traces(
                             artifact.counts),
                         accuracy=artifact.accuracy,
                         quant_acc=dict(artifact.quant_acc))

    @property
    def _farming(self) -> bool:
        """True when pending cells should resolve through the farm first: a
        usable process pool (``workers >= 2``), the fleet
        (``workers="cluster"``), or slabs (``stack``)."""
        return (self.workers == "cluster" or self.stack
                or (isinstance(self.workers, int) and self.workers >= 2))

    def _farm(self, jobs: list) -> None:
        self._charge_farmed(cellfarm.resolve_cells(
            jobs, self.cache.root, workers=self.workers, stack=self.stack,
            device=self.cache.device))

    def _farm_chunk(self, uniq_model_rows: np.ndarray) -> None:
        """Train this chunk's unresolved, affordable cells across worker
        processes, as same-signature slabs with ``stack=True``, or on the
        lease-coordinated fleet with ``workers="cluster"``, before the
        serial resolution loop (joint mode)."""
        if not self._farming:
            return
        jobs = []
        afford = (self.budget.remaining if self.budget is not None
                  else len(uniq_model_rows))
        for row in uniq_model_rows:
            if self._digit_key(row) in self._live:
                continue
            assignment = self._cell_assignment(row)
            wl = (self._resolve_wl(assignment["dataset"])
                  if "dataset" in assignment else self._resolve_wl(None))
            cell_asn = {"num_steps": assignment["num_steps"],
                        "population": assignment.get("population", 1.0)}
            if self.cache.contains(wl, cell_asn, seed=self.seed):
                continue
            if len(jobs) >= afford:
                break
            sub = self.space.hardware_subspace(
                arch.from_snn_config(wl.build(
                    int(cell_asn["num_steps"]), cell_asn["population"])),
                dedup=False)
            jobs.append(cellfarm.CellJob(
                workload=wl, assignment=cell_asn, seed=self.seed,
                quant_bits=tuple(_bits_values(sub))))
        self._farm(jobs)

    def _charge_farmed(self, outcomes: list) -> None:
        for out in outcomes:
            if out.error is not None:
                # the farm gave up on this cell after bounded retries
                # (cellfarm.CellOutcome.error); nothing was published and
                # nothing is charged: the serial resolution path trains it
                # in-process (or skips it for budget) instead of the whole
                # study dying on one bad worker
                continue
            if out.trained:
                self.farmed_misses += 1
                if self.budget is not None:
                    self.budget.charge()

    # ---- cells (cell-major grid) mode -------------------------------------
    def _step_cells(self) -> bool:
        self._prefetch_cells()
        while self._cell_cursor < len(self._cell_plan):
            cell, wl, snn_cfg, accel, sub = \
                self._cell_plan[self._cell_cursor]
            self._cell_cursor += 1
            cell_asn = {"num_steps": int(cell["num_steps"]),
                        "population": float(cell.get("population", 1.0))}
            if (self.budget is not None and not self.budget.can_spend()
                    and not self.cache.contains(wl, cell_asn,
                                                seed=self.seed)):
                self.skipped.append({"workload": wl.name, **cell})
                continue
            self._sweep_cell(cell, wl, snn_cfg, accel, sub, cell_asn)
            return True
        return False

    def _sweep_cell(self, cell, wl, snn_cfg, accel, sub, cell_asn) -> None:
        bits = _bits_values(sub)
        artifact = self.cache.resolve(wl, cell_asn, seed=self.seed,
                                      quant_bits=bits, budget=self.budget)
        live = _LiveCell(
            record=CellRecord(
                workload=wl.name, assignment=dict(cell), key=artifact.key,
                accuracy=artifact.accuracy,
                quant_acc=dict(artifact.quant_acc),
                cache_hit=artifact.cache_hit, n_evaluated=0,
                layer_sizes=snn_cfg.layer_sizes()),
            assignment=dict(cell), accel=accel, sub=sub,
            counts=cycle_model.counts_from_traces(artifact.counts),
            accuracy=artifact.accuracy, quant_acc=dict(artifact.quant_acc))
        inner = GridSearch(self.chunk_size)
        inner.bind(sub, self.objectives)
        while True:
            digits = inner.ask(self.chunk_size)
            if len(digits) == 0:
                break
            cols = sub.assemble(digits)
            metrics = evaluate_columns(accel, live.counts, cols,
                                       lib=self.lib)
            chunk = self._joint_chunk(live, cols, metrics)
            self._accumulate(chunk)
            live.record.n_evaluated += len(digits)
            inner.tell(digits, self._objective_matrix(chunk))
        self.cells.append(live.record)

    def _prefetch_cells(self) -> None:
        """Farm the cell plan's pending training across worker processes,
        as slabs with ``stack=True``, or on the fleet with
        ``workers="cluster"`` (cells mode); afterwards every
        prefetched cell resolves as a hit."""
        if self._prefetched or not self._farming:
            return
        self._prefetched = True
        jobs = []
        afford = (self.budget.remaining if self.budget is not None
                  else len(self._cell_plan))
        for cell, wl, _snn_cfg, _accel, sub in \
                self._cell_plan[self._cell_cursor:]:
            cell_asn = {"num_steps": int(cell["num_steps"]),
                        "population": float(cell.get("population", 1.0))}
            if self.cache.contains(wl, cell_asn, seed=self.seed):
                continue
            if len(jobs) >= afford:
                break
            jobs.append(cellfarm.CellJob(
                workload=wl, assignment=cell_asn, seed=self.seed,
                quant_bits=tuple(_bits_values(sub))))
        self._farm(jobs)

    # ---- checkpoint / resume ----------------------------------------------
    def _signature(self) -> str:
        """Stable hash of the search definition, so a resumed study refuses
        a different space/objectives/strategy."""
        if self.space is not None:
            sig = self.space.signature()
        else:                                   # cells mode, kwargs path
            sig = [[n, None, [str(v) for v in vals]]
                   for n, vals in self._model_axes]
            sig += [sub.signature() for _, _, _, _, sub in self._cell_plan]
        blob = json.dumps({"sig": sig, "objectives": list(self.objectives),
                           "strategy": type(self.strategy).__name__,
                           "strategy_config": self.strategy.signature(),
                           "mode": self.mode, "seed": self.seed},
                          sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:24]

    def checkpoint(self, directory: Optional[str] = None) -> str:
        """Persist the study state: frontier arrays through the atomic
        checkpoint store, everything else (strategy RNG state, cursors,
        budget, cell records) in a ``study.json`` sidecar written last —
        its presence marks a complete checkpoint.  Each checkpoint writes a
        fresh step directory (numbered by round) and prunes older ones only
        *after* the sidecar publishes, so a crash mid-checkpoint always
        leaves the previous (sidecar, arrays) pair intact and consistent.

        Cells mode sweeps each cell with its own inner grid, so the outer
        strategy holds no state there — only the cell cursor is recorded.
        """
        directory = directory or self.checkpoint_dir
        if directory is None:
            raise ValueError("no checkpoint directory: pass one here or as "
                             "explore(checkpoint_dir=...)")
        front = self.frontier.columns
        numeric = {k: np.asarray(v) for k, v in front.items()
                   if np.asarray(v).dtype.kind not in "USO"}
        strings = {k: np.asarray(v).tolist() for k, v in front.items()
                   if np.asarray(v).dtype.kind in "USO"}
        step = int(self.rounds)
        store.save(directory, step, {"frontier": numeric})
        meta = {
            "version": 1,
            "signature": self._signature(),
            "mode": self.mode,
            "done": self.done,
            "objectives": list(self.objectives),
            "n_evaluated": int(self.n_evaluated),
            "rounds": int(self.rounds),
            "frontier_step": step,
            "farmed_misses": int(self.farmed_misses),
            "strategy": {"class": type(self.strategy).__name__,
                         "state": (self.strategy.state_dict()
                                   if self.mode != "cells" else {})},
            "budget": (None if self.budget is None
                       else self.budget.state_dict()),
            "cell_cursor": int(self._cell_cursor),
            "cells": [self._record_dict(r) for r in self.cells],
            "skipped": list(self.skipped),
            "resolved": {k: (None if v is None else
                             self.cells.index(v.record))
                         for k, v in self._live.items()},
            "frontier": {
                "numeric": {k: {"dtype": str(v.dtype),
                                "shape": list(v.shape)}
                            for k, v in numeric.items()},
                "strings": strings,
            },
        }
        tmp = os.path.join(directory, _SIDECAR + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(directory, _SIDECAR))
        for old in store.all_steps(directory):      # prune after publish
            if old != step:
                shutil.rmtree(os.path.join(directory, f"step_{old:08d}"),
                              ignore_errors=True)
        return directory

    @staticmethod
    def _record_dict(r: CellRecord) -> dict:
        return {"workload": r.workload, "assignment": r.assignment,
                "key": r.key, "accuracy": r.accuracy,
                "quant_acc": {str(b): a for b, a in r.quant_acc.items()},
                "cache_hit": r.cache_hit, "n_evaluated": r.n_evaluated,
                "layer_sizes": list(r.layer_sizes)}

    def load(self, directory: str) -> "Study":
        """Restore a checkpointed study into this (freshly constructed,
        identically configured) instance."""
        path = os.path.join(directory, _SIDECAR)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no study checkpoint under {directory}")
        with open(path) as f:
            meta = json.load(f)
        if meta["signature"] != self._signature():
            raise ValueError(
                "checkpoint was written for a different study (space axes, "
                "objectives, strategy, mode, or seed differ) — resume with "
                "the arguments the study was started with")
        like = {"frontier": {
            k: np.zeros(m["shape"], dtype=np.dtype(m["dtype"]))
            for k, m in meta["frontier"]["numeric"].items()}}
        tree = store.restore(directory, like,
                             step=int(meta["frontier_step"]))
        cols = {k: np.asarray(v) for k, v in tree["frontier"].items()}
        for k, vals in meta["frontier"]["strings"].items():
            cols[k] = np.asarray(vals)
        if cols and self._acc.update(CandidateTable(cols)):
            self.frontier_version += 1
        self.done = bool(meta["done"])
        self.n_evaluated = int(meta["n_evaluated"])
        self.rounds = int(meta["rounds"])
        self.farmed_misses = int(meta["farmed_misses"])
        if self.mode != "cells":
            self.strategy.load_state_dict(meta["strategy"]["state"])
        if self.budget is not None and meta["budget"] is not None:
            self.budget.load_state_dict(meta["budget"])
        self._cell_cursor = int(meta["cell_cursor"])
        self.cells = [CellRecord(
            workload=d["workload"], assignment=d["assignment"],
            key=d["key"], accuracy=d["accuracy"],
            quant_acc={int(b): a for b, a in d["quant_acc"].items()},
            cache_hit=d["cache_hit"], n_evaluated=d["n_evaluated"],
            layer_sizes=d["layer_sizes"]) for d in meta["cells"]]
        self.skipped = list(meta["skipped"])
        for key, idx in meta["resolved"].items():
            if idx is None:
                self._live[key] = None
            else:
                rec = self.cells[idx]
                wl = self._resolve_wl(rec.workload)
                asn = dict(rec.assignment)
                cell_asn = {"num_steps": int(asn["num_steps"]),
                            "population": float(asn.get("population", 1.0))}
                self._live[key] = self._materialize(wl, asn, cell_asn,
                                                    record=rec)
        return self


def explore(space: Optional[SearchSpace] = None, *,
            # hardware-only evaluation context
            config: Optional[arch.AcceleratorConfig] = None,
            counts: Optional[Sequence[np.ndarray]] = None,
            # model-cell resolution context
            workload: Union[str, Workload, None] = None,
            datasets: Optional[Sequence[Union[str, Workload]]] = None,
            num_steps: Optional[Sequence[int]] = None,
            population: Optional[Sequence[float]] = None,
            hw_space: Optional[HwSpaceFn] = None,
            max_lhr: Optional[int] = None,
            weight_bits: Optional[Sequence[int]] = None,
            cache: Optional[TraceCache] = None,
            seed: int = 0,
            train_budget: Union[int, TrainingBudget, None] = None,
            # search
            strategy: Union[str, Strategy] = "grid",
            objectives: Optional[Sequence[str]] = None,
            chunk_size: int = 65536,
            keep_all: bool = False,
            lib: Optional[resources.CostLibrary] = None,
            # study lifecycle
            workers: Union[int, str] = 0,
            stack: bool = False,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every: Optional[int] = None,
            resume: bool = False,
            run: bool = True) -> Study:
    """The unified front end: explore ``space`` and return a ``Study``.

    Hardware-only spaces (no model axes, no workload kwargs) evaluate
    against ``config``/``counts`` exactly like ``dse.search``.  Spaces with
    model axes (or ``workload``/``datasets``/... kwargs) resolve each model
    cell through the ``workloads`` trace cache like ``dse.coexplore`` — with
    ``GridSearch`` every cell's hardware subspace is enumerated; with
    ``RandomSearch``/``EvolutionarySearch`` the strategy searches the *full
    joint space* and ``train_budget=k`` caps training at k cache misses
    (candidates in unaffordable cells return to the strategy as ``+inf``).

    ``checkpoint_dir`` + ``checkpoint_every=n`` checkpoint the study every n
    steps; ``resume=True`` restores from ``checkpoint_dir`` and continues.
    ``cache`` defaults to ``TraceCache()``: the port's own root, cells
    trained on the card.  ``workers=N`` trains pending cells across N
    spawned processes on the cache's device; ``stack=True`` prefers
    training same-signature cells as one slab over farming them
    (``repro_torch.distributed.cellstack``: published cells are bit for bit
    the solo-trained ones either way).  ``workers="cluster"`` spools them
    to the cache root's job queue for any enrolled ``fleet.FleetWorker``,
    on this or any other host, to claim by lease
    (``repro_torch.distributed.fleet``; it blocks on fleet progress and
    trains in process on the cache's device where there is none, so it
    completes with zero live workers too).  ``run=False`` returns the
    un-run study for manual ``step()``-ing.
    """
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    if isinstance(workers, str) and workers != "cluster":
        raise ValueError(f"workers must be an int or 'cluster', "
                         f"got {workers!r}")
    if isinstance(strategy, str):
        if strategy != "grid":
            raise ValueError(f"unknown strategy name {strategy!r}; pass a "
                             f"strategy instance for non-grid search")
        strategy = GridSearch(chunk_size)
    if keep_all and checkpoint_dir is not None:
        raise ValueError("checkpointing retains only the frontier; "
                         "keep_all tables are not checkpointed — drop one")
    if resume and checkpoint_dir is None:
        raise ValueError("resume=True needs checkpoint_dir=...")

    is_joint = (workload is not None or datasets is not None
                or num_steps is not None or population is not None
                or (space is not None and bool(space.model_axes)))
    if is_joint:
        study = _build_joint(
            space, workload=workload, datasets=datasets, num_steps=num_steps,
            population=population, hw_space=hw_space, max_lhr=max_lhr,
            weight_bits=weight_bits, cache=cache, seed=seed,
            train_budget=train_budget, strategy=strategy,
            objectives=objectives, chunk_size=chunk_size, keep_all=keep_all,
            lib=lib, workers=workers, stack=stack,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every)
    else:
        ignored = [name for name, val, default in (
            ("cache", cache, None), ("train_budget", train_budget, None),
            ("workers", workers, 0), ("stack", stack, False),
            ("hw_space", hw_space, None),
            ("max_lhr", max_lhr, None), ("weight_bits", weight_bits, None),
            ("seed", seed, 0)) if val != default]
        if ignored:
            raise ValueError(
                f"{ignored} only apply to model-cell resolution (spaces "
                f"with model axes or a workload); this exploration is "
                f"hardware-only")
        study = _build_hardware(
            space, config=config, counts=counts, strategy=strategy,
            objectives=objectives, chunk_size=chunk_size, keep_all=keep_all,
            lib=lib, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every)
    if resume:
        study.load(checkpoint_dir)
    if run:
        study.run()
    return study


def _build_hardware(space, *, config, counts, strategy, objectives,
                    chunk_size, keep_all, lib, checkpoint_dir,
                    checkpoint_every) -> Study:
    if space is None:
        raise ValueError("hardware-only exploration needs a SearchSpace "
                         "(or pass a workload for co-exploration)")
    if not space.axes:
        raise ValueError("search space has no axes")
    config = config if config is not None else space.config
    if counts is None:
        raise ValueError("hardware-only exploration needs counts= (per-layer "
                         "spike traffic)")
    objectives = tuple(objectives) if objectives is not None \
        else DEFAULT_OBJECTIVES
    for obj in objectives:
        if obj not in METRICS:
            raise ValueError(f"unknown objective {obj!r}; pick from {METRICS}")
    return Study(mode="hardware", space=space, strategy=strategy,
                 objectives=objectives, chunk_size=chunk_size,
                 keep_all=keep_all, lib=lib, config=config, counts=counts,
                 checkpoint_dir=checkpoint_dir,
                 checkpoint_every=checkpoint_every)


def _build_joint(space, *, workload, datasets, num_steps, population,
                 hw_space, max_lhr, weight_bits, cache, seed, train_budget,
                 strategy, objectives, chunk_size, keep_all, lib, workers,
                 stack, checkpoint_dir, checkpoint_every) -> Study:
    objectives = tuple(objectives) if objectives is not None \
        else DEFAULT_CO_OBJECTIVES
    for obj in objectives:
        if obj == "accuracy":
            raise ValueError("objectives are minimized — use 'error' "
                             "(= 1 - accuracy) instead of 'accuracy'")
        if obj not in CO_METRICS:
            raise ValueError(f"unknown objective {obj!r}; pick from "
                             f"{CO_METRICS}")
    if workload is None and datasets is None and (
            space is None or not any(ax.name == "dataset"
                                     for ax in space.model_axes)):
        raise ValueError("pass a workload, datasets=..., or a space with a "
                         "'dataset' model axis")
    custom_hw = hw_space is not None or (space is not None
                                         and bool(space.hw_axes))
    given_hw = [n for n, v in (("max_lhr", max_lhr),
                               ("weight_bits", weight_bits)) if v is not None]
    if custom_hw and given_hw:
        raise ValueError(
            f"the {given_hw} kwargs only shape the default hardware "
            f"subspace, but one is already declared via "
            f"{'hw_space' if hw_space is not None else 'the space'}; "
            f"pick one declaration style")
    cache = cache if cache is not None else TraceCache()
    if isinstance(train_budget, int):
        train_budget = TrainingBudget(train_budget)

    # Workload instances handed in directly (the ``workload`` param or
    # ``datasets=`` entries) need not be in the global registry — cells
    # carry only the name, so keep a local name -> Workload view.
    local_wls: dict[str, Workload] = {}
    if isinstance(workload, Workload):
        local_wls[workload.name] = workload
    for d in (datasets or ()):
        if isinstance(d, Workload):
            local_wls[d.name] = d
    if space is not None:
        for ax in space.model_axes:
            if ax.name == "dataset":
                for d in ax.values:
                    if isinstance(d, Workload):
                        local_wls[d.name] = d
    base_wl_holder = workload

    def resolve_wl(w: Union[str, Workload, None]) -> Workload:
        if w is None:
            w = base_wl_holder
        if isinstance(w, Workload):
            return w
        return local_wls[w] if w in local_wls else workloads.get(w)

    model_axes = _model_axis_list(space, workload, num_steps, population,
                                  datasets, resolve_wl)
    base_wl = resolve_wl(workload) if workload is not None else None

    def hw_factory(cfg: arch.AcceleratorConfig) -> SearchSpace:
        if hw_space is not None:
            return hw_space(cfg)
        if space is not None and space.hw_axes:
            return space.hardware_subspace(cfg)
        sub = SearchSpace.product_lhr(
            cfg, max_lhr=max_lhr if max_lhr is not None else 32)
        if weight_bits is not None:
            sub.add_global("weight_bits", tuple(int(b) for b in weight_bits))
        return sub

    mode = "cells" if isinstance(strategy, GridSearch) else "joint"
    if mode == "joint":
        if space is None or not space.hw_axes or hw_space is not None:
            raise ValueError(
                "joint Random/EvolutionarySearch strategies search the full "
                "joint digit space — declare both the model axes and the "
                "hardware axes in one SearchSpace (hw_space callables and "
                "default subspaces are only supported with GridSearch)")
        declared = {ax.name for ax in space.model_axes}
        needed = {n for n, _ in model_axes}
        if needed - declared:
            raise ValueError(
                f"joint strategies need every model axis declared in the "
                f"space; missing {sorted(needed - declared)} (e.g. "
                f"add_model('num_steps', ...))")
        l_max = _joint_prepass(space, model_axes, resolve_wl, base_wl)
        return Study(mode="joint", space=space, strategy=strategy,
                     objectives=objectives, chunk_size=chunk_size,
                     keep_all=keep_all, lib=lib, cache=cache,
                     budget=train_budget, seed=seed, resolve_wl=resolve_wl,
                     model_axes=model_axes, l_max=l_max, workers=workers,
                     stack=stack, checkpoint_dir=checkpoint_dir,
                     checkpoint_every=checkpoint_every)

    # cells mode: materialize every cell's topology and hardware subspace
    # BEFORE any training — a bad subspace (model axes, inconsistent column
    # sets across cells) fails here rather than mid-sweep with cells already
    # trained; also finds the widest per-layer column for cross-topology
    # padding.
    cell_plan: list[tuple] = []
    for cell in iter_cells(model_axes):
        wl = resolve_wl(cell["dataset"]) if "dataset" in cell else base_wl
        snn_cfg = wl.build(int(cell["num_steps"]),
                           float(cell.get("population", 1.0)))
        accel = arch.from_snn_config(snn_cfg)
        sub = hw_factory(accel)
        _check_subspace(sub, f"cell {cell}")
        cell_plan.append((cell, wl, snn_cfg, accel, sub))
    if not cell_plan:
        raise ValueError("model subspace is empty (an axis has no values)")
    names0 = sorted({ax.name for ax in cell_plan[0][4].axes})
    for cell, _, _, _, sub in cell_plan[1:]:
        names = sorted({ax.name for ax in sub.axes})
        if names != names0:
            raise ValueError(
                f"hardware subspaces must share axis names across cells "
                f"(one CandidateTable holds the joint frontier): cell "
                f"{cell_plan[0][0]} has {names0} but cell {cell} has {names}")
    l_max = max(len(accel.layers) for _, _, _, accel, _ in cell_plan)
    return Study(mode="cells", space=space, strategy=strategy,
                 objectives=objectives, chunk_size=chunk_size,
                 keep_all=keep_all, lib=lib, cache=cache, budget=train_budget,
                 seed=seed, resolve_wl=resolve_wl, model_axes=model_axes,
                 cell_plan=cell_plan, l_max=l_max, workers=workers,
                 stack=stack, checkpoint_dir=checkpoint_dir,
                 checkpoint_every=checkpoint_every)


def _joint_prepass(space: SearchSpace, model_axes, resolve_wl,
                   base_wl) -> int:
    """Validate the template hw axes and every dataset's topology binding
    before any training; returns the widest per-layer column width."""
    _check_subspace(SearchSpace(space.config, [
        dataclasses.replace(ax) for ax in space.hw_axes]), "the space")
    by_name = dict(model_axes)
    t0 = int(by_name["num_steps"][0])
    wls = ([resolve_wl(d) for d in by_name["dataset"]]
           if "dataset" in by_name else [base_wl])
    l_max = 0
    for wl in wls:
        accel = arch.from_snn_config(wl.build(t0, 1.0))
        space.hardware_subspace(accel, dedup=False)   # raises on bad binding
        l_max = max(l_max, len(accel.layers))
    return l_max
