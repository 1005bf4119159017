"""Model–hardware co-exploration: an exact thin wrapper over ``dse.explore``.

The headline claim of the paper is joint tailoring of "both the hardware and
model parameters".  ``coexplore`` makes model parameters searchable axes by
factoring the joint space into

    (model cell) x (hardware subspace)

A *model cell* is one assignment of the model axes (``num_steps``,
``population``, ``dataset``).  Each cell resolves **once** through the
``workloads.TraceCache`` to trained params, measured accuracy, and per-layer
spike traces; its topology derives an ``AcceleratorConfig``
(``arch.from_snn_config``), and the cell's hardware subspace then streams
through the chunked evaluator exactly as a hardware-only search would — the
numerics on a fixed cell are identical by construction (tested).

Accuracy joins cycles/LUT/BRAM/energy as a first-class Pareto objective:
every candidate row carries ``accuracy`` and ``error`` (= 1 - accuracy)
columns, and ``error`` is minimized in the shared k-objective accumulator.
When the hardware subspace has a ``weight_bits`` axis, the accuracy is the
**fixed-point datapath** accuracy at that precision
(``validate.quantized_accuracy``, cached per (cell, bits)) for every
topology — the integer reference models dense, conv and OR-pool layers, so
conv cells like ``dvs-conv`` are no longer padded with float accuracy.

Per-layer axis columns (``lhr``, ``mem_blocks``) are padded with -1 to the
widest cell when cells differ in layer count (the ``dataset`` axis mixes
topologies), so one ``CandidateTable`` holds the whole joint frontier.

The loop itself lives in ``dse.study`` since the ask/tell redesign; this
wrapper adapts the returned ``Study`` to the classic ``CoExploreResult``
and forwards the new knobs: ``strategy=`` (a non-grid strategy searches the
*joint* digit space instead of enumerating cells — requires a declared
space), ``train_budget=k`` (at most k cache misses), ``workers=N``
(parallel cell farming in spawned processes) and ``stack=True`` (slabs of
same-signature cells, ``repro_torch.distributed.cellstack``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

from repro_torch.core.accelerator import resources
from repro_torch.core.dse.strategies import GridSearch, Strategy
from repro_torch.core.dse.study import (CO_METRICS, DEFAULT_CO_OBJECTIVES,
                                        CellRecord, FrontierQueries,
                                        HwSpaceFn, Study, explore)
from repro_torch.core.dse.table import CandidateTable
from repro_torch.core.workloads import (TraceCache, TrainingBudget,
                                        Workload)

__all__ = ["CO_METRICS", "DEFAULT_CO_OBJECTIVES", "CellRecord",
           "CoExploreResult", "HwSpaceFn", "coexplore"]


@dataclasses.dataclass
class CoExploreResult(FrontierQueries):
    """Joint search result.  ``best_under`` (shared with ``SearchResult``)
    answers accuracy-aware picks — e.g. ``best_under("cycles", error=0.1)``
    for the fastest design losing at most 10 points of accuracy."""
    objectives: tuple[str, ...]
    frontier: CandidateTable             # joint accuracy-aware Pareto set
    cells: list[CellRecord]
    n_evaluated: int
    cache: TraceCache
    table: Optional[CandidateTable] = None      # all rows iff keep_all
    study: Optional[Study] = None               # the underlying Study

    @property
    def cache_stats(self) -> dict:
        return self.cache.stats

    @property
    def summary(self) -> dict:
        """Auditable counters: cache hits/misses, remaining train budget,
        cells resolved/skipped (see ``Study.summary``)."""
        if self.study is not None:
            return self.study.summary
        return {"n_evaluated": self.n_evaluated,
                "frontier_size": len(self.frontier),
                "cells_resolved": len(self.cells),
                "cache": dict(self.cache.stats)}


def coexplore(workload: Union[str, Workload, None] = None,
              space=None, *,
              num_steps: Optional[Sequence[int]] = None,
              population: Optional[Sequence[float]] = None,
              datasets: Optional[Sequence[Union[str, Workload]]] = None,
              hw_space: Union[HwSpaceFn, None] = None,
              max_lhr: Optional[int] = None,
              weight_bits: Optional[Sequence[int]] = None,
              objectives: Sequence[str] = DEFAULT_CO_OBJECTIVES,
              cache: Optional[TraceCache] = None,
              seed: int = 0,
              chunk_size: int = 65536,
              keep_all: bool = False,
              lib: Optional[resources.CostLibrary] = None,
              strategy: Optional[Strategy] = None,
              train_budget: Union[int, TrainingBudget, None] = None,
              workers: int = 0,
              stack: bool = False) -> CoExploreResult:
    """Joint model x hardware search returning an accuracy-aware frontier.

    Model axes come from ``space`` (a ``SearchSpace`` with ``add_model``
    axes) or the ``num_steps`` / ``population`` / ``datasets`` kwargs
    (defaults: the workload's ``num_steps_choices`` x population 1.0).  The
    hardware subspace per cell comes from, in priority order: ``hw_space``
    (a callable ``AcceleratorConfig -> SearchSpace``), the hardware axes of
    ``space`` rebound to the cell (``SearchSpace.hardware_subspace``), or a
    default per-layer power-of-two LHR product capped at ``max_lhr``
    (default 32) plus an optional global ``weight_bits`` axis.  The
    ``max_lhr``/``weight_bits`` kwargs only shape that default — passing
    them next to a custom subspace raises rather than silently dropping
    them.

    ``objectives`` may use any hardware metric plus ``error``
    (= 1 - accuracy, the minimization form of the accuracy objective).

    ``strategy`` defaults to exhaustive cell enumeration (``GridSearch``);
    pass ``RandomSearch``/``EvolutionarySearch`` (with a declared joint
    space) plus ``train_budget=k`` for the NAS-style budgeted loop,
    ``workers=N`` to farm cell training across processes, and
    ``stack=True`` to train same-signature cells as one slab
    (``repro_torch.distributed.cellstack``) — all forwarded to
    ``dse.explore``.
    """
    study = explore(
        space, workload=workload, datasets=datasets, num_steps=num_steps,
        population=population, hw_space=hw_space, max_lhr=max_lhr,
        weight_bits=weight_bits, objectives=objectives, cache=cache,
        seed=seed, chunk_size=chunk_size, keep_all=keep_all, lib=lib,
        strategy=strategy if strategy is not None else GridSearch(chunk_size),
        train_budget=train_budget, workers=workers, stack=stack)
    return CoExploreResult(objectives=study.objectives,
                           frontier=study.frontier, cells=study.cells,
                           n_evaluated=study.n_evaluated, cache=study.cache,
                           table=study.table, study=study)
