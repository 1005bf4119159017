"""Hardware-only design-space search.

``search`` walks a hardware ``SearchSpace`` through the ask/tell strategy
contract: each asked chunk of digit rows is assembled into axis columns,
evaluated by the vectorised cycle model and cost library, merged into the
incremental Pareto accumulator, and told back to the strategy.  The chunk
order is the JAX package's (``dse.study.Study._step_ask_tell`` /
``_evaluate_hardware``), so a grid search returns the same frontier bit
for bit.  Model axes (which need training per cell) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.core.accelerator import resources
from repro_torch.core.accelerator.arch import AcceleratorConfig
from repro_torch.core.dse.evaluate import METRICS, evaluate_columns
from repro_torch.core.dse.pareto import ParetoAccumulator
from repro_torch.core.dse.space import SearchSpace
from repro_torch.core.dse.strategies import GridSearch, Strategy
from repro_torch.core.dse.table import CandidateTable

DEFAULT_OBJECTIVES = ("cycles", "lut", "bram", "energy")


@dataclasses.dataclass
class SearchResult:
    config: AcceleratorConfig
    space: SearchSpace
    objectives: tuple[str, ...]
    frontier: CandidateTable          # Pareto-optimal rows (streamed merge)
    n_evaluated: int
    table: Optional[CandidateTable] = None    # all rows iff keep_all

    def _rows(self, needed: Sequence[str]) -> CandidateTable:
        """Full table when kept; else the frontier, which is only a valid
        search set when every queried column was a search objective."""
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

    def min_energy(self) -> Optional[dict]:
        t = self._rows(("energy",))
        return t.row(t.argmin("energy")) if len(t) else None


def search(cfg: AcceleratorConfig, counts: Sequence[np.ndarray],
           space: Optional[SearchSpace] = None,
           strategy: Union[str, Strategy] = "grid",
           objectives: Sequence[str] = DEFAULT_OBJECTIVES,
           chunk_size: int = 65536,
           keep_all: bool = False,
           lib: Optional[resources.CostLibrary] = None) -> SearchResult:
    """Explore ``space`` (default: the per-layer LHR power-of-two product).

    ``objectives`` name metric columns (any of ``evaluate.METRICS``) to
    minimize jointly; the frontier is their k-objective Pareto set, merged
    incrementally across evaluation chunks.
    """
    space = space if space is not None else SearchSpace.product_lhr(cfg)
    if not space.axes:
        raise ValueError("search space has no axes")
    if space.model_axes:
        raise ValueError(
            f"space has model axes "
            f"{[ax.name for ax in space.model_axes]}; those require "
            f"training per cell, which this package does not do yet")
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    objectives = tuple(objectives)
    for obj in objectives:
        if obj not in METRICS:
            raise ValueError(f"unknown objective {obj!r}; pick from {METRICS}")
    if isinstance(strategy, str):
        if strategy != "grid":
            raise ValueError(f"unknown strategy name {strategy!r}; pass a "
                             f"strategy instance for non-grid search")
        strategy = GridSearch(chunk_size)
    strategy.bind(space, objectives)
    acc = ParetoAccumulator(objectives)
    kept: list[CandidateTable] = []
    n_evaluated = 0
    while True:
        digits = strategy.ask(chunk_size)
        if len(digits) == 0:
            break
        cols = space.assemble(digits)
        metrics = evaluate_columns(cfg, counts, cols, lib=lib)
        chunk = CandidateTable({**cols, **metrics})
        acc.update(chunk)
        if keep_all:
            kept.append(chunk)
        n_evaluated += len(chunk)
        strategy.tell(digits, np.stack(
            [np.asarray(chunk.columns[k], np.float64) for k in objectives],
            axis=1))
    return SearchResult(config=cfg, space=space, objectives=objectives,
                        frontier=acc.frontier, n_evaluated=n_evaluated,
                        table=CandidateTable.concat(kept) if keep_all
                        else None)
