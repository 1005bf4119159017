"""Hardware-only search: an exact thin wrapper over ``dse.explore``.

``search`` keeps its seed-era signature and numerics, but the loop now
lives in ``dse.study``: the strategy is driven through the ask/tell
contract and each asked chunk flows through the vectorised evaluator into
the incremental Pareto accumulator — a ``GridSearch`` study reproduces the
pre-ask/tell frontier bit-exactly (chunk boundaries and evaluation order
are unchanged; tested).  For joint model x hardware searches, budgeted
strategies and resumable studies, call ``dse.explore`` directly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.core.accelerator import resources
from repro_torch.core.accelerator.arch import AcceleratorConfig
from repro_torch.core.dse.space import SearchSpace
from repro_torch.core.dse.study import (DEFAULT_OBJECTIVES,
                                        FrontierQueries, explore)
from repro_torch.core.dse.table import CandidateTable

__all__ = ["DEFAULT_OBJECTIVES", "FrontierQueries", "SearchResult",
           "auto_select", "search"]


@dataclasses.dataclass
class SearchResult(FrontierQueries):
    config: AcceleratorConfig
    space: SearchSpace
    objectives: tuple[str, ...]
    frontier: CandidateTable          # Pareto-optimal rows (streamed merge)
    n_evaluated: int
    table: Optional[CandidateTable] = None    # all rows iff keep_all

    def best_within_latency(self, max_cycles: float) -> Optional[dict]:
        return self.best_under("lut", cycles=max_cycles)

    def best_within_area(self, max_lut: float) -> Optional[dict]:
        return self.best_under("cycles", lut=max_lut)

    def min_energy(self) -> Optional[dict]:
        t = self._rows(("energy",))
        return t.row(t.argmin("energy")) if len(t) else None

    def config_for(self, row: dict) -> AcceleratorConfig:
        """Materialize a result row as a concrete AcceleratorConfig."""
        return self.config.with_updates(
            lhr=row.get("lhr"), mem_blocks=row.get("mem_blocks"),
            weight_bits=row.get("weight_bits"),
            penc_width=row.get("penc_width"),
            clock_mhz=row.get("clock_mhz"))


def search(cfg: AcceleratorConfig, counts: Sequence[np.ndarray],
           space: Optional[SearchSpace] = None,
           strategy: Union[str, object] = "grid",
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
            f"training/cache resolution per cell — use dse.coexplore")
    study = explore(space, config=cfg, counts=counts, strategy=strategy,
                    objectives=objectives, chunk_size=chunk_size,
                    keep_all=keep_all, lib=lib)
    return SearchResult(config=cfg, space=space, objectives=study.objectives,
                        frontier=study.frontier,
                        n_evaluated=study.n_evaluated, table=study.table)


def auto_select(cfg: AcceleratorConfig, counts: Sequence[np.ndarray],
                max_cycles: Optional[float] = None,
                max_lut: Optional[float] = None,
                space: Optional[SearchSpace] = None,
                **kw) -> Optional[tuple[AcceleratorConfig, dict]]:
    """The paper's "best mapping" picks over an arbitrary search space:
    smallest design within a latency budget (``max_cycles``), fastest within
    an area budget (``max_lut``), or minimum energy when no budget is given.
    Returns (materialized config, result row) or None if no design fits."""
    result = search(cfg, counts, space=space,
                    objectives=("cycles", "lut", "energy"), **kw)
    caps = {}
    if max_cycles is not None:
        caps["cycles"] = max_cycles
    if max_lut is not None:
        caps["lut"] = max_lut
    if max_cycles is not None:
        row = result.best_under("lut", **caps)
    elif max_lut is not None:
        row = result.best_under("cycles", **caps)
    else:
        row = result.min_energy()
    if row is None:
        return None
    return result.config_for(row), row
