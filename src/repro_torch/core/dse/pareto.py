"""k-objective Pareto machinery with streaming (chunk-incremental) merge.

Dominance is *strict* Pareto dominance for minimization: point ``a``
dominates ``b`` iff ``all(a <= b)`` and ``any(a < b)``.  Exact duplicates
therefore never dominate each other and every copy of a non-dominated point
stays on the frontier — this is what makes the chunk-incremental merge
order-independent: the frontier of a stream equals the frontier of the
concatenation regardless of chunk boundaries (tests/test_dse.py proves the
equivalence on ties and duplicates).

All checks run blockwise so memory stays O(block * frontier) even when a
chunk holds tens of thousands of points.
"""
from __future__ import annotations

import zlib
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.dse.table import CandidateTable


def any_dominates(front: Optional[np.ndarray], points: np.ndarray,
                  block: int = 1024) -> np.ndarray:
    """(len(points),) bool — some row of ``front`` strictly dominates point.

    A point never dominates itself, so ``any_dominates(x, x)`` is the
    "dominated within x" mask (duplicates survive).
    """
    points = np.asarray(points, np.float64)
    out = np.zeros(len(points), dtype=bool)
    if front is None or len(front) == 0 or len(points) == 0:
        return out
    front = np.asarray(front, np.float64)
    k_objs = front.shape[1]
    for s in range(0, len(points), block):
        p = points[s:s + block]                              # (m, K)
        le = np.ones((len(front), len(p)), dtype=bool)
        lt = np.zeros((len(front), len(p)), dtype=bool)
        for k in range(k_objs):
            f_k = front[:, k:k + 1]
            le &= f_k <= p[:, k]
            lt |= f_k < p[:, k]
        out[s:s + block] = (le & lt).any(axis=0)
    return out


def frontier_of(objectives: np.ndarray, block: int = 4096) -> np.ndarray:
    """Frontier rows of an (N, K) objective matrix, streamed blockwise."""
    obj = np.asarray(objectives, np.float64)
    front = np.empty((0, obj.shape[1]))
    for s in range(0, len(obj), block):
        sub = obj[s:s + block]
        sub = sub[~any_dominates(front, sub)]
        sub = sub[~any_dominates(sub, sub)]
        front = np.concatenate([front[~any_dominates(sub, front)], sub])
    return front


def pareto_mask_k(objectives: np.ndarray, block: int = 4096) -> np.ndarray:
    """Non-dominated mask over an (N, K) objective matrix (minimize all).

    Builds the frontier incrementally then takes one membership pass, so the
    cost is O(N * frontier) and memory stays bounded for very large N.
    """
    obj = np.asarray(objectives, np.float64)
    if obj.ndim != 2:
        raise ValueError(f"objectives must be (N, K), got {obj.shape}")
    return ~any_dominates(frontier_of(obj, block), obj)


def pareto_mask(cycles: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Two-objective non-dominated mask (the seed engine's signature).

    Unlike the seed implementation this keeps *every* copy of a duplicated
    frontier point (strict dominance), which is required for the streaming
    merge to be chunk-order independent.
    """
    return pareto_mask_k(np.stack([np.asarray(cycles, np.float64),
                                   np.asarray(lut, np.float64)], axis=1))


def _col_as_f64(v: np.ndarray) -> np.ndarray:
    """Column as float64 for duplicate keying.  Non-numeric columns (the
    ``dataset`` model axis is a string column) map through crc32 — a
    deterministic, process-independent code that is exact in float64."""
    v = np.asarray(v)
    if v.dtype.kind in "USO":
        crc = np.frompyfunc(lambda s: float(zlib.crc32(str(s).encode())), 1, 1)
        return crc(v).astype(np.float64)
    return v.astype(np.float64)


def _row_keys(table: CandidateTable, idx: np.ndarray | None = None
              ) -> np.ndarray:
    """Rows flattened across ALL columns, for exact-duplicate detection."""
    cols = []
    for k in sorted(table.columns):
        v = _col_as_f64(table.columns[k]).reshape(len(table), -1)
        cols.append(v if idx is None else v[idx])
    return np.ascontiguousarray(np.concatenate(cols, axis=1))


def _rows_in(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(len(a),) bool — row of ``a`` appears (exactly) among rows of ``b``."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros(len(a), dtype=bool)
    dt = [("", a.dtype)] * a.shape[1]
    return np.isin(a.view(dt).ravel(), np.ascontiguousarray(b).view(dt).ravel())


class ParetoAccumulator:
    """Incremental k-objective Pareto merge over CandidateTable chunks.

    Feed arbitrarily many chunks through :meth:`update`; only frontier rows
    are retained, so an unbounded stream evaluates in bounded memory.  The
    final :attr:`frontier` equals (as a row set) the frontier of a
    monolithic evaluation of the concatenated chunks.  Distinct candidates
    with tied objectives all survive, but exact full-row duplicates — the
    same candidate re-evaluated, as Random/EvolutionarySearch routinely do
    — are kept once, so frontier size never inflates with re-visits.
    """

    def __init__(self, objectives: Sequence[str]):
        if not objectives:
            raise ValueError("need at least one objective column name")
        self.objectives = tuple(objectives)
        self._table: Optional[CandidateTable] = None
        self._obj: Optional[np.ndarray] = None               # (F, K)

    def update(self, table: CandidateTable) -> bool:
        """Merge one chunk; returns True when the frontier changed (rows
        added and/or dominated rows dropped) — the signal streaming
        frontier consumers key events on."""
        if len(table) == 0:
            return False
        obj = np.stack([np.asarray(table.columns[k], np.float64)
                        for k in self.objectives], axis=1)
        idx = np.flatnonzero(~any_dominates(self._obj, obj))
        local = pareto_mask_k(obj[idx])
        idx = idx[local]
        # drop exact re-evaluations: within the chunk ...
        keys = _row_keys(table, idx)
        _, first = np.unique(keys, axis=0, return_index=True)
        first.sort()
        idx, keys = idx[first], keys[first]
        # ... and against the retained frontier
        if self._table is not None and len(self._table):
            fresh = ~_rows_in(keys, _row_keys(self._table))
            idx = idx[fresh]
        sub = obj[idx]
        if self._table is None:
            self._table, self._obj = table.take(idx), sub
            return len(idx) > 0
        old_keep = ~any_dominates(sub, self._obj)
        changed = len(idx) > 0 or not old_keep.all()
        self._table = CandidateTable.concat(
            [self._table.take(old_keep), table.take(idx)])
        self._obj = np.concatenate([self._obj[old_keep], sub])
        return changed

    @property
    def frontier(self) -> CandidateTable:
        if self._table is None:
            return CandidateTable({})
        return self._table
