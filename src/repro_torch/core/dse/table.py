"""Structure-of-arrays candidate storage.

A ``CandidateTable`` is a dict of equal-length NumPy columns — configuration
axes (``lhr``/``mem_blocks`` are (N, L), global axes like ``weight_bits`` or
``clock_mhz`` may be (N,)) next to metric columns (``cycles``, ``lut``,
``reg``, ``bram``, ``dsp``, ``energy``, all (N,)).  No per-candidate Python
objects exist anywhere in the search path; a 200k-candidate chunk is a
handful of arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np


@dataclasses.dataclass
class CandidateTable:
    columns: dict[str, np.ndarray]

    def __post_init__(self):
        lens = {k: len(v) for k, v in self.columns.items()}
        if len(set(lens.values())) > 1:
            raise ValueError(f"ragged columns: {lens}")

    def __len__(self) -> int:
        for v in self.columns.values():
            return len(v)
        return 0

    @property
    def nbytes(self) -> int:
        return sum(v.nbytes for v in self.columns.values())

    def take(self, idx) -> "CandidateTable":
        """Row subset by boolean mask or integer index array."""
        idx = np.asarray(idx)
        return CandidateTable({k: v[idx] for k, v in self.columns.items()})

    @staticmethod
    def concat(tables: Iterable["CandidateTable"]) -> "CandidateTable":
        tables = [t for t in tables if t.columns]
        if not tables:
            return CandidateTable({})
        keys = tables[0].columns.keys()
        for t in tables[1:]:
            if t.columns.keys() != keys:
                raise ValueError(f"column mismatch: {sorted(keys)} vs "
                                 f"{sorted(t.columns.keys())}")
        return CandidateTable({k: np.concatenate([t.columns[k] for t in tables])
                               for k in keys})

    def row(self, i: int) -> dict:
        """One candidate as plain Python values (tuples for per-layer cols)."""
        out = {}
        for k, v in self.columns.items():
            if v.ndim == 2:
                out[k] = tuple(v[i].tolist())
            else:
                out[k] = v[i].item()
        return out

    def argsort(self, key: str) -> np.ndarray:
        return np.argsort(self.columns[key], kind="stable")

    def sorted_by(self, key: str) -> "CandidateTable":
        return self.take(self.argsort(key))

    def argmin(self, key: str) -> int:
        return int(np.argmin(self.columns[key]))
