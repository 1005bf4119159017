"""Pluggable search strategies — ask/tell interface.

A strategy decides *which* candidates to evaluate; the driver
(``dse.study.explore``) owns the chunked evaluation and the incremental
Pareto merge.  The contract is pull-style:

    bind(space, objectives)     begin a fresh run over ``space``
    ask(n) -> digits            up to ``n`` candidates as an (m, n_axes)
                                mixed-radix digit matrix; an empty matrix
                                means the strategy is done
    tell(digits, objective_mat) the (m, K) float64 objective values for the
                                digits just asked (minimization; a row of
                                ``+inf`` marks an infeasible candidate the
                                driver refused to evaluate, e.g. a model
                                cell outside the training budget)
    state_dict()/load_state_dict()
                                JSON-serializable snapshot of everything
                                between ask/tell rounds (RNG state, cursors,
                                pending populations) — the hook ``Study``
                                checkpoints use to resume mid-search

The driver strictly alternates ``ask``/``tell`` and never re-orders rows,
so a strategy may rely on ``tell`` receiving exactly the digits of the
preceding ``ask``.

* ``GridSearch``         — exhaustive, chunked; any space size streams in
                           fixed memory.
* ``RandomSearch``       — uniform i.i.d. samples, for spaces too large to
                           enumerate (works past 2^63 candidates: sampling
                           is per-axis digits, never a flat index).  Exact
                           duplicate rows within one asked chunk are
                           dropped, so ``n_evaluated`` counts distinct
                           candidates.
* ``EvolutionarySearch`` — (mu + lambda)-style loop: parents are the
                           generation's non-dominated set padded by
                           normalized-sum rank (infeasible rows rank last);
                           children come from uniform crossover plus
                           per-gene random-reset mutation.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.dse.pareto import pareto_mask_k
from repro_torch.core.dse.space import SearchSpace


def _dedup_rows(digits: np.ndarray) -> np.ndarray:
    """Drop exact duplicate rows, keeping first occurrences in order."""
    if len(digits) < 2:
        return digits
    _, first = np.unique(digits, axis=0, return_index=True)
    first.sort()
    return digits[first]


def _rng_state(rng: np.random.Generator) -> dict:
    return rng.bit_generator.state          # plain dict of ints / strings


def _rng_from_state(state: dict) -> np.random.Generator:
    rng = np.random.default_rng()
    rng.bit_generator.state = state
    return rng


class Strategy:
    """Shared ask/tell scaffolding (binding + empty-result helper)."""

    _space: SearchSpace | None = None

    def bind(self, space: SearchSpace, objectives: tuple[str, ...]) -> None:
        """Begin a fresh run: reset all between-round state."""
        self._space = space
        self._objectives = tuple(objectives)

    def _empty(self) -> np.ndarray:
        return np.empty((0, len(self._space.axes)), dtype=np.int64)

    def ask(self, n: int) -> np.ndarray:
        raise NotImplementedError

    def tell(self, digits: np.ndarray, objective_mat: np.ndarray) -> None:
        """Default: stateless strategies ignore the results."""

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass

    def signature(self) -> dict:
        """The hyperparameters that define the search trajectory — part of
        the ``Study`` resume guard, so a checkpoint refuses a same-class
        strategy configured differently (seed, sample count, ...)."""
        return {k: v for k, v in vars(self).items()
                if not k.startswith("_")}


class GridSearch(Strategy):
    def __init__(self, chunk_size: int = 65536):
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.chunk_size = chunk_size

    def bind(self, space: SearchSpace, objectives) -> None:
        super().bind(space, objectives)
        if space.size >= 2 ** 62:
            raise ValueError(f"{space.size} candidates cannot be enumerated; "
                             f"use RandomSearch or EvolutionarySearch")
        self._cursor = 0

    def ask(self, n: int) -> np.ndarray:
        m = min(n, self.chunk_size, self._space.size - self._cursor)
        if m <= 0:
            return self._empty()
        digits = self._space.digits(
            np.arange(self._cursor, self._cursor + m, dtype=np.int64))
        self._cursor += m
        return digits

    def state_dict(self) -> dict:
        return {"cursor": int(self._cursor)}

    def load_state_dict(self, state: dict) -> None:
        self._cursor = int(state["cursor"])


class RandomSearch(Strategy):
    def __init__(self, n_samples: int, seed: int = 0,
                 chunk_size: int = 65536):
        if n_samples < 1:
            raise ValueError(f"n_samples must be >= 1, got {n_samples}")
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.n_samples = n_samples
        self.seed = seed
        self.chunk_size = chunk_size

    def bind(self, space: SearchSpace, objectives) -> None:
        super().bind(space, objectives)
        self._rng = np.random.default_rng(self.seed)
        self._emitted = 0

    def ask(self, n: int) -> np.ndarray:
        m = min(n, self.chunk_size, self.n_samples - self._emitted)
        if m <= 0:
            return self._empty()
        digits = _dedup_rows(self._space.sample_digits(self._rng, m))
        self._emitted += len(digits)
        return digits

    def state_dict(self) -> dict:
        return {"emitted": int(self._emitted), "rng": _rng_state(self._rng)}

    def load_state_dict(self, state: dict) -> None:
        self._emitted = int(state["emitted"])
        self._rng = _rng_from_state(state["rng"])


class EvolutionarySearch(Strategy):
    def __init__(self, population: int = 128, generations: int = 16,
                 seed: int = 0, mutation_rate: float | None = None):
        if population < 4:
            raise ValueError("population must be >= 4")
        if generations < 1:
            raise ValueError(f"generations must be >= 1, got {generations}")
        self.population = population
        self.generations = generations
        self.seed = seed
        self.mutation_rate = mutation_rate

    def bind(self, space: SearchSpace, objectives) -> None:
        super().bind(space, objectives)
        self._rng = np.random.default_rng(self.seed)
        self._gen = 0
        self._pop = space.sample_digits(self._rng, self.population)
        self._offset = 0                       # asked rows of current pop
        self._pending: list[np.ndarray] = []   # told objective rows

    def ask(self, n: int) -> np.ndarray:
        if self._gen >= self.generations or self._offset >= len(self._pop):
            return self._empty()
        m = min(n, len(self._pop) - self._offset)
        rows = self._pop[self._offset:self._offset + m]
        self._offset += m
        return rows

    def tell(self, digits: np.ndarray, objective_mat: np.ndarray) -> None:
        self._pending.append(np.asarray(objective_mat, np.float64))
        if sum(len(p) for p in self._pending) >= len(self._pop):
            self._breed()

    def _breed(self) -> None:
        obj = np.concatenate(self._pending)
        n_axes = len(self._space.axes)
        mut_p = self.mutation_rate or 1.0 / max(n_axes, 1)
        rng = self._rng
        # rank: non-dominated first, then by normalized objective sum;
        # infeasible rows (any +/-inf or nan objective) always last
        finite = np.isfinite(obj).all(axis=1)
        score = np.full(len(obj), np.inf)
        if finite.any():
            fo = obj[finite]
            nondom = pareto_mask_k(fo)
            span = np.maximum(fo.max(axis=0) - fo.min(axis=0), 1e-300)
            s = ((fo - fo.min(axis=0)) / span).sum(axis=1)
            score[finite] = s + np.where(nondom, 0.0, fo.shape[1])
        order = np.argsort(score, kind="stable")
        parents = self._pop[order[:max(2, self.population // 2)]]
        pa = parents[rng.integers(len(parents), size=self.population)]
        pb = parents[rng.integers(len(parents), size=self.population)]
        children = np.where(
            rng.random((self.population, n_axes)) < 0.5, pa, pb)
        mutate = rng.random((self.population, n_axes)) < mut_p
        self._pop = np.where(
            mutate, self._space.sample_digits(rng, self.population), children)
        self._gen += 1
        self._offset = 0
        self._pending = []

    def state_dict(self) -> dict:
        return {"rng": _rng_state(self._rng),
                "generation": int(self._gen),
                "offset": int(self._offset),
                "pop": np.asarray(self._pop).tolist(),
                "pending": [p.tolist() for p in self._pending]}

    def load_state_dict(self, state: dict) -> None:
        self._rng = _rng_from_state(state["rng"])
        self._gen = int(state["generation"])
        self._offset = int(state["offset"])
        self._pop = np.asarray(state["pop"], dtype=np.int64)
        self._pending = [np.asarray(p, np.float64).reshape(-1, len(
            self._objectives)) for p in state["pending"]]
