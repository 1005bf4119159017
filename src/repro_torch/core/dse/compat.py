"""Legacy DSE API, rewired as thin wrappers over the streaming engine.

The seed engine's entry points (``sweep``, ``sweep_memory_blocks``,
``sweep_weight_bits``, ``lhr_grid``, ``Candidate``/``DSEResult``) keep their
exact signatures and numerics, but every evaluation now runs through the
chunked vectorised path — no per-candidate ``with_lhr`` materialization or
scalar ``energy_mj`` calls remain.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.accelerator import cycle_model, resources
from repro_torch.core.accelerator.arch import AcceleratorConfig
from repro_torch.core.dse.engine import search
from repro_torch.core.dse.evaluate import evaluate_columns
from repro_torch.core.dse.pareto import pareto_mask
from repro_torch.core.dse.space import SearchSpace, pow2_values


@dataclasses.dataclass(frozen=True)
class Candidate:
    lhr: tuple[int, ...]
    cycles: float
    lut: float
    energy_mj: float
    pareto: bool = False


@dataclasses.dataclass
class DSEResult:
    config: AcceleratorConfig
    candidates: list[Candidate]

    @property
    def frontier(self) -> list[Candidate]:
        return [c for c in self.candidates if c.pareto]

    def best_within_latency(self, max_cycles: float) -> Optional[Candidate]:
        ok = [c for c in self.candidates if c.cycles <= max_cycles]
        return min(ok, key=lambda c: c.lut) if ok else None

    def best_within_area(self, max_lut: float) -> Optional[Candidate]:
        ok = [c for c in self.candidates if c.lut <= max_lut]
        return min(ok, key=lambda c: c.cycles) if ok else None

    def min_energy(self) -> Candidate:
        return min(self.candidates, key=lambda c: c.energy_mj)


def lhr_grid(cfg: AcceleratorConfig, max_lhr: int = 256,
             max_candidates: int = 200_000) -> np.ndarray:
    """All per-layer power-of-two LHR vectors (capped at layer size).

    Materializes the full (C, L) matrix, so it keeps the seed's candidate
    cap; for larger spaces build a ``SearchSpace`` and stream through
    ``search`` instead — there is no cap on that path.
    """
    axes = [pow2_values(min(max_lhr, layer.logical)) for layer in cfg.layers]
    n = int(np.prod([len(a) for a in axes]))
    if n > max_candidates:
        raise ValueError(f"{n} candidates exceed cap {max_candidates}; "
                         f"restrict max_lhr, sweep layerwise, or stream via "
                         f"dse.search(SearchSpace.product_lhr(cfg))")
    return np.array(list(itertools.product(*axes)), dtype=np.int64)


def sweep(cfg: AcceleratorConfig, counts: Sequence[np.ndarray],
          max_lhr: int = 256,
          lhr_matrix: Optional[np.ndarray] = None,
          chunk_size: int = 65536) -> DSEResult:
    """Evaluate every candidate LHR vector against a spike trace.

    ``counts``: per-layer (T,) traffic (trace or published averages).
    Evaluation is chunked and fully vectorised (including energy); the
    returned per-candidate object list is only built at the end, for
    compatibility.
    """
    lhr = np.asarray(lhr_matrix if lhr_matrix is not None
                     else lhr_grid(cfg, max_lhr), dtype=np.int64)
    n = len(lhr)
    cycles = np.empty(n)
    lut = np.empty(n)
    energy = np.empty(n)
    for s in range(0, n, chunk_size):
        m = evaluate_columns(cfg, counts, {"lhr": lhr[s:s + chunk_size]})
        cycles[s:s + chunk_size] = m["cycles"]
        lut[s:s + chunk_size] = m["lut"]
        energy[s:s + chunk_size] = m["energy"]
    mask = pareto_mask(cycles, lut)
    cands = [Candidate(lhr=tuple(int(x) for x in lhr[i]),
                       cycles=float(cycles[i]), lut=float(lut[i]),
                       energy_mj=float(energy[i]), pareto=bool(mask[i]))
             for i in range(n)]
    return DSEResult(config=cfg, candidates=cands)


def sweep_spike_train_length(cfg: AcceleratorConfig,
                             counts_per_t: dict[int, Sequence[np.ndarray]],
                             lhr: Sequence[int]) -> dict[int, float]:
    """Latency as a function of spike-train length T (paper Fig. 7b)."""
    out = {}
    c = cfg.with_lhr(lhr)
    for T, counts in counts_per_t.items():
        out[T] = float(cycle_model.latency_cycles(
            dataclasses.replace(c, num_steps=T), counts))
    return out


@dataclasses.dataclass(frozen=True)
class MemBlockCandidate:
    blocks: tuple[int, ...]      # memory blocks per layer
    cycles: float
    lut: float
    bram: int


def sweep_memory_blocks(cfg: AcceleratorConfig, counts: Sequence[np.ndarray],
                        divisors: Sequence[int] = (1, 2, 4, 8)
                        ) -> list[MemBlockCandidate]:
    """Explore memory blocks per layer (paper Sec. IV: "modifications can be
    made to the hardware configuration (e.g. ... reduce the memory blocks)").

    Fewer blocks than NUs serialize weight reads (``LayerHW.contention``)
    but shrink the BRAM + mapping-logic budget.  A thin wrapper: one joint
    ``mem_blocks`` axis through the streaming engine.
    """
    options = [tuple(max(1, layer.num_nus // d) for layer in cfg.layers)
               for d in divisors]
    space = SearchSpace(cfg).add_joint("mem_blocks", options)
    res = search(cfg, counts, space=space,
                 objectives=("cycles", "lut", "bram"), keep_all=True)
    t = res.table
    return [MemBlockCandidate(
        blocks=tuple(int(x) for x in t.columns["mem_blocks"][i]),
        cycles=float(t.columns["cycles"][i]),
        lut=float(t.columns["lut"][i]),
        bram=int(t.columns["bram"][i])) for i in range(len(t))]


def sweep_weight_bits(cfg: AcceleratorConfig,
                      bits_options: Sequence[int] = (4, 6, 8, 12, 16)
                      ) -> dict[int, int]:
    """BRAM footprint vs synapse weight precision (paper Sec. III notes
    weight quantization "significantly affects the system's memory
    requirements").  Accuracy impact is measured separately with the
    fixed-point validator (``validate.quantized_accuracy``).  A thin
    wrapper over the batched resource path."""
    bits = np.asarray(bits_options, dtype=np.int64)
    bram = resources.estimate_vector(cfg, weight_bits=bits).bram36
    return {int(b): int(r) for b, r in zip(bits, bram)}
