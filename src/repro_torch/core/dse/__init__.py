"""Design-space exploration over the accelerator model (NumPy).

* ``space``      — declarative ``SearchSpace`` over per-layer LHR, memory
                   blocks, weight precision, PENC width and clock.
* ``table``      — ``CandidateTable``: structure-of-arrays rows.
* ``evaluate``   — one vectorised cycle-model + cost call per chunk.
* ``pareto``     — k-objective Pareto masks and the incremental merge.
* ``strategies`` — the ask/tell contract: ``GridSearch``,
                   ``RandomSearch``, ``EvolutionarySearch``.
* ``engine``     — ``search``/``SearchResult`` for hardware-only spaces.
"""
from repro_torch.core.dse.engine import (DEFAULT_OBJECTIVES, SearchResult,
                                         search)
from repro_torch.core.dse.evaluate import METRICS, evaluate_columns
from repro_torch.core.dse.pareto import (ParetoAccumulator, any_dominates,
                                         frontier_of, pareto_mask,
                                         pareto_mask_k)
from repro_torch.core.dse.space import Axis, SearchSpace, pow2_values
from repro_torch.core.dse.strategies import (EvolutionarySearch, GridSearch,
                                             RandomSearch, Strategy)
from repro_torch.core.dse.table import CandidateTable

__all__ = [
    "Axis", "CandidateTable", "DEFAULT_OBJECTIVES", "EvolutionarySearch",
    "GridSearch", "METRICS", "ParetoAccumulator", "RandomSearch",
    "SearchResult", "SearchSpace", "Strategy", "any_dominates",
    "evaluate_columns", "frontier_of", "pareto_mask", "pareto_mask_k",
    "pow2_values", "search",
]
