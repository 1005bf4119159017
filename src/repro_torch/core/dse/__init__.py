"""Design-space exploration over the accelerator model (NumPy), and the
paper's study loop over model cells trained in torch.

* ``space``      — declarative ``SearchSpace``: per-layer LHR, memory
                   blocks, weight precision, PENC width and clock, plus
                   model axes (``num_steps``, ``population``, ``dataset``)
                   that resolve by training.
* ``table``      — ``CandidateTable``: structure-of-arrays rows.
* ``evaluate``   — one vectorised cycle-model + cost call per chunk.
* ``pareto``     — k-objective Pareto masks and the incremental merge.
* ``strategies`` — the ask/tell contract: ``GridSearch``,
                   ``RandomSearch``, ``EvolutionarySearch``.
* ``study``      — ``explore(space, ...) -> Study``: chunked evaluation,
                   the Pareto merge, model cells resolved through the torch
                   ``workloads.TraceCache`` with a training budget in cache
                   misses, checkpoint/resume, and the cell farm
                   (``workers=N``, ``stack=True``, ``workers="cluster"``).
* ``engine``     — ``search``/``SearchResult``/``auto_select``, thin
                   wrappers over ``explore`` for hardware-only spaces.
* ``coexplore``  — the cell-enumerating co-exploration front end, a thin
                   wrapper over ``explore``.
* ``compat``     — the seed API (``sweep``, ``sweep_memory_blocks``,
                   ``sweep_weight_bits``, ``Candidate``/``DSEResult``) over
                   the engine.

Each module is a copy of ``repro.core.dse``'s with its imports changed;
cells train on the cache's device, and ``workers="cluster"`` runs on the
port's fleet (``repro_torch.distributed.fleet``).
"""
from repro_torch.core.dse.coexplore import (CO_METRICS,
                                            DEFAULT_CO_OBJECTIVES,
                                            CellRecord, CoExploreResult,
                                            coexplore)
from repro_torch.core.dse.compat import (Candidate, DSEResult,
                                         MemBlockCandidate, lhr_grid, sweep,
                                         sweep_memory_blocks,
                                         sweep_spike_train_length,
                                         sweep_weight_bits)
from repro_torch.core.dse.engine import (DEFAULT_OBJECTIVES, SearchResult,
                                         auto_select, search)
from repro_torch.core.dse.evaluate import METRICS, evaluate_columns
from repro_torch.core.dse.pareto import (ParetoAccumulator, any_dominates,
                                         frontier_of, pareto_mask,
                                         pareto_mask_k)
from repro_torch.core.dse.space import (MODEL_AXES, Axis, SearchSpace,
                                        pow2_values)
from repro_torch.core.dse.strategies import (EvolutionarySearch, GridSearch,
                                             RandomSearch, Strategy)
from repro_torch.core.dse.study import Study, explore
from repro_torch.core.dse.table import CandidateTable

__all__ = [
    "Axis", "CO_METRICS", "Candidate", "CandidateTable", "CellRecord",
    "CoExploreResult", "DEFAULT_CO_OBJECTIVES", "DEFAULT_OBJECTIVES",
    "DSEResult", "EvolutionarySearch", "GridSearch", "METRICS", "MODEL_AXES",
    "MemBlockCandidate", "ParetoAccumulator", "RandomSearch", "SearchResult",
    "SearchSpace", "Strategy", "Study", "any_dominates", "auto_select",
    "coexplore", "evaluate_columns", "explore", "frontier_of", "lhr_grid",
    "pareto_mask", "pareto_mask_k", "pow2_values", "search", "sweep",
    "sweep_memory_blocks", "sweep_spike_train_length", "sweep_weight_bits",
]
