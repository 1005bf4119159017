"""Workload registry and trace/accuracy cache: a ``Workload`` declares a
dataset, a topology template and a training recipe, and ``TraceCache``
trains-or-loads any ``(workload, num_steps, population, seed)`` cell
deterministically and content-addressed, under its own root."""
from repro_torch.core.workloads.cache import (BudgetExceeded, CellArtifact,
                                              TraceCache, TrainingBudget,
                                              cell_key, default_root)
from repro_torch.core.workloads.registry import (DATASET_FAMILIES, Workload,
                                                 get, names, register)

__all__ = ["BudgetExceeded", "CellArtifact", "DATASET_FAMILIES",
           "TraceCache", "TrainingBudget", "Workload", "cell_key",
           "default_root", "get", "names", "register"]
