"""Workload registry: dataset, topology template and recipe of a model
cell.  The trace cache is not ported yet."""
from repro_torch.core.workloads.registry import (DATASET_FAMILIES, Workload,
                                                 get, names, register)

__all__ = ["DATASET_FAMILIES", "Workload", "get", "names", "register"]
