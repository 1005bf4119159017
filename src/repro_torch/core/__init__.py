"""The spiking model (``lif``, ``encoding``, ``snn``, ``train_snn``), the
layer-wise firing analysis of the paper's Fig. 1 (``sparsity``), the
accelerator model (``accelerator``), the design-space search and study loop
(``dse``), the spike-to-spike hardware validation (``validate``) and the
workload registry and trace cache (``workloads``), in PyTorch and NumPy."""
from repro_torch.core.lif import LIFParams, lif_step, spike_fn
from repro_torch.core.snn import Conv, Dense, MaxPool, SNNConfig

__all__ = ["LIFParams", "lif_step", "spike_fn", "SNNConfig", "Dense", "Conv",
           "MaxPool"]
