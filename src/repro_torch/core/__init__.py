"""The spiking model (``lif``, ``encoding``, ``snn``, ``train_snn``), the
accelerator model (``accelerator``), the design-space search (``dse``) and
the workload registry (``workloads``), in PyTorch and NumPy."""
from repro_torch.core.lif import LIFParams, lif_step, spike_fn
from repro_torch.core.snn import Conv, Dense, MaxPool, SNNConfig

__all__ = ["LIFParams", "lif_step", "spike_fn", "SNNConfig", "Dense", "Conv",
           "MaxPool"]
