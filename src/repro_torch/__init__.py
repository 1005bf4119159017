"""repro_torch: the sparsity-aware SNN accelerator DSE in PyTorch, with
hand-written CUDA kernels for Hopper.

Subpackages mirror the JAX package ``repro`` module for module:
  core         spiking model, accelerator model, DSE, workload registry
  kernels      CUDA kernels (sm_90a), ctypes bindings, plain versions
  data         synthetic datasets
  distributed  many cells at once: the process farm, stacked slabs and
               the fleet; the training supervisor
  serve        the multi-tenant DSE service and its event protocol
  checkpoint   atomic checkpoints of NumPy and tensor trees
and ``convert`` carries parameters between the two packages as NumPy.
Public entry points run on ``device="cuda"`` unless told ``device="cpu"``.
"""
