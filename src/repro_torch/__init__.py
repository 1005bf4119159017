"""repro_torch: the sparsity-aware SNN accelerator DSE in PyTorch, with
hand-written CUDA kernels for Hopper.

Subpackages mirror the JAX package ``repro`` module for module:
  core      spiking model, accelerator model, DSE, workload registry
  kernels   CUDA kernels (sm_90a), their ctypes bindings and plain versions
  data      synthetic datasets
and ``convert`` carries parameters between the two packages as NumPy.
Public entry points run on ``device="cuda"`` unless told ``device="cpu"``.
"""
