"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each kernel has ``csrc/<name>.cu`` (the kernel, a C entry point),
``<name>.py`` (the ctypes binding with operand checks and a launch count),
and a plain PyTorch version in ``ref.py``.  ``ops.py`` holds the public
wrappers, which dispatch by the device of the tensors.

The package exports the JAX package's kernel API (``repro.kernels``).  Three
of its functions share a name with their binding module (``spike_gemm``,
``lif_step``, ``penc_compact``), as in the JAX package: the package
attribute is the function, and the module is reached by its full name
(``importlib.import_module("repro_torch.kernels.lif_step")``).  ``ops``
imports the binding modules before these names are bound, so it holds the
modules.
"""
from repro_torch.kernels.ops import (apply_permutation,
                                    firing_rate_permutation, lif_step,
                                    penc_compact, skip_fraction, spike_gemm,
                                    spike_gemm_bwd_ds, spike_gemm_bwd_dw,
                                    spike_gemm_lif_step, spike_gemm_profiled,
                                    spike_gemm_train)

__all__ = ["lif_step", "spike_gemm", "spike_gemm_profiled",
           "spike_gemm_train", "spike_gemm_lif_step", "spike_gemm_bwd_dw",
           "spike_gemm_bwd_ds", "penc_compact", "skip_fraction",
           "firing_rate_permutation", "apply_permutation"]
