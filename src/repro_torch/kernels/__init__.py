"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each kernel has ``csrc/<name>.cu`` (the kernel, a C entry point),
``<name>.py`` (the ctypes binding with operand checks and a launch count),
and a plain PyTorch version in ``ref.py``.  ``ops.py`` holds the public
wrappers, which dispatch by the device of the tensors.
"""
