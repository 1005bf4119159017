"""Atomic checkpoints of NumPy trees, in the JAX package's format."""
