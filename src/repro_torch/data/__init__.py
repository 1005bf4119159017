"""Deterministic synthetic datasets (NumPy)."""
