"""Training launcher.  Only ``small_config`` is ported so far: the
serving launcher uses it to scale an architecture down for host-side runs.
``run_training`` (the supervised, checkpointed LM training loop) comes with
the LM training slice (ROADMAP §1).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig


def small_config(base: ArchConfig, d_model: int, layers: int,
                 vocab: int) -> ArchConfig:
    """Scale an arch config down (same family wiring) for host-side runs."""
    heads = max(4, base.n_heads * d_model // max(base.d_model, 1))
    heads = min(heads, d_model // 16)
    n_kv = max(1, min(base.n_kv, heads))
    while heads % n_kv:
        n_kv -= 1
    hd = d_model // heads
    sections = base.mrope_sections
    if base.rope == "mrope":
        half = hd // 2
        a = half // 4
        b = (half - a) // 2
        sections = (a, b, half - a - b)
    return dataclasses.replace(
        base, num_layers=layers, d_model=d_model, n_heads=heads, n_kv=n_kv,
        d_ff=d_model * 4 if base.d_ff else 0, vocab=vocab,
        head_dim=hd, dtype="float32", mrope_sections=sections)
