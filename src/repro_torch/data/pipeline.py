"""Deterministic host-side data pipeline for LM training: the JAX package's
``repro.data.pipeline``, with its NumPy batches unchanged and its device
batches as tensors.

Determinism: batch ``i`` of a given (seed, config) is identical regardless
of host count, the elastic-restart requirement; ``host_slice`` is the rows
of the global batch one host of several builds.  On a mesh every rank
draws the same global batch and keeps its block of it, as
``device_batches(..., shardings=...)`` places it.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.seq_len]))


def synthetic_lm_batch(cfg: DataConfig, step: int,
                       order: int = 2) -> dict[str, np.ndarray]:
    """Markov-chain token batch (learnable structure) for step ``step``."""
    rng = _batch_rng(cfg, step)
    likely_rng = np.random.default_rng(cfg.seed)       # chain fixed per run
    likely = likely_rng.integers(0, cfg.vocab, size=(cfg.vocab, 4))
    ctx_w = likely_rng.integers(1, cfg.vocab, size=order)
    B, S = cfg.global_batch, cfg.seq_len
    seqs = np.zeros((B, S + 1), np.int32)
    state = rng.integers(0, cfg.vocab, size=(B, order))
    for t in range(S + 1):
        ctx = (state * ctx_w).sum(-1) % cfg.vocab
        choice = likely[ctx, rng.integers(0, 4, size=B)]
        noise = rng.integers(0, cfg.vocab, size=B)
        tok = np.where(rng.random(B) < 0.1, noise, choice).astype(np.int32)
        seqs[:, t] = tok
        state = np.concatenate([state[:, 1:], tok[:, None]], axis=1)
    return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}


def host_slice(global_arr: np.ndarray, process_index: int,
               process_count: int) -> np.ndarray:
    """The rows of the global batch this host is responsible for."""
    B = global_arr.shape[0]
    per = B // process_count
    return global_arr[process_index * per:(process_index + 1) * per]


def to_device(host: dict[str, np.ndarray],
              device: DeviceLike = None) -> dict[str, torch.Tensor]:
    """A NumPy batch as int32 tensors on ``device`` (the token ids that
    ``layers.embed`` indexes with; the loss widens the labels itself)."""
    dev = resolve(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in host.items()}


def device_batch(cfg: DataConfig, step: int, device: DeviceLike = None,
                 shardings: Optional[dict] = None) -> dict:
    """Batch ``step`` on ``device``.  ``shardings``: a
    ``sharding.NamedSharding`` per key (from ``batch_specs``); the batch is
    then DTensors on that mesh, each rank keeping its block, on the mesh's
    device type unless ``device`` says otherwise."""
    if shardings is None:
        return to_device(synthetic_lm_batch(cfg, step), device)
    from repro_torch.distributed.sharding import place
    device = device or next(iter(shardings.values())).mesh.device_type
    batch = to_device(synthetic_lm_batch(cfg, step), device)
    return {k: place(v, shardings[k]) for k, v in batch.items()}


def device_batches(cfg: DataConfig, device: DeviceLike = None,
                   start_step: int = 0,
                   shardings: Optional[dict] = None) -> Iterator[dict]:
    """``device_batch`` of every step from ``start_step`` on (restart
    support)."""
    step = start_step
    while True:
        yield device_batch(cfg, step, device, shardings)
        step += 1
