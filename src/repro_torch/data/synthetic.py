"""Deterministic synthetic datasets (offline stand-ins for MNIST / FMNIST /
DVSGesture) plus token streams for the LM substrate.

The image datasets are *structurally matched* to the originals (28x28 in
[0,1], 10 classes; event streams with two polarity channels for the DVS
analogue) and are generated from fixed seeds so every run, test, and
benchmark sees identical data.  See DESIGN.md §7 for why (no network access).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class Dataset:
    name: str
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int


def _smooth_prototypes(rng: np.ndarray, num_classes: int, h: int, w: int,
                       blobs: int = 4) -> np.ndarray:
    """Class prototypes as mixtures of Gaussian blobs -> smooth, distinct."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    protos = np.zeros((num_classes, h, w), np.float32)
    for c in range(num_classes):
        for _ in range(blobs):
            cy, cx = rng.uniform(4, h - 4), rng.uniform(4, w - 4)
            sig = rng.uniform(1.5, 4.0)
            amp = rng.uniform(0.5, 1.0)
            protos[c] += amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2))
        protos[c] /= protos[c].max() + 1e-9
    return protos


def make_images(name: str = "synth-mnist", seed: int = 0, num_classes: int = 10,
                n_train: int = 2048, n_test: int = 512, h: int = 28, w: int = 28,
                noise: float = 0.15) -> Dataset:
    """MNIST/FMNIST-like: per-class smooth prototypes + pixel noise, in [0,1]."""
    rng = np.random.default_rng(seed)
    protos = _smooth_prototypes(rng, num_classes, h, w)

    def _make(n):
        y = rng.integers(0, num_classes, size=n)
        x = protos[y] + noise * rng.standard_normal((n, h, w)).astype(np.float32)
        # per-sample random gain, mimicking intensity variation
        x *= rng.uniform(0.7, 1.0, size=(n, 1, 1)).astype(np.float32)
        return np.clip(x, 0.0, 1.0), y.astype(np.int32)

    x_tr, y_tr = _make(n_train)
    x_te, y_te = _make(n_test)
    return Dataset(name, x_tr, y_tr, x_te, y_te, num_classes)


def make_events(name: str = "synth-dvs", seed: int = 0, num_classes: int = 8,
                n_train: int = 512, n_test: int = 128, t: int = 16,
                h: int = 32, w: int = 32) -> Dataset:
    """DVSGesture-like event streams: a bright blob moving along a
    class-specific trajectory; two polarity channels (on/off events).

    Returns x arrays of shape (N, T, H, W, 2) in {0,1}.
    """
    rng = np.random.default_rng(seed)
    angles = np.linspace(0, 2 * np.pi, num_classes, endpoint=False)
    speeds = 1.0 + 0.5 * (np.arange(num_classes) % 2)

    def _make(n):
        y = rng.integers(0, num_classes, size=n)
        x = np.zeros((n, t, h, w, 2), np.float32)
        for i in range(n):
            ang, spd = angles[y[i]], speeds[y[i]]
            cy, cx = rng.uniform(h * 0.3, h * 0.7), rng.uniform(w * 0.3, w * 0.7)
            dy, dx = spd * np.sin(ang), spd * np.cos(ang)
            prev = None
            for ts in range(t):
                py, px = int(cy + dy * ts) % h, int(cx + dx * ts) % w
                mask = np.zeros((h, w), bool)
                y0, y1 = max(py - 2, 0), min(py + 3, h)
                x0, x1 = max(px - 2, 0), min(px + 3, w)
                mask[y0:y1, x0:x1] = True
                if prev is not None:
                    on = mask & ~prev
                    off = prev & ~mask
                    x[i, ts, :, :, 0][on] = 1.0
                    x[i, ts, :, :, 1][off] = 1.0
                prev = mask
            # sensor noise events
            noise = rng.random((t, h, w, 2)) < 0.01
            x[i] = np.maximum(x[i], noise.astype(np.float32))
        return x, y.astype(np.int32)

    x_tr, y_tr = _make(n_train)
    x_te, y_te = _make(n_test)
    return Dataset(name, x_tr, y_tr, x_te, y_te, num_classes)


def make_tokens(seed: int = 0, vocab: int = 1024, n_seqs: int = 512,
                seq_len: int = 256, order: int = 2) -> np.ndarray:
    """Synthetic language data: a random order-``order`` Markov chain over the
    vocab — learnable structure for LM smoke training (loss must drop)."""
    rng = np.random.default_rng(seed)
    # sparse transition structure: each context maps to a few likely tokens
    ctx_hash_w = rng.integers(1, vocab, size=order)
    likely = rng.integers(0, vocab, size=(vocab, 4))
    seqs = np.zeros((n_seqs, seq_len), np.int32)
    state = rng.integers(0, vocab, size=(n_seqs, order))
    for t in range(seq_len):
        ctx = (state * ctx_hash_w).sum(-1) % vocab
        choice = likely[ctx, rng.integers(0, 4, size=n_seqs)]
        noise = rng.integers(0, vocab, size=n_seqs)
        take_noise = rng.random(n_seqs) < 0.1
        tok = np.where(take_noise, noise, choice)
        seqs[:, t] = tok
        state = np.concatenate([state[:, 1:], tok[:, None]], axis=1)
    return seqs


def batches(x: np.ndarray, y: np.ndarray, batch_size: int, seed: int = 0,
            epochs: int = 1) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    for _ in range(epochs):
        perm = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = perm[i:i + batch_size]
            yield x[idx], y[idx]
