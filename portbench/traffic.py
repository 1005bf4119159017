"""The general traffic generator: a pool of samples made on the device from
the run's seed, and the order in which a run's steps draw batches from it.

A mix is a JSON file under ``traffic/``; its ``kind`` picks one of two
generators, torch copies of the port's ``data/synthetic.py``:

* ``events``: ``make_events``' DVS-like streams, a 5 x 5 blob moving along
  a class-specific line (on events where it arrives, off events where it
  leaves) OR-ed with sensor noise.  ``or_bins`` > 1 bins the stream into
  fewer steps, each the OR of that many consecutive bins.  Stored as uint8
  and fed as float32 (B, T, H, W, 2), as ``train_snn.train`` feeds events.
* ``images``: ``make_images``' intensities, smooth class prototypes plus
  pixel noise times a per-sample gain, clipped to [0, 1], flattened; the
  port's train step rate-codes them.

Every draw comes from generators seeded by ``seed_of(seed, ...)``, so a
seed gives the same pool and the same batches on every run.  A run draws
its batches epoch by epoch: each cell of a slab walks its own permutation
of the pool, so a batch never repeats a row within an epoch.
"""
from __future__ import annotations

import hashlib
import math

import torch

#: Samples made at once while a pool is generated (bounds its memory).
_CHUNK = 32


def seed_of(seed: int, *tags) -> int:
    """A 63-bit seed derived from the run's ``seed`` and ``tags``."""
    text = ":".join(str(t) for t in (seed, *tags))
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_of(seed, *tags))


def num_steps(mix: dict, default: int) -> int:
    """The spike-train length a mix feeds: its binned stream's, or the
    configuration's ``default`` for rate-coded images."""
    if mix["kind"] == "events":
        return mix["bins"] // mix.get("or_bins", 1)
    return default


def make_events(mix: dict, num_classes: int, gen: torch.Generator,
                device) -> tuple[torch.Tensor, torch.Tensor]:
    """(pool (N, T, H, W, 2) uint8, labels (N,) int64)."""
    n, bins, h, w = mix["pool"], mix["bins"], mix["height"], mix["width"]
    group = mix.get("or_bins", 1)
    half = mix["blob"] // 2
    f64 = dict(dtype=torch.float64, device=device)
    labels = torch.randint(num_classes, (n,), generator=gen, device=device)
    angles = torch.arange(num_classes, **f64) * (2 * math.pi / num_classes)
    speeds = 1.0 + 0.5 * (torch.arange(num_classes, **f64) % 2)
    cy = h * (0.3 + 0.4 * torch.rand(n, generator=gen, **f64))
    cx = w * (0.3 + 0.4 * torch.rand(n, generator=gen, **f64))
    ang, spd = angles[labels], speeds[labels]
    ts = torch.arange(bins, **f64)
    # the blob's centre bin by bin, truncated and wrapped as int(.) % h
    py = torch.remainder(torch.trunc(cy[:, None] + (spd * torch.sin(ang))
                                     [:, None] * ts), h).long()
    px = torch.remainder(torch.trunc(cx[:, None] + (spd * torch.cos(ang))
                                     [:, None] * ts), w).long()
    rows = torch.arange(h, device=device)
    cols = torch.arange(w, device=device)
    pool = torch.empty((n, bins // group, h, w, 2), dtype=torch.uint8,
                       device=device)
    for i in range(0, n, _CHUNK):
        j = min(i + _CHUNK, n)
        in_r = (rows[None, None, :] - py[i:j, :, None]).abs() <= half
        in_c = (cols[None, None, :] - px[i:j, :, None]).abs() <= half
        blob = in_r[..., :, None] & in_c[..., None, :]     # (c, bins, h, w)
        ev = torch.zeros((j - i, bins, h, w, 2), dtype=torch.bool,
                         device=device)
        ev[:, 1:, ..., 0] = blob[:, 1:] & ~blob[:, :-1]     # on
        ev[:, 1:, ..., 1] = blob[:, :-1] & ~blob[:, 1:]     # off
        ev |= torch.rand((j - i, bins, h, w, 2), generator=gen,
                         device=device) < mix["noise_p"]
        if group > 1:
            ev = ev.reshape(j - i, bins // group, group, h, w, 2).any(2)
        pool[i:j] = ev.to(torch.uint8)
    return pool, labels


def make_images(mix: dict, num_classes: int, gen: torch.Generator,
                device) -> tuple[torch.Tensor, torch.Tensor]:
    """(pool (N, H*W) float32 in [0, 1], labels (N,) int64)."""
    n, h, w, blobs = mix["pool"], mix["height"], mix["width"], mix["blobs"]
    f32 = dict(dtype=torch.float32, device=device)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, **f32)

    shape = (num_classes, blobs, 1, 1)
    cy, cx = uniform(shape, 4, h - 4), uniform(shape, 4, w - 4)
    sig, amp = uniform(shape, 1.5, 4.0), uniform(shape, 0.5, 1.0)
    yy = torch.arange(h, **f32)[:, None]
    xx = torch.arange(w, **f32)[None, :]
    protos = (amp * torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                              / (2 * sig ** 2))).sum(1)
    protos = protos / (protos.amax(dim=(1, 2), keepdim=True) + 1e-9)
    labels = torch.randint(num_classes, (n,), generator=gen, device=device)
    x = protos[labels] + mix["noise"] * torch.randn((n, h, w), generator=gen,
                                                    **f32)
    lo, hi = mix["gain"]
    x = (x * uniform((n, 1, 1), lo, hi)).clamp(0.0, 1.0)
    return x.reshape(n, h * w), labels


GENERATORS = {"events": make_events, "images": make_images}


class Feed:
    """The batches of one run: ``next()`` gives the pool rows of the next
    step, (C, B) for a slab of C cells or (B,) for one cell, and
    ``batch(rows)`` the step's (x, y) on the device."""

    def __init__(self, mix: dict, num_classes: int, seed: int, device):
        self.device = device
        self.cells = mix.get("cells")
        self.batch_size = mix["batch"]
        self.pool, self.labels = GENERATORS[mix["kind"]](
            mix, num_classes, generator(device, seed, "pool"), device)
        n = self.pool.shape[0]
        if n < 3 * self.batch_size:
            raise ValueError(f"a pool of {n} cannot give three batches of "
                             f"{self.batch_size} distinct rows")
        self._order = generator(device, seed, "order")
        self._per_epoch = n // self.batch_size
        self._perm = None
        self._at = self._per_epoch

    def next(self) -> torch.Tensor:
        if self._at == self._per_epoch:
            n = self.pool.shape[0]
            self._perm = torch.rand((self.cells or 1, n),
                                    generator=self._order,
                                    device=self.device).argsort(dim=1)
            self._at = 0
        b = self.batch_size
        rows = self._perm[:, self._at * b:(self._at + 1) * b]
        self._at += 1
        return rows if self.cells else rows[0]

    def batch(self, rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.pool[rows].to(torch.float32), self.labels[rows]
