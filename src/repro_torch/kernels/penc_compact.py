"""PENC spike-address compaction on the card (``csrc/penc_compact.cu``).

Per row of (B, N) fp32 spikes: the ascending indices of the entries > 0,
packed to the front of a (B, capacity) int32 row, -1 padded and cut at
``capacity``; and the row's spike count, not cut, as (B,) int32 (the
paper's Event Control Unit priority-encodes a spike train into addresses
in this order).  ``ops.penc_compact`` is the public entry point and sends
CPU tensors to ``ref.penc_compact_ref`` instead.

A row longer than one tile is split across blocks (``penc_plan``): a mask
pass writes a bitmask and each tile's spike count into a workspace, and an
address pass gives each tile its first slot and its share of the -1 pad.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch import spans
from repro_torch.kernels import build

_INT_MAX = 2 ** 31 - 1
#: Entries of a round of the two-pass kernels: 256 threads, each with 4
#: 16-byte loads of 4 neighbours.  A tile is a whole number of rounds.
ROUND = 4096
#: Entries whose bitmask is one group of 4 uint32 words; bit l of word j
#: is entry 4 l + j of the group.
CHUNK = 128
#: Most tiles a row is cut into, so a block of the address pass reads a
#: bounded number of the row's tile counts.
MAX_TILES = 1024


class PencPlan(NamedTuple):
    """How ``penc_compact_cuda`` cuts a (b, n) call at ``capacity``."""
    b: int
    n: int
    capacity: int
    tile: int        # entries of a row one block covers
    tiles: int       # tiles a row
    pad: int         # slots of [0, capacity) each tile pads

    @property
    def one_launch(self) -> bool:
        """One tile a row: a block a row, in one kernel and no workspace."""
        return self.tiles == 1

    @property
    def mask_words(self) -> int:
        """int32 words of the bitmask: 4 per ``CHUNK`` entries of a row."""
        return 0 if self.one_launch else self.b * 4 * -(-self.n // CHUNK)

    @property
    def count_words(self) -> int:
        """int32 words of the tile counts, one a (row, tile)."""
        return 0 if self.one_launch else self.b * self.tiles

    def tile_range(self, t: int) -> tuple[int, int]:
        """The [lo, hi) entries of a row that tile ``t`` reads."""
        return min(self.n, t * self.tile), min(self.n, (t + 1) * self.tile)

    def pad_range(self, t: int) -> tuple[int, int]:
        """The [lo, hi) slots of a row whose -1 pad tile ``t`` writes,
        where they lie at or beyond the row's count."""
        return (min(self.capacity, t * self.pad),
                min(self.capacity, (t + 1) * self.pad))


def penc_plan(b: int, n: int, capacity: int) -> PencPlan:
    """One round a tile, up to ``MAX_TILES`` tiles a row: net-5's conv2
    input (64, 131072) runs 2,048 blocks of 4,096 entries, fc1's (64,
    32768) 512, fc2's and fc3's rows one launch of 64 blocks.  Tiles of
    8,192 or 16,384 entries were slower at capacity N (PERF.md)."""
    rounds = max(1, -(-(-(-n // ROUND)) // MAX_TILES))
    tile = ROUND * rounds
    tiles = max(1, -(-n // tile))
    return PencPlan(b, n, capacity, tile, tiles, -(-capacity // tiles))


def workspace(plan: PencPlan, device: torch.device) -> torch.Tensor | None:
    """The bitmask and tile counts of a two-pass ``plan``, one int32
    tensor, or None for one launch.  The wrapper holds it until both
    launches are queued: freed before, its memory could go to an output."""
    if plan.one_launch:
        return None
    return torch.empty(plan.mask_words + plan.count_words, dtype=torch.int32,
                       device=device)


@functools.cache
def _entry():
    fn = build.library("penc_compact").penc_compact_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def penc_compact_cuda(spikes: torch.Tensor, capacity: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel(s) on the current stream; raises on any operand
    the kernel does not take (device, dtype, shape, contiguity, sizes)."""
    dev = build.cuda_device(spikes, "penc_compact")
    if spikes.dim() != 2:
        raise ValueError(f"penc_compact takes (B, N) spikes, got shape "
                         f"{tuple(spikes.shape)}")
    b, n = spikes.shape
    build.check_operand(spikes, "spikes", (b, n), dev)
    plan = penc_plan(b, n, capacity)
    if not 0 <= capacity <= _INT_MAX or max(b, n) > _INT_MAX or \
            b * plan.tiles > _INT_MAX:
        raise ValueError(f"penc_compact takes 0 <= capacity and sizes below "
                         f"2**31, got capacity {capacity}, spikes {(b, n)}")
    idx = torch.empty((b, capacity), dtype=torch.int32, device=dev)
    counts = torch.empty((b,), dtype=torch.int32, device=dev)
    ws = workspace(plan, dev)
    vectorized = int(n % 4 == 0 and spikes.data_ptr() % 16 == 0)
    err = _entry()(spikes.data_ptr(), idx.data_ptr(), counts.data_ptr(),
                   None if ws is None else ws.data_ptr(), b, n, capacity,
                   plan.tile, plan.tiles, plan.pad, vectorized,
                   build.stream_ptr(dev))
    build.check_launch(err, "penc_compact")
    spans.count("launch.penc_compact")   # one a call, one pass or two
    return idx, counts
