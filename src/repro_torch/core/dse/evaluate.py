"""Batched candidate evaluation: axis columns in, metric columns out.

One call evaluates a whole chunk of candidates through the vectorised cycle
model and component library — there is no per-candidate Python object or
``with_lhr`` materialization anywhere on this path.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.accelerator import cycle_model, resources
from repro_torch.core.accelerator.arch import AcceleratorConfig

METRICS = ("cycles", "lut", "reg", "bram", "dsp", "energy")

AXIS_NAMES = frozenset(
    {"lhr", "mem_blocks", "weight_bits", "penc_width", "clock_mhz"})


def evaluate_columns(cfg: AcceleratorConfig, counts: Sequence[np.ndarray],
                     cols: dict[str, np.ndarray],
                     lib: Optional[resources.CostLibrary] = None
                     ) -> dict[str, np.ndarray]:
    """Evaluate a chunk of candidates given as column arrays.

    ``cols`` maps axis names (``lhr``, ``mem_blocks``, ``weight_bits``,
    ``penc_width``, ``clock_mhz``) to (n, L) per-layer or (n,) global
    arrays.  Returns (n,) metric columns for ``METRICS``.
    """
    unknown = set(cols) - AXIS_NAMES
    if unknown:
        raise ValueError(f"unknown axes {sorted(unknown)}; "
                         f"known: {sorted(AXIS_NAMES)}")
    if not cols:
        raise ValueError("no axis columns to evaluate")
    lib = lib or resources.CostLibrary()
    n = len(next(iter(cols.values())))
    lhr = cols.get("lhr")
    mem = cols.get("mem_blocks")
    wb = cols.get("weight_bits")
    pw = cols.get("penc_width")
    clk = cols.get("clock_mhz")

    cycles = cycle_model.latency_cycles(
        cfg, counts, lhr_matrix=lhr, mem_blocks_matrix=mem, penc_width=pw)
    cycles = np.broadcast_to(np.asarray(cycles, np.float64), (n,)).copy()

    if any(a is not None for a in (lhr, mem, wb, pw)):
        res = resources.estimate_vector(
            cfg, lhr_matrix=lhr, mem_blocks_matrix=mem, weight_bits=wb,
            penc_width=pw, lib=lib)
        lut, reg = res.lut, res.reg
        bram, dsp = res.bram36, res.dsp
    else:                                    # only clock_mhz varies
        r = resources.estimate(cfg, lib)
        lut, reg, bram, dsp = r.lut, r.reg, r.bram36, r.dsp

    energy = resources.energy_mj_vector(
        cfg, counts, cycles, lhr_matrix=lhr, lut=lut, clock_mhz=clk, lib=lib)

    def bcast(x, dtype):
        return np.broadcast_to(np.asarray(x, dtype), (n,)).copy()

    return {"cycles": cycles,
            "lut": bcast(lut, np.float64),
            "reg": bcast(reg, np.float64),
            "bram": bcast(bram, np.int64),
            "dsp": bcast(dsp, np.int64),
            "energy": bcast(energy, np.float64)}
