"""FPGA resource + energy estimation (the paper's component cost library).

The paper synthesizes each hardware component once (Xilinx Virtex
UltraScale+, 100 MHz) and sums per-component costs at configuration time.  We
cannot run Vivado here, so the per-component constants are **calibrated
against the paper's own Table I** by least squares (see ``calibrate.py``,
which re-derives them from ``paper_data``); EXPERIMENTS.md reports per-row
residuals.  The structural model is the paper's:

  per NU:          LIF datapath (leak multiplier, adder, comparator) + regs
  per layer ECU:   chunked PENC (~penc_width bits), bit-reset logic, FSM,
                   shift-register address array (fan_in addresses deep)
  per mem block:   BRAM36 primitives holding synapse rows + mapping logic
  top level:       per-layer interconnect / wrapper overhead
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.accelerator.arch import (AcceleratorConfig, LayerHW,
                                         per_layer_col)


@dataclasses.dataclass(frozen=True)
class CostLibrary:
    # --- LUT (calibrated: see calibrate.py; residuals in EXPERIMENTS.md) ---
    lut_per_nu: float = 103.0          # FC LIF ALU + address decode
    lut_per_conv_nu: float = 1858.3    # conv NU: 2D addr extraction (Fig. 5)
    lut_per_penc_bit: float = 3.5      # priority encoder + bit-reset
    lut_per_mem_block: float = 18.2    # mapping/arbitration logic
    lut_fixed_per_layer: float = 427.4 # ECU FSM + wrapper
    # --- REG ---
    reg_per_nu: float = 77.2           # membrane/state registers
    reg_per_conv_nu: float = 2735.6    # conv NU pipeline registers
    reg_per_addr_bit: float = 0.944    # shift-register address array
    reg_fixed_per_layer: float = 301.8
    # --- BRAM / DSP ---
    bram36_bits: int = 36 * 1024
    dsp_per_nu: float = 1.0            # beta multiplier
    # --- energy (fit to Table I energy column, relative least squares) ---
    static_w: float = 0.346            # device static + clock tree
    w_per_lut: float = 0.0             # dynamic power per active LUT (the
    #                                    relative fit attributes LUT-correlated
    #                                    energy to the per-op term below)
    pj_per_acc_op: float = 13.2        # per weight accumulate (BRAM read+add)


@dataclasses.dataclass(frozen=True)
class Resources:
    lut: float
    reg: float
    bram36: int
    dsp: int

    def __add__(self, o: "Resources") -> "Resources":
        return Resources(self.lut + o.lut, self.reg + o.reg,
                         self.bram36 + o.bram36, self.dsp + o.dsp)


def layer_resources(layer: LayerHW, lib: CostLibrary = CostLibrary()) -> Resources:
    nus = layer.num_nus
    # the shift-register array stores compressed spike addresses; the paper
    # sizes it for the layer's worst-case traffic (= fan_in addresses).
    # reg_per_addr_bit is the calibrated per-slot register cost (addr width
    # amortized into the constant).
    shift_regs = layer.fan_in_size * lib.reg_per_addr_bit
    lut_nu = lib.lut_per_conv_nu if layer.kind == "conv" else lib.lut_per_nu
    reg_nu = lib.reg_per_conv_nu if layer.kind == "conv" else lib.reg_per_nu
    lut = (lut_nu * nus
           + lib.lut_per_penc_bit * layer.penc_width
           + lib.lut_per_mem_block * layer.num_mem_blocks
           + lib.lut_fixed_per_layer)
    reg = (reg_nu * nus
           + shift_regs
           + lib.reg_fixed_per_layer)
    bram = math.ceil(layer.synapses * layer.weight_bits / lib.bram36_bits)
    return Resources(lut=lut, reg=reg, bram36=max(bram, 1), dsp=nus)


def estimate(cfg: AcceleratorConfig, lib: CostLibrary = CostLibrary()) -> Resources:
    total = Resources(0.0, 0.0, 0, 0)
    for layer in cfg.layers:
        total = total + layer_resources(layer, lib)
    return total


@dataclasses.dataclass(frozen=True)
class ResourcesVector:
    """Per-candidate resource columns for a batch of C designs."""
    lut: np.ndarray                  # (C,) float
    reg: np.ndarray                  # (C,) float
    bram36: np.ndarray               # (C,) int
    dsp: np.ndarray                  # (C,) int


def estimate_vector(cfg: AcceleratorConfig,
                    lhr_matrix: np.ndarray | None = None,
                    mem_blocks_matrix: np.ndarray | None = None,
                    weight_bits: np.ndarray | None = None,
                    penc_width: np.ndarray | None = None,
                    lib: CostLibrary = CostLibrary()) -> ResourcesVector:
    """Vectorised resource estimate over C candidate designs (DSE).

    Per-layer matrices are (C, L); ``weight_bits``/``penc_width`` may also be
    (C,) globals.  Any ``None`` axis falls back to the config's own values,
    so the result matches ``estimate`` row-for-row on materialized configs.
    """
    given = [a for a in (lhr_matrix, mem_blocks_matrix, weight_bits,
                         penc_width) if a is not None]
    if not given:
        raise ValueError("estimate_vector needs at least one candidate axis; "
                         "use estimate() for a single config")
    n = len(np.asarray(given[0]))
    lut = np.zeros(n)
    reg = np.zeros(n)
    bram = np.zeros(n, dtype=np.int64)
    dsp = np.zeros(n)
    for l, layer in enumerate(cfg.layers):
        lhr_l = per_layer_col(lhr_matrix, l)
        nus = (np.ceil(layer.logical / np.asarray(lhr_l, np.float64))
               if lhr_l is not None else np.float64(layer.num_nus))
        mem_l = per_layer_col(mem_blocks_matrix, l)
        if mem_l is None:
            mem = layer.mem_blocks if layer.mem_blocks else nus
        else:
            mem_l = np.asarray(mem_l, np.float64)
            mem = np.where(mem_l > 0, mem_l, nus)
        pw_l = per_layer_col(penc_width, l)
        pw = layer.penc_width if pw_l is None else pw_l
        wb_l = per_layer_col(weight_bits, l)
        wb = layer.weight_bits if wb_l is None else np.asarray(wb_l, np.int64)
        lut_nu = lib.lut_per_conv_nu if layer.kind == "conv" else lib.lut_per_nu
        reg_nu = lib.reg_per_conv_nu if layer.kind == "conv" else lib.reg_per_nu
        lut += (lut_nu * nus + lib.lut_per_penc_bit * pw
                + lib.lut_per_mem_block * mem + lib.lut_fixed_per_layer)
        reg += (reg_nu * nus + layer.fan_in_size * lib.reg_per_addr_bit
                + lib.reg_fixed_per_layer)
        bram += np.maximum(-(-(layer.synapses * wb) // lib.bram36_bits), 1)
        dsp += nus
    return ResourcesVector(lut=lut, reg=reg, bram36=bram,
                           dsp=dsp.astype(np.int64))


def estimate_lut_vector(cfg: AcceleratorConfig, lhr_matrix: np.ndarray,
                        lib: CostLibrary = CostLibrary()) -> np.ndarray:
    """Vectorised LUT estimate over (C, L) candidate LHR matrices (DSE)."""
    return estimate_vector(cfg, lhr_matrix=lhr_matrix, lib=lib).lut


def accumulate_ops(cfg: AcceleratorConfig, counts) -> float:
    """Total weight-accumulate operations per inference (for energy)."""
    ops = 0.0
    for layer, c in zip(cfg.layers, counts):
        c = np.asarray(c, dtype=np.float64)
        per_spike = (layer.lhr * layer.num_nus if layer.kind == "fc"
                     else layer.kernel ** 2 * layer.logical)
        ops += float(c.sum()) * per_spike
    return ops


def energy_mj(cfg: AcceleratorConfig, counts, cycles: float,
              lib: CostLibrary = CostLibrary()) -> float:
    """E = (static + LUT-proportional dynamic) * runtime + per-op energy."""
    res = estimate(cfg, lib)
    runtime_s = cycles / (cfg.timing.clock_mhz * 1e6)
    power_w = lib.static_w + lib.w_per_lut * res.lut
    return (power_w * runtime_s + lib.pj_per_acc_op * 1e-12 * accumulate_ops(cfg, counts)) * 1e3


def accumulate_ops_vector(cfg: AcceleratorConfig, counts,
                          lhr_matrix: np.ndarray | None = None) -> np.ndarray:
    """Vectorised ``accumulate_ops`` over (C, L) candidate LHR matrices.

    FC work per spike is ``lhr * ceil(logical / lhr)`` (each NU walks its
    owned neurons), so it varies with the candidate; conv work is
    LHR-independent.
    """
    if lhr_matrix is None:
        return np.asarray(accumulate_ops(cfg, counts))
    lhr = np.asarray(lhr_matrix, dtype=np.int64)
    ops = np.zeros(lhr.shape[0])
    for l, (layer, c) in enumerate(zip(cfg.layers, counts)):
        csum = float(np.asarray(c, dtype=np.float64).sum())
        if layer.kind == "fc":
            per_spike = lhr[:, l] * -(-layer.logical // lhr[:, l])
        else:
            per_spike = layer.kernel ** 2 * layer.logical
        ops += csum * per_spike
    return ops


def energy_mj_vector(cfg: AcceleratorConfig, counts, cycles: np.ndarray,
                     lhr_matrix: np.ndarray | None = None,
                     lut: np.ndarray | None = None,
                     clock_mhz: np.ndarray | None = None,
                     lib: CostLibrary = CostLibrary()) -> np.ndarray:
    """Vectorised ``energy_mj`` over C candidates.

    ``cycles``: (C,) latencies (from the batched cycle model).  ``lut`` can
    be passed to reuse an ``estimate_vector`` result; ``clock_mhz`` is a
    (C,) per-candidate clock axis (defaults to the config's clock).
    """
    cycles = np.asarray(cycles, dtype=np.float64)
    clk = np.asarray(cfg.timing.clock_mhz if clock_mhz is None else clock_mhz,
                     dtype=np.float64)
    runtime_s = cycles / (clk * 1e6)
    if lut is None:
        lut = (estimate_vector(cfg, lhr_matrix=lhr_matrix, lib=lib).lut
               if lhr_matrix is not None else estimate(cfg, lib).lut)
    power_w = lib.static_w + lib.w_per_lut * lut
    ops = accumulate_ops_vector(cfg, counts, lhr_matrix)
    return (power_w * runtime_s + lib.pj_per_acc_op * 1e-12 * ops) * 1e3
