"""Cycle-accurate latency model (the paper's TLM simulator, Sec. V).

Driven by per-layer per-time-step spike counts — either the trace of a
trained model (``repro_torch.core.snn.spike_counts_per_layer``) or the paper's
published averages — and an ``AcceleratorConfig``.

Per layer and time step the engine passes through the ECU state machine's
three phases (paper Fig. 4):

  PENC compress:  cycles = spikes + ceil(fan_in / penc_width)
                  (one address emitted per cycle + one cycle to scan each
                  chunk, empty chunks skipped in a single cycle)
  Accumulate:     fc:   spikes * lhr * acc_cpo * contention
                  conv: spikes * k^2 * lhr * acc_cpo * contention
                  (each NU serially walks its logical neurons per spike
                  address; a BRAM read-modify-write costs ``acc_cpo`` cycles;
                  NUs sharing a memory block serialize)
  Activate:       fc:   lhr * act_cycles                  (all owned neurons)
                  conv: min(spikes * k^2, out_positions) * lhr * act_cycles
                  (event-driven activation over affected addresses with lazy
                  leak — see TimingModel.conv_event_driven_act)

Layer-wise pipelining (paper Sec. V-B: "the ECU loads the spike train into a
buffer and moves on") is the exact dataflow recurrence

    finish[l][t] = max(finish[l-1][t], finish[l][t-1]) + lat[l][t]

whose final entry is the per-inference latency.  Everything is vectorised
over arbitrary trailing axes, so a full DSE sweep (thousands of LHR vectors)
or a batch of sample traces evaluates in one shot.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.accelerator.arch import (AcceleratorConfig, LayerHW,
                                         per_layer_col)


def layer_latency(layer: LayerHW, spikes: np.ndarray, t: "TimingModel",
                  lhr: np.ndarray | int | None = None,
                  contention: np.ndarray | int | None = None,
                  penc_chunks: np.ndarray | int | None = None) -> np.ndarray:
    """Latency (cycles) of one layer engine for one time step.

    ``spikes``: incoming spike count(s) — any shape, broadcastable.
    ``lhr``/``contention``/``penc_chunks``: overrides for vectorised DSE
    sweeps (scalars or (C,) candidate vectors; default to the layer's own
    derived values).  ``latency_cycles`` computes consistent overrides from
    per-candidate lhr/mem_blocks/penc_width matrices.
    """
    lhr = layer.lhr if lhr is None else lhr
    contention = layer.contention if contention is None else contention
    penc_chunks = layer.penc_chunks if penc_chunks is None else penc_chunks
    spikes = np.asarray(spikes, dtype=np.float64)
    penc = spikes + penc_chunks
    if layer.kind == "fc":
        acc = spikes * lhr * t.acc_cycles_per_op * contention
        act = lhr * np.float64(t.act_cycles)
    else:
        fan_out = layer.kernel * layer.kernel
        acc = spikes * fan_out * lhr * t.acc_cycles_per_op * contention
        if t.conv_event_driven_act:
            affected = np.minimum(spikes * fan_out, layer.out_positions)
        else:
            affected = np.float64(layer.out_positions)
        act = affected * lhr * t.act_cycles
    return penc + acc + act + t.sync_cycles


def pipeline_latency(lat: np.ndarray) -> np.ndarray:
    """Exact layer-pipeline recurrence.

    ``lat``: (L, T, ...) per-layer per-step latencies.
    Returns finish time of the last layer's last step, shape ``lat.shape[2:]``.
    """
    L, T = lat.shape[:2]
    finish_prev_layer = np.zeros(lat.shape[1:], dtype=np.float64)  # (T, ...)
    for l in range(L):
        finish = np.empty_like(finish_prev_layer)
        busy = np.zeros(lat.shape[2:], dtype=np.float64)
        for t in range(T):
            start = np.maximum(finish_prev_layer[t], busy)
            busy = start + lat[l, t]
            finish[t] = busy
        finish_prev_layer = finish
    return finish_prev_layer[T - 1]


def _ceil_div(a, b):
    return -(-a // b)


def latency_cycles(cfg: AcceleratorConfig, counts: Sequence[np.ndarray],
                   lhr_matrix: np.ndarray | None = None,
                   mem_blocks_matrix: np.ndarray | None = None,
                   penc_width: np.ndarray | None = None) -> np.ndarray:
    """Per-inference latency.

    ``counts``: per-layer incoming spike counts, each (T,) or (T, ...) —
    entry ``l`` is the traffic entering layer ``l``.
    ``lhr_matrix``: optional (C, L) int array — evaluates C candidate LHR
    vectors at once (vectorised DSE); result shape (..., C) or (C,).
    ``mem_blocks_matrix``: optional (C, L) int array of memory blocks per
    layer (0 = one block per NU).  Port contention is recomputed per
    candidate from the *candidate's* NU count, so joint LHR x mem_blocks
    sweeps stay consistent with the scalar ``with_lhr`` path.
    ``penc_width``: optional (C,) or (C, L) PENC chunk widths.
    """
    L = len(cfg.layers)
    assert len(counts) == L, (len(counts), L)
    batched = any(x is not None
                  for x in (lhr_matrix, mem_blocks_matrix, penc_width))
    lat = []
    for l, layer in enumerate(cfg.layers):
        c = np.asarray(counts[l], dtype=np.float64)
        if not batched:
            lat.append(layer_latency(layer, c, cfg.timing))
            continue
        c = c.reshape(c.shape + (1,))                    # (T, ..., 1)
        lhr_l = per_layer_col(lhr_matrix, l)            # (C,) or None
        mem_l = per_layer_col(mem_blocks_matrix, l)
        pw_l = per_layer_col(penc_width, l)
        contention = None
        if lhr_l is not None or mem_l is not None:
            lhr_v = np.asarray(layer.lhr if lhr_l is None else lhr_l,
                               dtype=np.int64)
            mem_v = np.asarray(layer.mem_blocks if mem_l is None else mem_l,
                               dtype=np.int64)
            nus = _ceil_div(layer.logical, lhr_v)
            contention = _ceil_div(nus, np.where(mem_v > 0, mem_v, nus))
        pchunks = (None if pw_l is None
                   else _ceil_div(layer.fan_in_size,
                                  np.asarray(pw_l, dtype=np.int64)))
        lat.append(layer_latency(layer, c, cfg.timing, lhr=lhr_l,
                                 contention=contention, penc_chunks=pchunks))
    if batched:
        shape = np.broadcast_shapes(*[x.shape for x in lat])
        lat = [np.broadcast_to(x, shape) for x in lat]
    lat = np.stack(lat, axis=0)                          # (L, T, ...)
    return pipeline_latency(lat)


def latency_seconds(cfg: AcceleratorConfig, counts,
                    lhr_matrix: np.ndarray | None = None,
                    mem_blocks_matrix: np.ndarray | None = None,
                    penc_width: np.ndarray | None = None,
                    clock_mhz: np.ndarray | float | None = None) -> np.ndarray:
    """Wall-clock latency; forwards the batched DSE kwargs so a vectorised
    sweep gets per-candidate seconds directly (shape follows
    ``latency_cycles``).  ``clock_mhz`` may be a per-candidate (n,) vector
    for sweeps with a clock axis; default is the base config's clock."""
    clk = np.asarray(cfg.timing.clock_mhz if clock_mhz is None else clock_mhz,
                     np.float64)
    return latency_cycles(cfg, counts, lhr_matrix=lhr_matrix,
                          mem_blocks_matrix=mem_blocks_matrix,
                          penc_width=penc_width) / (clk * 1e6)


def counts_from_traces(counts: Sequence[np.ndarray],
                       pool_before: Sequence[bool] | None = None,
                       pool_retention: float = 1.0) -> list[np.ndarray]:
    """Sampled per-layer spike traces -> per-layer (T,) mean traffic.

    ``counts``: one array per spiking layer, shaped (T,) or (T, N) / any
    trailing sample axes (the ``snn.spike_counts_per_layer`` /
    ``train_snn.dump_traces`` output); trailing axes are averaged away.
    ``pool_before[l]``: True if an OR-pool sits in front of layer ``l`` —
    its traffic is scaled by ``pool_retention`` (spike survival fraction).
    Traces dumped from a real model already carry pooling in the counts, so
    retention scaling is only for average-based (Table-I style) traffic.
    """
    out = []
    for l, c in enumerate(counts):
        c = np.asarray(c, dtype=np.float64)
        if c.ndim > 1:
            c = c.mean(axis=tuple(range(1, c.ndim)))
        scale = pool_retention if pool_before and pool_before[l] else 1.0
        out.append(c * scale)
    return out


def counts_from_averages(cfg: AcceleratorConfig, avg_spikes: Sequence[float],
                         num_steps: int | None = None,
                         pool_before: Sequence[bool] | None = None) -> list[np.ndarray]:
    """Constant per-step traffic from published averages (paper Table-I
    caption) — used for calibration and the Table-I reproduction benchmark.

    ``pool_before[l]``: True if an OR-pool sits in front of layer ``l``
    (its traffic is scaled by ``timing.pool_retention``).
    """
    T = num_steps or cfg.num_steps
    return counts_from_traces(
        [np.full((T,), float(s)) for s in avg_spikes],
        pool_before=pool_before,
        pool_retention=cfg.timing.pool_retention)


@dataclasses.dataclass
class LatencyBreakdown:
    per_layer_per_step: np.ndarray     # (L, T)
    bottleneck_layer: int
    total_cycles: float


def breakdown(cfg: AcceleratorConfig, counts: Sequence[np.ndarray]) -> LatencyBreakdown:
    lat = np.stack([layer_latency(layer, np.asarray(c, np.float64), cfg.timing)
                    for layer, c in zip(cfg.layers, counts)])
    total = pipeline_latency(lat)
    return LatencyBreakdown(
        per_layer_per_step=lat,
        bottleneck_layer=int(np.argmax(lat.sum(axis=1))),
        total_cycles=float(total),
    )
