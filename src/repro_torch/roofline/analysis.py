"""Roofline analysis of dry-run records: the JAX package's
``roofline.analysis`` against one H100's peaks.

Three terms per (arch x shape x mesh), in seconds:

    compute    = FLOPs_per_rank / PEAK_FLOPS               (989 TF/s bf16)
    memory     = bytes_per_rank / HBM_BW                   (3.35 TB/s)
    collective = collective_wire_bytes_per_rank / LINK_BW  (450 GB/s)

The counts are those of ``roofline.counting`` over one traced step of a
cell (``launch.dryrun``): this rank's FLOPs, operand and output bytes, and
the bytes of each collective it issues, each weighed by its wire
multiplier.  Every loop iteration runs in eager PyTorch, so the counts need
no loop correction; ``parsed_flops`` and ``parsed_bytes_accessed`` equal
``cost``'s, and keep the reference's keys.

The peaks are a data sheet's, not measurements, and assume the card's full
power limit.  ``LINK_BW`` is NVLink's rate each way between the cards of
one host; a mesh of 256 or 512 ranks spans many hosts, whose links between
them are slower, so there the collective term is a lower bound.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from repro_torch.roofline.counting import ModuleStats

# NVIDIA H100 80GB HBM3 (SXM), 700 W, NVIDIA's data sheet: dense bf16
PEAK_FLOPS = 989e12
# NVIDIA H100 80GB HBM3 (SXM), 700 W, NVIDIA's data sheet: bytes/s of HBM3
HBM_BW = 3.35e12
# NVIDIA H100 80GB HBM3 (SXM), 700 W, NVIDIA's data sheet: NVLink bytes/s
# each way
LINK_BW = 450e9


class CellSkipped(Exception):
    """Raised for (arch x shape) cells excluded by design (DESIGN.md §4)."""


# ---------------------------------------------------------------------------
# Summaries of a traced cell
# ---------------------------------------------------------------------------

def memory_summary(stats: ModuleStats) -> dict:
    """This rank's bytes, under the keys of XLA's memory analysis: the
    arguments' storages (params, optimizer state and batch, each rank's
    block), the result's, and the rest of the peak as temporaries, so that
    ``total_bytes_per_device`` is the most this rank held at once.  The
    port donates no argument, so nothing aliases."""
    temp = max(0, stats.peak_bytes - stats.argument_bytes
               - stats.output_bytes)
    out = {"argument_size_in_bytes": int(stats.argument_bytes),
           "output_size_in_bytes": int(stats.output_bytes),
           "temp_size_in_bytes": int(temp),
           "alias_size_in_bytes": 0}
    out["total_bytes_per_device"] = (
        out["argument_size_in_bytes"] + out["output_size_in_bytes"]
        + out["temp_size_in_bytes"] - out["alias_size_in_bytes"])
    return out


def cost_summary(stats: ModuleStats) -> dict:
    return {"flops": float(stats.flops),
            "bytes_accessed": float(stats.bytes_accessed)}


def collective_summary(stats: ModuleStats) -> dict:
    """The reference's collective record: bytes by kind, wire bytes, and
    the FLOP and byte totals under its ``parsed_*`` keys."""
    return {
        "bytes_by_kind": {k: int(v) for k, v in
                          stats.collective_bytes_by_kind.items()},
        "total_wire_bytes": int(stats.collective_wire_bytes),
        "unknown_trip_loops": stats.unknown_trip_loops,
        "parsed_flops": float(stats.flops),
        "parsed_bytes_accessed": float(stats.bytes_accessed),
        "dots": stats.dots,
    }


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops: float
    useful_ratio: float      # MODEL_FLOPS / (FLOPs per rank * ranks)
    bottleneck: str

    def table_row(self) -> dict:
        return dataclasses.asdict(self)


def roofline_from_record(record: dict, model_flops: float) -> Roofline:
    """Build the three terms from one dry-run JSON record, whose counts
    are one rank's."""
    coll_rec = record.get("collectives", {})
    flops = coll_rec.get("parsed_flops") or record.get("cost", {}).get(
        "flops", 0.0)
    bytes_acc = coll_rec.get("parsed_bytes_accessed") or record.get(
        "cost", {}).get("bytes_accessed", 0.0)
    coll = coll_rec.get("total_wire_bytes", 0.0)
    chips = record.get("devices", 1)
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_acc / HBM_BW
    collective_s = coll / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    useful = model_flops / (flops * chips) if flops else 0.0
    return Roofline(compute_s=compute_s, memory_s=memory_s,
                    collective_s=collective_s, model_flops=model_flops,
                    hlo_flops=flops, useful_ratio=useful,
                    bottleneck=bottleneck)


@functools.lru_cache(maxsize=64)
def _param_count(cfg) -> int:
    """The elements of ``registry.init_params(cfg)``, built on the meta
    device (the reference's ``jax.eval_shape``)."""
    from repro_torch.models import registry
    from repro_torch.tree import leaves
    params = registry.init_params(torch.Generator(), cfg, device="meta")
    return sum(math.prod(l.shape) for l in leaves(params))


def model_flops(cfg, shape, active_params: Optional[float] = None) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference forward);
    MoE uses N_active (top-k of the expert params)."""
    n_total = active_params
    if n_total is None:
        n_total = _param_count(cfg)
        if cfg.moe is not None:
            # count expert tensors once, scale to top-k/E activation
            e, k = cfg.moe.num_experts, cfg.moe.top_k
            expert = 3 * cfg.d_model * cfg.d_ff * e * cfg.num_layers
            n_total = n_total - expert + expert * k / e
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_total * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_total * tokens
    return 2.0 * n_total * shape.global_batch      # decode: 1 token/seq
