"""Stacked-cell training: train same-shape cells as one slab on the card.

The DSE's costly leg is training model cells, and a solo dvs-conv cell
leaves the card mostly idle: each of its 150 steps is a few hundred launches
over tiny shapes.  Many pending cells are the *same program*: identical
topology shapes, ``num_steps`` and recipe, differing only in seed or
dataset shard.  This module groups such jobs by **stack signature**,
stacks their params, Adam state and generators along a leading cell axis,
and trains the whole slab with one loop of ``train_snn``'s stacked step.
The model's five kernels take the cell axis as their outermost grid index
(``kernels/ops.py``), so per time step the slab launches each kernel as
often as one solo cell does, and each cell keeps its own tile flags.

Bit-exactness contract (DESIGN.md §14): every published cell is a cache
hit for a later *solo*-trained recipe, with equal params, traces and
accuracy.  The rules that make it hold:

* **Each kernel runs the solo shape's plan per cell** (never the cell axis
  folded into M), so each cell's sums run in the solo order.
* **Reductions outside the kernels run per cell on the solo shape**: the
  bias gradients (``ops.cell_sum_to``) and each cell's loss, whose sum is
  differentiated (each cell's gradient times 1.0).
* **Init stays host-side and per cell** (``train_snn.init_cell`` then
  ``torch.stack``).
* **Generator chains are the solo ones**: each cell's rate code is drawn
  from its own generator at the solo shape; evaluation (seed 1234) and the
  trace dump (seed 7) seed alike for every cell, so one draw at the solo
  shape serves the slab.
* **Data batching stays host-side and per cell**: one
  ``synthetic.batches(..., seed=job.seed)`` iterator per cell, stacked per
  step.

Placement: ``stack_mesh`` is the JAX package's 1-D ``"cells"`` mesh over
the local cards, when the slab divides evenly over more than one; then
``_shard`` splits the slab into one chunk a card along the cell axis
(``cell_specs``: every leaf leads with it) and each card trains its chunk
with the same slab step, one host thread a card.  Cells never communicate,
so splitting a slab changes no cell's bits.  One card (or a slab that does
not divide) keeps the whole slab on the cache's device.

Results unstack and publish per cell through ``TraceCache.publish``, so
stacking is invisible to every consumer: cache keys never mention the
slab, and ``Study``/``explore`` only see ordinary hits afterwards.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import convert, optim
from repro_torch.core import encoding, snn, train_snn
from repro_torch.core.workloads.cache import CellArtifact, TraceCache
from repro_torch.data import synthetic
from repro_torch.device import DeviceLike
from repro_torch.distributed.cellfarm import CellJob, CellOutcome
from repro_torch.distributed.sharding import P
from repro_torch.tree import tree_map

#: cells per training slab: bounds device memory (C x params, batches and
#: activations)
MAX_STACK = 16

#: evaluation batch size and generator seeds: must mirror the defaults of
#: train_snn.evaluate and dump_traces (the bit-exactness contract)
_EVAL_BATCH = 256
_EVAL_SEED = 1234
_TRACE_SEED = 7


# ---------------------------------------------------------------------------
# Stack signatures
# ---------------------------------------------------------------------------

def stack_signature(job: CellJob) -> str:
    """Hash of everything the slab *shares* across cells.

    Two jobs with equal signatures may train together: the built topology
    (layer types, shapes, LIF parameters: the whole ``SNNConfig`` minus its
    display name), the encoding, the training recipe (``train_steps``,
    ``batch_size``, ``lr``), the test-set geometry the stacked evaluate and
    trace legs iterate (``n_test``, ``trace_samples``), and the resolved
    matmul backend.  Deliberately EXCLUDED: workload name, ``seed``,
    ``data_seed``, ``noise``, ``n_train``: per-cell degrees of freedom
    (seed, dataset shard) that live in host-side iterators.  mnist-mlp and
    fmnist-mlp cells at the same (T, population) therefore stack.
    """
    T = int(job.assignment["num_steps"])
    pop = float(job.assignment.get("population", 1.0))
    wl = job.workload
    cfg = wl.build(T, pop)
    payload = {
        "cfg": dataclasses.asdict(dataclasses.replace(cfg, name="")),
        "layer_types": [type(l).__name__ for l in cfg.layers],
        "encoding": wl.encoding,
        "n_test": wl.n_test,
        "train_steps": wl.train_steps,
        "batch_size": wl.batch_size,
        "lr": wl.lr,
        "trace_samples": wl.trace_samples,
        "backend": snn.resolve_matmul_backend(wl.matmul_backend),
    }
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def group_jobs(jobs: Sequence[CellJob]) -> dict[str, list[int]]:
    """Job indices grouped by stack signature, order-preserving."""
    groups: dict[str, list[int]] = {}
    for i, job in enumerate(jobs):
        groups.setdefault(stack_signature(job), []).append(i)
    return groups


# ---------------------------------------------------------------------------
# Cell-axis sharding (the sharding.py rules idiom, one rule)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CellMesh:
    """A 1-D ``"cells"`` mesh over local cards.  One process drives them
    all (cells never communicate), so it is a list of devices, not a
    ``DeviceMesh`` over a process group."""
    devices: tuple

    axis_names = ("cells",)

    @property
    def shape(self) -> dict:
        return {"cells": len(self.devices)}


def stack_mesh(n_cells: int) -> Optional[CellMesh]:
    """A 1-D ``"cells"`` mesh over every local card, when the stack
    divides evenly over more than one; ``None`` keeps the slab on one
    device."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > 1 and n_cells % n == 0:
        return CellMesh(tuple(torch.device("cuda", i) for i in range(n)))
    return None


def cell_specs(tree):
    """Spec rule table for stacked-cell state: every leaf leads with the
    cell axis, so the single rule shards dim 0 over ``"cells"`` and
    replicates the rest (entries beyond the spec are None)."""
    return tree_map(lambda _: P("cells"), tree)


def _shard(jobs: Sequence[CellJob], mesh: Optional[CellMesh],
           device: torch.device) -> list[tuple]:
    """The slab's chunks along the cell axis, with the device each trains
    on: one chunk a card of ``mesh``, or the whole slab on ``device``."""
    if mesh is None:
        return [(device, list(jobs))]
    per = len(jobs) // len(mesh.devices)
    return [(dev, list(jobs[i * per:(i + 1) * per]))
            for i, dev in enumerate(mesh.devices)]


def _train_sharded(jobs: Sequence[CellJob], device: torch.device,
                   stats: Optional[dict] = None) -> list[tuple]:
    """``_train_slab`` of the slab's chunks, each on its card (a host
    thread a card when there are several); results in job order."""
    mesh = stack_mesh(len(jobs)) if device.type == "cuda" else None
    parts = _shard(jobs, mesh, device)
    if len(parts) == 1:
        return _train_slab(parts[0][1], parts[0][0], stats=stats)
    from concurrent.futures import ThreadPoolExecutor

    def run(part):
        dev, chunk = part
        own = {}
        with torch.cuda.device(dev):
            return _train_slab(chunk, dev, stats=own), own

    with ThreadPoolExecutor(len(parts)) as pool:
        done = list(pool.map(run, parts))
    if stats is not None:
        for _, own in done:
            for k, v in own.items():
                stats[k] = stats.get(k, 0) + v
    return [r for results, _ in done for r in results]


# ---------------------------------------------------------------------------
# Stacked training
# ---------------------------------------------------------------------------

def stack_params(trees: Sequence[snn.Params]) -> snn.Params:
    """Cells' params (one list of layer dicts each) as one slab: each leaf
    ``torch.stack``-ed along a new leading cell axis."""
    return [{k: torch.stack([t[i][k] for t in trees]) for k in layer}
            for i, layer in enumerate(trees[0])]


def _train_slab(jobs: Sequence[CellJob], device: torch.device,
                stats: Optional[dict] = None) -> list[tuple]:
    """Train one slab of same-signature jobs on ``device``.  Returns
    per-job ``(params numpy, counts, accuracy)`` in job order.  ``stats``
    (optional) accumulates host-clock seconds: ``data_seconds`` (the
    datasets, made once for each distinct workload), ``first_step_seconds``
    (the first step, which builds the kernels on first use),
    ``train_seconds`` (every step), of which ``batch_seconds`` (each step's
    batches gathered on the host and copied to ``device``), and
    ``eval_seconds`` (evaluate and the traces); and ``cells``."""
    job0 = jobs[0]
    wl0 = job0.workload
    T = int(job0.assignment["num_steps"])
    pop = float(job0.assignment.get("population", 1.0))
    cfg = wl0.build(T, pop)
    backend = snn.resolve_matmul_backend(wl0.matmul_backend)
    tx = optim.adam(wl0.lr)
    C = len(jobs)

    t0 = time.perf_counter()
    made = {}                    # cells of one workload share its dataset
    for j in jobs:
        if j.workload not in made:
            made[j.workload] = j.workload.make_data(T)
    datas = [made[j.workload] for j in jobs]
    data_s = time.perf_counter() - t0
    # per-cell host-side init, as each solo run starts
    inits = [train_snn.init_cell(cfg, tx, j.seed, device=device)
             for j in jobs]
    params = stack_params([i[0] for i in inits])
    opt_state = tx.init(params)          # zeros and count 0, as each cell's
    generators = [i[2] for i in inits]
    step_fn = train_snn.make_stacked_train_step(cfg, tx, backend)

    iters = [synthetic.batches(d.x_train, d.y_train, wl0.batch_size,
                               seed=j.seed, epochs=10_000)
             for d, j in zip(datas, jobs)]
    t0 = time.perf_counter()
    first = None
    batch_s = 0.0
    for _ in range(wl0.train_steps):
        t1 = time.perf_counter()
        batches = [next(it) for it in iters]
        x = torch.as_tensor(np.stack([b[0] for b in batches]), device=device)
        y = torch.as_tensor(np.stack([b[1] for b in batches]), device=device)
        batch_s += time.perf_counter() - t1
        params, opt_state, loss = step_fn(params, opt_state, generators, x, y)
        if first is None:
            loss.cpu()                   # waits for the step
            first = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    accuracy = _evaluate_stack(cfg, backend, params, datas, device)
    counts = _trace_stack(cfg, backend, params, datas, wl0.trace_samples,
                          device)
    if stats is not None:
        for key, secs in (("data_seconds", data_s),
                          ("first_step_seconds", first or 0.0),
                          ("train_seconds", train_s),
                          ("batch_seconds", batch_s),
                          ("eval_seconds", time.perf_counter() - t0)):
            stats[key] = stats.get(key, 0.0) + secs
        stats["cells"] = stats.get("cells", 0) + C

    host = convert.params_to_numpy(params)
    return [([{k: np.ascontiguousarray(v[c]) for k, v in p.items()}
              for p in host],
             [np.ascontiguousarray(layer[:, c], np.float32)
              for layer in counts],
             float(accuracy[c]))
            for c in range(C)]


def _evaluate_stack(cfg, backend, params, datas,
                    device: torch.device) -> np.ndarray:
    """Per-cell test accuracy, replicating ``train_snn.evaluate`` bit for
    bit: the same batches and the seed-1234 generator chain, one draw at
    the solo shape for every cell (the solo chain never involves the
    cell's seed)."""
    xs = np.stack([d.x_test for d in datas])
    ys = np.stack([d.y_test for d in datas])
    n = xs.shape[1]
    correct = np.zeros(len(datas), np.int64)
    gen = torch.Generator(device=device).manual_seed(_EVAL_SEED)
    with torch.inference_mode():
        for i in range(0, n, _EVAL_BATCH):
            xb = torch.as_tensor(xs[:, i:i + _EVAL_BATCH], device=device)
            spikes_in = train_snn.encode_shared(gen, xb, cfg.num_steps)
            out = snn.apply(cfg, params, spikes_in, matmul_backend=backend)
            for c in range(len(datas)):
                pred = encoding.population_decode(out[:, c], cfg.num_classes)
                correct[c] += int((pred.cpu().numpy()
                                   == ys[c, i:i + _EVAL_BATCH]).sum())
    return correct / max(n, 1)


def _trace_stack(cfg, backend, params, datas, trace_samples: int,
                 device: torch.device) -> list[np.ndarray]:
    """Per-cell spike traces, replicating ``train_snn.dump_traces``: the
    seed-7 generator shared by the slab, the first ``trace_samples`` test
    samples of each cell.  One (T, C, S) array per spiking layer."""
    gen = torch.Generator(device=device).manual_seed(_TRACE_SEED)
    with torch.inference_mode():
        xb = torch.as_tensor(np.stack([d.x_test[:trace_samples]
                                       for d in datas]), device=device)
        spikes_in = train_snn.encode_shared(gen, xb, cfg.num_steps)
        counts = snn.spike_counts_per_layer(cfg, params, spikes_in,
                                            matmul_backend=backend)
        return [c.cpu().numpy() for c in counts]


# ---------------------------------------------------------------------------
# Front end
# ---------------------------------------------------------------------------

def resolve_stacked(jobs: Sequence[CellJob], root: str,
                    cache: Optional[TraceCache] = None,
                    max_stack: int = MAX_STACK,
                    stats: Optional[dict] = None,
                    device: DeviceLike = None) -> list[CellOutcome]:
    """Resolve ``jobs`` against the cache at ``root``, training pending
    cells as same-signature slabs (of at most ``max_stack`` cells) on the
    cache's device (``device`` when no ``cache`` is given; None means the
    card).  Jobs need not share a signature: they are grouped here, and a
    singleton group trains in-process as a slab of one.  Returns one
    outcome per job, in job order; already-published cells resolve as
    hits, as the process farm's do.  ``stats`` (optional): ``_train_slab``'s,
    and ``publish_seconds`` (writing the cells and their fixed-point
    accuracy)."""
    cache = cache if cache is not None else TraceCache(root=root,
                                                       device=device)
    outcomes: list[Optional[CellOutcome]] = [None] * len(jobs)
    for _sig, idxs in group_jobs(jobs).items():
        pending = []
        for i in idxs:
            job = jobs[i]
            if cache.contains(job.workload, job.assignment, seed=job.seed):
                art = cache.resolve(job.workload, job.assignment,
                                    seed=job.seed,
                                    quant_bits=job.quant_bits)
                outcomes[i] = CellOutcome(key=art.key, trained=False)
            else:
                pending.append(i)
        for s in range(0, len(pending), max_stack):
            slab = pending[s:s + max_stack]
            results = _train_sharded([jobs[i] for i in slab],
                                     cache.device, stats=stats)
            t0 = time.perf_counter()
            for i, (params, counts, acc) in zip(slab, results):
                job = jobs[i]
                art = cache.publish(job.workload, job.assignment,
                                    seed=job.seed, params=params,
                                    counts=counts, accuracy=acc,
                                    quant_bits=job.quant_bits)
                outcomes[i] = CellOutcome(key=art.key,
                                          trained=not art.cache_hit)
            if stats is not None:
                stats["publish_seconds"] = (stats.get("publish_seconds", 0.0)
                                            + time.perf_counter() - t0)
    return outcomes


__all__ = ["MAX_STACK", "CellArtifact", "CellMesh", "cell_specs",
           "group_jobs", "resolve_stacked", "stack_mesh", "stack_params",
           "stack_signature"]
