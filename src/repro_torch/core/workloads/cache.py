"""Content-addressed trace/accuracy cache for model cells.

A *cell* is one point of the model subspace: ``(workload, num_steps,
population, seed)``.  Resolving a cell means training (or loading) the
model, dumping its per-layer spike traces, and measuring accuracy: the
expensive leg of co-exploration.  The cache trains each cell at most once,
across repeated sweeps and across processes:

* **Key**: sha256 over the workload's canonical ``signature()`` plus the
  model-axis assignment and seed, the same key as the JAX package's.
* **Root**: its own, ``REPRO_TORCH_WORKLOAD_CACHE`` or
  ``~/.cache/repro_torch/workloads``.  A cell trained here is not the bytes
  of the JAX package's cell under the same key, so the two never share a
  root by default.
* **Storage**: ``repro_torch.checkpoint.store``: the params tree and the
  per-layer (T, S) trace counts publish atomically as one checkpoint under
  ``<root>/<key>/step_00000000``; concurrent trainers of the same cell race
  benignly (deterministic training => identical bytes; the last
  ``os.replace`` wins).  A ``meta.msgpack`` sidecar (also atomically
  replaced) holds accuracy, the quantized-accuracy table and the key
  fields; its presence marks the cell complete.
* **Restore**: the ``like`` tree the store needs is rebuilt from the
  workload alone, so no pickled structure is ever trusted.

``TraceCache.resolve`` is the entry point; it also extends the cell's
quantized-accuracy table (``validate.quantized_accuracy`` at the requested
``weight_bits``) for every topology.  Training runs on the cache's
``device`` (the card unless told otherwise).  ``TraceCache.publish`` stores
a cell trained elsewhere (a slab of ``distributed/cellstack.py``) with the
same hit, miss and budget semantics.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import threading
from typing import Any, Optional, Sequence

import msgpack
import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import store
from repro_torch.core import encoding, snn, train_snn, validate
from repro_torch.core.workloads.registry import Workload
from repro_torch.device import DeviceLike, resolve

log = logging.getLogger(__name__)

_META = "meta.msgpack"
_QUANT_SAMPLES = 64          # test samples for the fixed-point accuracy leg

#: meta paths already reported corrupt (quarantine logs once per path)
_quarantined: set[str] = set()


def default_root() -> str:
    return os.environ.get(
        "REPRO_TORCH_WORKLOAD_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "workloads"))


class BudgetExceeded(RuntimeError):
    """A cache miss would overspend the training budget."""


class TrainingBudget:
    """Training budget denominated in cache *misses* — the expensive leg of
    co-exploration.  Cache hits are free; each miss (an actual training run)
    charges one unit.  ``TraceCache.resolve(..., budget=...)`` charges
    *before* training starts, so an exhausted budget fails fast instead of
    after minutes of wasted work.  Callers that would rather skip an
    unaffordable cell than raise probe ``can_spend`` and
    ``TraceCache.contains`` first.

    Thread-safe: one lock guards every check-and-charge, so concurrent
    studies sharing one budget never double-spend the last unit —
    ``try_charge`` is the atomic check+charge for callers that must not
    race.  Only the
    lock-free counters round-trip through ``state_dict``/pickle; the lock
    is rebuilt on load, so checkpointed budgets restore across processes.
    """

    def __init__(self, limit: int):
        if limit < 0:
            raise ValueError(f"budget limit must be >= 0, got {limit}")
        self.limit = int(limit)
        self.spent = 0
        self._lock = threading.Lock()

    @property
    def remaining(self) -> int:
        # locked like every other accessor: an unlocked limit - spent can
        # tear against a concurrent load_state_dict swapping both fields
        with self._lock:
            return self.limit - self.spent

    def can_spend(self, n: int = 1) -> bool:
        with self._lock:
            return self.spent + n <= self.limit

    def charge(self, n: int = 1) -> None:
        if not self.try_charge(n):
            raise BudgetExceeded(
                f"training budget exhausted: {self.spent}/{self.limit} "
                f"misses spent, cannot charge {n} more")

    def refund(self, n: int = 1) -> None:
        """Return ``n`` charged-but-unspent units (a training run that was
        charged up front and then failed — ``TraceCache.resolve`` refunds
        on the failure path so the unit is not silently lost).  Clamped at
        zero: a refund can never manufacture budget."""
        with self._lock:
            self.spent = max(0, self.spent - int(n))

    def try_charge(self, n: int = 1) -> bool:
        """Atomically charge ``n`` misses iff affordable; False otherwise
        (the race-free form of ``can_spend`` + ``charge``)."""
        with self._lock:
            if self.spent + n > self.limit:
                return False
            self.spent += n
            return True

    def state_dict(self) -> dict:
        with self._lock:
            return {"limit": self.limit, "spent": self.spent}

    def load_state_dict(self, state: dict) -> None:
        with self._lock:
            self.limit = int(state["limit"])
            self.spent = int(state["spent"])

    # the lock never crosses a process boundary: pickling (e.g. inside a
    # farmed job's closure) ships the counters and rebuilds a fresh lock
    def __getstate__(self) -> dict:
        return self.state_dict()

    def __setstate__(self, state: dict) -> None:
        self.limit = int(state["limit"])
        self.spent = int(state["spent"])
        self._lock = threading.Lock()


def cell_key(workload: Workload, assignment: dict, seed: int) -> str:
    """Content hash of everything that determines the trained artifact."""
    payload = {
        "workload": workload.signature(),
        "assignment": {k: assignment[k] for k in sorted(assignment)},
        "seed": int(seed),
    }
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


@dataclasses.dataclass
class CellArtifact:
    """One resolved model cell: trained params + traces + accuracy."""
    workload: str
    assignment: dict                 # {"num_steps": T, "population": p, ...}
    key: str
    snn_cfg: snn.SNNConfig
    params: Any                      # numpy pytree (list of {"w","b"} dicts)
    accuracy: float                  # float-datapath test accuracy
    counts: list[np.ndarray]         # per spiking layer, (T, S) sampled traffic
    quant_acc: dict[int, float]      # weight_bits -> fixed-point accuracy
    cache_hit: bool

    def accuracy_at(self, weight_bits: Optional[int] = None) -> float:
        """Accuracy under a hardware precision choice: the fixed-point
        datapath accuracy when measured at these bits, else the float one."""
        if weight_bits is not None and int(weight_bits) in self.quant_acc:
            return self.quant_acc[int(weight_bits)]
        return self.accuracy


class TraceCache:
    """Train-or-load cells under ``root``; misses train on ``device``."""

    def __init__(self, root: Optional[str] = None,
                 device: DeviceLike = None):
        self.root = root or default_root()
        self.device = resolve(device)
        self.hits = 0
        self.misses = 0

    # ---- public -----------------------------------------------------------
    def contains(self, workload: Workload, assignment: dict,
                 seed: int = 0) -> bool:
        """True when the cell is already published (resolving it is a hit —
        no training, no budget charge).  Does not touch the counters."""
        norm = {"num_steps": int(assignment["num_steps"]),
                "population": float(assignment.get("population", 1.0))}
        key = cell_key(workload, norm, seed)
        return self._read_meta(os.path.join(self.root, key)) is not None

    def contains_key(self, key: str) -> bool:
        """``contains`` for callers that already hold the content address.
        Same semantics: complete, readable meta == published."""
        return self._read_meta(os.path.join(self.root, key)) is not None

    def resolve(self, workload: Workload, assignment: dict, seed: int = 0,
                quant_bits: Sequence[int] = (),
                budget: Optional[TrainingBudget] = None) -> CellArtifact:
        """Train-or-load one cell.  ``assignment`` must provide ``num_steps``
        and may provide ``population`` (default 1.0).  ``quant_bits``: weight
        precisions whose fixed-point accuracy the caller needs — computed
        once (any topology: ``validate`` models dense, conv and pool
        datapaths) and appended to the cell's metadata.
        ``budget``: a ``TrainingBudget`` charged one miss *before* training
        starts; an exhausted budget raises ``BudgetExceeded`` instead of
        training (hits are always free)."""
        T = int(assignment["num_steps"])
        pop = float(assignment.get("population", 1.0))
        norm = {"num_steps": T, "population": pop}
        key = cell_key(workload, norm, seed)
        cfg = workload.build(T, pop)
        cell_dir = os.path.join(self.root, key)

        meta = self._read_meta(cell_dir)
        if meta is not None:
            params, counts = self._load_arrays(cell_dir, workload, cfg, T)
            self.hits += 1
            hit = True
        else:
            if budget is not None:
                budget.charge()
            try:
                params, counts, accuracy = self._train(workload, cfg, T,
                                                       seed)
                meta = {"workload": workload.name, "assignment": norm,
                        "seed": int(seed), "accuracy": float(accuracy),
                        "quant_acc": {}}
                self._write_cell(cell_dir, workload, params, counts, meta)
            except BaseException:
                # the charge landed before training; a failed run spent
                # nothing, so hand the unit back instead of leaking it
                if budget is not None:
                    budget.refund()
                raise
            self.misses += 1
            hit = False

        quant, meta = self._extend_quant(cell_dir, workload, cfg, T, params,
                                         meta, quant_bits)
        return CellArtifact(
            workload=workload.name, assignment=norm, key=key, snn_cfg=cfg,
            params=params, accuracy=float(meta["accuracy"]), counts=counts,
            quant_acc=quant, cache_hit=hit)

    def publish(self, workload: Workload, assignment: dict, seed: int = 0,
                *, params, counts: Sequence[np.ndarray], accuracy: float,
                quant_bits: Sequence[int] = (),
                budget: Optional[TrainingBudget] = None) -> CellArtifact:
        """Publish an already-trained cell (the batch hook of the stacked
        trainer, ``distributed/cellstack.py``).  As ``resolve``: if the cell
        is already published (a concurrent trainer won the race), the
        stored copy is loaded and this counts as a hit (the caller's arrays
        are dropped; deterministic training makes them equal anyway);
        otherwise the arrays are written atomically (checkpoint first,
        ``meta.msgpack`` last), the miss counter increments and ``budget``
        is charged one miss, refunded if the write fails.  The
        quantized-accuracy table extends as in ``resolve``, so a later solo
        ``resolve`` of the same recipe is a pure hit.  ``params``: NumPy,
        as ``convert.params_to_numpy`` gives them."""
        T = int(assignment["num_steps"])
        pop = float(assignment.get("population", 1.0))
        norm = {"num_steps": T, "population": pop}
        key = cell_key(workload, norm, seed)
        cfg = workload.build(T, pop)
        cell_dir = os.path.join(self.root, key)

        meta = self._read_meta(cell_dir)
        if meta is not None:
            params, counts = self._load_arrays(cell_dir, workload, cfg, T)
            self.hits += 1
            hit = True
        else:
            if budget is not None:
                budget.charge()
            try:
                params = [{k: np.asarray(v.detach().cpu().numpy()
                                         if torch.is_tensor(v) else v)
                           for k, v in p.items()} for p in params]
                counts = [np.asarray(c, np.float32) for c in counts]
                meta = {"workload": workload.name, "assignment": norm,
                        "seed": int(seed), "accuracy": float(accuracy),
                        "quant_acc": {}}
                self._write_cell(cell_dir, workload, params, counts, meta)
            except BaseException:
                if budget is not None:   # a failed publish spent nothing
                    budget.refund()
                raise
            self.misses += 1
            hit = False

        quant, meta = self._extend_quant(cell_dir, workload, cfg, T, params,
                                         meta, quant_bits)
        return CellArtifact(
            workload=workload.name, assignment=norm, key=key, snn_cfg=cfg,
            params=params, accuracy=float(meta["accuracy"]),
            counts=list(counts), quant_acc=quant, cache_hit=hit)

    # ---- internals --------------------------------------------------------
    def _extend_quant(self, cell_dir: str, workload: Workload,
                      cfg: snn.SNNConfig, T: int, params, meta: dict,
                      quant_bits: Sequence[int]) -> tuple[dict, dict]:
        """Lazily extend the cell's quantized-accuracy table to cover
        ``quant_bits``; returns the (table, freshest-meta) pair."""
        quant = {int(k): float(v) for k, v in meta["quant_acc"].items()}
        missing = [int(b) for b in quant_bits if int(b) not in quant]
        if missing:
            data = workload.make_data(T)
            for bits in missing:
                quant[bits] = _quantized_accuracy(cfg, params, data, bits)
            # merge over the freshest meta: a concurrent resolver may have
            # extended the table for other bits while we computed ours (a
            # lost entry would be benignly recomputed, but don't invite it)
            meta = self._read_meta(cell_dir) or meta
            quant = {**{int(k): float(v)
                        for k, v in meta["quant_acc"].items()}, **quant}
            meta["quant_acc"] = {str(b): a for b, a in quant.items()}
            self._write_meta(cell_dir, meta)
        return quant, meta

    def _train(self, workload: Workload, cfg: snn.SNNConfig, T: int,
               seed: int):
        data = workload.make_data(T)
        res = train_snn.train(cfg, data, steps=workload.train_steps,
                              batch_size=workload.batch_size,
                              lr=workload.lr, seed=seed,
                              matmul_backend=workload.matmul_backend,
                              device=self.device)
        traces = train_snn.dump_traces(cfg, res.params, data.x_test,
                                       max_samples=workload.trace_samples,
                                       matmul_backend=workload.matmul_backend,
                                       device=self.device)
        params = convert.params_to_numpy(res.params)
        counts = [np.asarray(c, np.float32)
                  for c in traces["layer_input_spike_counts"]]
        return params, counts, res.test_accuracy

    def _like_tree(self, workload: Workload, cfg: snn.SNNConfig, T: int):
        """Checkpoint target structure, rebuilt from the workload alone."""
        params_like = convert.params_to_numpy(snn.init_params(
            torch.Generator().manual_seed(0), cfg, device="cpu"))
        S = min(workload.trace_samples, workload.n_test)
        counts_like = [np.zeros((T, S), np.float32)
                       for _ in cfg.layer_sizes()]
        return {"counts": counts_like, "params": params_like}

    def _load_arrays(self, cell_dir: str, workload: Workload,
                     cfg: snn.SNNConfig, T: int):
        like = self._like_tree(workload, cfg, T)
        tree = store.restore(cell_dir, like, step=0)
        return tree["params"], tree["counts"]

    def _write_cell(self, cell_dir: str, workload: Workload, params,
                    counts: list[np.ndarray], meta: dict) -> None:
        store.save(cell_dir, 0, {"counts": counts, "params": params})
        self._write_meta(cell_dir, meta)       # meta last: marks completion

    def _write_meta(self, cell_dir: str, meta: dict) -> None:
        os.makedirs(cell_dir, exist_ok=True)
        tmp = os.path.join(cell_dir, _META + ".tmp")
        with open(tmp, "wb") as f:
            f.write(msgpack.packb(meta))
        os.replace(tmp, os.path.join(cell_dir, _META))

    def _read_meta(self, cell_dir: str) -> Optional[dict]:
        """Read the completion-marking meta sidecar.  Unreadable meta — a
        truncated or torn write, real on network filesystems — is treated
        as *missing* (the cell re-resolves as a miss and republishes) after
        quarantining the bad bytes to ``meta.msgpack.corrupt``; without the
        quarantine every future ``resolve``/``contains`` of the cell would
        crash forever on the same torn file."""
        path = os.path.join(cell_dir, _META)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        try:
            meta = msgpack.unpackb(raw)
            if not isinstance(meta, dict) or "accuracy" not in meta \
                    or "quant_acc" not in meta:
                raise ValueError(f"meta is not a complete cell record: "
                                 f"{type(meta).__name__}")
        except Exception as e:                           # noqa: BLE001
            self._quarantine_meta(path, e)
            return None
        return meta

    def _quarantine_meta(self, path: str, error: Exception) -> None:
        if path not in _quarantined:                     # log once per path
            _quarantined.add(path)
            log.warning("unreadable cell meta %s (%s: %s); quarantined as "
                        "%s.corrupt — the cell will retrain",
                        path, type(error).__name__, error, _META)
        try:
            os.replace(path, path + ".corrupt")
        except OSError:
            pass                 # a concurrent resolver already moved it

    @property
    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses}


def _quantized_accuracy(cfg: snn.SNNConfig, params, data, bits: int) -> float:
    """Fixed-point datapath accuracy at ``bits``-bit weights (any topology:
    conv/pool layers run the integer conv reference via layer specs)."""
    weights, biases = [], []
    for p in params:
        if p:                       # MaxPool entries carry no parameters
            weights.append(np.asarray(p["w"]))
            biases.append(np.asarray(p["b"]))
    specs = validate.layer_specs(cfg.layers)
    conv_net = any(sp[0] != "dense" for sp in specs)
    n = min(_QUANT_SAMPLES, len(data.x_test))
    x = np.asarray(data.x_test[:n])
    if x.ndim == 5:
        # pre-encoded event data (B, T, H, W, C): already a spike train,
        # same time-major transpose as train_snn._encode_input
        spikes = x.transpose(1, 0, 2, 3, 4).astype(np.int64)
    else:
        flat = torch.as_tensor(x).reshape(n, -1)
        spikes = encoding.rate_encode(
            torch.Generator().manual_seed(1), flat,
            cfg.num_steps).numpy().astype(np.int64)
        if conv_net:
            spikes = spikes.reshape(cfg.num_steps, n, *cfg.input_shape)
    return validate.quantized_accuracy(
        weights, biases, spikes, data.y_test[:n],
        num_classes=cfg.num_classes, frac_bits=int(bits) - 1,
        specs=specs if conv_net else None)
