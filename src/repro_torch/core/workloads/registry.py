"""Workload registry: the model half of the co-exploration loop.

A ``Workload`` declares everything the Training/Configuration phases need to
produce a *model cell* — one concrete trained model inside the joint
model x hardware design space:

* a **dataset** family (synthetic MNIST / FMNIST / DVS stand-ins — see
  ``repro_torch.data.synthetic`` and DESIGN.md §7) plus its generation knobs;
* a **topology template** (the hidden ``snn.Dense`` / ``snn.Conv`` stack,
  *excluding* the classifier) with a **population-scale knob**: ``build``
  multiplies every template layer's ``features`` by a width multiplier, the
  paper's "neuron population size" axis;
* the **encoding** ("rate" for intensity images, "event" for pre-encoded
  DVS streams) and the candidate ``num_steps`` (spike-train length T)
  values — the paper's robustness-showcase axis;
* training hyper-parameters, all baked into the workload so a cell is fully
  determined by ``(workload, num_steps, population, seed)`` — which is
  exactly the trace-cache key (see ``workloads.cache``).

Workloads are frozen dataclasses: derive variants with
``dataclasses.replace`` (benchmarks shrink ``n_train``/``train_steps`` that
way) and register them under new names.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core import snn
from repro_torch.data import synthetic

DATASET_FAMILIES = ("mnist", "fmnist", "dvs")


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    dataset: str                            # one of DATASET_FAMILIES
    input_shape: tuple[int, ...]            # (H, W) images / (H, W, 2) events
    layers: tuple[snn.LayerSpec, ...]       # hidden template at population=1
    num_classes: int
    pcr: int = 1                            # population-coding ratio (output)
    encoding: str = "rate"                  # "rate" | "event"
    num_steps_choices: tuple[int, ...] = (4, 8, 15, 25)
    population_choices: tuple[float, ...] = (0.5, 1.0, 2.0)
    # dataset generation (deterministic — DESIGN.md §7)
    n_train: int = 2048
    n_test: int = 512
    data_seed: int = 0
    noise: float = 0.15                     # images only
    # training recipe (part of the cache key)
    train_steps: int = 150
    batch_size: int = 64
    lr: float = 2e-3
    trace_samples: int = 64                 # test samples traced per cell
    version: int = 1                        # bump to invalidate cached cells
    # Execution backend of the forward pass (one of ``snn.MATMUL_BACKENDS``;
    # None defers to the REPRO_TORCH_MATMUL_BACKEND env var).  Deliberately
    # NOT part of signature(): traces are backend-invariant
    # (tests/test_torch_snn.py), so every backend shares one cell key.
    matmul_backend: Optional[str] = None

    def __post_init__(self):
        if self.dataset not in DATASET_FAMILIES:
            raise ValueError(f"unknown dataset family {self.dataset!r}; "
                             f"pick from {DATASET_FAMILIES}")
        if (self.matmul_backend is not None
                and self.matmul_backend not in snn.MATMUL_BACKENDS):
            raise ValueError(f"unknown matmul backend "
                             f"{self.matmul_backend!r}; "
                             f"pick from {snn.MATMUL_BACKENDS}")
        want = "event" if self.dataset == "dvs" else "rate"
        if self.encoding != want:
            raise ValueError(f"dataset {self.dataset!r} requires "
                             f"{want!r} encoding, got {self.encoding!r}")
        for spec in self.layers:
            if not isinstance(spec, (snn.Dense, snn.Conv, snn.MaxPool)):
                raise TypeError(spec)

    # ---- topology ---------------------------------------------------------
    def build(self, num_steps: int, population: float = 1.0) -> snn.SNNConfig:
        """Materialize one model cell's topology: template widths scaled by
        the ``population`` multiplier, classifier (``num_classes * pcr``
        neurons) appended unscaled."""
        if population <= 0:
            raise ValueError(f"population multiplier must be > 0, "
                             f"got {population}")
        scaled = tuple(_scale(spec, population) for spec in self.layers)
        out = snn.Dense(self.num_classes * self.pcr)
        return snn.SNNConfig(
            name=f"{self.name}-T{num_steps}-p{population:g}",
            input_shape=self.input_shape,
            layers=scaled + (out,),
            num_classes=self.num_classes,
            pcr=self.pcr,
            num_steps=int(num_steps))

    # ---- data -------------------------------------------------------------
    def make_data(self, num_steps: int) -> synthetic.Dataset:
        """Deterministic dataset for one cell.  Event data is generated at
        the cell's T (the stream length IS the spike train); image data is
        T-independent (rate encoding happens in training)."""
        if self.dataset == "dvs":
            h, w, _ = self.input_shape
            return synthetic.make_events(
                name=f"synth-{self.name}", seed=self.data_seed,
                num_classes=self.num_classes, n_train=self.n_train,
                n_test=self.n_test, t=int(num_steps), h=h, w=w)
        return synthetic.make_images(
            name=f"synth-{self.name}", seed=self.data_seed,
            num_classes=self.num_classes, n_train=self.n_train,
            n_test=self.n_test, h=self.input_shape[0],
            w=self.input_shape[1], noise=self.noise)

    def is_mlp(self) -> bool:
        """True when every layer is Dense — the topologies the *serial*
        hardware model (``validate.HardwareModel``) simulates.  The
        quantized-accuracy leg is no longer gated on this: the fixed-point
        reference covers conv/pool layers too (``validate.layer_specs``)."""
        return all(isinstance(s, snn.Dense) for s in self.layers)

    def signature(self) -> dict:
        """Canonical content description for cache keying — every field that
        changes the trained artifact, in primitive types."""
        return {
            "name": self.name, "dataset": self.dataset,
            "input_shape": list(self.input_shape),
            "layers": [_spec_sig(s) for s in self.layers],
            "num_classes": self.num_classes, "pcr": self.pcr,
            "encoding": self.encoding,
            "n_train": self.n_train, "n_test": self.n_test,
            "data_seed": self.data_seed, "noise": self.noise,
            "train_steps": self.train_steps, "batch_size": self.batch_size,
            "lr": self.lr, "trace_samples": self.trace_samples,
            "version": self.version,
        }


def _scale(spec: snn.LayerSpec, population: float) -> snn.LayerSpec:
    if isinstance(spec, (snn.Dense, snn.Conv)):
        return dataclasses.replace(
            spec, features=max(1, int(round(spec.features * population))))
    return spec                                   # MaxPool: no width


def _spec_sig(spec: snn.LayerSpec) -> list:
    if isinstance(spec, snn.Dense):
        return ["dense", spec.features]
    if isinstance(spec, snn.Conv):
        return ["conv", spec.features, spec.kernel, spec.stride, spec.padding]
    if isinstance(spec, snn.MaxPool):
        return ["pool", spec.window]
    raise TypeError(spec)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Workload] = {}


def register(workload: Workload, overwrite: bool = False) -> Workload:
    if workload.name in _REGISTRY and not overwrite:
        raise ValueError(f"workload {workload.name!r} already registered")
    _REGISTRY[workload.name] = workload
    return workload


def get(name: str) -> Workload:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown workload {name!r}; "
                       f"registered: {names()}") from None


def names() -> list[str]:
    return sorted(_REGISTRY)


# Built-ins: the three dataset families of the paper's evaluation, at sizes
# a CPU container trains in minutes.
register(Workload(
    name="mnist-mlp", dataset="mnist", input_shape=(28, 28),
    layers=(snn.Dense(128), snn.Dense(128)),
    num_classes=10, pcr=4))

register(Workload(
    name="fmnist-mlp", dataset="fmnist", input_shape=(28, 28),
    layers=(snn.Dense(128), snn.Dense(128)),
    num_classes=10, pcr=4, data_seed=17, noise=0.35))

register(Workload(
    name="dvs-conv", dataset="dvs", input_shape=(32, 32, 2),
    layers=(snn.Conv(8, 3), snn.MaxPool(2), snn.Conv(16, 3), snn.MaxPool(2),
            snn.Dense(64)),
    num_classes=8, pcr=2, encoding="event",
    num_steps_choices=(8, 12, 16), n_train=512, n_test=128))
