"""Declarative search space over hardware *and* model parameters.

A ``SearchSpace`` is an ordered list of axes over an ``AcceleratorConfig``.
Three axis shapes cover the paper's DSE dimensions plus the joint sweeps the
seed engine could not express:

* **per-layer scalar** — one axis per layer, independent options
  (``add_per_layer("lhr", [[1,2,4], [1,2], ...])``); the Cartesian product
  explores every per-layer combination, exactly like the seed ``lhr_grid``.
* **joint (zipped) vector** — one axis whose options are whole per-layer
  vectors (``add_joint("mem_blocks", [(64,32,16), (32,16,8)])``); all layers
  move together, the seed ``sweep_memory_blocks`` pattern.
* **global scalar** — one value applied everywhere
  (``add_global("weight_bits", (4, 6, 8))`` or ``add_global("clock_mhz", …)``).

The full space is the Cartesian product of all axes (last axis fastest,
matching ``itertools.product``).  Nothing is ever materialized: ``decode``
turns a chunk of flat candidate indices into column arrays by mixed-radix
digit extraction, so a billion-point space streams through fixed memory.

Known axis names and where they act:

  ``lhr``          per layer — NU count (latency, LUT/REG/DSP, energy)
  ``mem_blocks``   per layer — port contention vs BRAM mapping logic
  ``weight_bits``  per layer or global — BRAM footprint (accuracy measured
                   separately via ``validate.quantized_accuracy``)
  ``penc_width``   per layer or global — PENC scan cycles vs encoder LUTs
  ``clock_mhz``    global — runtime/energy scaling

**Model axes** (``num_steps``, ``population``, ``dataset`` — added via
``add_model``) live in the same declarative space but act on the *model*,
not the hardware: every combination of their values is a *model cell* that
must be trained (or cache-loaded) before hardware evaluation, so the plain
``search`` engine refuses them — ``dse.coexplore`` factors the joint space
into (model cell) x (hardware subspace) and streams each cell's hardware
subspace through the usual chunked evaluator.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np

from repro_torch.core.accelerator.arch import AcceleratorConfig

#: axes resolved by training/loading a model cell, not by the cycle model
MODEL_AXES = ("dataset", "num_steps", "population")

# per-layer defaults pulled from the base config when an axis doesn't cover
# a layer (or doesn't exist at all)
_PER_LAYER_DEFAULTS = {
    "lhr": lambda layer: layer.lhr,
    "mem_blocks": lambda layer: layer.mem_blocks,
    "weight_bits": lambda layer: layer.weight_bits,
    "penc_width": lambda layer: layer.penc_width,
}


def iter_cells(axes: Sequence[tuple[str, Sequence]]):
    """Assignment dicts over (name, values) pairs, last axis fastest — the
    product iteration shared by ``SearchSpace.model_cells`` and
    ``dse.coexplore``'s kwargs path."""
    names = [n for n, _ in axes]
    for combo in itertools.product(*[v for _, v in axes]):
        yield dict(zip(names, combo))


def pow2_values(cap: int) -> list[int]:
    """[1, 2, 4, ...] up to ``cap`` — the paper's LHR sweep style."""
    vals = [1]
    while vals[-1] * 2 <= cap:
        vals.append(vals[-1] * 2)
    return vals


@dataclasses.dataclass(frozen=True)
class Axis:
    name: str
    values: tuple                 # scalars, or length-L tuples (joint axis)
    layer: int | None = None      # index for per-layer scalar axes

    def __post_init__(self):
        if not self.values:
            raise ValueError(f"axis {self.name!r} has no values")
        if self.is_vector:
            if self.layer is not None:
                raise ValueError(f"joint axis {self.name!r} cannot bind to "
                                 f"a single layer")
            lens = {len(v) for v in self.values}
            if len(lens) != 1:
                raise ValueError(f"joint axis {self.name!r} has ragged "
                                 f"options: {lens}")

    @property
    def is_vector(self) -> bool:
        return isinstance(self.values[0], (tuple, list, np.ndarray))

    @property
    def cardinality(self) -> int:
        return len(self.values)


class SearchSpace:
    def __init__(self, config: AcceleratorConfig, axes: Sequence[Axis] = ()):
        self.config = config
        self.axes: list[Axis] = []
        for ax in axes:
            self._append(ax)

    # ---- construction (fluent) -------------------------------------------
    def _append(self, axis: Axis) -> None:
        for ax in self.axes:
            if ax.name != axis.name:
                continue
            if ax.is_vector or axis.is_vector or ax.layer is None \
                    or axis.layer is None or ax.layer == axis.layer:
                raise ValueError(
                    f"axis {axis.name!r} conflicts with an existing axis of "
                    f"the same name (only distinct per-layer bindings may "
                    f"share a name)")
        if axis.layer is not None and not (
                0 <= axis.layer < len(self.config.layers)):
            raise ValueError(f"axis {axis.name!r}: layer {axis.layer} out of "
                             f"range for {len(self.config.layers)} layers")
        self.axes.append(axis)

    def add_per_layer(self, name: str,
                      values_per_layer: Sequence[Sequence]) -> "SearchSpace":
        """One independent scalar axis per layer (Cartesian across layers)."""
        if len(values_per_layer) != len(self.config.layers):
            raise ValueError(f"{name}: {len(values_per_layer)} value lists "
                             f"for {len(self.config.layers)} layers")
        for i, vals in enumerate(values_per_layer):
            self._append(Axis(name, tuple(vals), layer=i))
        return self

    def add_joint(self, name: str, options: Sequence[Sequence]) -> "SearchSpace":
        """One axis whose options are whole per-layer vectors (zipped)."""
        opts = tuple(tuple(o) for o in options)
        for o in opts:
            if len(o) != len(self.config.layers):
                raise ValueError(f"{name}: option {o} has {len(o)} entries "
                                 f"for {len(self.config.layers)} layers")
        self._append(Axis(name, opts))
        return self

    def add_global(self, name: str, values: Sequence) -> "SearchSpace":
        if name in MODEL_AXES:
            raise ValueError(f"{name!r} is a model axis; use add_model")
        self._append(Axis(name, tuple(values)))
        return self

    def add_model(self, name: str, values: Sequence) -> "SearchSpace":
        """Model-parameter axis (``num_steps`` / ``population`` /
        ``dataset``): each value combination is a model cell resolved by
        training or the trace cache — see ``dse.coexplore``."""
        if name not in MODEL_AXES:
            raise ValueError(f"unknown model axis {name!r}; "
                             f"pick from {MODEL_AXES}")
        self._append(Axis(name, tuple(values)))
        return self

    @classmethod
    def product_lhr(cls, config: AcceleratorConfig,
                    max_lhr: int = 256) -> "SearchSpace":
        """Per-layer power-of-two LHR product — the seed ``lhr_grid`` space."""
        return cls(config).add_per_layer(
            "lhr", [pow2_values(min(max_lhr, l.logical))
                    for l in config.layers])

    # ---- geometry ---------------------------------------------------------
    @property
    def size(self) -> int:
        n = 1
        for ax in self.axes:
            n *= ax.cardinality          # python int: no overflow
        return n if self.axes else 0

    # ---- model / hardware factorization -----------------------------------
    @property
    def model_axes(self) -> list[Axis]:
        return [ax for ax in self.axes if ax.name in MODEL_AXES]

    @property
    def hw_axes(self) -> list[Axis]:
        return [ax for ax in self.axes if ax.name not in MODEL_AXES]

    def model_cells(self):
        """Iterate the model subspace: one assignment dict per cell, in
        declared-axis product order (last axis fastest).  A space with no
        model axes has exactly one (empty) cell."""
        axes = self.model_axes
        if not axes:
            yield {}
            return
        yield from iter_cells([(ax.name, ax.values) for ax in axes])

    def hardware_subspace(self, config: AcceleratorConfig | None = None,
                          dedup: bool = True) -> "SearchSpace":
        """The hardware-only axes, rebound to ``config`` (a model cell's
        derived ``AcceleratorConfig``).  ``lhr`` options (per-layer scalar
        or joint vector) are clamped to the cell's layer sizes (duplicates
        dropped, order kept) — a population-scaled cell may be narrower
        than the template the axes were declared against; joint axes whose
        vector width disagrees with the cell's layer count are rejected.

        ``dedup=False`` keeps clamp-induced duplicate values so every axis
        retains its *template* cardinality — the property the joint ask/tell
        driver needs: a strategy's digit over the template space then stays
        a valid digit in every cell's rebound subspace."""
        config = config if config is not None else self.config
        sub = SearchSpace(config)
        for ax in self.hw_axes:
            if ax.layer is not None and ax.layer >= len(config.layers):
                raise ValueError(
                    f"axis {ax.name!r} binds layer {ax.layer} but the cell "
                    f"config has {len(config.layers)} layers; pass a "
                    f"per-cell hw_space callable to coexplore instead")
            values = ax.values
            if ax.is_vector:
                if len(values[0]) != len(config.layers):
                    raise ValueError(
                        f"joint axis {ax.name!r} options are "
                        f"{len(values[0])}-wide but the cell config has "
                        f"{len(config.layers)} layers; pass a per-cell "
                        f"hw_space callable to coexplore instead")
                if ax.name == "lhr":
                    caps = [l.logical for l in config.layers]
                    clamped = (tuple(min(int(x), c) for x, c in zip(v, caps))
                               for v in values)
                    values = tuple(dict.fromkeys(clamped) if dedup
                                   else clamped)
            elif ax.name == "lhr" and ax.layer is not None:
                cap = config.layers[ax.layer].logical
                clamped = (min(int(v), cap) for v in ax.values)
                values = tuple(dict.fromkeys(clamped) if dedup else clamped)
            sub._append(Axis(ax.name, values, layer=ax.layer))
        return sub

    def split_digits(self, digits: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Split an (n, n_axes) digit matrix into its model-axis and
        hardware-axis columns (each in declared-axis order) — the joint
        ask/tell driver factors asked chunks by model cell this way."""
        digits = np.asarray(digits)
        model = [i for i, ax in enumerate(self.axes) if ax.name in MODEL_AXES]
        hw = [i for i, ax in enumerate(self.axes) if ax.name not in MODEL_AXES]
        return digits[:, model], digits[:, hw]

    def model_assignment(self, model_digits: Sequence[int]) -> dict:
        """One model-axis digit row -> assignment dict (``dataset`` values
        stay whatever was declared — name or Workload instance)."""
        axes = self.model_axes
        if len(model_digits) != len(axes):
            raise ValueError(f"{len(model_digits)} model digits for "
                             f"{len(axes)} model axes")
        return {ax.name: ax.values[int(d)]
                for ax, d in zip(axes, model_digits)}

    def signature(self) -> list:
        """Canonical structural description (axis names, bindings, values)
        used to verify a resumed ``Study`` is given the space it was
        checkpointed with.  Values reduce to primitives; objects (e.g.
        Workload instances on a ``dataset`` axis) reduce to their ``name``
        or ``repr``."""
        def prim(v):
            if isinstance(v, (tuple, list, np.ndarray)):
                return [prim(x) for x in v]
            if isinstance(v, (int, float, str, bool)):
                return v
            if isinstance(v, np.generic):
                return v.item()
            return getattr(v, "name", repr(v))
        return [[ax.name, ax.layer, prim(ax.values)] for ax in self.axes]

    # ---- decoding ---------------------------------------------------------
    def digits(self, flat_idx: np.ndarray) -> np.ndarray:
        """Mixed-radix digits (n, n_axes), last axis fastest."""
        idx = np.asarray(flat_idx, dtype=np.int64)
        out = np.empty((len(idx), len(self.axes)), dtype=np.int64)
        stride = 1
        for a in range(len(self.axes) - 1, -1, -1):
            card = self.axes[a].cardinality
            out[:, a] = (idx // stride) % card
            stride *= card
        return out

    def sample_digits(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Uniform random digit matrix — valid even for spaces past 2^63."""
        return np.stack([rng.integers(ax.cardinality, size=n)
                         for ax in self.axes], axis=1)

    def assemble(self, digits: np.ndarray) -> dict[str, np.ndarray]:
        """Digit matrix -> named column arrays, filling config defaults for
        layers no axis covers."""
        n = len(digits)
        n_layers = len(self.config.layers)
        cols: dict[str, np.ndarray] = {}
        for a, ax in enumerate(self.axes):
            vals = np.asarray(ax.values)
            picked = vals[digits[:, a]]              # (n,) or (n, L)
            if ax.is_vector:
                cols[ax.name] = picked
            elif ax.layer is None:
                cols[ax.name] = picked
            else:
                if ax.name not in cols:
                    default = _PER_LAYER_DEFAULTS.get(ax.name)
                    if default is None:
                        raise ValueError(f"no per-layer default for axis "
                                         f"{ax.name!r}")
                    base = [default(l) for l in self.config.layers]
                    cols[ax.name] = np.tile(
                        np.asarray(base, dtype=vals.dtype), (n, 1))
                cols[ax.name][:, ax.layer] = picked
        return cols

    def decode(self, flat_idx: np.ndarray) -> dict[str, np.ndarray]:
        """Chunk of flat candidate indices -> column arrays."""
        return self.assemble(self.digits(flat_idx))
