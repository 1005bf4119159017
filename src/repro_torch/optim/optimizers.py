"""Optimizers over parameter trees (lists, tuples and dicts of tensors).

The protocol of the JAX package's ``optim``:

    tx = adam(lr)
    state = tx.init(params)
    updates, state = tx.update(grads, state, params)
    params = apply_updates(params, updates)

The arithmetic is the JAX package's too, not ``torch.optim.Adam``'s: float32
moments, the bias corrections ``1 - b**count`` taken in float32 from a
float32 count, ``(m / c1) / (sqrt(v / c2) + eps)``, then ``-lr * u``.  A
Python float ``b1 ** count`` would be float64, and ``torch.optim.Adam``
orders its divisions otherwise; both differ from the reference in the last
bits.  States are NamedTuples of tensors, so ``convert`` can carry them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.optim.schedules import constant_schedule

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the tensors of same-structured trees of lists, tuples and
    dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *leaves)
                          for leaves in zip(tree, *rest))
    return fn(tree, *rest)


@dataclasses.dataclass(frozen=True)
class GradientTransform:
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Optional[Tree]], tuple[Tree, Tree]]


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: (p.to(torch.float32) + u).to(p.dtype),
                    params, updates)


def _first_tensor(tree: Tree) -> torch.Tensor:
    found = []
    tree_map(found.append, tree)
    if not found:
        raise ValueError("the parameter tree holds no tensor")
    return found[0]


def _zero_count(params: Tree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=_first_tensor(params).device)


class ScaleState(NamedTuple):
    count: torch.Tensor


def scale_by_schedule(schedule: Callable) -> GradientTransform:
    def init(params):
        return ScaleState(count=_zero_count(params))

    def update(updates, state, params=None):
        del params
        lr = schedule(state.count)
        updates = tree_map(lambda u: -lr * u, updates)
        return updates, ScaleState(count=state.count + 1)

    return GradientTransform(init, update)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device: taken in
    float64 and rounded once.  PyTorch's float32 ``sqrt`` on the CPU is off
    by an ulp in about 0.7% of elements; XLA's and the card's are not."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


class AdamState(NamedTuple):
    count: torch.Tensor
    mu: Tree
    nu: Tree


def _scale_by_adam(b1: float, b2: float, eps: float) -> GradientTransform:
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return AdamState(count=_zero_count(params),
                         mu=tree_map(zeros, params),
                         nu=tree_map(zeros, params))

    def update(updates, state, params=None):
        del params
        count = state.count + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                      state.mu, updates)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2)
                      * torch.square(g.to(torch.float32)), state.nu, updates)
        step = count.to(torch.float32)
        c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                        device=step.device), step)
        c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                        device=step.device), step)
        upd = tree_map(lambda m, v: (m / c1) / (_sqrt(v / c2) + eps),
                       mu, nu)
        return upd, AdamState(count=count, mu=mu, nu=nu)

    return GradientTransform(init, update)


def chain(*transforms: GradientTransform) -> GradientTransform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransform(init, update)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransform:
    """Adam at a constant learning rate, with float32 moments."""
    return chain(_scale_by_adam(b1, b2, eps),
                 scale_by_schedule(constant_schedule(learning_rate)))
