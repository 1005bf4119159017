"""Optimizers over parameter trees (dicts, lists, tuples of tensors).

The protocol of the JAX package's ``optim``:

    tx = adamw(lr, ...)
    state = tx.init(params)
    updates, state = tx.update(grads, state, params)
    params = apply_updates(params, updates)

The arithmetic is the JAX package's too, not ``torch.optim``'s: moments in
``state_dtype`` (float32), the bias corrections ``1 - b**count`` taken in
float32 from a float32 count, ``(m / c1) / (sqrt(v / c2) + eps)``, then
``-lr * u``.  A Python float ``b1 ** count`` would be float64, and
``torch.optim.Adam`` orders its divisions otherwise; both differ from the
reference in the last bits.  States are NamedTuples of tensors, so
``convert`` and the checkpoint store can carry them.

Three rules of JAX's arithmetic that PyTorch does not share are kept by
hand.  A bf16 array times a float32 0-d array (the learning rate, the clip
scale, a bias correction) is float32 in JAX, where PyTorch would keep bf16
(a 0-d tensor does not promote a dimensioned one of its category): such
leaves are widened first (``_wide``).  A Python number is weakly typed in
JAX, so against a bf16 array it is rounded to bf16 first, where PyTorch
would multiply by its float32 value (``_weak``).  And ``scalar / tensor``
is a true division here, where PyTorch's ``__rtruediv__`` multiplies by a
reciprocal.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.optim.schedules import constant_schedule
from repro_torch.tree import leaves, tree_map

Tree = Any

__all__ = ["AdafactorState", "AdamState", "ClipState", "GradientTransform",
           "MomState", "ScaleState", "WeightDecayState", "adafactor_lite",
           "adam", "adamw", "apply_updates", "chain", "clip_by_global_norm",
           "constant", "global_norm", "scale_by_schedule", "sgd",
           "tree_map"]


@dataclasses.dataclass(frozen=True)
class GradientTransform:
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Optional[Tree]], tuple[Tree, Tree]]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device: taken in
    float64 and rounded once.  PyTorch's float32 ``sqrt`` on the CPU is off
    by an ulp in about 0.7% of elements; XLA's and the card's are not."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def _wide(u: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``u`` in the dtype JAX gives ``u * s`` for a 0-d, non-weak ``s``:
    a bf16 leaf meeting a float32 scalar is widened to float32."""
    return u.to(torch.promote_types(u.dtype, s.dtype))


def _weak(c: float, x: torch.Tensor):
    """The Python number ``c`` as JAX applies it to ``x``: in ``x``'s dtype
    (a bf16 ``x`` meets ``c`` rounded to bf16)."""
    if x.dtype.is_floating_point and x.dtype.itemsize < 4:
        return torch.tensor(c, dtype=x.dtype, device=x.device)
    return c


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    # a fill on the device: a CUDA graph can capture it, where a copy from
    # the host of ``torch.tensor`` would wait for the stream
    return torch.full((), value, dtype=torch.float32, device=like.device)


def global_norm(tree: Tree) -> torch.Tensor:
    """The float32 2-norm of every leaf together, summed leaf by leaf in
    ``jax.tree.leaves`` order."""
    xs = leaves(tree)
    if not xs:
        return torch.zeros((), dtype=torch.float32)
    return _sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                     for x in xs))


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: (p.to(torch.float32) + u).to(p.dtype),
                    params, updates)


def _zero_count(params: Tree) -> torch.Tensor:
    xs = leaves(params)
    if not xs:
        raise ValueError("the parameter tree holds no tensor")
    return torch.zeros((), dtype=torch.int32, device=xs[0].device)


def _schedule(learning_rate) -> Callable:
    return learning_rate if callable(learning_rate) else constant(
        learning_rate)


def _scale_by_lr(lr: torch.Tensor, updates: Tree) -> Tree:
    return tree_map(lambda u: -lr * _wide(u, lr), updates)


# ---------------------------------------------------------------------------
# Elementary transforms
# ---------------------------------------------------------------------------

class ScaleState(NamedTuple):
    count: torch.Tensor


def scale_by_schedule(schedule: Callable) -> GradientTransform:
    def init(params):
        return ScaleState(count=_zero_count(params))

    def update(updates, state, params=None):
        del params
        lr = schedule(state.count)
        return _scale_by_lr(lr, updates), ScaleState(count=state.count + 1)

    return GradientTransform(init, update)


class ClipState(NamedTuple):
    pass


def clip_by_global_norm(max_norm: float) -> GradientTransform:
    def init(params):
        del params
        return ClipState()

    def update(updates, state, params=None):
        del params
        norm = global_norm(updates)
        scale = torch.minimum(_f32(1.0, norm),
                              _f32(max_norm, norm) / (norm + 1e-9))
        return tree_map(lambda u: _wide(u, scale) * scale, updates), state

    return GradientTransform(init, update)


class AdamState(NamedTuple):
    count: torch.Tensor
    mu: Tree
    nu: Tree


def _scale_by_adam(b1: float, b2: float, eps: float,
                   state_dtype: torch.dtype) -> GradientTransform:
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=state_dtype)
        return AdamState(count=_zero_count(params),
                         mu=tree_map(zeros, params),
                         nu=tree_map(zeros, params))

    def update(updates, state, params=None):
        del params
        count = state.count + 1
        mu = tree_map(lambda m, g: _weak(b1, m) * m + _weak(1 - b1, m)
                      * g.to(state_dtype), state.mu, updates)
        nu = tree_map(lambda v, g: _weak(b2, v) * v + _weak(1 - b2, v)
                      * torch.square(g.to(state_dtype)), state.nu, updates)
        step = count.to(torch.float32)
        c1 = 1 - torch.pow(_f32(b1, step), step)
        c2 = 1 - torch.pow(_f32(b2, step), step)
        upd = tree_map(lambda m, v: (_wide(m, c1) / c1)
                       / (_sqrt(_wide(v, c2) / c2) + eps), mu, nu)
        return upd, AdamState(count=count, mu=mu, nu=nu)

    return GradientTransform(init, update)


class WeightDecayState(NamedTuple):
    pass


def _add_decayed_weights(weight_decay: float,
                         mask_fn: Optional[Callable] = None
                         ) -> GradientTransform:
    """``u + weight_decay * p`` on every leaf, or on the leaves where
    ``mask_fn(params)`` is true."""
    def init(params):
        del params
        return WeightDecayState()

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("weight decay needs params")
        if mask_fn is None:
            updates = tree_map(
                lambda u, p: u + _weak(weight_decay, u) * p.to(u.dtype),
                updates, params)
        else:
            updates = tree_map(
                lambda u, p, m: u + (_weak(weight_decay, u) * p.to(u.dtype)
                                     if m else 0.0),
                updates, params, mask_fn(params))
        return updates, state

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


# ---------------------------------------------------------------------------
# User-facing optimizers
# ---------------------------------------------------------------------------

class MomState(NamedTuple):
    count: torch.Tensor
    trace: Tree              # None without momentum


def sgd(learning_rate, momentum: float = 0.0) -> GradientTransform:
    schedule = _schedule(learning_rate)

    def init(params):
        trace = (tree_map(torch.zeros_like, params) if momentum else None)
        return MomState(count=_zero_count(params), trace=trace)

    def update(updates, state, params=None):
        del params
        if momentum:
            trace = tree_map(lambda t, g: _weak(momentum, t) * t + g,
                             state.trace, updates)
            updates = trace
        else:
            trace = None
        lr = schedule(state.count)
        return (_scale_by_lr(lr, updates),
                MomState(count=state.count + 1, trace=trace))

    return GradientTransform(init, update)


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, state_dtype=torch.float32) -> GradientTransform:
    return chain(_scale_by_adam(b1, b2, eps, state_dtype),
                 scale_by_schedule(_schedule(learning_rate)))


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: Optional[float] = 1.0, state_dtype=torch.float32,
          decay_mask_fn: Optional[Callable] = None) -> GradientTransform:
    """AdamW with optional global-norm clipping: the LM-training default."""
    parts = []
    if clip_norm is not None:
        parts.append(clip_by_global_norm(clip_norm))
    parts.append(_scale_by_adam(b1, b2, eps, state_dtype))
    parts.append(_add_decayed_weights(weight_decay, decay_mask_fn))
    parts.append(scale_by_schedule(_schedule(learning_rate)))
    return chain(*parts)


class AdafactorState(NamedTuple):
    count: torch.Tensor
    row: Tree    # factored second moment, rows   (for >=2D params)
    col: Tree    # factored second moment, cols
    full: Tree   # unfactored second moment       (for <2D params)


def adafactor_lite(learning_rate, decay: float = 0.8, eps: float = 1e-30,
                   clip_threshold: float = 1.0) -> GradientTransform:
    """Factored second-moment optimizer for very large models (no first
    moment): O(rows + cols) state per matrix instead of O(rows * cols).
    Every leaf with ``ndim >= 2`` is factored over its last two dims, so a
    stacked (L, d_in, d_out) leaf keeps (L, d_in) rows and (L, d_out)
    columns."""
    schedule = _schedule(learning_rate)
    f32 = torch.float32

    def init(params):
        def zeros(p, shape):
            return torch.zeros(shape, dtype=f32, device=p.device)

        return AdafactorState(
            count=_zero_count(params),
            row=tree_map(lambda p: zeros(p, p.shape[:-1] if p.ndim >= 2
                                         else ()), params),
            col=tree_map(lambda p: zeros(p, p.shape[:-2] + p.shape[-1:]
                                         if p.ndim >= 2 else ()), params),
            full=tree_map(lambda p: zeros(p, () if p.ndim >= 2
                                          else p.shape), params))

    def update(updates, state, params=None):
        del params
        count = state.count + 1
        step = count.to(f32)
        beta = 1.0 - torch.pow(step, _f32(-decay, step))

        def upd_one(g, r, c, f):
            g32 = g.to(f32)
            sq = torch.square(g32) + eps
            if g.ndim >= 2:
                r = beta * r + (1 - beta) * torch.mean(sq, dim=-1)
                c = beta * c + (1 - beta) * torch.mean(sq, dim=-2)
                rmean = torch.mean(r, dim=-1, keepdim=True)
                vhat = ((r / torch.clamp(rmean, min=eps))[..., None]
                        * c[..., None, :])
                u = g32 / _sqrt(torch.clamp(vhat, min=eps))
            else:
                f = beta * f + (1 - beta) * sq
                u = g32 / _sqrt(torch.clamp(f, min=eps))
            rms = _sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return u, r, c, f

        out = tree_map(upd_one, updates, state.row, state.col, state.full)
        part = lambda i: tree_map(lambda g, o: o[i], updates, out)
        lr = schedule(count - 1)
        us = tree_map(lambda g, o: (-lr * o[0]).to(g.dtype), updates, out)
        return us, AdafactorState(count=count, row=part(1), col=part(2),
                                  full=part(3))

    return GradientTransform(init, update)


#: A ``step -> lr`` schedule of one float32 value (the reference has both
#: names).
constant = constant_schedule
