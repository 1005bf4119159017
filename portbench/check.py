"""How ``correct`` is decided: the port's first three training steps
against the plain reference's, from the same weights and batches.

Three numbers are compared, each with the limit of the cell's
``limits/<cell>.json``:

* ``loss_gap``: the largest ``|L - L_ref| / |L_ref|`` over the steps (and
  the cells of a slab) whose losses the limits file ``loss_steps`` names;
* ``grad_gap``: over every leaf of every cell, the gap between the norm of
  the port's first gradient (its Adam first moment after one step, over
  ``1 - b1``) and the reference's, over the larger of that leaf's reference
  norm and the cell's median leaf norm;
* ``update_gap``: the same of the parameters' change over the three steps,
  leaving out leaves whose first reference gradient is under a thousandth
  of the cell's median leaf's (round-off alone moves them under Adam).

A NaN or an infinity reads as an infinite gap.
"""
from __future__ import annotations

import dataclasses
import math
import statistics

NAMES = ("loss_gap", "grad_gap", "update_gap")
#: Leaves whose first reference gradient norm is under this share of the
#: cell's median leaf's are left out of ``update_gap``.
STILL_LEAF = 1e-3


@dataclasses.dataclass
class Readings:
    losses: list        # [step][cell]
    grads: list         # [cell][leaf]: first-step gradient norms
    updates: list       # [cell][leaf]: norms of the change over the steps


def _gap(a: float, b: float, scale: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(scale, 1e-30)


def _leaf_gap(prog: list, ref: list, keep: list) -> float:
    med = statistics.median(r for r, k in zip(ref, keep) if k)
    return max(_gap(p, r, max(r, med))
               for p, r, k in zip(prog, ref, keep) if k)


def numbers(prog: Readings, ref: Readings, loss_steps) -> dict:
    loss = max(_gap(p, r, abs(r))
               for s in loss_steps
               for p, r in zip(prog.losses[s], ref.losses[s]))
    grad, update = 0.0, 0.0
    for c, g_ref in enumerate(ref.grads):
        med = statistics.median(g_ref)
        moving = [g >= STILL_LEAF * med for g in g_ref]
        grad = max(grad, _leaf_gap(prog.grads[c], g_ref, [True] * len(g_ref)))
        update = max(update, _leaf_gap(prog.updates[c], ref.updates[c],
                                       moving))
    return {"loss_gap": loss, "grad_gap": grad, "update_gap": update}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    at or under its limit."""
    shown = {n: {"value": values[n], "limit": limits[n]["limit"]}
             for n in NAMES}
    ok = all(v["value"] <= v["limit"] for v in shown.values())
    return ok, shown
