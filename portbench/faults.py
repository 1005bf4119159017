"""Faults planted under the timed path, for the check that ``correct``
comes out false: the port's step with

* ``frozen``: its state returned unchanged (the loss still computed);
* ``half``: half the batch left out, the loss's mean taken over the rest.

A training cell on one chip has no exchange between chips to leave out.
"""
from __future__ import annotations

FAULTS = ("frozen", "half")


def broken(step, fault: str, slab: bool):
    """``step`` with ``fault`` planted."""
    if fault == "frozen":
        def frozen(params, opt_state, gens, x, y):
            return params, opt_state, step(params, opt_state, gens, x, y)[2]
        return frozen
    if fault == "half":
        def half(params, opt_state, gens, x, y):
            n = y.shape[-1] // 2
            if slab:
                return step(params, opt_state, gens, x[:, :n], y[:, :n])
            return step(params, opt_state, gens, x[:n], y[:n])
        return half
    raise ValueError(f"unknown fault {fault!r}")
