"""Leaky Integrate-and-Fire dynamics with surrogate-gradient spikes.

At every time step a neuron's membrane potential is

    U[t] = beta * U[t-1] + I[t] + bias - reset

with a spike ``S[t] = H(U[t] - theta)`` and reset by subtraction
(``reset = theta * S[t-1]``) or to zero.  The Heaviside is not
differentiable; training uses the fast-sigmoid surrogate

    dS/dU ~= 1 / (1 + slope * |U - theta|)^2
"""
from __future__ import annotations

import dataclasses

import torch

DEFAULT_SLOPE = 25.0


class SpikeFn(torch.autograd.Function):
    """Heaviside step of ``v = u - theta`` with the fast-sigmoid
    surrogate gradient."""

    @staticmethod
    def forward(ctx, v: torch.Tensor, slope: float) -> torch.Tensor:
        ctx.save_for_backward(v)
        ctx.slope = slope
        return (v > 0).to(v.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (v,) = ctx.saved_tensors
        surr = 1.0 / torch.square(1.0 + ctx.slope * torch.abs(v))
        return g * surr, None


def spike_fn(v: torch.Tensor, slope: float = DEFAULT_SLOPE) -> torch.Tensor:
    return SpikeFn.apply(v, slope)


@dataclasses.dataclass(frozen=True)
class LIFParams:
    """Static neuron constants (per layer)."""
    beta: float = 0.95          # leak factor
    threshold: float = 1.0      # firing threshold
    slope: float = DEFAULT_SLOPE
    reset_mechanism: str = "subtract"   # "subtract" | "zero"


def lif_step(u_prev: torch.Tensor, s_prev: torch.Tensor,
             current: torch.Tensor, p: LIFParams
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One LIF update, each operation rounded on its own.  Returns (u, s)."""
    if p.reset_mechanism == "subtract":
        u = p.beta * u_prev + current - p.threshold * s_prev
    elif p.reset_mechanism == "zero":
        u = p.beta * u_prev * (1.0 - s_prev) + current
    else:
        raise ValueError(f"unknown reset mechanism {p.reset_mechanism!r}")
    return u, spike_fn(u - p.threshold, p.slope)


def lif_init_state(shape, dtype=torch.float32, *, device: torch.device
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero membrane potentials and spikes, (u, s), of ``shape``."""
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
