"""The plain reference of a spiking net's training step, in PyTorch.

What it computes, in fp32 with TF32 off (``precision="fp32"``):

* products as im2col and one matmul a call (convolutions: ``F.unfold`` and
  ``F.fold`` in (c, dy, dx) patch order, XLA's pads); their backward as
  the two matmuls of the chain rule;
* the LIF update ``u = beta * u + I - theta * s`` (reset by subtraction)
  and the spike ``s = u > theta`` with the fast-sigmoid surrogate
  ``1 / (1 + slope * |u - theta|)^2``;
* the OR-pool as a max over each (dy, dx) window, whose gradient goes whole
  to the first maximum;
* the rate code ``u < x`` of uniforms drawn as the port draws them, the
  rate loss (cross-entropy of population-pooled spike counts) and Adam.

``precision="tf32"`` rounds every product's operands to TF32 (10 bits of
mantissa, to nearest, ties away from zero) and accumulates in fp32, as the
tensor cores do: the control, one precision below what the configurations
state.  Nothing here imports the port; the benchmark hands both sides the
same initial weights and batches.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from portbench.net import Net, conv_pads, fanout_positions


def no_round(x: torch.Tensor) -> torch.Tensor:
    return x


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32's 10 mantissa bits, ties away from 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


ROUNDING = {"fp32": no_round, "tf32": tf32_round}


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, rnd):
        ctx.save_for_backward(a, b)
        ctx.rnd = rnd
        return rnd(a) @ rnd(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        rnd = ctx.rnd
        da = rnd(g) @ rnd(b).T if ctx.needs_input_grad[0] else None
        db = rnd(a).T @ rnd(g) if ctx.needs_input_grad[1] else None
        return da, db, None


def _im2col(x: torch.Tensor, k: int, stride: int, pads: tuple) -> torch.Tensor:
    """(B*OH*OW, C*k*k) patches of NHWC ``x``, in (c, dy, dx) order."""
    (h_lo, h_hi), (w_lo, w_hi) = pads
    xp = F.pad(x.permute(0, 3, 1, 2), (w_lo, w_hi, h_lo, h_hi))
    cols = F.unfold(xp, k, stride=stride)            # (B, C*k*k, L)
    return cols.transpose(1, 2).reshape(-1, cols.shape[1])


class _Conv(torch.autograd.Function):
    """NHWC x HWIO convolution by im2col; the patches are made again in the
    backward instead of being saved."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, rnd):
        b, h, wd, c = x.shape
        k, f = w.shape[0], w.shape[-1]
        oh, h_lo, h_hi = conv_pads(h, k, stride, padding)
        ow, w_lo, w_hi = conv_pads(wd, k, stride, padding)
        ctx.geom = (k, stride, ((h_lo, h_hi), (w_lo, w_hi)), (oh, ow))
        ctx.rnd = rnd
        ctx.save_for_backward(x, w)
        wm = w.permute(2, 0, 1, 3).reshape(c * k * k, f)
        out = rnd(_im2col(x, k, stride, ctx.geom[2])) @ rnd(wm)
        return out.reshape(b, oh, ow, f)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        k, stride, pads, (oh, ow) = ctx.geom
        rnd = ctx.rnd
        b, h, wd, c = x.shape
        f = w.shape[-1]
        gm = rnd(g.reshape(-1, f))
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wm = w.permute(2, 0, 1, 3).reshape(c * k * k, f)
            dcols = (gm @ rnd(wm).T).reshape(b, oh * ow, c * k * k)
            (h_lo, h_hi), (w_lo, w_hi) = pads
            full = F.fold(dcols.transpose(1, 2),
                          (h + h_lo + h_hi, wd + w_lo + w_hi), k,
                          stride=stride)
            dx = full[:, :, h_lo:h_lo + h, w_lo:w_lo + wd].permute(0, 2, 3, 1)
        if ctx.needs_input_grad[1]:
            dwm = rnd(_im2col(x, k, stride, pads)).T @ gm
            dw = dwm.reshape(c, k, k, f).permute(1, 2, 0, 3)
        return dx, dw, None, None, None


class _Spike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, slope):
        ctx.save_for_backward(v)
        ctx.slope = slope
        return (v > 0).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        return g * (1.0 / torch.square(1.0 + ctx.slope * torch.abs(v))), None


def or_pool(s: torch.Tensor, window: int) -> torch.Tensor:
    """Max over non-overlapping windows of NHWC ``s`` (a ragged edge is
    dropped); autograd's max routes the gradient to the first maximum in
    (dy, dx) order."""
    b, h, w, c = s.shape
    oh, ow = h // window, w // window
    win = s[:, :oh * window, :ow * window].reshape(
        b, oh, window, ow, window, c).permute(0, 1, 3, 5, 2, 4).reshape(
        b, oh, ow, c, window * window)
    return win.max(dim=-1).values


def rate_uniforms(gen: torch.Generator, shape, num_steps: int,
                  device) -> torch.Tensor:
    return torch.rand((num_steps,) + tuple(shape), generator=gen,
                      device=device, dtype=torch.float32)


class Encoder:
    """A cell's input spikes, (T, B, ...): pre-encoded events (B, T, ...)
    as they are, or intensities rate-coded from ``gen``'s next draw."""

    def __init__(self, net: Net, gen: Optional[torch.Generator]):
        self.net, self.gen = net, gen

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.gen is None:
            return x.transpose(0, 1)
        u = rate_uniforms(self.gen, x.shape, self.net.num_steps, x.device)
        return (u < x).to(torch.float32)


def forward(net: Net, params: list, spikes: torch.Tensor,
            rnd: Callable = no_round,
            record: Optional[Callable] = None) -> torch.Tensor:
    """The output layer's (T, B, N) spike train of (T, B, ...) input
    ``spikes``; ``record(i, t, s_in)``, if given, sees the input of spiking
    layer ``i`` at every step."""
    lif = net.lif
    if lif.reset != "subtract":
        raise ValueError(f"the reference resets by subtraction only, not "
                         f"{lif.reset!r}")
    batch = spikes.shape[1]
    states = {i: (torch.zeros((batch,) + l.out_shape, device=spikes.device),
                  torch.zeros((batch,) + l.out_shape, device=spikes.device))
              for i, l in enumerate(net.layers) if l.spiking}
    out = []
    for t in range(spikes.shape[0]):
        x, n = spikes[t], 0
        for i, (layer, p) in enumerate(zip(net.layers, params)):
            if layer.kind == "pool":
                x = or_pool(x, layer.window)
                continue
            if record is not None:
                record(n, t, x)
            n += 1
            if layer.kind == "conv":
                cur = _Conv.apply(x, p["w"], layer.stride, layer.padding,
                                  rnd) + p["b"]
            else:
                cur = _Matmul.apply(x.reshape(batch, -1), p["w"], rnd) + p["b"]
            u_prev, s_prev = states[i]
            u = lif.beta * u_prev + cur - lif.threshold * s_prev
            x = _Spike.apply(u - lif.threshold, lif.slope)
            states[i] = (u, x)
        out.append(x)
    return torch.stack(out)


def rate_loss_sum(train: torch.Tensor, labels: torch.Tensor,
                  num_classes: int) -> torch.Tensor:
    """Summed (not averaged) cross-entropy of the population-pooled spike
    counts of a (T, B, N) train."""
    counts = train.sum(0)
    logits = counts.reshape(counts.shape[0], num_classes, -1).sum(-1)
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).sum()


def loss_and_grads(net: Net, params: list, spikes: torch.Tensor,
                   labels: torch.Tensor, rows: int, rnd: Callable = no_round
                   ) -> tuple[float, list]:
    """The mean rate loss of one cell's batch and its gradient, by BPTT in
    blocks of ``rows`` samples (each block's share of the mean, summed)."""
    batch = labels.shape[0]
    leaves = [{k: v.detach().requires_grad_() for k, v in p.items()}
              for p in params]
    flat = [v for p in leaves for v in p.values()]
    total = 0.0
    grads = [torch.zeros_like(v) for v in flat]
    for lo in range(0, batch, rows):
        train = forward(net, leaves, spikes[:, lo:lo + rows], rnd)
        loss = rate_loss_sum(train, labels[lo:lo + rows],
                             net.num_classes) / batch
        for g, d in zip(grads, torch.autograd.grad(loss, flat)):
            g += d
        total += float(loss.detach())
        del train, loss
    it = iter(grads)
    return total, [{k: next(it) for k in p} for p in leaves]


class Adam:
    """Adam's arithmetic: moments in fp32, bias corrections ``1 - b**t``."""

    def __init__(self, params: list, lr: float, b1: float, b2: float,
                 eps: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = [{k: torch.zeros_like(v) for k, v in p.items()}
                  for p in params]
        self.v = [{k: torch.zeros_like(v) for k, v in p.items()}
                  for p in params]
        self.t = 0

    def step(self, params: list, grads: list) -> list:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        new = []
        for p, g, m, v in zip(params, grads, self.m, self.v):
            q = {}
            for k in p:
                m[k] = self.b1 * m[k] + (1.0 - self.b1) * g[k]
                v[k] = self.b2 * v[k] + (1.0 - self.b2) * torch.square(g[k])
                q[k] = p[k] - self.lr * ((m[k] / c1)
                                         / (torch.sqrt(v[k] / c2) + self.eps))
            new.append(q)
        return new


def train_steps(net: Net, params: list, batches: list, gen, optimizer: dict,
                rows: int, precision: str = "fp32"):
    """One cell's first ``len(batches)`` steps from ``params``.  Returns
    (losses, the first step's gradient, the parameters after the last
    step)."""
    rnd = ROUNDING[precision]
    encode = Encoder(net, gen)
    adam = Adam(params, optimizer["lr"], optimizer["b1"], optimizer["b2"],
                optimizer["eps"])
    losses, first = [], None
    for x, y in batches:
        loss, grads = loss_and_grads(net, params, encode(x), y, rows, rnd)
        losses.append(loss)
        if first is None:
            first = grads
        with torch.no_grad():
            params = adam.step(params, grads)
    return losses, first, params


def spike_stats(net: Net, params: list, spikes: torch.Tensor) -> list:
    """Per spiking layer, a (T, 3) list of the statistics of its input spikes at
    each step: the events, the events times their fan-out positions (a
    conv input's output pixels reached; 1 for a dense input), and the input
    columns any sample of the batch fires (a dense layer's weight rows
    needed; 0 for a conv)."""
    stats = [torch.zeros((spikes.shape[0], 3), dtype=torch.float64,
                         device=spikes.device) for _ in net.spiking]
    layers = net.spiking
    cover = {}
    for i, l in enumerate(layers):
        if l.kind == "conv":
            h, w, _ = l.in_shape
            cover[i] = torch.outer(*(torch.tensor(
                fanout_positions(n, l.kernel, l.stride, l.padding),
                dtype=torch.float64, device=spikes.device) for n in (h, w)))

    def record(i, t, x):
        x = x.reshape(x.shape[0], *layers[i].in_shape)
        events = x.sum(dtype=torch.float64)
        if layers[i].kind == "conv":
            reach = (x.sum(dim=(0, 3), dtype=torch.float64) * cover[i]).sum()
            stats[i][t] = torch.stack([events, reach, events.new_zeros(())])
        else:
            cols = (x.reshape(x.shape[0], -1).amax(0) > 0).sum().double()
            stats[i][t] = torch.stack([events, events, cols])

    with torch.no_grad():
        forward(net, params, spikes, record=record)
    return [s.tolist() for s in stats]


def norms(leaves: list) -> list[float]:
    """The fp64 2-norm of each leaf, in (layer, key) order."""
    return [math.sqrt(float(torch.sum(torch.square(v.double()))))
            for p in leaves for v in p.values()]
