"""A train step on the card, captured once into a CUDA graph and replayed.

Every step of a training loop launches the same kernels at the same
shapes; at net-5 that is 10,851 launches a step, which the host sends one
by one more slowly than the card runs them.  ``StepGraphs`` wraps a step
``fn(params, opt_state, generator(s), x, y) -> (params, opt_state,
loss)`` and runs all of it, the forward's T-loop, autograd's BPTT through
the custom Functions and the optimizer's update, as one
``torch.cuda.CUDAGraph``:

- where any tensor of params, opt_state, x or y is not on the card, the
  step runs eagerly;
- on the card, the first call of a signature runs eagerly (the warm-up:
  kernels are built and loaded, lazy state is made).  A signature is the
  tree of params, opt_state, x and y, the shape, dtype and device of each
  of their tensors, and the number of generators of a slab;
- the second call of a signature captures the step on static copies of
  its arguments, then replays it;
- later calls copy their arguments into those buffers and replay.

A call returns clones of the graph's outputs: no later call writes to a
tensor it returned, and the arguments are not changed in place.  The
graphs of one ``StepGraphs`` are captured on one side stream of the
arguments' device and share one memory pool: their only live tensors
there are their outputs, and one replay ends before the next begins on
the stream.

Random bits.  Each CUDA generator the step takes is stood in for, inside
the graph, by a generator of the graph's own, registered with it
(``register_generator_state``).  A replay starts it from the caller's
generator's state and hands the advanced state back, so the step draws
what the eager step would draw from the generator passed, whichever one
that is.

Counters and spans.  The counters of ``repro_torch.spans`` (the kernels'
``launch.*``) count while the capture runs the step's Python; each later
replay adds every counter's tally, so ``kernels.ops.launch_counts()`` reads
per step what an eager step launches.  Spans open only where Python runs: in
the eager call and in the capture, not in a replay.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch import spans


def _generators(generator) -> list:
    """The generators of a step's ``generator`` argument: one, or a slab's
    sequence of them."""
    return list(generator) if isinstance(generator, (list, tuple)) else [
        generator]


def _on_card(leaves: list) -> bool:
    return bool(leaves) and all(
        isinstance(t, torch.Tensor) and t.is_cuda for t in leaves)


def _signature(spec, leaves: list, generator) -> tuple:
    return (spec, tuple((t.shape, t.dtype, t.device) for t in leaves),
            len(generator) if isinstance(generator, (list, tuple)) else None)


@dataclasses.dataclass
class _Graph:
    """One captured step: its graph, static inputs, stand-in generators
    (position among the caller's, generator) and static outputs."""
    graph: torch.cuda.CUDAGraph
    inputs: list
    generators: list
    outputs: list
    out_spec: pytree.TreeSpec
    tally: dict              # counter -> count of one step, from the capture

    def replay(self, leaves: list, generator, count: bool = True):
        # no caller holds a static buffer, so every argument is copied in
        for buf, arg in zip(self.inputs, leaves):
            buf.copy_(arg)
        gens = _generators(generator)
        for i, own in self.generators:
            own.set_state(gens[i].get_state())
        self.graph.replay()
        for i, own in self.generators:
            gens[i].set_state(own.get_state())
        if count:
            for name, n in self.tally.items():
                spans.count(name, n)
        return pytree.tree_unflatten([t.clone() for t in self.outputs],
                                     self.out_spec)


def _capture(fn: Callable, args: tuple, generator, pool,
             stream: torch.cuda.Stream) -> _Graph:
    """Capture ``fn`` on static copies of ``args`` = (params, opt_state,
    x, y), with the graph's own generators standing in for those of
    ``generator`` on the arguments' kind of device (a CUDA generator may
    name no index), on ``stream``, a side stream of the arguments'
    device."""
    leaves, spec = pytree.tree_flatten(args)
    inputs = [t.clone() for t in leaves]
    gens = _generators(generator)
    own = [(i, torch.Generator(device=g.device)) for i, g in enumerate(gens)
           if isinstance(g, torch.Generator)
           and g.device.type == leaves[0].device.type]
    for i, g in own:
        gens[i] = g
    graph = torch.cuda.CUDAGraph()
    for _, g in own:
        graph.register_generator_state(g)
    params, opt_state, x, y = pytree.tree_unflatten(inputs, spec)
    before = spans.counts()
    # thread_local: another thread of the process may allocate or wait
    # while this one captures (a service's worker thread trains cells)
    with torch.cuda.graph(graph, pool=pool, stream=stream,
                          capture_error_mode="thread_local"):
        out = fn(params, opt_state,
                 gens if isinstance(generator, (list, tuple)) else gens[0],
                 x, y)
    tally = {name: n - before.get(name, 0)
             for name, n in spans.counts().items()
             if n != before.get(name, 0)}
    outputs, out_spec = pytree.tree_flatten(out)
    return _Graph(graph, inputs, own, outputs, out_spec, tally)


class StepGraphs:
    """``fn``, a train step, run eagerly off the card and as one CUDA
    graph a signature on it (the module's docstring)."""

    def __init__(self, fn: Callable):
        self.fn = fn
        #: signature -> its captured graph, or None once it has warmed up
        self.graphs: dict = {}
        self._pool = None
        self._stream = None      # the captures' side stream, and its device

    def __call__(self, params, opt_state, generator, x, y):
        args = (params, opt_state, x, y)
        leaves, spec = pytree.tree_flatten(args)
        if not _on_card(leaves):
            return self.fn(params, opt_state, generator, x, y)
        key = _signature(spec, leaves, generator)
        if key not in self.graphs:
            self.graphs[key] = None
            return self.fn(params, opt_state, generator, x, y)
        got = self.graphs[key]
        if got is not None:
            return got.replay(leaves, generator)
        if self._stream is None:
            self._stream = torch.cuda.Stream(leaves[0].device)
        got = self.graphs[key] = _capture(self.fn, args, generator,
                                          self._pool, self._stream)
        if self._pool is None:
            self._pool = got.graph.pool()
        # the capture ran the step's Python, and its launches counted then
        return got.replay(leaves, generator, count=False)
