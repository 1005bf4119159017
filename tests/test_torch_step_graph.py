"""The train step's CUDA graphs (``core/step_graph.py``) off the card.

On CPU tensors the step runs eagerly, makes no graph and gives the plain
step's numbers bit for bit.  The graph path's bookkeeping (signatures,
static buffers, clones of the outputs, generator stand-ins, the launch
tally) is run here with a stand-in for ``torch.cuda.CUDAGraph`` whose
replay runs the captured step again into the captured outputs; the real
capture is held to the eager step on the card in
``tests/test_torch_cuda.py``.  This file imports no JAX.
"""
import contextlib

import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch import optim, spans
from repro_torch.core import snn, step_graph, train_snn

torch.set_num_threads(2)

BACKENDS = ("torch", "spike_gemm", "spike_gemm_fused")


def _net(num_steps: int = 3) -> snn.SNNConfig:
    return snn.SNNConfig("conv-pool-dense", (6, 6, 2),
                         (snn.Conv(3), snn.MaxPool(2), snn.Dense(5)),
                         num_classes=5, num_steps=num_steps)


def _batch(cfg, seed: int, batch: int = 2, rate: bool = False, cells=None):
    """(x, y): events (B, T, H, W, C), or intensities (B, H, W, C) for a
    rate code; with ``cells``, a slab's (C, B, ...)."""
    gen = torch.Generator().manual_seed(seed)
    lead = (cells,) if cells else ()
    if rate:
        x = torch.rand(lead + (batch,) + cfg.input_shape, generator=gen)
    else:
        x = (torch.rand(lead + (batch, cfg.num_steps) + cfg.input_shape,
                        generator=gen) < 0.3).float()
    y = torch.randint(0, cfg.num_classes, lead + (batch,), generator=gen)
    return x, y


def _plain_step(cfg, tx, backend, params, opt_state, gen, x, y):
    """The train step written out: loss, BPTT, Adam."""
    leaves = [{k: v.detach().requires_grad_() for k, v in p.items()}
              for p in params]
    loss = train_snn.loss_fn(cfg, leaves, gen, x, y, matmul_backend=backend)
    flat = [v for p in leaves for v in p.values()]
    grads = iter(torch.autograd.grad(loss, flat))
    grads = [{k: next(grads) for k in p} for p in leaves]
    with torch.no_grad():
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optim.apply_updates(params, updates)
    return params, opt_state, loss.detach()


def _equal_trees(a, b) -> bool:
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    return sa == sb and all(torch.equal(u, v) for u, v in zip(la, lb))


@pytest.mark.parametrize("rate", [False, True], ids=["events", "rate"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_cpu_step_runs_eagerly_and_makes_no_graph(backend, rate,
                                                  monkeypatch):
    def no_graph(*args, **kwargs):
        raise AssertionError("a CUDA graph was made for CPU tensors")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    monkeypatch.setattr(torch.cuda, "graph", no_graph)
    cfg = _net()
    tx = optim.adam(1e-2)
    step = train_snn.make_train_step(cfg, tx, backend)
    params, opt_state, gen = train_snn.init_cell(cfg, tx, 4, device="cpu")
    plain = (params, opt_state)
    plain_gen = torch.Generator().manual_seed(4)
    for k in range(3):
        x, y = _batch(cfg, 10 + k, rate=rate)
        params, opt_state, loss = step(params, opt_state, gen, x, y)
        *plain, plain_loss = _plain_step(cfg, tx, backend, *plain,
                                         plain_gen, x, y)
        assert torch.equal(loss, plain_loss)
        assert _equal_trees((params, opt_state), tuple(plain))
    assert torch.equal(gen.get_state(), plain_gen.get_state())
    assert step.graphs.graphs == {}


# ---------------------------------------------------------------------------
# The graph path's bookkeeping, with a stand-in graph
# ---------------------------------------------------------------------------

class _FakeGraph:
    """``torch.cuda.CUDAGraph`` on the CPU: a replay runs the captured
    step again on the captured inputs and writes into its outputs."""
    capturing = None

    def __init__(self):
        self.body = None
        self.generators = []

    def register_generator_state(self, generator):
        self.generators.append(generator)

    def pool(self):
        return ("pool", id(self))

    def replay(self):
        self.body()


@contextlib.contextmanager
def _fake_capture(graph, pool=None, stream=None,
                  capture_error_mode="global"):
    _FakeGraph.capturing = graph
    try:
        yield
    finally:
        _FakeGraph.capturing = None


def _recorded(fn):
    """``fn`` that counts one ``launch.fake`` a call, as a kernel binding
    counts its launch, and that hands a capture its body."""
    def step(*args):
        spans.count("launch.fake")
        out = fn(*args)
        graph = _FakeGraph.capturing
        if graph is not None:
            def body():
                new = pytree.tree_leaves(fn(*args))
                for o, n in zip(pytree.tree_leaves(out), new):
                    o.copy_(n)
            graph.body = body
        return out
    return step


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(step_graph, "_on_card", lambda leaves: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: ("stream",
                                                              device))
    spans.reset_counts("launch.fake")
    yield
    spans.reset_counts("launch.fake")


def _clone(tree):
    return pytree.tree_map(lambda t: t.clone(), tree)


@pytest.mark.parametrize("kind", ["events", "rate", "slab"])
def test_replays_equal_eager_steps(kind, fake_card):
    cfg = _net()
    tx = optim.adam(1e-2)
    cells = 3 if kind == "slab" else None
    rate = kind != "events"
    if cells:
        step = train_snn.make_stacked_train_step(cfg, tx, "spike_gemm")
        inits = [train_snn.init_cell(cfg, tx, s, device="cpu")
                 for s in range(cells)]
        params = [{k: torch.stack([i[0][n][k] for i in inits]) for k in p}
                  for n, p in enumerate(inits[0][0])]
        opt_state = tx.init(params)
        gen = [i[2] for i in inits]
        eager_gen = [torch.Generator().manual_seed(s) for s in range(cells)]
    else:
        step = train_snn.make_train_step(cfg, tx, "spike_gemm")
        params, opt_state, gen = train_snn.init_cell(cfg, tx, 4,
                                                     device="cpu")
        eager_gen = torch.Generator().manual_seed(4)
    graphs = step.graphs
    eager_fn = graphs.fn
    graphs.fn = _recorded(eager_fn)
    eager = (params, opt_state)
    returned = []
    for k in range(6):
        x, y = _batch(cfg, 20 + k, rate=rate, cells=cells)
        before = spans.counts().get("launch.fake", 0)
        params, opt_state, loss = step(params, opt_state, gen, x, y)
        assert spans.counts()["launch.fake"] == before + 1
        *eager, eager_loss = eager_fn(*eager, eager_gen, x, y)
        assert torch.equal(loss, eager_loss), k
        assert _equal_trees((params, opt_state), tuple(eager)), k
        # what earlier calls returned is not written by this one
        for old, kept in returned:
            assert _equal_trees(old, kept)
        out = (params, opt_state, loss)
        returned.append((out, _clone(out)))
    for g, e in zip(step_graph._generators(gen),
                    step_graph._generators(eager_gen)):
        assert torch.equal(g.get_state(), e.get_state())
    (graph,) = graphs.graphs.values()
    assert graph.tally == {"launch.fake": 1}
    assert len(graph.generators) == (cells or 1)


def test_a_new_signature_warms_up_and_captures_its_own_graph(fake_card):
    cfg = _net()
    tx = optim.adam(1e-2)
    step = train_snn.make_train_step(cfg, tx, "spike_gemm_fused")
    graphs = step.graphs
    eager_fn = graphs.fn
    graphs.fn = _recorded(eager_fn)
    params, opt_state, gen = train_snn.init_cell(cfg, tx, 7, device="cpu")
    eager = (params, opt_state)
    eager_gen = torch.Generator().manual_seed(7)
    made = []
    for k, batch in enumerate((2, 2, 2, 3, 3, 3, 2)):
        x, y = _batch(cfg, 30 + k, batch=batch, rate=True)
        params, opt_state, loss = step(params, opt_state, gen, x, y)
        *eager, eager_loss = eager_fn(*eager, eager_gen, x, y)
        assert torch.equal(loss, eager_loss), k
        assert _equal_trees((params, opt_state), tuple(eager)), k
        made.append(sum(g is not None for g in graphs.graphs.values()))
    # each batch shape: an eager warm-up, then a capture; one shared pool
    assert made == [0, 1, 1, 1, 2, 2, 2]
    assert len(graphs.graphs) == 2


def test_a_replay_draws_from_the_generator_it_is_given(fake_card):
    """A fresh generator each step, as a supervisor that can restart a
    step passes: the replay draws from it and advances it."""
    cfg = _net()
    tx = optim.adam(1e-2)
    step = train_snn.make_train_step(cfg, tx, "spike_gemm")
    eager_fn = step.graphs.fn
    step.graphs.fn = _recorded(eager_fn)
    params, opt_state, _ = train_snn.init_cell(cfg, tx, 3, device="cpu")
    eager = (params, opt_state)
    x, y = _batch(cfg, 40, rate=True)
    for k in range(5):
        gen = torch.Generator().manual_seed(100 + k)
        eager_gen = torch.Generator().manual_seed(100 + k)
        params, opt_state, loss = step(params, opt_state, gen, x, y)
        *eager, eager_loss = eager_fn(*eager, eager_gen, x, y)
        assert torch.equal(loss, eager_loss), k
        assert torch.equal(gen.get_state(), eager_gen.get_state())
    assert len(step.graphs.graphs) == 1
