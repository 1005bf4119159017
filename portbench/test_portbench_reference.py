"""The plain reference agrees with ``repro_torch`` on the CPU at tiny sizes
of both configurations (net-3 as a slab of 2), and its pieces agree with
PyTorch's own operators."""
from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from portbench import harness
from portbench.conftest import tiny_cell
from portbench.reference import snn as ref
from repro_torch import optim


@pytest.mark.parametrize("which,cells", [("net5", None), ("net3", 2)])
def test_the_reference_follows_the_port_step_by_step(card_on_cpu, which,
                                                     cells):
    cell = tiny_cell(which, cells=cells or 2)
    run = harness.Run(cell, 2 ** 32 + 1, card_on_cpu)
    prog, p0, rows = harness.first_steps(run, 0.9)
    run.free()
    got = harness.reference_readings(run, p0, rows)
    for ps, rs in zip(prog.losses, got.losses):
        assert ps == pytest.approx(rs, rel=1e-6)
    for field in ("grads", "updates"):
        for pc, rc in zip(getattr(prog, field), getattr(got, field)):
            assert pc == pytest.approx(rc, rel=1e-4, abs=1e-9)
    assert len(got.grads) == (cells or 1)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      -(1.0 + 2 ** -11), 3.0])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                         -(1.0 + 2 ** -10), 3.0])
    assert ref.tf32_round(x).equal(want)


def test_conv_and_matmul_match_torch_with_their_gradients():
    torch.manual_seed(0)
    x = torch.rand(2, 5, 6, 3, dtype=torch.float64, requires_grad=True)
    w = torch.randn(3, 3, 3, 4, dtype=torch.float64, requires_grad=True)
    for stride, padding in ((1, "SAME"), (2, "SAME"), (1, "VALID")):
        got = ref._Conv.apply(x, w, stride, padding, ref.no_round)
        pad = (1, 1, 1, 1) if padding == "SAME" and stride == 1 else (
            (0, 1, 1, 1) if padding == "SAME" else (0, 0, 0, 0))
        want = F.conv2d(F.pad(x.permute(0, 3, 1, 2), pad),
                        w.permute(3, 2, 0, 1), stride=stride).permute(
            0, 2, 3, 1)
        assert got.shape == want.shape
        torch.testing.assert_close(got, want)
        g = torch.randn_like(want)
        torch.testing.assert_close(torch.autograd.grad(got, (x, w), g),
                                   torch.autograd.grad(want, (x, w), g))
    a = torch.randn(4, 5, dtype=torch.float64, requires_grad=True)
    b = torch.randn(5, 3, dtype=torch.float64, requires_grad=True)
    g = torch.randn(4, 3, dtype=torch.float64)
    torch.testing.assert_close(
        torch.autograd.grad(ref._Matmul.apply(a, b, ref.no_round), (a, b), g),
        torch.autograd.grad(a @ b, (a, b), g))


def test_or_pool_sends_the_gradient_to_the_first_maximum():
    s = torch.tensor([[1.0, 1.0], [0.0, 1.0]]).reshape(1, 2, 2, 1)
    s.requires_grad_()
    out = ref.or_pool(s, 2)
    (g,) = torch.autograd.grad(out.sum(), s)
    assert out.item() == 1.0
    assert g.reshape(-1).tolist() == [1.0, 0.0, 0.0, 0.0]
    z = torch.zeros(1, 2, 2, 1, requires_grad=True)
    (g,) = torch.autograd.grad(ref.or_pool(z, 2).sum(), z)
    assert g.reshape(-1).tolist() == [1.0, 0.0, 0.0, 0.0]


def test_adam_matches_the_ports_arithmetic():
    torch.manual_seed(1)
    p = [{"w": torch.randn(6, 4), "b": torch.randn(4)}]
    tx = optim.adam(2e-3)
    state = tx.init(p)
    mine = ref.Adam(p, 2e-3, 0.9, 0.999, 1e-8)
    port, own = p, p
    for _ in range(3):
        g = [{k: torch.randn_like(v) for k, v in p[0].items()}]
        updates, state = tx.update(g, state, port)
        port = optim.apply_updates(port, updates)
        own = mine.step(own, g)
        for k in p[0]:
            torch.testing.assert_close(own[0][k], port[0][k], rtol=1e-6,
                                       atol=1e-7)
