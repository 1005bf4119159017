"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips where ``torch.cuda.is_available()`` is
false.  Run them on a GPU host with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports no JAX, so it runs where only PyTorch is installed.
Weights on a 2^-8 grid keep every partial sum exact in fp32, so kernel and
plain version must agree bit for bit, and so must a backward step of
each autograd Function on the card and on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref, spike_gemm, spike_gemm_bwd

GRID = 2.0 ** -8


def _spikes(rng, shape, density):
    return (rng.random(shape) < density).astype(np.float32)


def _grid_weights(rng, shape, scale=0.5):
    w = rng.normal(scale=scale, size=shape)
    return (np.round(w / GRID) * GRID).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU host)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 1.0])
def test_cuda_spike_gemm_equals_plain(cuda, density):
    rng = np.random.default_rng(9)
    s = _t(_spikes(rng, (70, 1000), density)).to(cuda)
    w = _t(_grid_weights(rng, (1000, 130))).to(cuda)
    before = spike_gemm.launches
    got = ops.spike_gemm(s, w)
    torch.cuda.synchronize()
    assert spike_gemm.launches == before + 1
    assert torch.equal(got, ref.spike_gemm_ref(s, w))


@pytest.mark.cuda
@pytest.mark.parametrize("reset", ["subtract", "zero"])
def test_cuda_fused_equals_plain(cuda, reset):
    rng = np.random.default_rng(10)
    s = _t(_spikes(rng, (64, 700), 0.1)).to(cuda)
    w = _t(_grid_weights(rng, (700, 90))).to(cuda)
    b = _t(_grid_weights(rng, (90,))).to(cuda)
    u0 = _t(rng.normal(size=(64, 90)).astype(np.float32)).to(cuda)
    s0 = _t(_spikes(rng, (64, 90), 0.3)).to(cuda)
    got = ops.spike_gemm_lif_step(s, w, b, u0, s0, beta=0.95, threshold=1.0,
                                  reset_mechanism=reset)
    want = ref.spike_gemm_lif_ref(s, w, b, u0, s0, beta=0.95, threshold=1.0,
                                  reset_mechanism=reset)
    assert all(torch.equal(g, wv) for g, wv in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "VALID")])
def test_cuda_spike_conv_equals_plain(cuda, stride, padding):
    rng = np.random.default_rng(11)
    x = _t(_spikes(rng, (3, 17, 15, 4), 0.2)).to(cuda)
    w = _t(_grid_weights(rng, (3, 3, 4, 33))).to(cuda)
    got = ops.spike_conv(x, w, stride=stride, padding=padding)
    want = ref.spike_conv_ref(x, w, stride=stride, padding=padding)
    assert torch.equal(got, want)


def _cotangent(rng, shape, density=0.6):
    g = np.round(rng.normal(size=shape) * 16) / 16
    return (g * (rng.random(shape) < density)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(70, 1000, 130), (5, 33, 7),
                                   (4100, 18, 32)])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 1.0])
def test_cuda_dw_ds_equal_plain(cuda, m, k, n, density):
    rng = np.random.default_rng(12)
    s = _t(_spikes(rng, (m, k), density)).to(cuda)
    g = _t(_cotangent(rng, (m, n))).to(cuda)
    w = _t(_grid_weights(rng, (k, n))).to(cuda)
    dw_before = spike_gemm_bwd.dw_launches
    dw = ops.spike_gemm_bwd_dw(s, g)
    ds = ops.spike_gemm_bwd_ds(g, w)
    torch.cuda.synchronize()
    assert spike_gemm_bwd.dw_launches == dw_before + 1
    assert torch.equal(dw, ref.spike_gemm_dw_ref(s, g))
    assert torch.equal(ds, ref.spike_gemm_ds_ref(g, w))
    assert torch.equal(dw, ops.spike_gemm_bwd_dw(s, g))     # no run-to-run


@pytest.mark.cuda
def test_cuda_ds_does_not_skip_a_cancelling_tile(cuda):
    g = torch.zeros(40, 64, device=cuda)
    g[3, 5], g[7, 9] = 0.75, -0.75
    ds = ops.spike_gemm_bwd_ds(g, torch.ones(6, 64, device=cuda))
    assert torch.equal(ds[3], torch.full((6,), 0.75, device=cuda))
    assert torch.equal(ds[7], torch.full((6,), -0.75, device=cuda))


def _backward_step(fn, args, cots, device):
    """Outputs and input gradients of one autograd step of ``fn``."""
    targs = [_t(a).to(device).requires_grad_() for a in args]
    outs = fn(*targs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(outs, targs,
                                [_t(c).to(device) for c in cots])
    return [t.detach().cpu() for t in (*outs, *grads)]


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["gemm", "conv", "fused-subtract",
                                   "fused-zero"])
def test_cuda_autograd_step_equals_cpu(cuda, which):
    """One forward and backward of each Function on the card equals the
    same step on the CPU (plain versions) bit for bit: grid operands, and
    cotangents that enter the products on their grid."""
    rng = np.random.default_rng(13)
    if which == "gemm":
        args = [_spikes(rng, (40, 300), 0.2), _grid_weights(rng, (300, 20))]
        cots = [_cotangent(rng, (40, 20))]
        fn = ops.spike_gemm_train
    elif which == "conv":
        args = [_spikes(rng, (2, 17, 15, 4), 0.2),
                _grid_weights(rng, (3, 3, 4, 33))]
        cots = [_cotangent(rng, (2, 9, 8, 33))]
        fn = lambda x, w: ops.spike_conv_train(x, w, stride=2)
    else:
        reset = which.split("-")[1]
        args = [_spikes(rng, (24, 200), 0.2), _grid_weights(rng, (200, 30)),
                _grid_weights(rng, (30,)), _grid_weights(rng, (24, 30), 1.0),
                _spikes(rng, (24, 30), 0.3)]
        cots = [_cotangent(rng, (24, 30)), np.zeros((24, 30), np.float32)]
        fn = lambda *a: ops.spike_gemm_lif_step(
            *a, beta=0.5, threshold=1.0, reset_mechanism=reset)
    got = _backward_step(fn, args, cots, cuda)
    want = _backward_step(fn, args, cots, "cpu")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    s = torch.ones(40, 64, device=cuda)
    w = torch.ones(64, 8, device=cuda)
    flags = ops.block_flags(s)
    with pytest.raises(TypeError, match="dtype"):
        spike_gemm.spike_gemm_cuda(s.double(), w, flags)
    with pytest.raises(ValueError, match="contiguous"):
        spike_gemm.spike_gemm_cuda(s, torch.ones(8, 64, device=cuda).t(),
                                   flags)
    with pytest.raises(TypeError, match="dtype"):
        spike_gemm.spike_gemm_cuda(s, w, flags.long())
    with pytest.raises(ValueError, match="shape"):
        spike_gemm.spike_gemm_cuda(s, w, flags[:1])
    with pytest.raises(ValueError, match="expected"):
        spike_gemm.spike_gemm_cuda(s, w.cpu(), flags)
