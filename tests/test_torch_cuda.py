"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips where ``torch.cuda.is_available()`` is
false.  Run them on a GPU host with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports no JAX, so it runs where only PyTorch is installed.
Weights on a 2^-8 grid keep every partial sum exact in fp32, so kernel and
plain version must agree bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref, spike_gemm

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
