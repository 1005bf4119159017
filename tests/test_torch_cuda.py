"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips where ``torch.cuda.is_available()`` is
false.  Run them on a GPU host with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports no JAX, so it runs where only PyTorch is installed.
Weights on a 2^-8 grid keep every partial sum exact in fp32, so kernel and
plain version must agree bit for bit, and so must a backward step of
each autograd Function on the card and on the CPU.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import (ops, ref, spike_conv, spike_gemm_bwd,
                                 spike_gemm_fused)

# the package exports the functions spike_gemm, lif_step and penc_compact
# (the JAX package's kernel API), so their binding modules are reached by
# their full names
spike_gemm = importlib.import_module("repro_torch.kernels.spike_gemm")
lif_kernel = importlib.import_module("repro_torch.kernels.lif_step")
penc_kernel = importlib.import_module("repro_torch.kernels.penc_compact")

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


#: (B, H, W, C, F, kernel, stride, padding): ragged layers (odd sizes,
#: stride 2, VALID, C and F past one word of 32), the dvs-conv cell's two
#: convs and net-5's conv1 and conv2.
CONV_LAYERS = [(3, 17, 15, 3, 33, 3, 2, "SAME"),
               (2, 9, 11, 33, 5, 3, 1, "VALID"),
               (2, 9, 8, 4, 7, 2, 2, "VALID"),
               (64, 32, 32, 2, 8, 3, 1, "SAME"),
               (64, 16, 16, 8, 16, 3, 1, "SAME"),
               (64, 128, 128, 2, 32, 3, 1, "SAME"),
               (64, 64, 64, 32, 32, 3, 1, "SAME")]


def _conv_operands(cuda, layer, density, seed):
    """Spikes, grid weights and an integer cotangent in [-2, 2] (every sum
    of dW is exact at net-5's 10^6 output pixels), made on the card."""
    b, h, w, c, f, k, stride, padding = layer
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.rand((b, h, w, c), generator=gen, device=cuda)
         < density).float()
    wt = torch.randn((k, k, c, f), generator=gen, device=cuda) * 0.5
    wt = torch.round(wt / GRID) * GRID
    out = ref.spike_conv_ref(x, wt, stride=stride, padding=padding)
    g = torch.randn(out.shape, generator=gen, device=cuda).round().clamp(-2, 2)
    g = g * (torch.rand(out.shape, generator=gen, device=cuda) < 0.6)
    return x, wt, g, dict(stride=stride, padding=padding), out


@pytest.mark.cuda
@pytest.mark.parametrize("layer", CONV_LAYERS)
@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 1.0])
def test_cuda_conv_kernels_equal_plain(cuda, layer, density):
    """The conv and the conv dW on the spikes, on grid operands: equal to
    the plain versions bit for bit, the same bytes on a second call, one
    counted launch per op call (dW's split pass and reduction are one)."""
    x, w, g, conv, want = _conv_operands(cuda, layer, density, 18)
    k = w.shape[0]
    before = spike_conv.launches
    got = ops.spike_conv(x, w, **conv)
    torch.cuda.synchronize()
    assert spike_conv.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got, ops.spike_conv(x, w, **conv))
    before = spike_gemm_bwd.dw_launches
    dw = ops.spike_conv_bwd_dw(x, g, kernel_size=(k, k), **conv)
    torch.cuda.synchronize()
    assert spike_gemm_bwd.dw_launches == before + 1
    assert torch.equal(dw, ref.spike_conv_dw_ref(x, g, k, k, **conv))
    assert torch.equal(dw, ops.spike_conv_bwd_dw(x, g, kernel_size=(k, k),
                                                 **conv))


@pytest.mark.cuda
@pytest.mark.parametrize("layer", CONV_LAYERS[:3] + CONV_LAYERS[-1:])
def test_cuda_conv_kernels_take_any_values(cuda, layer):
    """Inputs other than spikes: each nonzero is an event with its own
    value (here on a 2^-2 grid, so every sum stays exact)."""
    x, w, g, conv, _ = _conv_operands(cuda, layer, 0.3, 19)
    gen = torch.Generator(device=cuda).manual_seed(20)
    x = x * torch.randint(1, 9, x.shape, generator=gen, device=cuda) / 4
    k = w.shape[0]
    assert torch.equal(ops.spike_conv(x, w, **conv),
                       ref.spike_conv_ref(x, w, **conv))
    assert torch.equal(ops.spike_conv_bwd_dw(x, g, kernel_size=(k, k), **conv),
                       ref.spike_conv_dw_ref(x, g, k, k, **conv))


@pytest.mark.cuda
def test_cuda_conv_kernels_refuse_what_they_cannot_take(cuda):
    x = torch.ones(2, 8, 8, 4, device=cuda)
    w = torch.ones(3, 3, 4, 8, device=cuda)
    g = torch.ones(2, 8, 8, 8, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        spike_conv.spike_conv_cuda(x.double(), w, 1, "SAME")
    with pytest.raises(ValueError, match="contiguous"):
        spike_conv.spike_conv_cuda(x.transpose(1, 2), w, 1, "SAME")
    with pytest.raises(ValueError, match="shape"):
        spike_conv.spike_conv_cuda(x, w[:, :, :3], 1, "SAME")
    with pytest.raises(ValueError, match="shared memory"):
        spike_conv.spike_conv_cuda(torch.ones(1, 8, 8, 256, device=cuda),
                                   torch.ones(3, 3, 256, 4, device=cuda), 1,
                                   "SAME")
    with pytest.raises(ValueError, match="shape"):
        spike_gemm_bwd.spike_conv_dw_cuda(x, g[:, :7], 3, 3, 1, "SAME")
    with pytest.raises(TypeError, match="dtype"):
        spike_gemm_bwd.spike_conv_dw_cuda(x, g.double(), 3, 3, 1, "SAME")


#: Shapes that take the split-K path: net-5's fc1, a ragged large K, and
#: dvs-conv's first dense layer, whose workspace is small enough to come
#: from the allocator's pool of the outputs.
SPLIT_SHAPES = [(64, 32768, 512), (70, 32768 + 37, 130), (64, 1024, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", SPLIT_SHAPES)
@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 1.0])
def test_cuda_split_path_equals_plain(cuda, m, k, n, density):
    """The split-K kernels on grid operands: equal to the plain versions
    bit for bit, the same bytes on a second call, one counted launch per
    op call (the split pass and the reduction are one launch)."""
    assert spike_gemm.split_plan(m, n, k)[0] > 1
    rng = np.random.default_rng(16)
    s = _t(_spikes(rng, (m, k), density)).to(cuda)
    w = _t(_grid_weights(rng, (k, n), scale=0.05)).to(cuda)
    b = _t(_grid_weights(rng, (n,))).to(cuda)
    u0 = _t(_grid_weights(rng, (m, n), 1.0)).to(cuda)
    s0 = _t(_spikes(rng, (m, n), 0.3)).to(cuda)
    before = spike_gemm.launches
    got = ops.spike_gemm(s, w)
    torch.cuda.synchronize()
    assert spike_gemm.launches == before + 1
    assert torch.equal(got, ref.spike_gemm_ref(s, w))
    assert torch.equal(got, ops.spike_gemm(s, w))
    for reset in ("subtract", "zero"):
        kw = dict(beta=0.95, threshold=1.0, reset_mechanism=reset)
        before = spike_gemm_fused.launches
        got = ops.spike_gemm_lif_step(s, w, b, u0, s0, **kw)
        torch.cuda.synchronize()
        assert spike_gemm_fused.launches == before + 1
        want = ref.spike_gemm_lif_ref(s, w, b, u0, s0, **kw)
        again = ops.spike_gemm_lif_step(s, w, b, u0, s0, **kw)
        for g, wv, a in zip(got, want, again):
            assert torch.equal(g, wv) and torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", SPLIT_SHAPES)
def test_cuda_split_path_on_normal_weights(cuda, m, k, n):
    """Normal weights: the same bytes on every call (a fixed order of
    sums, no atomics), and within 1e-5 of the largest sum of |s*w| of the
    plain version, whose sums run in cuBLAS's order."""
    rng = np.random.default_rng(17)
    s = _t(_spikes(rng, (m, k), 0.2)).to(cuda)
    w = rng.normal(size=(k, n)) / np.sqrt(k)
    w = _t(w.astype(np.float32)).to(cuda)
    got = ops.spike_gemm(s, w)
    assert torch.equal(got, ops.spike_gemm(s, w))
    norm = (s @ w.abs()).max().item()
    assert (got - ref.spike_gemm_ref(s, w)).abs().max().item() < 1e-5 * norm


def _cotangent(rng, shape, density=0.6):
    g = np.round(rng.normal(size=shape) * 16) / 16
    return (g * (rng.random(shape) < density)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(70, 1000, 130), (5, 33, 7),
                                   (4100, 18, 32), (64, 32768, 512),
                                   (130, 300, 68)])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 1.0])
def test_cuda_dw_ds_equal_plain(cuda, m, k, n, density):
    """The dense dW and dS on grid operands, at net-5's fc1 (dS's large
    blocks, dW's 16 columns a lane) and at more than 64 rows (dW's chunks
    of M): equal to the plain versions bit for bit, the same bytes twice,
    one counted launch each; dW also on spikes of other values."""
    rng = np.random.default_rng(12)
    s = _t(_spikes(rng, (m, k), density)).to(cuda)
    g = _t(_cotangent(rng, (m, n))).to(cuda)
    w = _t(_grid_weights(rng, (k, n))).to(cuda)
    dw_before = spike_gemm_bwd.dw_launches
    ds_before = spike_gemm_bwd.ds_launches
    dw = ops.spike_gemm_bwd_dw(s, g)
    ds = ops.spike_gemm_bwd_ds(g, w)
    torch.cuda.synchronize()
    assert spike_gemm_bwd.dw_launches == dw_before + 1
    assert spike_gemm_bwd.ds_launches == ds_before + 1
    assert torch.equal(dw, ref.spike_gemm_dw_ref(s, g))
    assert torch.equal(ds, ref.spike_gemm_ds_ref(g, w))
    assert torch.equal(dw, ops.spike_gemm_bwd_dw(s, g))     # no run-to-run
    assert torch.equal(ds, ops.spike_gemm_bwd_ds(g, w))
    values = s * _t(rng.integers(1, 9, (m, k)).astype(np.float32)).to(cuda) / 4
    assert torch.equal(ops.spike_gemm_bwd_dw(values, g),
                       ref.spike_gemm_dw_ref(values, g))


@pytest.mark.cuda
def test_cuda_ds_does_not_skip_a_cancelling_tile(cuda):
    g = torch.zeros(40, 64, device=cuda)
    g[3, 5], g[7, 9] = 0.75, -0.75
    ds = ops.spike_gemm_bwd_ds(g, torch.ones(6, 64, device=cuda))
    assert torch.equal(ds[3], torch.full((6,), 0.75, device=cuda))
    assert torch.equal(ds[7], torch.full((6,), -0.75, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("layer", CONV_LAYERS)
@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 1.0])
def test_cuda_conv_ds_equals_plain(cuda, layer, density):
    """The conv dS on grid operands: equal to the plain version (the matrix
    dS in patch space folded back by col2im) bit for bit, the same bytes on
    a second call, one counted launch per call."""
    x, w, _, conv, out = _conv_operands(cuda, layer, 0.3, 21)
    gen = torch.Generator(device=cuda).manual_seed(22)
    g = torch.randn(out.shape, generator=gen, device=cuda).round().clamp(-2, 2)
    g = g * (torch.rand(out.shape, generator=gen, device=cuda) < density)
    before = spike_gemm_bwd.ds_launches
    ds = ops.spike_conv_bwd_ds(g, w, tuple(x.shape), **conv)
    torch.cuda.synchronize()
    assert spike_gemm_bwd.ds_launches == before + 1
    assert torch.equal(ds, ref.spike_conv_ds_ref(g, w, tuple(x.shape),
                                                 **conv))
    assert torch.equal(ds, ops.spike_conv_bwd_ds(g, w, tuple(x.shape),
                                                 **conv))


@pytest.mark.cuda
@pytest.mark.parametrize("layer", CONV_LAYERS)
def test_cuda_conv_ds_is_col2im_of_the_dense_ds(cuda, layer):
    """Normal operands: each tap an fmaf chain over ascending f, the taps
    added in (dy, dx) order, so the conv dS equals col2im of the card's
    dense dS in patch space bit for bit."""
    b, h, wd, c, f, k, stride, padding = layer
    gen = torch.Generator(device=cuda).manual_seed(23)
    oh, ow = spike_gemm_bwd.conv_ds_plan((b, h, wd, c), (k, k, c, f), stride,
                                         padding)[4:6]
    g = torch.randn((b, oh, ow, f), generator=gen, device=cuda)
    w = torch.randn((k, k, c, f), generator=gen, device=cuda)
    ds = ops.spike_conv_bwd_ds(g, w, (b, h, wd, c), stride=stride,
                               padding=padding)
    patches = spike_gemm_bwd.spike_gemm_ds_cuda(g.reshape(-1, f),
                                                w.reshape(-1, f))
    assert torch.equal(ds, spike_conv.conv_col2im(patches, (b, h, wd, c), k,
                                                  k, stride, padding))


@pytest.mark.cuda
def test_cuda_conv_ds_does_not_skip_a_cancelling_row(cuda):
    g = torch.zeros(2, 8, 8, 32, device=cuda)
    g[1, 3, 4, :16], g[1, 3, 4, 16:] = 0.75, -0.75    # the row sums to zero
    w = torch.ones(3, 3, 32, 32, device=cuda)
    w[..., 16:] = 2.0
    ds = ops.spike_conv_bwd_ds(g, w, (2, 8, 8, 32))
    assert torch.equal(ds, ref.spike_conv_ds_ref(g, w, (2, 8, 8, 32)))
    assert torch.equal(ds[1, 2:5, 3:6], torch.full((3, 3, 32), -12.0,
                                                   device=cuda))


@pytest.mark.cuda
def test_cuda_conv_ds_refuses_what_it_cannot_take(cuda):
    g = torch.ones(2, 8, 8, 8, device=cuda)
    w = torch.ones(3, 3, 4, 8, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        spike_gemm_bwd.spike_conv_ds_cuda(g.double(), w, (2, 8, 8, 4), 1,
                                          "SAME")
    with pytest.raises(ValueError, match="shape"):
        spike_gemm_bwd.spike_conv_ds_cuda(g[:, :7], w, (2, 8, 8, 4), 1,
                                          "SAME")
    with pytest.raises(ValueError, match="input channels"):
        spike_gemm_bwd.spike_conv_ds_cuda(g, w, (2, 8, 8, 5), 1, "SAME")
    with pytest.raises(ValueError, match="stride"):
        spike_gemm_bwd.spike_conv_ds_cuda(g, w, (2, 8, 8, 4), 0, "SAME")


@pytest.mark.cuda
def test_cuda_conv_backward_builds_no_patch_space_cotangent(cuda,
                                                            monkeypatch):
    """The conv Function's backward on the card never folds a patch-space
    cotangent back (col2im raises on a CUDA tensor here), and its output
    and gradients equal the CPU's bit for bit on grid operands."""
    real = spike_conv.conv_col2im

    def col2im(d_patches, *args):
        if d_patches.is_cuda:
            raise AssertionError("col2im ran on the card")
        return real(d_patches, *args)

    monkeypatch.setattr(spike_conv, "conv_col2im", col2im)
    monkeypatch.setattr(ref, "conv_col2im", col2im)
    rng = np.random.default_rng(24)
    for stride, padding, shape in ((1, "SAME", (2, 16, 16, 32)),
                                   (2, "VALID", (2, 17, 15, 4))):
        args = [_spikes(rng, shape, 0.2),
                _grid_weights(rng, (3, 3, shape[-1], 33))]
        out = ref.spike_conv_ref(_t(args[0]), _t(args[1]), stride=stride,
                                 padding=padding)
        cots = [_cotangent(rng, tuple(out.shape))]
        fn = lambda x, w: ops.spike_conv_train(x, w, stride=stride,
                                               padding=padding)
        got = _backward_step(fn, args, cots, cuda)
        want = _backward_step(fn, args, cots, "cpu")
        for a, b in zip(got, want):
            assert torch.equal(a, b)


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


def _unaligned(x):
    """A contiguous copy of ``x`` that starts 4 bytes past a 16-byte
    boundary, so the kernels take their unvectorised path."""
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    y = buf[1:1 + x.numel()].view(x.shape)
    y.copy_(x)
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reset", ["subtract", "zero"])
@pytest.mark.parametrize("shape,aligned", [((8, 512), True), ((1, 100), True),
                                           ((3, 701), True), ((5, 1), True),
                                           ((64, 4099), True),
                                           ((16, 2048), False)])
def test_cuda_lif_step_equals_plain(cuda, shape, aligned, reset, dtype):
    """Bit for bit in both dtypes: the kernel rounds each operation as the
    plain version's PyTorch ops do."""
    rng = np.random.default_rng(14)
    args = [_t(rng.normal(size=shape).astype(np.float32)),
            _t(_spikes(rng, shape, 0.3)),
            _t(rng.normal(size=shape).astype(np.float32))]
    args = [a.to(cuda, dtype) for a in args]
    if not aligned:
        args = [_unaligned(a) for a in args]
    kw = dict(beta=0.9, threshold=0.7, reset_mechanism=reset)
    before = lif_kernel.launches
    got = ops.lif_step(*args, **kw)
    torch.cuda.synchronize()
    assert lif_kernel.launches == before + 1
    want = ref.lif_step_ref(*args, **kw)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,aligned", [((8, 128), True), ((3, 100), True),
                                           ((16, 777), True),
                                           ((4, 9000), True),
                                           ((5, 4100), False)])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.1, 0.9, 1.0])
def test_cuda_penc_compact_equals_plain(cuda, shape, aligned, density):
    rng = np.random.default_rng(15)
    s = _t(_spikes(rng, shape, density)).to(cuda)
    if not aligned:
        s = _unaligned(s)
    for capacity in (shape[1], 100, 7, 0, shape[1] + 5):
        before = penc_kernel.launches
        idx, cnt = ops.penc_compact(s, capacity)
        torch.cuda.synchronize()
        assert penc_kernel.launches == before + 1
        want_idx, want_cnt = ref.penc_compact_ref(s, capacity)
        assert idx.dtype == cnt.dtype == torch.int32
        assert torch.equal(idx, want_idx) and torch.equal(cnt, want_cnt)


@pytest.mark.cuda
def test_cuda_new_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    x = torch.ones(4, 8, device=cuda)
    with pytest.raises(TypeError, match="lif_step takes"):
        lif_kernel.lif_step_cuda(x.double(), x.double(), x.double(),
                                 beta=0.9, threshold=1.0)
    with pytest.raises(TypeError, match="dtype"):
        lif_kernel.lif_step_cuda(x, x.bfloat16(), x, beta=0.9, threshold=1.0)
    with pytest.raises(ValueError, match="shape"):
        lif_kernel.lif_step_cuda(x, x[:2], x, beta=0.9, threshold=1.0)
    with pytest.raises(TypeError, match="dtype"):
        penc_kernel.penc_compact_cuda(x.double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        penc_kernel.penc_compact_cuda(x.t(), 4)
    with pytest.raises(ValueError, match="capacity"):
        penc_kernel.penc_compact_cuda(x, -1)
