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

from repro_torch.kernels import ops, ref, spike_conv, spike_gemm_bwd

# the package exports the functions spike_gemm, lif_step and penc_compact
# (the JAX package's kernel API), so their binding modules are reached by
# their full names
spike_gemm = importlib.import_module("repro_torch.kernels.spike_gemm")
lif_kernel = importlib.import_module("repro_torch.kernels.lif_step")
epilogue_kernel = importlib.import_module("repro_torch.kernels.conv_epilogue")
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
    before = ops.launch_counts()["spike_gemm"]
    got = ops.spike_gemm(s, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["spike_gemm"] == before + 1
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
    before = ops.launch_counts()["spike_conv"]
    got = ops.spike_conv(x, w, **conv)
    torch.cuda.synchronize()
    assert ops.launch_counts()["spike_conv"] == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got, ops.spike_conv(x, w, **conv))
    before = ops.launch_counts()["spike_gemm_dw"]
    dw = ops.spike_conv_bwd_dw(x, g, kernel_size=(k, k), **conv)
    torch.cuda.synchronize()
    assert ops.launch_counts()["spike_gemm_dw"] == before + 1
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
    before = ops.launch_counts()["spike_gemm"]
    got = ops.spike_gemm(s, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["spike_gemm"] == before + 1
    assert torch.equal(got, ref.spike_gemm_ref(s, w))
    assert torch.equal(got, ops.spike_gemm(s, w))
    for reset in ("subtract", "zero"):
        kw = dict(beta=0.95, threshold=1.0, reset_mechanism=reset)
        before = ops.launch_counts()["spike_gemm_lif"]
        got = ops.spike_gemm_lif_step(s, w, b, u0, s0, **kw)
        torch.cuda.synchronize()
        assert ops.launch_counts()["spike_gemm_lif"] == before + 1
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
    dw_before = ops.launch_counts()["spike_gemm_dw"]
    ds_before = ops.launch_counts()["spike_gemm_ds"]
    dw = ops.spike_gemm_bwd_dw(s, g)
    ds = ops.spike_gemm_bwd_ds(g, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["spike_gemm_dw"] == dw_before + 1
    assert ops.launch_counts()["spike_gemm_ds"] == ds_before + 1
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
    before = ops.launch_counts()["spike_gemm_ds"]
    ds = ops.spike_conv_bwd_ds(g, w, tuple(x.shape), **conv)
    torch.cuda.synchronize()
    assert ops.launch_counts()["spike_gemm_ds"] == before + 1
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
    before = ops.launch_counts()["lif_step"]
    got = ops.lif_step(*args, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["lif_step"] == before + 1
    want = ref.lif_step_ref(*args, **kw)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


#: Entries of one tile of the two-pass penc_compact kernels.
PENC_TILE = penc_kernel.ROUND


@pytest.mark.cuda
@pytest.mark.parametrize("shape,aligned", [
    ((8, 128), True), ((3, 100), True), ((16, 777), True), ((4, 9000), True),
    ((5, 4100), False), ((4, PENC_TILE - 1), True), ((4, PENC_TILE + 1), True),
    ((3, 3 * PENC_TILE + 7), True), ((3, 3 * PENC_TILE + 8), False),
    ((64, 131072), True), ((1, 9000), True), ((257, 5000), True),
    ((5, 1), True), ((6, 31), True), ((7, 33), True),
    ((2, (penc_kernel.MAX_TILES + 1) * PENC_TILE + 5), True)])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.1, 0.9, 1.0])
def test_cuda_penc_compact_equals_plain(cuda, shape, aligned, density):
    """Rows of one tile (one launch) and of several (the two passes, the
    last tile ragged; the last shape's tiles are two rounds long), at
    capacities 0, 1, 7, 100, N, N + 5 and 2 N."""
    rng = np.random.default_rng(15)
    s = _t(_spikes(rng, shape, density)).to(cuda)
    if not aligned:
        s = _unaligned(s)
    for capacity in (shape[1], 100, 7, 1, 0, shape[1] + 5, 2 * shape[1]):
        before = ops.launch_counts()["penc_compact"]
        idx, cnt = ops.penc_compact(s, capacity)
        torch.cuda.synchronize()
        assert ops.launch_counts()["penc_compact"] == before + 1
        want_idx, want_cnt = ref.penc_compact_ref(s, capacity)
        assert idx.dtype == cnt.dtype == torch.int32
        assert torch.equal(idx, want_idx) and torch.equal(cnt, want_cnt)


@pytest.mark.cuda
@pytest.mark.parametrize("cut", [PENC_TILE - 1, PENC_TILE, PENC_TILE + 1,
                                 2 * PENC_TILE])
def test_cuda_penc_compact_count_reaching_capacity_at_a_tile_edge(cuda, cut):
    """Every entry of row 0 fires, so its count reaches ``capacity`` just
    inside tile 0, exactly on its end, just past it or on tile 1's end."""
    s = torch.ones(3, 3 * PENC_TILE + 7, device=cuda)
    s[1, ::3] = 0.0
    s[2] = 0.0
    idx, cnt = ops.penc_compact(s, cut)
    want_idx, want_cnt = ref.penc_compact_ref(s, cut)
    assert torch.equal(idx, want_idx) and torch.equal(cnt, want_cnt)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 700), (3, 3 * PENC_TILE + 7)])
def test_cuda_penc_compact_values_other_than_spikes(cuda, shape):
    """> 0 fires (0.5, 2, inf); 0, -0.0, -1 and NaN do not; on aligned and
    unaligned storage alike."""
    rng = np.random.default_rng(16)
    vals = np.array([0.0, -0.0, -1.0, np.nan, 0.5, 2.0, np.inf], np.float32)
    x = _t(vals[rng.integers(0, len(vals), shape)]).to(cuda)
    for s in (x, _unaligned(x)):
        for capacity in (shape[1], 50):
            idx, cnt = ops.penc_compact(s, capacity)
            want_idx, want_cnt = ref.penc_compact_ref(s, capacity)
            assert torch.equal(idx, want_idx) and torch.equal(cnt, want_cnt)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,capacity", [((64, 131072), 131072),
                                            ((64, 131072), 100),
                                            ((64, 512), 512)])
def test_cuda_penc_compact_gives_the_same_bytes_twice(cuda, shape, capacity):
    rng = np.random.default_rng(17)
    s = _t(_spikes(rng, shape, 0.1)).to(cuda)
    first = ops.penc_compact(s, capacity)
    second = ops.penc_compact(s, capacity)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


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


# ---- the cell axis (a DSE slab of C cells of one shape) -------------------
#
# Each case stacks C = 3 cells with their own weights and spike densities;
# one call must be one counted launch for the whole slab, and each cell's
# slice must equal a solo launch on that cell's operands and the plain
# version bit for bit (grid operands).  Shapes whose M or B is not a
# multiple of 32 check that no flag tile mixes two cells.

CELL_DENSITIES = (0.0, 0.05, 0.3)


def _cell_stack(make, densities=CELL_DENSITIES):
    return torch.stack([make(i, d) for i, d in enumerate(densities)])


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(70, 1000, 130), (45, 33, 7),
                                   (64, 1024, 64), (64, 32768, 512)])
def test_cuda_cell_axis_dense_forward(cuda, m, k, n):
    rng = np.random.default_rng(30)
    s = _cell_stack(lambda i, d: _t(_spikes(rng, (m, k), d))).to(cuda)
    w = _cell_stack(lambda i, d: _t(_grid_weights(rng, (k, n), 0.05))).to(
        cuda)
    b = _cell_stack(lambda i, d: _t(_grid_weights(rng, (n,)))).to(cuda)
    u0 = _cell_stack(lambda i, d: _t(_grid_weights(rng, (m, n), 1.0))).to(
        cuda)
    s0 = _cell_stack(lambda i, d: _t(_spikes(rng, (m, n), 0.3))).to(cuda)
    flags = ops.block_flags(s)
    assert flags.shape == (3,) + spike_gemm.build.tile_grid(m, k)
    for c in range(3):
        assert torch.equal(flags[c], ops.block_flags(s[c]))
    before = ops.launch_counts()["spike_gemm"]
    got = ops.spike_gemm(s, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["spike_gemm"] == before + 1
    for c in range(3):
        assert torch.equal(got[c], ops.spike_gemm(s[c], w[c]))
        assert torch.equal(got[c], ref.spike_gemm_ref(s[c], w[c]))
    for reset in ("subtract", "zero"):
        kw = dict(beta=0.95, threshold=1.0, reset_mechanism=reset)
        before = ops.launch_counts()["spike_gemm_lif"]
        u, sp = ops.spike_gemm_lif_step(s, w, b, u0, s0, **kw)
        torch.cuda.synchronize()
        assert ops.launch_counts()["spike_gemm_lif"] == before + 1
        for c in range(3):
            solo = ops.spike_gemm_lif_step(s[c], w[c], b[c], u0[c], s0[c],
                                           **kw)
            plain = ref.spike_gemm_lif_ref(s[c], w[c], b[c], u0[c], s0[c],
                                           **kw)
            assert torch.equal(u[c], solo[0]) and torch.equal(sp[c], solo[1])
            assert torch.equal(u[c], plain[0])
            assert torch.equal(sp[c], plain[1])


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(70, 1000, 130), (45, 33, 7),
                                   (64, 32768, 512), (130, 300, 68)])
def test_cuda_cell_axis_dense_backward(cuda, m, k, n):
    rng = np.random.default_rng(31)
    s = _cell_stack(lambda i, d: _t(_spikes(rng, (m, k), d))).to(cuda)
    g = _cell_stack(lambda i, d: _t(_cotangent(rng, (m, n), 1 - d))).to(cuda)
    w = _cell_stack(lambda i, d: _t(_grid_weights(rng, (k, n)))).to(cuda)
    dw_before = ops.launch_counts()["spike_gemm_dw"]
    ds_before = ops.launch_counts()["spike_gemm_ds"]
    dw = ops.spike_gemm_bwd_dw(s, g)
    ds = ops.spike_gemm_bwd_ds(g, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["spike_gemm_dw"] == dw_before + 1
    assert ops.launch_counts()["spike_gemm_ds"] == ds_before + 1
    for c in range(3):
        assert torch.equal(dw[c], ops.spike_gemm_bwd_dw(s[c], g[c]))
        assert torch.equal(dw[c], ref.spike_gemm_dw_ref(s[c], g[c]))
        assert torch.equal(ds[c], ops.spike_gemm_bwd_ds(g[c], w[c]))
        assert torch.equal(ds[c], ref.spike_gemm_ds_ref(g[c], w[c]))


@pytest.mark.cuda
@pytest.mark.parametrize("layer", CONV_LAYERS[:5])
def test_cuda_cell_axis_conv(cuda, layer):
    """The conv forward, dW and dS on a slab of 3 cells (the ragged layers
    and the dvs-conv cell's two convs)."""
    cells = [_conv_operands(cuda, layer, d, 40 + i)
             for i, d in enumerate(CELL_DENSITIES)]
    conv = cells[0][3]
    x, w, g = (torch.stack([cell[j] for cell in cells]) for j in range(3))
    k = w.shape[1]
    names = ("spike_conv", "spike_gemm_dw", "spike_gemm_ds")
    counts = [ops.launch_counts()[n] for n in names]
    out = ops.spike_conv(x, w, **conv)
    dw = ops.spike_conv_bwd_dw(x, g, kernel_size=(k, k), **conv)
    ds = ops.spike_conv_bwd_ds(g, w, tuple(x.shape), **conv)
    torch.cuda.synchronize()
    assert [ops.launch_counts()[n] for n in names] == [
        n + 1 for n in counts]
    for c in range(3):
        xc, wc, gc = x[c], w[c], g[c]
        assert torch.equal(out[c], ops.spike_conv(xc, wc, **conv))
        assert torch.equal(out[c], cells[c][4])
        assert torch.equal(dw[c], ops.spike_conv_bwd_dw(
            xc, gc, kernel_size=(k, k), **conv))
        assert torch.equal(dw[c], ref.spike_conv_dw_ref(xc, gc, k, k,
                                                        **conv))
        assert torch.equal(ds[c], ops.spike_conv_bwd_ds(
            gc, wc, tuple(xc.shape), **conv))
        assert torch.equal(ds[c], ref.spike_conv_ds_ref(
            gc, wc, tuple(xc.shape), **conv))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["gemm", "conv", "fused"])
def test_cuda_cell_axis_autograd_step_equals_solo(cuda, which):
    """One forward and backward of each train Function on a slab of 3
    cells equals, cell by cell, the solo step on the card bit for bit."""
    rng = np.random.default_rng(32)
    if which == "gemm":
        args = [[_spikes(rng, (45, 300), d), _grid_weights(rng, (300, 20))]
                for d in CELL_DENSITIES]
        cots = [[_cotangent(rng, (45, 20))] for _ in CELL_DENSITIES]
        fn = ops.spike_gemm_train
    elif which == "conv":
        args = [[_spikes(rng, (3, 16, 16, 8), d),
                 _grid_weights(rng, (3, 3, 8, 16))] for d in CELL_DENSITIES]
        cots = [[_cotangent(rng, (3, 16, 16, 16))] for _ in CELL_DENSITIES]
        fn = ops.spike_conv_train
    else:
        args = [[_spikes(rng, (45, 200), d), _grid_weights(rng, (200, 30)),
                 _grid_weights(rng, (30,)), _grid_weights(rng, (45, 30), 1.0),
                 _spikes(rng, (45, 30), 0.3)] for d in CELL_DENSITIES]
        cots = [[_cotangent(rng, (45, 30)), np.zeros((45, 30), np.float32)]
                for _ in CELL_DENSITIES]
        fn = lambda *a: ops.spike_gemm_lif_step(
            *a, beta=0.5, threshold=1.0, reset_mechanism="subtract")
    stacked = _backward_step(fn, [np.stack(a) for a in zip(*args)],
                             [np.stack(c) for c in zip(*cots)], cuda)
    for c in range(3):
        solo = _backward_step(fn, args[c], cots[c], cuda)
        for a, b in zip(stacked, solo):
            assert torch.equal(a[c], b)


# ---- the conv epilogue (bias, LIF, spike, OR-pool) -------------------------
#
# ops.conv_lif_step on the card against its plain version
# (ref.conv_lif_ref / conv_lif_bwd_ref, the unfused chain's ops) run on the
# same card tensors: u, s, the pooled map, the first maxima and the three
# elementwise cotangents bit for bit; the bias gradient to fp32 summation
# order (exactly where every partial sum is exact).

#: (B, H, W, F): net-5's conv1 and conv2 at a small B, a ragged 33 x 33
#: image, channels that are not whole float4s, and the dvs-conv cell's
#: first conv.
EPILOGUE_SHAPES = [(4, 128, 128, 32), (4, 64, 64, 32), (2, 33, 33, 32),
                   (2, 33, 31, 5), (8, 32, 32, 8)]


def _epilogue_operands(cuda, shape, seed, pooled=True, grid=False):
    """cur, bias, u_prev, s_prev, and the cotangents of u, s and the
    pooled map, made on the card: normal values that put a share of u near
    the threshold, or on the 1/256 grid with small magnitudes."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    lead, f = shape[:-4], shape[-1]

    def normal(shp, scale=1.0, shift=0.0):
        x = torch.randn(shp, generator=gen, device=cuda) * scale + shift
        return torch.round(x * 256) / 256 if grid else x

    def spikes(shp, p=0.3):
        return (torch.rand(shp, generator=gen, device=cuda) < p).float()

    b_, h, w = shape[-4:-1]
    pshape = lead + (b_, h // 2, w // 2, f)
    return dict(cur=normal(shape, 0.8, 0.4), bias=normal(lead + (f,), 0.1),
                u_prev=normal(shape, 0.5, 0.8), s_prev=spikes(shape),
                gu=normal(shape), gs=normal(shape),
                gp=normal(pshape) if pooled else None)


def _epilogue_both(op, reset, window, slope=25.0, drop=()):
    """(fused, plain) outputs and cotangents of one step; ``drop`` names
    cotangents that did not flow (None)."""
    kw = dict(beta=0.95, threshold=1.0, reset_mechanism=reset)
    fwd = epilogue_kernel.conv_epilogue_fwd_cuda(
        op["cur"], op["bias"], op["u_prev"], op["s_prev"], window=window,
        **kw)
    plain = ref.conv_lif_ref(op["cur"], op["bias"], op["u_prev"],
                             op["s_prev"], window=window, **kw)
    u, first = fwd[0], fwd[3]
    cots = {k: None if k in drop else op[k] for k in ("gu", "gs", "gp")}
    if window is None:
        cots["gp"] = None
    bwd = epilogue_kernel.conv_epilogue_bwd_cuda(
        cots["gu"], cots["gs"], cots["gp"], first, u, op["u_prev"],
        op["s_prev"], (True, True, True, True), slope=slope, window=window,
        **kw)
    plain_bwd = ref.conv_lif_bwd_ref(
        cots["gu"], cots["gs"], cots["gp"], first, u, op["u_prev"],
        op["s_prev"], slope=slope, window=window, **kw)
    return fwd, plain, bwd, plain_bwd


@pytest.mark.cuda
@pytest.mark.parametrize("window", [2, None], ids=["pool2", "nopool"])
@pytest.mark.parametrize("reset", ["subtract", "zero"])
@pytest.mark.parametrize("shape", EPILOGUE_SHAPES)
def test_cuda_conv_epilogue_equals_plain(cuda, shape, reset, window):
    op = _epilogue_operands(cuda, shape, 50)
    before = ops.launch_counts()["conv_epilogue"]
    fwd, plain, bwd, plain_bwd = _epilogue_both(op, reset, window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["conv_epilogue"] == before + 2
    for name, got, want in zip(("u", "s", "pooled", "first"), fwd, plain):
        assert (got is None) == (want is None), name
        if got is not None:
            assert got.dtype == want.dtype and torch.equal(got, want), name
    assert 0.05 < fwd[1].mean().item() < 0.95
    d_cur, d_b, d_u_prev, d_s_prev = bwd
    for name, got, want in zip(("d_cur", "d_u_prev", "d_s_prev"),
                               (d_cur, d_u_prev, d_s_prev), plain_bwd):
        assert torch.equal(got, want), name
    # fp32 summation order: within a few roundings of the sum of |g|
    g = plain_bwd[0]
    gap = (d_b - g.sum_to_size(d_b.shape)).abs()
    assert (gap <= 1e-5 * g.abs().sum_to_size(d_b.shape)).all()
    again = _epilogue_both(op, reset, window)[2]
    assert all(torch.equal(a, b) for a, b in zip(bwd, again))


@pytest.mark.cuda
@pytest.mark.parametrize("drop", [("gu",), ("gs",), ("gp",), ("gu", "gs")])
def test_cuda_conv_epilogue_missing_cotangents(cuda, drop):
    """Where a cotangent did not flow (the last step's u, the pool's only
    reader), the kernel takes none and still equals the plain version."""
    op = _epilogue_operands(cuda, (2, 33, 33, 32), 51)
    _, _, bwd, plain_bwd = _epilogue_both(op, "subtract", 2, drop=drop)
    for got, want in zip((bwd[0], bwd[2], bwd[3]), plain_bwd):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 64, 64, 32), (2, 33, 31, 5)])
def test_cuda_conv_epilogue_bias_grad_exact_on_grid(cuda, shape):
    """slope 0 makes the surrogate 1: g is on the 1/256 grid, every partial
    sum is exact, and the bias gradient equals ``sum_to_size``'s."""
    op = _epilogue_operands(cuda, shape, 52, grid=True)
    _, _, bwd, plain_bwd = _epilogue_both(op, "subtract", 2, slope=0.0)
    d_b = bwd[1]
    assert torch.equal(d_b, plain_bwd[0].sum_to_size(d_b.shape))


@pytest.mark.cuda
def test_cuda_conv_epilogue_no_grad(cuda):
    """Under no_grad the step saves nothing, writes no first maxima, and
    equals the plain version."""
    op = _epilogue_operands(cuda, (2, 33, 33, 32), 53)
    args = [op[k] for k in ("cur", "bias", "u_prev", "s_prev")]
    kw = dict(beta=0.95, threshold=1.0)
    fwd = epilogue_kernel.conv_epilogue_fwd_cuda(*args, window=2,
                                                 save_first=False, **kw)
    assert fwd[3] is None
    with torch.no_grad():
        got = ops.conv_lif_step(*(a.requires_grad_() for a in args),
                                pool_window=2, **kw)
    want = ref.conv_lif_ref(*args, window=2, first=False, **kw)
    assert all(g.grad_fn is None for g in got)
    for g, w, f in zip(got, want, fwd):
        assert torch.equal(g, w) and torch.equal(g, f)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 33, 33, 32), (3, 16, 16, 8),
                                   (2, 9, 11, 5)])
def test_cuda_conv_epilogue_slab_equals_solo(cuda, shape):
    """A 3-cell slab through the autograd Function, cell by cell against
    the solo step bit for bit, the bias gradient included; one counted
    launch each way for the slab."""
    op = _epilogue_operands(cuda, (3,) + shape, 54)
    names = ("cur", "bias", "u_prev", "s_prev")
    kw = dict(beta=0.95, threshold=1.0, pool_window=2)

    def step(c=None):
        leaves = [(op[k] if c is None else op[k][c]).clone()
                  .requires_grad_() for k in names]
        outs = ops.conv_lif_step(*leaves, **kw)
        cots = [op[k] if c is None else op[k][c] for k in ("gu", "gs", "gp")]
        grads = torch.autograd.grad(outs, leaves, cots)
        return [t.detach() for t in (*outs, *grads)]

    before = ops.launch_counts()["conv_epilogue"]
    slab = step()
    torch.cuda.synchronize()
    assert ops.launch_counts()["conv_epilogue"] == before + 2
    for c in range(3):
        for a, b in zip(slab, step(c)):
            assert torch.equal(a[c], b)


@pytest.mark.cuda
def test_cuda_conv_epilogue_refuses_what_it_cannot_take(cuda):
    op = _epilogue_operands(cuda, (2, 8, 8, 4), 55)
    args = [op[k] for k in ("cur", "bias", "u_prev", "s_prev")]
    kw = dict(beta=0.95, threshold=1.0)
    with pytest.raises(ValueError, match="windows"):
        epilogue_kernel.conv_epilogue_fwd_cuda(*args, window=17, **kw)
    with pytest.raises(ValueError, match="shape"):
        epilogue_kernel.conv_epilogue_fwd_cuda(args[0], args[1][:2],
                                               *args[2:], **kw)
    with pytest.raises(TypeError, match="dtype"):
        epilogue_kernel.conv_epilogue_fwd_cuda(args[0].double(), *args[1:],
                                               **kw)
    with pytest.raises(ValueError, match="CUDA"):
        epilogue_kernel.conv_epilogue_fwd_cuda(*(a.cpu() for a in args),
                                               **kw)


def _unfused_conv_step(spec, p, s_in, state, pool_window):
    """``snn._conv_step`` with the unfused chain (bias add, lif_step,
    OR-pool) after the same conv kernel."""
    from repro_torch.core import lif, snn
    cur = ops.spike_conv_train(s_in, p["w"], stride=spec.stride,
                               padding=spec.padding)
    u, s = lif.lif_step(state[0], state[1], snn._add_bias(cur, p["b"], None),
                        spec.lif)
    return u, s, snn._or_pool(s, pool_window) if pool_window else s


@pytest.mark.cuda
def test_cuda_net5_shaped_step_equals_the_unfused_chain(cuda, monkeypatch):
    """A net-5-shaped net (Conv32-P2-Conv32-P2-Dense-Dense) trained one
    step on the default backend: its loss and every gradient equal those
    of the step with the unfused epilogue, the conv biases' to fp32
    summation order and every other leaf bit for bit."""
    from repro_torch.core import snn, train_snn
    cfg = snn.SNNConfig("net-5-small", (32, 32, 2),
                        (snn.Conv(32, 3), snn.MaxPool(2), snn.Conv(32, 3),
                         snn.MaxPool(2), snn.Dense(64), snn.Dense(11)),
                        num_classes=11, num_steps=6)
    gen = torch.Generator().manual_seed(56)
    params = snn.init_params(gen, cfg, device=cuda)
    for q, gain in zip(params, (5.0, 0, 3.0, 0, 2.0, 2.0)):
        if q:
            q["w"] = q["w"] * gain
            q["b"] = torch.randn(q["b"].shape, generator=gen).to(cuda) * 0.1
    x = (torch.rand((4, 6, 32, 32, 2), generator=gen) < 0.2).float().to(cuda)
    y = torch.arange(4).to(cuda)
    enc = torch.Generator(device=cuda)
    runs = []
    for unfused in (False, True):
        if unfused:
            monkeypatch.setattr(snn, "_conv_step", _unfused_conv_step)
        leaves = [{k: v.clone().requires_grad_() for k, v in q.items()}
                  for q in params]
        ops.reset_launch_counts()
        loss = train_snn.loss_fn(cfg, leaves, enc, x, y,
                                 matmul_backend="spike_gemm_fused")
        grads = torch.autograd.grad(loss, [v for q in leaves
                                           for v in q.values()])
        torch.cuda.synchronize()
        runs.append((loss, grads, ops.launch_counts()["conv_epilogue"]))
    (l0, g0, n0), (l1, g1, n1) = runs
    assert (n0, n1) == (4 * cfg.num_steps, 0)
    assert torch.equal(l0, l1)
    keys = [(i, k) for i, q in enumerate(params) for k in q]
    for (i, k), a, b in zip(keys, g0, g1):
        assert a.abs().sum() > 0, (i, k)
        if k == "b" and isinstance(cfg.layers[i], snn.Conv):
            torch.testing.assert_close(a, b, rtol=1e-5,
                                       atol=1e-5 * a.abs().max().item())
        else:
            assert torch.equal(a, b), (i, k)


# ---------------------------------------------------------------------------
# The train step as one CUDA graph (core/step_graph.py)
# ---------------------------------------------------------------------------

def _net5_layers(num_steps):
    from repro_torch.core import snn
    return snn.SNNConfig(
        "net-5", (128, 128, 2),
        (snn.Conv(32, 3), snn.MaxPool(2), snn.Conv(32, 3), snn.MaxPool(2),
         snn.Dense(512), snn.Dense(256), snn.Dense(11)),
        num_classes=11, num_steps=num_steps)


def _step_batch(cfg, cuda, seed, batch, rate, cells=None):
    """(x, y) on the card: events (B, T, H, W, C) at about 2%, or
    intensities (B, H, W, C) below 0.2 for a rate code; with ``cells``,
    a slab's (C, B, ...)."""
    gen = torch.Generator().manual_seed(seed)
    lead = (cells,) if cells else ()
    if rate:
        x = torch.rand(lead + (batch,) + cfg.input_shape, generator=gen) / 5
    else:
        x = (torch.rand(lead + (batch, cfg.num_steps) + cfg.input_shape,
                        generator=gen) < 0.02).float()
    y = torch.randint(0, cfg.num_classes, lead + (batch,), generator=gen)
    return x.to(cuda), y.to(cuda)


def _tree_leaves(tree):
    from torch.utils import _pytree as pytree
    return pytree.tree_leaves(tree)


def _same(a, b):
    la, lb = _tree_leaves(a), _tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(u, v)
                                      for u, v in zip(la, lb))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["events", "rate", "slab"])
@pytest.mark.parametrize("backend", ["spike_gemm", "spike_gemm_fused"])
def test_cuda_graphed_step_equals_the_eager_step(cuda, backend, kind):
    """net-5's layers at T = 6: a warm-up and 5 replayed steps equal 6
    eager steps bit for bit (losses, params, Adam's moments, the
    generators' states); what call k returned is unchanged after call
    k + 1; a replayed step counts the launches an eager step does."""
    from repro_torch import optim
    from repro_torch.core import train_snn
    cfg = _net5_layers(6)
    tx = optim.adam(2e-3)
    cells = 3 if kind == "slab" else None
    rate = kind == "rate"
    if cells:
        step = train_snn.make_stacked_train_step(cfg, tx, backend)
        inits = [train_snn.init_cell(cfg, tx, s, device=cuda)
                 for s in range(cells)]
        params = [{k: torch.stack([i[0][n][k] for i in inits]) for k in p}
                  for n, p in enumerate(inits[0][0])]
        opt_state = tx.init(params)
        gen = [i[2] for i in inits]
        eager_gen = [torch.Generator(device=cuda).manual_seed(s)
                     for s in range(cells)]
        gens = (gen, eager_gen)
    else:
        step = train_snn.make_train_step(cfg, tx, backend)
        params, opt_state, gen = train_snn.init_cell(cfg, tx, 4, device=cuda)
        eager_gen = torch.Generator(device=cuda).manual_seed(4)
        gens = ([gen], [eager_gen])
    eager_fn = step.graphs.fn
    eager = (params, opt_state)
    returned = []
    for k in range(6):
        x, y = _step_batch(cfg, cuda, 60 + k, 4 if not cells else 2, rate,
                           cells)
        ops.reset_launch_counts()
        params, opt_state, loss = step(params, opt_state, gen, x, y)
        torch.cuda.synchronize()
        graphed_launches = ops.launch_counts()
        ops.reset_launch_counts()
        *eager, eager_loss = eager_fn(*eager, eager_gen, x, y)
        torch.cuda.synchronize()
        assert graphed_launches == ops.launch_counts(), k
        assert sum(graphed_launches.values()) > 0
        assert torch.equal(loss, eager_loss), k
        assert _same((params, opt_state), tuple(eager)), k
        for old, kept in returned:
            assert _same(old, kept), k
        out = (params, opt_state, loss)
        returned.append((out, [t.clone() for t in _tree_leaves(out)]))
    for g, e in zip(*gens):
        assert torch.equal(g.get_state(), e.get_state())
    assert [g is not None for g in step.graphs.graphs.values()] == [True]


@pytest.mark.cuda
def test_cuda_a_new_batch_shape_makes_a_new_graph(cuda):
    """B = 4, then B = 2, then B = 4 again: each shape warms up eagerly,
    is captured at its second call and replayed after, every step equal
    to the eager one."""
    from repro_torch import optim
    from repro_torch.core import train_snn
    cfg = _net5_layers(4)
    tx = optim.adam(2e-3)
    step = train_snn.make_train_step(cfg, tx, "spike_gemm_fused")
    params, opt_state, gen = train_snn.init_cell(cfg, tx, 9, device=cuda)
    eager = (params, opt_state)
    eager_gen = torch.Generator(device=cuda).manual_seed(9)
    made = []
    for k, batch in enumerate((4, 4, 4, 2, 2, 2, 4)):
        x, y = _step_batch(cfg, cuda, 80 + k, batch, rate=True)
        params, opt_state, loss = step(params, opt_state, gen, x, y)
        *eager, eager_loss = step.graphs.fn(*eager, eager_gen, x, y)
        assert torch.equal(loss, eager_loss), k
        assert _same((params, opt_state), tuple(eager)), k
        made.append(sum(g is not None for g in step.graphs.graphs.values()))
    assert made == [0, 1, 1, 1, 2, 2, 2]


def _profiled_kernels(step):
    """The device kernels one call of ``step`` launches, by name, as the
    profiler lists them; copies and fills of memory left out (a replay
    lists its in-graph copies as kernels, and copies its inputs in and
    its outputs out).  The profiler can miss the first kernels launched
    after it starts, so spin kernels run first, their trace left out."""
    import time
    from collections import Counter
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(32):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.05)
        step()
        torch.cuda.synchronize()
    return Counter(e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "spin_kernel" not in e.name
                   and not e.name.lower().startswith(("memcpy", "memset")))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["solo", "slab"])
def test_cuda_a_replay_launches_the_eager_steps_kernels(cuda, kind):
    """As the profiler sees them, not as the counters add up: a replayed
    step runs every kernel of the eager step, and no other."""
    from repro_torch import optim
    from repro_torch.core import train_snn
    cfg = _net5_layers(4)
    tx = optim.adam(2e-3)
    cells = 3 if kind == "slab" else None
    if cells:
        step = train_snn.make_stacked_train_step(cfg, tx, "spike_gemm_fused")
        inits = [train_snn.init_cell(cfg, tx, s, device=cuda)
                 for s in range(cells)]
        params = [{k: torch.stack([i[0][n][k] for i in inits]) for k in p}
                  for n, p in enumerate(inits[0][0])]
        opt_state = tx.init(params)
        gen = [i[2] for i in inits]
    else:
        step = train_snn.make_train_step(cfg, tx, "spike_gemm_fused")
        params, opt_state, gen = train_snn.init_cell(cfg, tx, 5, device=cuda)
    x, y = _step_batch(cfg, cuda, 90, 2, False, cells)

    def call():
        step(params, opt_state, gen, x, y)

    eager = _profiled_kernels(call)               # the warm-up
    call()                                        # the capture
    replay = _profiled_kernels(call)
    assert [g is not None for g in step.graphs.graphs.values()] == [True]
    assert sum(eager.values()) > 0
    assert replay == eager
