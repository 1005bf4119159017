"""The training leg of the port against the JAX package, on the CPU: the
block-skip backward's plain versions, the three autograd Functions, the
OR-pool gradient, the train step, and Adam.

Inputs are NumPy arrays made from seeds and handed to both packages; the
JAX kernels run in interpret mode, as the JAX package's own tests run them.
Exactness is asked for where every sum is exact: spikes, weights on a 2^-8
grid, cotangents on a coarse grid, and ``beta = 0.5``.  Elsewhere the
tolerances are stated with their reason; the main one is that XLA on the
CPU contracts multiply-adds into FMAs under ``jit`` (the LIF update, the
surrogate, Adam's moments) and PyTorch rounds them separately (ROADMAP §3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.core import lif as jlif
from repro.core import snn as jsnn
from repro.core import train_snn as jtrain
from repro.kernels import ops as jops
from repro.kernels import spike_conv as jconv
from repro_torch import convert, optim
from repro_torch.core import lif, snn, train_snn
from repro_torch.kernels import ops

torch.set_num_threads(2)

GRID = 2.0 ** -8
T = 6
BATCH = 4
BLOCKS = dict(block_m=32, block_n=32, block_k=32)


def _spikes(rng, shape, density):
    return (rng.random(shape) < density).astype(np.float32)


def _grid(rng, shape, scale=0.5, step=GRID):
    return (np.round(rng.normal(scale=scale, size=shape) / step)
            * step).astype(np.float32)


def _cotangent(rng, shape, density=0.6):
    """Signed values on a 1/16 grid with exact zeros."""
    return _grid(rng, shape, 1.0, 1 / 16) * _spikes(rng, shape, density)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return jnp.asarray(x)


class TestPlainBackward:
    @pytest.mark.parametrize("m,k,n", [(70, 100, 9), (33, 40, 130)])
    @pytest.mark.parametrize("density", [0.0, 0.05, 0.5])
    def test_exact_on_grid_operands(self, m, k, n, density):
        rng = np.random.default_rng(m + n)
        s, g = _spikes(rng, (m, k), density), _cotangent(rng, (m, n))
        w = _grid(rng, (k, n))
        np.testing.assert_array_equal(
            ops.spike_gemm_bwd_dw(_t(s), _t(g)).numpy(),
            np.asarray(jops.spike_gemm_bwd_dw(_j(s), _j(g), **BLOCKS)))
        np.testing.assert_array_equal(
            ops.spike_gemm_bwd_ds(_t(g), _t(w)).numpy(),
            np.asarray(jops.spike_gemm_bwd_ds(_j(g), _j(w), **BLOCKS)))
        np.testing.assert_array_equal(
            ops.cotangent_block_flags(_t(g)).numpy(),
            np.asarray(jops.cotangent_block_flags(_j(g), block_m=32,
                                                  block_n=32)))

    def test_normal_operands_within_rtol(self):
        """Normal operands: the sums are taken in another order, so the
        stated tolerance is 1e-6 of the largest sum of |terms|."""
        rng = np.random.default_rng(3)
        s = _spikes(rng, (90, 70), 0.3)
        g = rng.normal(size=(90, 20)).astype(np.float32)
        w = rng.normal(size=(70, 20)).astype(np.float32)
        dw = ops.spike_gemm_bwd_dw(_t(s), _t(g)).numpy()
        ds = ops.spike_gemm_bwd_ds(_t(g), _t(w)).numpy()
        want_dw = np.asarray(jops.spike_gemm_bwd_dw(_j(s), _j(g), **BLOCKS))
        want_ds = np.asarray(jops.spike_gemm_bwd_ds(_j(g), _j(w), **BLOCKS))
        np.testing.assert_allclose(dw, want_dw, rtol=1e-6,
                                   atol=1e-6 * (s.T @ np.abs(g)).max())
        np.testing.assert_allclose(ds, want_ds, rtol=1e-6,
                                   atol=1e-6 * (np.abs(g) @ np.abs(w).T).max())

    def test_cancelling_tile_is_not_skipped(self):
        g = np.zeros((40, 64), np.float32)
        g[3, 5], g[7, 9] = 0.75, -0.75              # the tile sums to zero
        flags = ops.cotangent_block_flags(_t(g)).numpy()
        assert flags.tolist() == [[1, 0], [0, 0]]
        w = np.ones((6, 64), np.float32)
        w[:, 9] = 2.0
        ds = ops.spike_gemm_bwd_ds(_t(g), _t(w)).numpy()
        np.testing.assert_array_equal(ds[3], np.full(6, 0.75, np.float32))
        np.testing.assert_array_equal(ds[7], np.full(6, -1.5, np.float32))

    def test_flags_must_match_the_tile_grid(self):
        s, g = torch.ones(40, 64), torch.ones(40, 8)
        with pytest.raises(ValueError, match="tile grid"):
            ops.spike_gemm_bwd_dw(s, g, flags=torch.ones(1, 1,
                                                         dtype=torch.int32))
        with pytest.raises(ValueError, match="tile grid"):
            ops.spike_gemm_bwd_ds(g, torch.ones(64, 8),
                                  gflags=torch.ones(1, 2, dtype=torch.int32))


class TestPlainConvDw:
    """The conv layer's dW, which the card computes from the input spikes
    (``ops.spike_conv_bwd_dw``), against the JAX package's: the matrix dW
    over its patch matrix."""

    @pytest.mark.parametrize("stride", [1, 2])
    @pytest.mark.parametrize("padding", ["SAME", "VALID"])
    @pytest.mark.parametrize("kernel", [2, 3])
    @pytest.mark.parametrize("cin", [3, 33])
    @pytest.mark.parametrize("cout", [5, 33])
    def test_exact_on_grid_operands(self, stride, padding, kernel, cin,
                                    cout):
        rng = np.random.default_rng(kernel * 100 + cin + cout + stride)
        x = _spikes(rng, (2, 9, 8, cin), 0.3)
        oh = jconv.conv_out_size(9, kernel, stride, padding)[0]
        ow = jconv.conv_out_size(8, kernel, stride, padding)[0]
        g = _cotangent(rng, (2, oh, ow, cout))
        got = ops.spike_conv_bwd_dw(_t(x), _t(g), kernel_size=(kernel, kernel),
                                    stride=stride, padding=padding)
        patches = jconv.conv_patches(_j(x), kernel, kernel, stride, padding)
        want = jops.spike_gemm_bwd_dw(patches, _j(g).reshape(-1, cout),
                                      **BLOCKS)
        assert got.shape == (kernel, kernel, cin, cout)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(want).reshape(got.shape))

    @pytest.mark.parametrize("shape,kernel,stride,padding", [
        ((3, 17, 15, 33), 3, 2, "SAME"), ((5, 16, 16, 8), 3, 1, "SAME"),
        ((2, 9, 7, 3), 2, 2, "VALID")])
    def test_split_order_equals_jax_on_grid(self, shape, kernel, stride,
                                            padding):
        """The card's association, emulated: each split adds its tiles'
        pixels one at a time in fp32 (tiles of ``conv_tile``, splits of
        ``conv_dw_plan``), and the splits are added in order.  On grid
        operands it equals JAX's dW bit for bit, and it covers every output
        pixel once."""
        from repro_torch.kernels import spike_conv, spike_gemm_bwd
        rng = np.random.default_rng(11)
        cout = 6
        x = _spikes(rng, shape, 0.3)
        geo = spike_conv.conv_geometry(shape, (kernel, kernel, shape[-1],
                                               cout), stride, padding,
                                       dw=True)
        b, oh, ow, tr, tw = geo[0], geo[4], geo[5], geo[12], geo[13]
        g = _cotangent(rng, (b, oh, ow, cout))
        patches = np.asarray(jconv.conv_patches(_j(x), kernel, kernel,
                                                stride, padding))
        tiles = [[(bi * oh + t0 + r) * ow + u0 + c for r in range(tr)
                  for c in range(tw) if t0 + r < oh and u0 + c < ow]
                 for bi in range(b) for t0 in range(0, oh, tr)
                 for u0 in range(0, ow, tw)]
        items = kernel * kernel * -(-shape[-1] // 32)
        warps, splits, per = spike_gemm_bwd.conv_dw_plan(len(tiles), items,
                                                         geo[-1])
        assert (splits - 1) * per < len(tiles) <= splits * per
        assert warps == min(max(4, items), 16)
        total, seen = None, []
        for z in range(splits):
            rows = [p for tile in tiles[z * per:(z + 1) * per] for p in tile]
            seen += rows
            terms = patches[rows, :, None] * g.reshape(-1, cout)[rows, None]
            part = np.cumsum(terms, axis=0, dtype=np.float32)[-1]
            total = part if total is None else total + part
        assert sorted(seen) == list(range(b * oh * ow))
        want = jops.spike_gemm_bwd_dw(_j(patches), _j(g).reshape(-1, cout),
                                      **BLOCKS)
        np.testing.assert_array_equal(total, np.asarray(want))


def _grads_of(fn, args, cots, wrt):
    """Outputs of ``fn(*args)`` and the gradients of ``<outs, cots>`` with
    respect to ``args[i]`` for i in ``wrt``, through torch autograd."""
    targs = [_t(a).requires_grad_(i in wrt) if isinstance(a, np.ndarray)
             else a for i, a in enumerate(args)]
    outs = fn(*targs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(outs, [targs[i] for i in wrt],
                                [_t(c) for c in cots])
    return [o.detach().numpy() for o in outs], [g.numpy() for g in grads]


def _assert_equal_all(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


class TestAutogradFunctionsAgainstJaxVjp:
    """Each Function's forward and backward against ``jax.vjp`` of the JAX
    package's custom_vjp, called eagerly (no ``jit``, so no FMA), on grid
    operands: equal bit for bit."""

    @pytest.mark.parametrize("m,k,n", [(9, 70, 13), (40, 33, 64)])
    def test_spike_gemm_train(self, m, k, n):
        rng = np.random.default_rng(k)
        s, w = _spikes(rng, (m, k), 0.3), _grid(rng, (k, n))
        g = _cotangent(rng, (m, n))
        outs, grads = _grads_of(ops.spike_gemm_train, [s, w], [g], (0, 1))
        jout, vjp = jax.vjp(lambda a, b: jops.spike_gemm_train(a, b), _j(s),
                            _j(w))
        _assert_equal_all(outs + grads, [jout, *vjp(_j(g))])

    @pytest.mark.parametrize("stride", [1, 2])
    @pytest.mark.parametrize("padding", ["SAME", "VALID"])
    def test_spike_conv_train(self, stride, padding):
        rng = np.random.default_rng(stride)
        x, w = _spikes(rng, (2, 9, 7, 3), 0.3), _grid(rng, (3, 3, 3, 5))
        jf = lambda a, b: jops.spike_conv_train(a, b, stride=stride,
                                                padding=padding)
        jout, vjp = jax.vjp(jf, _j(x), _j(w))
        g = _cotangent(rng, jout.shape)
        outs, grads = _grads_of(
            lambda a, b: ops.spike_conv_train(a, b, stride=stride,
                                              padding=padding),
            [x, w], [g], (0, 1))
        _assert_equal_all(outs + grads, [jout, *vjp(_j(g))])

    def test_spike_conv_train_input_needs_no_grad(self):
        """A net's first layer: only dW, and no dS launch."""
        rng = np.random.default_rng(5)
        x, w = _spikes(rng, (2, 8, 8, 2), 0.3), _grid(rng, (3, 3, 2, 4))
        g = _cotangent(rng, (2, 8, 8, 4))
        _, (dw,) = _grads_of(ops.spike_conv_train, [x, w], [g], (1,))
        _, vjp = jax.vjp(jops.spike_conv_train, _j(x), _j(w))
        np.testing.assert_array_equal(dw, np.asarray(vjp(_j(g))[1]))

    def test_spike_conv_train_forward_is_spike_conv(self):
        """One forward: the Function's output is ``spike_conv``'s, bit for
        bit, on normal weights too."""
        rng = np.random.default_rng(6)
        x = _t(_spikes(rng, (2, 9, 9, 3), 0.3))
        w = _t(rng.standard_normal((3, 3, 3, 4)).astype(np.float32))
        for stride in (1, 2):
            torch.testing.assert_close(
                ops.spike_conv_train(x, w, stride=stride),
                ops.spike_conv(x, w, stride=stride), rtol=0, atol=0)

    @pytest.mark.parametrize("reset", ["subtract", "zero"])
    @pytest.mark.parametrize("through_spikes", [False, True])
    def test_spike_gemm_lif_step(self, reset, through_spikes):
        """Without a cotangent on the spikes, ``g = gu`` is on the grid and
        everything is equal bit for bit.  With one, ``g = gu + gs*surr``
        carries the surrogate, which is not on the grid, so the three sums
        over ``g`` (dW, dS, d_bias) are taken in another order by each
        package: those to 1e-6 of their largest sum of |terms|, the
        elementwise outputs and cotangents still bit for bit."""
        rng = np.random.default_rng(7)
        m, k, n = 10, 50, 12
        args = [_spikes(rng, (m, k), 0.3), _grid(rng, (k, n)),
                _grid(rng, (n,), 0.2), _grid(rng, (m, n), 1.0),
                _spikes(rng, (m, n), 0.3)]
        cots = [_cotangent(rng, (m, n)), _cotangent(rng, (m, n))]
        if not through_spikes:
            cots[1][:] = 0.0
        kw = dict(beta=0.5, threshold=1.0, slope=25.0,
                  reset_mechanism=reset)
        outs, grads = _grads_of(lambda *a: ops.spike_gemm_lif_step(*a, **kw),
                                args, cots, range(5))
        jout, vjp = jax.vjp(lambda *a: jops.spike_gemm_lif_step(*a, **kw),
                            *map(_j, args))
        jgrads = [np.asarray(v) for v in vjp(tuple(map(_j, cots)))]
        assert outs[1].sum() > 0 and (outs[1] == 0).any()
        _assert_equal_all(outs + grads[3:], [*jout, *jgrads[3:]])
        if not through_spikes:
            _assert_equal_all(grads[:3], jgrads[:3])
            return
        g = np.abs(cots[0]) + np.abs(cots[1])
        scales = [(g @ np.abs(args[1]).T).max(), (args[0].T @ g).max(),
                  g.sum(0).max()]
        for got, want, scale in zip(grads[:3], jgrads[:3], scales):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)

    def test_fused_backward_matches_the_unfused_step(self):
        """The fused Function's backward equals autograd through
        ``spike_gemm_train + b`` and ``lif.lif_step`` (default beta)."""
        rng = np.random.default_rng(8)
        m, k, n = 6, 40, 10
        args = [_spikes(rng, (m, k), 0.3), _grid(rng, (k, n)),
                _grid(rng, (n,), 0.2), _grid(rng, (m, n), 1.0),
                _spikes(rng, (m, n), 0.3)]
        cots = [_cotangent(rng, (m, n)), _cotangent(rng, (m, n))]
        p = lif.LIFParams()

        def unfused(s, w, b, u0, s0):
            return lif.lif_step(u0, s0, ops.spike_gemm_train(s, w) + b, p)

        fused = _grads_of(lambda *a: ops.spike_gemm_lif_step(
            *a, beta=p.beta, threshold=p.threshold, slope=p.slope), args,
            cots, range(5))
        plain = _grads_of(unfused, args, cots, range(5))
        _assert_equal_all(fused[0] + fused[1], plain[0] + plain[1])


class TestOrPoolGradient:
    @pytest.mark.parametrize("h,w", [(8, 8), (9, 7)])
    def test_gradient_goes_to_the_first_maximum_as_in_jax(self, h, w):
        rng = np.random.default_rng(h * w)
        s = _spikes(rng, (2, h, w, 3), 0.4)
        s[0, :4, :4] = 0.0                     # all-zero windows: all tied
        s[1, :2, :2] = 1.0                     # a window of four spikes
        g = rng.normal(size=(2, h // 2, w // 2, 3)).astype(np.float32)
        x = _t(s).requires_grad_()
        (snn._or_pool(x, 2) * _t(g)).sum().backward()
        want = jax.grad(lambda a: (jsnn._or_pool(a, 2) * g).sum())(_j(s))
        np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
        # the whole cotangent of a tied window lands on its first element
        np.testing.assert_array_equal(x.grad.numpy()[0, 0, 0], g[0, 0, 0])
        assert float(x.grad[0, 0:2, 0:2].abs().sum()) == float(
            np.abs(g[0, 0, 0]).sum())


def _configs(kind, beta):
    """The same small topology as a JAX and a port ``SNNConfig``."""
    cfgs = []
    for mod, lp in ((jsnn, jlif.LIFParams), (snn, lif.LIFParams)):
        p = lp(beta=beta)
        if kind == "mlp":
            layers = (mod.Dense(24, p), mod.Dense(16, p), mod.Dense(8, p))
            cfgs.append(mod.SNNConfig("mlp", (30,), layers, num_classes=4,
                                      pcr=2, num_steps=T))
        else:       # the dvs-conv topology of the registry, narrower
            layers = (mod.Conv(4, 3, lif=p), mod.MaxPool(2),
                      mod.Conv(8, 3, lif=p), mod.MaxPool(2),
                      mod.Dense(16, p), mod.Dense(8, p))
            cfgs.append(mod.SNNConfig("dvs-conv", (16, 16, 2), layers,
                                      num_classes=4, pcr=2, num_steps=T))
    return cfgs


def _case(kind, beta, seed=0):
    """Configs, grid params (NumPy) and one batch.  The rate MLP gets
    binary images: rate coding then draws no random bits that matter
    (u < 0 never holds, u < 1 always does), so both packages encode the
    same train; the conv net gets pre-encoded events."""
    jcfg, tcfg = _configs(kind, beta)
    rng = np.random.default_rng(seed)
    npp = []
    for p in jsnn.init_params(jax.random.key(seed), jcfg):
        npp.append({k: (np.round((np.asarray(v) * 2.5 + 0.05 * (k == "b"))
                                 / GRID) * GRID).astype(np.float32)
                    for k, v in p.items()})
    shape = (BATCH, 30) if kind == "mlp" else (BATCH, T, 16, 16, 2)
    x = _spikes(rng, shape, 0.3 if kind == "mlp" else 0.2)
    y = rng.integers(0, 4, size=BATCH).astype(np.int32)
    return jcfg, tcfg, npp, x, y


def _jax_params(npp):
    return [{k: _j(v) for k, v in p.items()} for p in npp]


def _close_to_max(got, want, rtol):
    """Each leaf within ``rtol`` of the leaf's max |value|."""
    for g, w in zip(got, want):
        for key in w:
            a, b = np.asarray(g[key]), np.asarray(w[key])
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=rtol * max(np.abs(b).max(), 1e-30),
                                       err_msg=key)


JAX_BACKEND = {"torch": "jnp", "spike_gemm": "spike_gemm",
               "spike_gemm_fused": "spike_gemm_fused"}


@pytest.mark.parametrize("kind", ["mlp", "dvs-conv"])
@pytest.mark.parametrize("backend", snn.MATMUL_BACKENDS)
def test_train_step_matches_jitted_jax(kind, backend):
    """One ``make_train_step`` from the same grid params and batch against
    JAX's jitted one on the same backend: the loss to rtol 1e-6, the
    gradients and the new parameters to 1e-5 of each leaf's max |value|.
    ``beta = 0.5`` keeps the forward exact; what is left is the surrogate
    and Adam under ``jit`` (FMA contraction)."""
    jcfg, tcfg, npp, x, y = _case(kind, 0.5)
    jb = JAX_BACKEND[backend]
    key = jax.random.key(1)
    jloss_fn = lambda p: jtrain.loss_fn(jcfg, p, key, _j(x), _j(y),
                                        matmul_backend=jb)
    jl, jgrads = jax.jit(jax.value_and_grad(jloss_fn))(_jax_params(npp))
    jtx = joptim.adam(2e-3)
    jp = _jax_params(npp)
    jnew, _, jl2 = jax.jit(jtrain.make_train_step(jcfg, jtx, jb))(
        jp, jtx.init(jp), key, _j(x), _j(y))
    assert float(jl2) == float(jl)

    tp = convert.params_from_numpy(npp, "cpu")
    gen = torch.Generator().manual_seed(1)
    leaves = [{k: v.clone().requires_grad_() for k, v in p.items()}
              for p in tp]
    loss = train_snn.loss_fn(tcfg, leaves, gen, _t(x), _t(y),
                             matmul_backend=backend)
    flat = [v for p in leaves for v in p.values()]
    it = iter(torch.autograd.grad(loss, flat))
    loss = loss.detach()
    grads = [{k: next(it) for k in p} for p in leaves]
    tx = optim.adam(2e-3)
    new, _, loss2 = train_snn.make_train_step(tcfg, tx, backend)(
        tp, tx.init(tp), gen, _t(x), _t(y))

    assert float(jl) > 0.1                       # the net is not silent
    assert float(loss) == pytest.approx(float(jl), rel=1e-6)
    assert float(loss2) == float(loss)
    _close_to_max([{k: v.numpy() for k, v in p.items()} for p in grads],
                  jgrads, 1e-5)
    _close_to_max(convert.params_to_numpy(new), jnew, 1e-5)


@pytest.mark.parametrize("kind", ["mlp", "dvs-conv"])
def test_three_steps_track_jax_at_default_beta(kind):
    """Three steps of the default backend from the same params against
    JAX's jitted steps, at ``beta = 0.95``: the FMA makes membranes differ
    by an ulp, a spike near threshold can flip, and the trajectories part
    slowly.  Per-step losses agree to 1e-3 relative and the trained nets'
    output spikes on the batch differ in at most 2% of places."""
    jcfg, tcfg, npp, x, y = _case(kind, 0.95, seed=2)
    jtx, tx = joptim.adam(2e-3), optim.adam(2e-3)
    jp = _jax_params(npp)
    jstate = jtx.init(jp)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jtx, "spike_gemm_fused"))
    tp = convert.params_from_numpy(npp, "cpu")
    state = tx.init(tp)
    step = train_snn.make_train_step(tcfg, tx)
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        jp, jstate, jl = jstep(jp, jstate, jax.random.key(i), _j(x), _j(y))
        tp, state, loss = step(tp, state, gen, _t(x), _t(y))
        assert float(loss) == pytest.approx(float(jl), rel=1e-3), i
    assert int(state[0].count) == int(jstate[0].count) == 3
    spikes_in = x.transpose(1, 0, 2, 3, 4) if x.ndim == 5 else \
        np.broadcast_to(x, (T,) + x.shape).copy()
    want = np.asarray(jsnn.apply(jcfg, jp, _j(spikes_in)))
    got = snn.apply(tcfg, tp, _t(spikes_in)).numpy()
    assert want.sum() > 0
    assert (got != want).mean() <= 0.02


def test_apply_writes_are_differentiable():
    """``apply`` writes each step's spikes into a preallocated train; the
    gradient through those writes equals the one through a stacked train."""
    _, tcfg, npp, x, _ = _case("mlp", 0.5)
    spikes_in = _t(np.broadcast_to(x, (T,) + x.shape).copy())
    cot = _t(np.random.default_rng(1).normal(
        size=(T, BATCH, 8)).astype(np.float32))

    def grads(run):
        tp = [{k: v.requires_grad_() for k, v in p.items()}
              for p in convert.params_from_numpy(npp, "cpu")]
        (run(tp) * cot).sum().backward()
        return [p["w"].grad.numpy() for p in tp]

    def stacked(tp):
        states = snn.init_states(tcfg, BATCH, torch.device("cpu"))
        outs = []
        for t in range(T):
            states, spikes = snn.step(tcfg, tp, states, spikes_in[t])
            outs.append(spikes[-1])
        return torch.stack(outs)

    _assert_equal_all(grads(lambda tp: snn.apply(tcfg, tp, spikes_in)),
                      grads(stacked))


class TestAdam:
    def _case(self):
        rng = np.random.default_rng(0)
        params = [{"w": rng.normal(size=(60, 7)).astype(np.float32),
                   "b": rng.normal(size=7).astype(np.float32)}, {}]
        grads = [[{"w": (rng.normal(size=(60, 7)) * 10.0 ** rng.integers(
                       -8, 2, size=(60, 7))).astype(np.float32),
                   "b": rng.normal(size=7).astype(np.float32)}, {}]
                 for _ in range(3)]
        return params, grads

    @pytest.mark.parametrize("jit", [False, True])
    def test_matches_jax_adam(self, jit):
        """Eager JAX: equal bit for bit.  Jitted: XLA contracts the moment
        updates into FMAs, so rtol 1e-6."""
        params, grads = self._case()
        jtx, tx = joptim.adam(2e-3), optim.adam(2e-3)
        jp = _jax_params(params)
        js = jtx.init(jp)

        def jstep(p, s, g):
            upd, s = jtx.update(g, s, p)
            return joptim.apply_updates(p, upd), s

        jstep = jax.jit(jstep) if jit else jstep
        tp = convert.params_from_numpy(params, "cpu")
        ts = tx.init(tp)
        for g in grads:
            jp, js = jstep(jp, js, _jax_params(g))
            upd, ts = tx.update(convert.params_from_numpy(g, "cpu"), ts, tp)
            tp = optim.apply_updates(tp, upd)
            got = convert.params_to_numpy(tp)
            if jit:
                for a, b in zip(got, jp):
                    for k in b:
                        np.testing.assert_allclose(a[k], np.asarray(b[k]),
                                                   rtol=1e-6)
            else:
                _assert_equal_all([a[k] for a, b in zip(got, jp) for k in b],
                                  [b[k] for b in jp for k in b])
        assert int(ts[0].count) == int(ts[1].count) == 3

    def test_state_round_trips_through_numpy(self):
        """Both packages start from the same optimizer state: JAX's state
        as NumPy into the port, one eager step each, equal results."""
        params, grads = self._case()
        jtx, tx = joptim.adam(2e-3), optim.adam(2e-3)
        jp = _jax_params(params)
        js = jtx.init(jp)
        upd, js = jtx.update(_jax_params(grads[0]), js, jp)
        jp = joptim.apply_updates(jp, upd)
        np_state = {"count": np.asarray(js[0].count),
                    "mu": [{k: np.asarray(v) for k, v in p.items()}
                           for p in js[0].mu],
                    "nu": [{k: np.asarray(v) for k, v in p.items()}
                           for p in js[0].nu]}
        ts = convert.adam_state_from_numpy(np_state, "cpu")
        back = convert.adam_state_to_numpy(ts)
        assert int(back["count"]) == 1
        _assert_equal_all([back["mu"][0]["w"], back["nu"][0]["b"]],
                          [np_state["mu"][0]["w"], np_state["nu"][0]["b"]])
        tp = convert.params_from_numpy(
            [{k: np.asarray(v) for k, v in p.items()} for p in jp], "cpu")
        upd, js = jtx.update(_jax_params(grads[1]), js, jp)
        jp = joptim.apply_updates(jp, upd)
        tupd, ts = tx.update(convert.params_from_numpy(grads[1], "cpu"), ts,
                             tp)
        tp = optim.apply_updates(tp, tupd)
        np.testing.assert_array_equal(tp[0]["w"].numpy(),
                                      np.asarray(jp[0]["w"]))
