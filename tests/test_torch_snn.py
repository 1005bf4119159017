"""The port's model layer (repro_torch.core lif, encoding, snn) against the
JAX package's, on the same NumPy inputs and parameters.

Parameters come from ``repro.core.snn.init_params`` and cross with
``repro_torch.convert``.  Two regimes:

* exact: weights on a 2^-8 grid and ``beta = 0.5``, where every membrane
  value is exact in fp32 and the rounding order cannot matter;
* default ``beta = 0.95``: ``snn.apply`` in JAX runs under ``lax.scan``,
  where XLA on the CPU contracts ``beta*u + cur`` into one FMA, while
  PyTorch rounds the product and the sum separately (ROADMAP §3,
  ``test_jit_contracts_the_subtract_reset_update``).  Membranes then agree
  to about 1e-6 relative, and a spike flips only where ``u`` lands within
  an ulp of the threshold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.core import lif as jlif
from repro.core import snn as jsnn
from repro_torch import convert, spans
from repro_torch.core import encoding, lif, snn
from repro_torch.kernels import ops

torch.set_num_threads(2)

GRID = 2.0 ** -8
T = 8
BATCH = 4


def _both(kind, beta):
    """The same topology as a JAX and a port ``SNNConfig``."""
    cfgs = []
    for mod, lp in ((jsnn, jlif.LIFParams), (snn, lif.LIFParams)):
        p = lp(beta=beta)
        if kind == "mlp":
            layers = (mod.Dense(24, p), mod.Dense(16, p), mod.Dense(8, p))
            cfgs.append(mod.SNNConfig("mlp", (30,), layers, num_classes=4,
                                      pcr=2, num_steps=T))
        else:       # the dvs-conv topology of the workload registry
            layers = (mod.Conv(8, 3, lif=p), mod.MaxPool(2),
                      mod.Conv(16, 3, lif=p), mod.MaxPool(2),
                      mod.Dense(64, p), mod.Dense(16, p))
            cfgs.append(mod.SNNConfig("dvs-conv", (32, 32, 2), layers,
                                      num_classes=8, pcr=2, num_steps=T))
    return cfgs


def _np_params(jcfg, gain, grid):
    params = jsnn.init_params(jax.random.key(0), jcfg)
    out = []
    for p in params:
        q = {}
        for k, v in p.items():
            v = np.asarray(v) * gain
            if k == "b":
                v = v + 0.05
            q[k] = (np.round(v / GRID) * GRID if grid else v).astype(
                np.float32)
        out.append(q)
    return out


def _input(kind, seed=0):
    rng = np.random.default_rng(seed)
    shape = (T, BATCH, 30) if kind == "mlp" else (T, BATCH, 32, 32, 2)
    return (rng.random(shape) < 0.2).astype(np.float32)


@pytest.fixture(scope="module", params=["mlp", "dvs-conv"])
def net(request):
    return request.param


class TestLIF:
    @pytest.mark.parametrize("reset", ["subtract", "zero"])
    def test_step_matches_eager_jax(self, reset):
        rng = np.random.default_rng(1)
        u, c = (rng.normal(size=(4, 50)).astype(np.float32)
                for _ in range(2))
        s = (rng.random((4, 50)) < 0.3).astype(np.float32)
        got = lif.lif_step(torch.from_numpy(u), torch.from_numpy(s),
                           torch.from_numpy(c),
                           lif.LIFParams(reset_mechanism=reset))
        want = jlif.lif_step(jnp.asarray(u), jnp.asarray(s), jnp.asarray(c),
                             jlif.LIFParams(reset_mechanism=reset))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_surrogate_gradient_matches_jax(self):
        v = np.linspace(-1, 1, 101).astype(np.float32)
        tv = torch.from_numpy(v).requires_grad_()
        lif.spike_fn(tv, 25.0).sum().backward()
        want = jax.grad(lambda x: jlif.spike_fn(x, 25.0).sum())(
            jnp.asarray(v))
        np.testing.assert_allclose(tv.grad.numpy(), np.asarray(want),
                                   rtol=1e-6)
        np.testing.assert_array_equal(lif.spike_fn(tv.detach()).numpy(),
                                      (v > 0).astype(np.float32))

    def test_unknown_reset_raises(self):
        z = torch.zeros(2)
        with pytest.raises(ValueError, match="reset"):
            lif.lif_step(z, z, z, lif.LIFParams(reset_mechanism="hard"))

    def test_jit_contracts_the_subtract_reset_update(self):
        """The finding behind the default-beta tolerances: jitted XLA on the
        CPU fuses ``0.95*u + c`` into one FMA, so it differs from PyTorch's
        separately rounded update on a share of elements, each time by an
        ulp or so; the zero-reset expression and eager JAX do not differ."""
        rng = np.random.default_rng(0)
        n = 1 << 16
        u, c = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
        s = (rng.random(n) < 0.3).astype(np.float32)
        tu, tc, ts = map(torch.from_numpy, (u, c, s))
        sub = jax.jit(lambda u, c, s: 0.95 * u + c - 1.0 * s)
        zero = jax.jit(lambda u, c, s: 0.95 * u * (1 - s) + c)
        t_sub = (0.95 * tu + tc - 1.0 * ts).numpy()
        j_sub = np.asarray(sub(u, c, s))
        differ = j_sub != t_sub
        assert differ.mean() > 0.05
        np.testing.assert_allclose(j_sub, t_sub, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(zero(u, c, s)),
                                      (0.95 * tu * (1 - ts) + tc).numpy())
        eager = 0.95 * jnp.asarray(u) + jnp.asarray(c) - 1.0 * jnp.asarray(s)
        np.testing.assert_array_equal(np.asarray(eager), t_sub)


class TestEncoding:
    def test_population_pool_and_decode_match_jax_with_ties(self):
        rng = np.random.default_rng(2)
        train = (rng.random((6, 32, 12)) < 0.2).astype(np.float32)
        train[:, :4] = 0.0                         # silent rows: all tied
        got = encoding.population_decode(torch.from_numpy(train), 4)
        want = jenc.population_decode(jnp.asarray(train), 4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got.numpy()[:4] == 0).all()
        np.testing.assert_array_equal(
            encoding.population_pool(torch.from_numpy(train), 4).numpy(),
            np.asarray(jenc.population_pool(jnp.asarray(train), 4)))

    def test_rate_loss_matches_jax(self):
        rng = np.random.default_rng(3)
        train = (rng.random((10, 16, 8)) < 0.3).astype(np.float32)
        y = rng.integers(0, 4, size=16).astype(np.int32)
        got = encoding.rate_loss(torch.from_numpy(train), torch.from_numpy(y),
                                 4)
        want = jenc.rate_loss(jnp.asarray(train), jnp.asarray(y), 4)
        assert float(got) == pytest.approx(float(want), rel=1e-6)

    def test_pool_rejects_uneven_split(self):
        with pytest.raises(ValueError, match="class pools"):
            encoding.population_pool(torch.zeros(2, 10), 4)

    def test_rate_encode_is_bernoulli_and_seeded(self):
        x = torch.linspace(0, 1, 11).repeat(4, 1)
        a = encoding.rate_encode(torch.Generator().manual_seed(0), x, 2000)
        b = encoding.rate_encode(torch.Generator().manual_seed(0), x, 2000)
        assert a.shape == (2000, 4, 11) and torch.equal(a, b)
        assert set(a.unique().tolist()) <= {0.0, 1.0}
        np.testing.assert_allclose(a.mean((0, 1)).numpy(), x[0].numpy(),
                                   atol=0.03)
        assert float(a[..., 0].sum()) == 0 and float(a[..., -1].min()) == 1


class TestTopology:
    def test_shapes_and_sizes_match_jax(self, net):
        jcfg, tcfg = _both(net, 0.95)
        assert snn.output_shapes(tcfg) == jsnn.output_shapes(jcfg)
        assert tcfg.layer_sizes() == jcfg.layer_sizes()
        assert tcfg.output_features == jcfg.output_features

    def test_init_params_structure_matches_jax(self, net):
        jcfg, tcfg = _both(net, 0.95)
        got = snn.init_params(torch.Generator().manual_seed(0), tcfg,
                              device="cpu")
        want = jsnn.init_params(jax.random.key(0), jcfg)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert {k: tuple(v.shape) for k, v in g.items()} == \
                {k: tuple(v.shape) for k, v in w.items()}
            if "w" in g:
                fan_in = int(np.prod(g["w"].shape[:-1]))
                assert float(g["w"].std()) == pytest.approx(
                    fan_in ** -0.5, rel=0.3)

    def test_convert_round_trip(self, net):
        jcfg, _ = _both(net, 0.95)
        npp = _np_params(jcfg, 1.0, grid=False)
        back = convert.params_to_numpy(convert.params_from_numpy(npp, "cpu"))
        for a, b in zip(npp, back):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])

    @pytest.mark.parametrize("h,w", [(8, 8), (9, 7)])
    def test_or_pool_matches_jax_valid_truncation(self, h, w):
        rng = np.random.default_rng(4)
        s = (rng.random((2, h, w, 3)) < 0.3).astype(np.float32)
        np.testing.assert_array_equal(
            snn._or_pool(torch.from_numpy(s), 2).numpy(),
            np.asarray(jsnn._or_pool(jnp.asarray(s), 2)))


class TestBackendResolution:
    def test_default_is_the_fused_kernel(self, monkeypatch):
        monkeypatch.delenv(snn.MATMUL_BACKEND_ENV, raising=False)
        assert snn.resolve_matmul_backend() == "spike_gemm_fused"

    def test_own_env_var_not_the_jax_one(self, monkeypatch):
        monkeypatch.setenv("REPRO_MATMUL_BACKEND", "jnp")
        monkeypatch.setenv(snn.MATMUL_BACKEND_ENV, "torch")
        assert snn.resolve_matmul_backend() == "torch"
        assert snn.resolve_matmul_backend("spike_gemm") == "spike_gemm"
        monkeypatch.delenv(snn.MATMUL_BACKEND_ENV)
        assert snn.resolve_matmul_backend() == "spike_gemm_fused"

    def test_unknown_backend_raises(self):
        with pytest.raises(ValueError, match="unknown matmul backend"):
            snn.resolve_matmul_backend("jnp")


@pytest.fixture(scope="module")
def exact_case(net):
    jcfg, tcfg = _both(net, 0.5)
    npp = _np_params(jcfg, 2.0, grid=True)
    x = _input(net)
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in npp]
    want_out = np.asarray(jsnn.apply(jcfg, jp, jnp.asarray(x),
                                     matmul_backend="jnp"))
    want_counts = [np.asarray(c) for c in jsnn.spike_counts_per_layer(
        jcfg, jp, jnp.asarray(x), matmul_backend="jnp")]
    return tcfg, npp, x, want_out, want_counts


class TestApplyExact:
    @pytest.mark.parametrize("backend", snn.MATMUL_BACKENDS)
    def test_output_and_counts_equal_jax(self, exact_case, backend):
        tcfg, npp, x, want_out, want_counts = exact_case
        tp = convert.params_from_numpy(npp, "cpu")
        out = snn.apply(tcfg, tp, torch.from_numpy(x),
                        matmul_backend=backend)
        np.testing.assert_array_equal(out.numpy(), want_out)
        counts = snn.spike_counts_per_layer(tcfg, tp, torch.from_numpy(x),
                                            matmul_backend=backend)
        assert len(counts) == len(want_counts)
        for got, want in zip(counts, want_counts):
            np.testing.assert_array_equal(got.numpy(), want)
        assert sum(float(c.sum()) for c in counts[1:]) > 0   # not silent

    def test_permuted_dense_layers_change_nothing(self, exact_case):
        tcfg, npp, x, want_out, _ = exact_case
        tp = convert.params_from_numpy(npp, "cpu")
        rng = np.random.default_rng(5)
        perms, shape = [], tcfg.input_shape
        for spec, out_shape in zip(tcfg.layers, snn.output_shapes(tcfg)):
            perms.append(torch.from_numpy(rng.permutation(
                int(np.prod(shape)))) if isinstance(spec, snn.Dense)
                else None)
            shape = out_shape
        for backend in ("spike_gemm", "spike_gemm_fused"):
            out = snn.apply(tcfg, tp, torch.from_numpy(x),
                            matmul_backend=backend, layer_perms=perms)
            np.testing.assert_array_equal(out.numpy(), want_out)
        with pytest.raises(ValueError, match="layer_perms"):
            snn.apply(tcfg, tp, torch.from_numpy(x), layer_perms=perms[:-1])


def _jax_membranes(jcfg, jp, x):
    """Per step, every spiking layer's (u, s), from ``lax.scan`` as
    ``snn.apply`` runs it."""
    def body(states, s_in):
        new, _ = jsnn.step(jcfg, jp, states, s_in, matmul_backend="jnp")
        return new, [st for st in new if st is not None]
    states0 = jsnn.init_states(jcfg, x.shape[1])
    _, per_step = jax.jit(lambda xs: jax.lax.scan(body, states0, xs))(x)
    return [(np.asarray(u), np.asarray(s)) for u, s in per_step]


@pytest.fixture(scope="module")
def default_case(net):
    jcfg, tcfg = _both(net, 0.95)
    npp = _np_params(jcfg, 2.0, grid=True)
    x = _input(net, seed=1)
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in npp]
    want_out = np.asarray(jsnn.apply(jcfg, jp, jnp.asarray(x),
                                     matmul_backend="jnp"))
    return tcfg, npp, x, want_out, _jax_membranes(jcfg, jp, jnp.asarray(x))


class TestApplyDefaultBeta:
    @pytest.mark.parametrize("backend", snn.MATMUL_BACKENDS)
    def test_teacher_forced_membranes_within_rtol(self, default_case,
                                                  backend):
        """From JAX's own state at t-1, one port step gives JAX's state at
        t to rtol 1e-6; its spikes agree wherever u is not within 1e-5 of
        the threshold.  Grid weights keep the currents exact, so what is
        left is the FMA: one rounding of ``beta*u`` (at most half an ulp
        of values below 16, hence atol 2e-6 where ``u`` cancels to near
        zero)."""
        tcfg, npp, x, _, jstates = default_case
        tp = convert.params_from_numpy(npp, "cpu")
        spiking = [i for i, s in enumerate(tcfg.layers)
                   if not isinstance(s, snn.MaxPool)]
        for t in range(1, T):
            states = [None] * len(tcfg.layers)
            for li, (u, s) in zip(spiking, jstates):
                states[li] = (torch.tensor(u[t - 1]),
                              torch.tensor(s[t - 1]))
            new, _ = snn.step(tcfg, tp, states, torch.from_numpy(x[t]),
                              matmul_backend=backend)
            for li, (u, s) in zip(spiking, jstates):
                got_u, got_s = (v.numpy() for v in new[li])
                np.testing.assert_allclose(got_u, u[t], rtol=1e-6,
                                           atol=2e-6)
                far = np.abs(u[t] - 1.0) > 1e-5
                np.testing.assert_array_equal(got_s[far], s[t][far])

    @pytest.mark.parametrize("backend", snn.MATMUL_BACKENDS)
    def test_free_running_spikes_rarely_flip(self, default_case, backend):
        """Run free, a flip can propagate; bound the share of flipped
        output spikes at 1%."""
        tcfg, npp, x, want_out, _ = default_case
        tp = convert.params_from_numpy(npp, "cpu")
        out = snn.apply(tcfg, tp, torch.from_numpy(x),
                        matmul_backend=backend).numpy()
        assert out.shape == want_out.shape
        assert (out != want_out).mean() <= 0.01
        assert want_out.sum() > 0


# ---------------------------------------------------------------------------
# The conv epilogue as one step (ops.conv_lif_step) against the unfused
# chain snn._add_bias + lif.lif_step + snn._OrPool, on the CPU, bit for bit
# ---------------------------------------------------------------------------

EPI_STEPS = 3


def _epilogue_case(shape, cells, seed=0):
    """Per step a bias-free conv output (a leaf), a bias leaf, and the
    cotangents of the pooled and the last membranes: normal values that
    put a share of ``u`` near the threshold."""
    gen = torch.Generator().manual_seed(seed)
    lead = () if cells is None else (cells,)
    f = shape[-1]
    curs = [(torch.randn(lead + shape, generator=gen) * 0.8 + 0.4)
            .requires_grad_() for _ in range(EPI_STEPS)]
    bias = (torch.randn(lead + (f,), generator=gen) * 0.1).requires_grad_()
    return curs, bias, gen


def _chain(curs, bias, lif_p, window, cells, fused):
    """EPI_STEPS steps of one conv layer's epilogue from zero state:
    fused (``ops.conv_lif_step``) or the unfused chain.  Returns the
    per-step (u, s, out) with out the pooled spikes (or s)."""
    z = torch.zeros_like(curs[0].detach())
    u, s = z, z
    steps = []
    for cur in curs:
        if fused:
            res = ops.conv_lif_step(
                cur, bias, u, s, beta=lif_p.beta, threshold=lif_p.threshold,
                slope=lif_p.slope, reset_mechanism=lif_p.reset_mechanism,
                pool_window=window)
            u, s = res[:2]
            out = res[2] if window else s
        else:
            x = snn._add_bias(cur, bias, cells)
            u, s = lif.lif_step(u, s, x, lif_p)
            out = snn._or_pool(s, window) if window else s
        steps.append((u, s, out))
    return steps


def _loss_of(steps, gen_seed):
    """A loss that reads each step's out and the last u once: s has no
    reader outside the layer but its pool (or the loss) and the next
    step's reset, as in the model."""
    gen = torch.Generator().manual_seed(gen_seed)
    loss = 0
    for _, _, out in steps:
        loss = loss + (out * torch.randn(out.shape, generator=gen)).sum()
    u = steps[-1][0]
    return loss + (u * torch.randn(u.shape, generator=gen)).sum()


class TestConvEpilogue:
    @pytest.mark.parametrize("cells", [None, 2], ids=["solo", "slab2"])
    @pytest.mark.parametrize("shape", [(2, 8, 8, 4), (2, 9, 7, 3)],
                             ids=["even", "ragged"])
    @pytest.mark.parametrize("reset", ["subtract", "zero"])
    def test_forward_and_every_gradient_equal_the_chain(self, reset, shape,
                                                        cells):
        lif_p = lif.LIFParams(reset_mechanism=reset)
        for window in (2, None):
            curs, bias, _ = _epilogue_case(shape, cells)
            runs = []
            for fused in (True, False):
                leaves = [c.detach().clone().requires_grad_() for c in curs]
                b = bias.detach().clone().requires_grad_()
                steps = _chain(leaves, b, lif_p, window, cells, fused)
                grads = torch.autograd.grad(_loss_of(steps, 7), leaves + [b])
                runs.append((steps, grads))
            (got, got_g), (want, want_g) = runs
            for a, w in zip(got, want):
                for x, y in zip(a, w):
                    assert x.shape == y.shape and torch.equal(x, y)
            assert sum(float(s.detach().sum()) for _, s, _ in want) > 0
            for x, y in zip(got_g, want_g):
                assert torch.equal(x, y)
            assert all(float(g.abs().sum()) > 0 for g in want_g)

    def test_ragged_edge_gets_no_pool_gradient(self):
        curs, bias, _ = _epilogue_case((1, 5, 5, 2), None)
        z = torch.zeros(1, 5, 5, 2)
        _, _, pooled = ops.conv_lif_step(curs[0], bias, z, z, beta=0.95,
                                         threshold=1.0, pool_window=2)
        assert pooled.shape == (1, 2, 2, 2)
        (d_cur,) = torch.autograd.grad(pooled.sum(), curs[0])
        assert d_cur[:, :4, :4].any()
        assert not d_cur[:, 4].any() and not d_cur[:, :, 4].any()

    def test_no_grad_saves_nothing_and_equals(self):
        curs, bias, _ = _epilogue_case((2, 9, 7, 3), None)
        z = torch.zeros(2, 9, 7, 3)
        with torch.no_grad():
            got = ops.conv_lif_step(curs[0], bias, z, z, beta=0.95,
                                    threshold=1.0, pool_window=2)
            x = snn._add_bias(curs[0], bias, None)
            u, s = lif.lif_step(z, z, x, lif.LIFParams())
            want = (u, s, snn._or_pool(s, 2))
        assert all(g.grad_fn is None for g in got)
        for a, w in zip(got, want):
            assert torch.equal(a, w)

    def test_refuses_a_window_past_a_byte_and_an_unknown_reset(self):
        z = torch.zeros(1, 4, 4, 2)
        b = torch.zeros(2)
        with pytest.raises(ValueError, match="windows"):
            ops.conv_lif_step(z, b, z, z, beta=0.9, threshold=1.0,
                              pool_window=17)
        with pytest.raises(ValueError, match="reset"):
            ops.conv_lif_step(z, b, z, z, beta=0.9, threshold=1.0,
                              reset_mechanism="hard")


def _plain_conv_step(spec, p, s_in, state, pool_window):
    """``snn._conv_step`` with the unfused epilogue: the chain the
    ``torch`` backend runs, after the kernel backends' conv."""
    cur = ops.spike_conv_train(s_in, p["w"], stride=spec.stride,
                               padding=spec.padding)
    cells = None if cur.dim() == 4 else cur.shape[0]
    u, s = lif.lif_step(state[0], state[1],
                        snn._add_bias(cur, p["b"], cells), spec.lif)
    return u, s, snn._or_pool(s, pool_window) if pool_window else s


class TestConvEpilogueInTheNet:
    @pytest.mark.parametrize("cells", [None, 2], ids=["solo", "slab2"])
    @pytest.mark.parametrize("hw", [(12, 12), (13, 11)],
                             ids=["even", "ragged"])
    @pytest.mark.parametrize("reset", ["subtract", "zero"])
    def test_loss_and_gradients_equal_the_unfused_chain(
            self, monkeypatch, reset, hw, cells):
        """A Conv-MaxPool-Conv-MaxPool-Dense net trained one step on the
        default backend: the loss, every gradient and every layer's train
        equal those of the same step with the conv epilogue unfused."""
        p = lif.LIFParams(reset_mechanism=reset)
        cfg = snn.SNNConfig("conv-net", hw + (2,),
                            (snn.Conv(4, 3, lif=p), snn.MaxPool(2),
                             snn.Conv(4, 3, lif=p), snn.MaxPool(2),
                             snn.Dense(6, p)), num_classes=3, pcr=2,
                            num_steps=4)
        assert cfg.conv_pool_windows == (2, None, 2, None, None)
        gen = torch.Generator().manual_seed(3)
        params = snn.init_params(gen, cfg, device="cpu")
        for q, gain in zip(params, (4.0, 0, 3.0, 0, 2.0)):
            if q:
                q["w"] = q["w"] * gain
                q["b"] = torch.randn(q["b"].shape, generator=gen) * 0.1
        lead = (4,) if cells is None else (4, cells)
        if cells is not None:
            params = [{k: torch.stack([v, v.flip(0) * 0.9])
                       for k, v in q.items()} for q in params]
        x = (torch.rand(lead + (3,) + cfg.input_shape, generator=gen)
             < 0.3).float()
        runs = []
        for unfused in (False, True):
            if unfused:
                monkeypatch.setattr(snn, "_conv_step", _plain_conv_step)
            leaves = [{k: v.clone().requires_grad_() for k, v in q.items()}
                      for q in params]
            trains = snn.apply(cfg, leaves, x, return_all_layers=True)
            out = trains[-1]
            loss = (out * torch.linspace(-1, 1, out.shape[-1])).sum()
            grads = torch.autograd.grad(
                loss, [v for q in leaves for v in q.values()])
            runs.append((trains, loss, grads))
        (t0, l0, g0), (t1, l1, g1) = runs
        assert torch.equal(l0, l1)
        assert all(torch.equal(a, b) for a, b in zip(t0, t1))
        assert all(torch.equal(a, b) for a, b in zip(g0, g1))
        assert all(float(t.detach().sum()) > 0 for t in t0)
        assert all(float(g.abs().sum()) > 0 for g in g0)

    def test_the_pool_layer_runs_no_pass_of_its_own(self):
        cfg = snn.SNNConfig("c", (6, 6, 2), (snn.Conv(3), snn.MaxPool(2),
                                             snn.MaxPool(1), snn.Dense(4)),
                            num_classes=4, num_steps=2)
        assert cfg.conv_pool_windows == (2, None, None, None)
        params = snn.init_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
        states = snn.init_states(cfg, 2, torch.device("cpu"))
        s_in = (torch.rand(2, 6, 6, 2) < 0.5).float()
        for backend in snn.MATMUL_BACKENDS:
            with spans.recording() as records:
                new, spikes = snn.step(cfg, params, states, s_in,
                                       matmul_backend=backend)
            names = [r.name for r in records]
            fused = backend != "torch"
            assert ("fwd.pool1" in names) != fused
            assert "fwd.pool2" in names
            assert new[1] is None and new[2] is None
            assert spikes[0].shape == (2, 6, 6, 3)
