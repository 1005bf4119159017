"""The port's kernel API against the JAX package's, on the CPU:
``lif_step``, ``penc_compact`` and ``spike_gemm_profiled`` on the same
NumPy inputs, and the exported names.

The JAX ops run as their own tests run them, with the Pallas kernels in
interpret mode (``interpret=True`` is their default); the port's ops run
their plain versions, since the tensors lie on the CPU.  Tolerances:

* ``lif_step`` is exact where every value is exact in fp32 (operands on a
  2^-8 grid, ``beta = 0.5``) and for the zero reset.  Otherwise XLA
  contracts the jitted subtract-reset update ``beta*u + cur`` into one FMA
  and the port rounds twice (ROADMAP §3).  That moves one rounding of the
  intermediate, whose error ``thr*s`` can then leave large beside a small
  ``u``; so ``u`` is held within 1e-6 of the largest term, ``|beta*u| +
  |cur| + |thr*s|`` (one rounding is 6e-8 of it), and ``s`` equal wherever
  ``u`` is farther than that from the threshold.  In
  bfloat16 XLA keeps the intermediates in fp32 while the port rounds each
  operation to bfloat16, so ``u`` is held to the JAX test's own atol 2e-2
  and ``s`` equal outside that band.
* ``penc_compact`` returns integers: equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jkernels
from repro.kernels import ops as jops
from repro_torch import kernels
from repro_torch.core import validate
from repro_torch.kernels import ops

torch.set_num_threads(2)

GRID = 2.0 ** -8
LIF_SHAPES = [(8, 512), (1, 100), (3, 700), (16, 2048), (5, 1)]


def _lif_inputs(shape, seed, grid=False):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=shape)
    c = rng.normal(size=shape)
    if grid:
        u, c = (np.round(x * 2 / GRID) * GRID for x in (u, c))
    s = (rng.random(shape) < 0.3).astype(np.float32)
    return u.astype(np.float32), s, c.astype(np.float32)


def _both_lif(args, dtype, **kw):
    """(port's (u, s), JAX's (u, s)) as float32 NumPy arrays."""
    tdt = {np.float32: torch.float32, "bf16": torch.bfloat16}[dtype]
    jdt = {np.float32: jnp.float32, "bf16": jnp.bfloat16}[dtype]
    got = ops.lif_step(*(torch.from_numpy(a).to(tdt) for a in args), **kw)
    want = jops.lif_step(*(jnp.asarray(a, jdt) for a in args), **kw)
    assert all(g.dtype == tdt for g in got)
    assert all(w.dtype == jdt for w in want)
    return ([g.float().numpy() for g in got],
            [np.asarray(w, np.float32) for w in want])


class TestLifStep:
    @pytest.mark.parametrize("reset", ["subtract", "zero"])
    @pytest.mark.parametrize("shape", LIF_SHAPES)
    def test_equals_jax_exactly_on_grid_operands(self, shape, reset):
        (u, s), (ju, js) = _both_lif(_lif_inputs(shape, 0, grid=True),
                                     np.float32, beta=0.5, threshold=1.0,
                                     reset_mechanism=reset)
        np.testing.assert_array_equal(u, ju)
        np.testing.assert_array_equal(s, js)
        assert 0 < s.sum() < s.size or s.size < 10

    @pytest.mark.parametrize("shape", LIF_SHAPES)
    def test_zero_reset_equals_jax_exactly_on_normal_operands(self, shape):
        (u, s), (ju, js) = _both_lif(_lif_inputs(shape, 1), np.float32,
                                     beta=0.9, threshold=1.0,
                                     reset_mechanism="zero")
        np.testing.assert_array_equal(u, ju)
        np.testing.assert_array_equal(s, js)

    @pytest.mark.parametrize("beta,threshold", [(0.9, 1.0), (0.95, 0.5),
                                                (0.23, 2.0)])
    @pytest.mark.parametrize("shape", LIF_SHAPES)
    def test_subtract_reset_within_an_fma_of_jax(self, shape, beta,
                                                 threshold):
        args = _lif_inputs(shape, 2)
        (u, s), (ju, js) = _both_lif(args, np.float32, beta=beta,
                                     threshold=threshold)
        up, sp, cur = args
        band = 1e-6 * (np.abs(beta * up) + np.abs(cur) + threshold * sp)
        assert (np.abs(u - ju) <= band).all()
        far = np.abs(ju - threshold) > band
        np.testing.assert_array_equal(s[far], js[far])

    @pytest.mark.parametrize("reset", ["subtract", "zero"])
    @pytest.mark.parametrize("shape", LIF_SHAPES)
    def test_bfloat16_within_the_jax_tests_tolerance(self, shape, reset):
        (u, s), (ju, js) = _both_lif(_lif_inputs(shape, 3), "bf16",
                                     beta=0.9, threshold=1.0,
                                     reset_mechanism=reset)
        np.testing.assert_allclose(u, ju, atol=2e-2)
        far = np.abs(ju - 1.0) > 2e-2
        np.testing.assert_array_equal(s[far], js[far])

    def test_bfloat16_rounds_every_operation(self):
        """Each operation in fp32, its result rounded to bfloat16 at once,
        and beta and the threshold rounded to bfloat16 first."""
        u, s, c = (torch.from_numpy(a).bfloat16()
                   for a in _lif_inputs((4, 300), 4))
        got_u, got_s = ops.lif_step(u, s, c, beta=0.9, threshold=0.3)
        beta, thr = (torch.tensor(x, dtype=torch.bfloat16).float()
                     for x in (0.9, 0.3))

        def rnd(x):
            return x.bfloat16().float()

        want = rnd(rnd(rnd(beta * u.float()) + c.float())
                   - rnd(thr * s.float()))
        assert torch.equal(got_u.float(), want)
        assert torch.equal(got_s.float(), (want > thr).float())

    def test_unknown_reset_raises(self):
        x = torch.zeros(2, 3)
        with pytest.raises(ValueError, match="reset"):
            ops.lif_step(x, x, x, beta=0.9, threshold=1.0,
                         reset_mechanism="none")


def _bits(shape, density, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < density).astype(np.float32)


def _both_penc(bits, capacity):
    idx, cnt = ops.penc_compact(torch.from_numpy(bits), capacity)
    assert idx.dtype == cnt.dtype == torch.int32
    jidx, jcnt = jops.penc_compact(jnp.asarray(bits), capacity=capacity)
    return (idx.numpy(), cnt.numpy()), (np.asarray(jidx), np.asarray(jcnt))


class TestPencCompact:
    @pytest.mark.parametrize("shape", [(8, 128), (3, 100), (16, 777)])
    @pytest.mark.parametrize("density", [0.0, 0.1, 0.9])
    def test_equals_jax(self, shape, density):
        bits = _bits(shape, density)
        (idx, cnt), (jidx, jcnt) = _both_penc(bits, min(shape[1], 128))
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(cnt, jcnt)
        np.testing.assert_array_equal(cnt, bits.sum(1))

    def test_empty_full_and_overflowing_rows(self):
        bits = _bits((6, 96), 0.5, seed=1)
        bits[0] = 0.0            # empty: all -1, count 0
        bits[1] = 1.0            # full: overflows capacity 40, count 96
        bits[2, :40] = 1.0       # exactly capacity
        bits[2, 40:] = 0.0
        (idx, cnt), (jidx, jcnt) = _both_penc(bits, 40)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(cnt, jcnt)
        assert (idx[0] == -1).all() and cnt[0] == 0
        np.testing.assert_array_equal(idx[1], np.arange(40))
        assert cnt[1] == 96                      # the count is not cut
        np.testing.assert_array_equal(idx[2], np.arange(40))

    @pytest.mark.parametrize("capacity", [37, 50])
    def test_capacity_at_or_beyond_the_row(self, capacity):
        bits = _bits((5, 37), 0.4, seed=2)
        (idx, cnt), (jidx, jcnt) = _both_penc(bits, capacity)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(cnt, jcnt)
        assert idx.shape == (5, capacity)
        for row, c in zip(idx, cnt):
            assert (row[c:] == -1).all()

    def test_matches_the_serial_priority_encoder(self):
        """Equal to the fixed-point validator's chunked PENC when the
        capacity covers the row."""
        bits = _bits((4, 250), 0.2, seed=3)
        idx, cnt = ops.penc_compact(torch.from_numpy(bits), 250)
        for b in range(4):
            serial = validate.penc_compress(bits[b].astype(np.int64))
            assert [int(i) for i in idx[b] if i >= 0] == serial
            assert int(cnt[b]) == len(serial)

    def test_capacity_drops_overflow(self):
        idx, cnt = ops.penc_compact(torch.ones(1, 64), 16)
        np.testing.assert_array_equal(idx[0].numpy(), np.arange(16))
        assert int(cnt[0]) == 64


class TestProfiledGemmAndExports:
    def test_profiled_equals_spike_gemm_and_jax(self):
        rng = np.random.default_rng(5)
        s = _bits((24, 300), 0.1, seed=5)
        s[:, 100:] *= (rng.random(200) < 0.2)          # cold columns
        w = (np.round(rng.normal(size=(300, 40)) / GRID) * GRID).astype(
            np.float32)
        perm = ops.firing_rate_permutation(torch.from_numpy(s.mean(0)))
        got = ops.spike_gemm_profiled(torch.from_numpy(s),
                                      torch.from_numpy(w), perm)
        assert torch.equal(got, ops.spike_gemm(torch.from_numpy(s),
                                               torch.from_numpy(w)))
        jperm = jops.firing_rate_permutation(jnp.asarray(s.mean(0)))
        np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
        want = jops.spike_gemm_profiled(jnp.asarray(s), jnp.asarray(w),
                                        jperm, block_m=8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_exports_the_jax_kernel_api(self):
        assert kernels.__all__ == jkernels.__all__
        for name in kernels.__all__:
            assert callable(getattr(kernels, name))

