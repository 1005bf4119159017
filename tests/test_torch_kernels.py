"""The port's kernel layer (repro_torch.kernels) against the JAX package's
(repro.kernels), on the same NumPy inputs.

On the CPU the port's ops run their plain PyTorch versions and the JAX ops
run their Pallas kernels in interpret mode.  Operands are spikes in {0,1}
and weights on a 2^-8 grid small enough that every partial sum is exact in
fp32, so the comparisons are exact whatever the summation order.  The CUDA
kernels themselves are held against the plain versions on a card by
tests/test_torch_cuda.py.
"""
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import spike_conv as jconv
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import (spike_conv, spike_gemm, spike_gemm_bwd,
                                 spike_gemm_fused)

torch.set_num_threads(2)

GRID = 2.0 ** -8


def _spikes(rng, shape, density):
    return (rng.random(shape) < density).astype(np.float32)


def _grid_weights(rng, shape, scale=0.5):
    w = rng.normal(scale=scale, size=shape)
    return (np.round(w / GRID) * GRID).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


class TestFlags:
    @pytest.mark.parametrize("shape", [(8, 100), (33, 257), (64, 128)])
    @pytest.mark.parametrize("blocks", [(8, 128), (32, 32)])
    def test_block_flags_match_jax(self, shape, blocks):
        rng = np.random.default_rng(0)
        s = _spikes(rng, shape, 0.02)
        bm, bk = blocks
        got = ops.block_flags(_t(s), block_m=bm, block_k=bk)
        want = jops.block_flags(jnp.asarray(s), block_m=bm, block_k=bk)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("seed", range(3))
    def test_skip_fraction_matches_jax(self, seed):
        """The port counts tiles exactly; JAX takes an fp32 mean."""
        rng = np.random.default_rng(seed)
        s = _spikes(rng, (40, 700), 0.003)
        s[8:24] = 0.0
        for bm, bk in [(8, 128), (build.TILE["block_m"],
                                  build.TILE["block_k"])]:
            assert ops.skip_fraction(_t(s), bm, bk) == pytest.approx(
                jops.skip_fraction(jnp.asarray(s), bm, bk), abs=1e-7)

    def test_all_zero_skips_everything(self):
        assert ops.skip_fraction(torch.zeros(64, 300)) == 1.0
        assert ops.skip_fraction(torch.ones(64, 300)) == 0.0

    def test_pad_to(self):
        x = torch.ones(32, 64)
        assert ops._pad_to(x, (32, 32)) is x
        y = ops._pad_to(torch.ones(3, 5), (4, 8))
        assert y.shape == (4, 8) and float(y.sum()) == 15.0
        assert float(y[3:].abs().sum() + y[:, 5:].abs().sum()) == 0.0


class TestSpikeGemm:
    @pytest.mark.parametrize("shape", [(8, 100, 10), (33, 257, 65),
                                       (64, 512, 11)])
    @pytest.mark.parametrize("density", [0.0, 0.1, 1.0])
    def test_matches_jax_exactly(self, shape, density):
        m, k, n = shape
        rng = np.random.default_rng(1)
        s = _spikes(rng, (m, k), density)
        w = _grid_weights(rng, (k, n))
        got = ops.spike_gemm(_t(s), _t(w))
        want = jops.spike_gemm(jnp.asarray(s), jnp.asarray(w), block_m=8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_reuses_caller_flags_and_rejects_mismatch(self):
        rng = np.random.default_rng(2)
        s, w = _t(_spikes(rng, (40, 300), 0.1)), _t(_grid_weights(
            rng, (300, 20)))
        flags = ops.block_flags(s)
        np.testing.assert_array_equal(ops.spike_gemm(s, w, flags=flags),
                                      ops.spike_gemm(s, w))
        with pytest.raises(ValueError, match="tile grid"):
            ops.spike_gemm(s, w, flags=flags[:, :-1])

    def test_permutation_leaves_product_unchanged(self):
        rng = np.random.default_rng(3)
        k = 512
        rates = np.where(rng.random(k) < 0.85, 0.001, 0.15)
        s = (rng.random((32, k)) < rates).astype(np.float32)
        w = _grid_weights(rng, (k, 16))
        perm = ops.firing_rate_permutation(_t(s.mean(0)))
        want_perm = jops.firing_rate_permutation(jnp.asarray(s.mean(0)))
        np.testing.assert_array_equal(perm.numpy(), np.asarray(want_perm))
        sp, wp = ops.apply_permutation(_t(s), _t(w), perm)
        np.testing.assert_array_equal(ops.spike_gemm(sp, wp).numpy(), s @ w)
        assert ops.skip_fraction(sp, 8, 128) > ops.skip_fraction(
            _t(s), 8, 128) + 0.3


class TestSpikeConv:
    @pytest.mark.parametrize("stride", [1, 2])
    @pytest.mark.parametrize("padding", ["SAME", "VALID"])
    @pytest.mark.parametrize("kernel", [2, 3])
    def test_patches_match_jax_order(self, stride, padding, kernel):
        rng = np.random.default_rng(4)
        x = rng.normal(size=(2, 9, 8, 3)).astype(np.float32)
        got = spike_conv.conv_patches(_t(x), kernel, kernel, stride, padding)
        want = jconv.conv_patches(jnp.asarray(x), kernel, kernel, stride,
                                  padding)
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("size", [7, 8, 9])
    @pytest.mark.parametrize("stride", [1, 2])
    def test_out_size_matches_jax(self, size, stride):
        for padding in ("SAME", "VALID"):
            assert spike_conv.conv_out_size(size, 3, stride, padding) == \
                jconv.conv_out_size(size, 3, stride, padding)

    @pytest.mark.parametrize("stride", [1, 2])
    @pytest.mark.parametrize("padding", ["SAME", "VALID"])
    @pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
    def test_matches_jax_exactly(self, stride, padding, density):
        rng = np.random.default_rng(5)
        x = _spikes(rng, (2, 9, 9, 3), density)
        w = _grid_weights(rng, (3, 3, 3, 5))
        want = np.asarray(jops.spike_conv(jnp.asarray(x), jnp.asarray(w),
                                          stride=stride, padding=padding,
                                          block_m=8))
        got = ops.spike_conv(_t(x), _t(w), stride=stride, padding=padding)
        np.testing.assert_array_equal(got.numpy(), want)
        # the lowering the card runs (patches, flags, one accumulate)
        lowered, _ = ops._conv_lowered(
            _t(x), _t(w), stride, padding, None,
            lambda p, w2, f: ref.spike_gemm_ref(p, w2))
        np.testing.assert_array_equal(lowered.numpy(), want)

    def test_rejects_mismatched_flags_and_channels(self):
        x, w = torch.zeros(1, 6, 6, 2), torch.zeros(3, 3, 2, 4)
        with pytest.raises(ValueError, match="tile grid"):
            ops.spike_conv(x, w, flags=torch.zeros(9, 9, dtype=torch.int32))
        with pytest.raises(ValueError, match="input channels"):
            ops.spike_conv(x, torch.zeros(3, 3, 5, 4))


class TestFusedGemmLif:
    @pytest.mark.parametrize("reset", ["subtract", "zero"])
    @pytest.mark.parametrize("shape", [(5, 100, 33), (16, 300, 50)])
    def test_exact_on_grid_with_beta_half(self, reset, shape):
        """beta = 0.5 and grid operands: every product and sum of the
        epilogue is exact, so rounding order cannot matter."""
        m, k, n = shape
        rng = np.random.default_rng(6)
        s = _spikes(rng, (m, k), 0.2)
        w, b = _grid_weights(rng, (k, n)), _grid_weights(rng, (n,))
        u0 = _grid_weights(rng, (m, n), 1.0)
        s0 = _spikes(rng, (m, n), 0.3)
        got_u, got_s = ops.spike_gemm_lif_step(
            _t(s), _t(w), _t(b), _t(u0), _t(s0), beta=0.5, threshold=1.0,
            reset_mechanism=reset)
        want_u, want_s = jops.spike_gemm_lif_step(
            *map(jnp.asarray, (s, w, b, u0, s0)), beta=0.5, threshold=1.0,
            reset_mechanism=reset)
        np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))

    @pytest.mark.parametrize("reset", ["subtract", "zero"])
    def test_close_with_default_beta(self, reset):
        """beta = 0.95 rounds ``beta*u``; XLA may contract it with the add
        into one FMA where PyTorch rounds twice (ROADMAP §3), so membranes
        agree to a few ulp and spikes exactly away from the threshold."""
        rng = np.random.default_rng(7)
        s = _spikes(rng, (8, 200), 0.2)
        w, b = _grid_weights(rng, (200, 40)), _grid_weights(rng, (40,))
        u0 = rng.normal(size=(8, 40)).astype(np.float32)
        s0 = _spikes(rng, (8, 40), 0.3)
        got_u, got_s = ops.spike_gemm_lif_step(
            _t(s), _t(w), _t(b), _t(u0), _t(s0), beta=0.95, threshold=1.0,
            reset_mechanism=reset)
        want_u, want_s = jops.spike_gemm_lif_step(
            *map(jnp.asarray, (s, w, b, u0, s0)), beta=0.95, threshold=1.0,
            reset_mechanism=reset)
        np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u),
                                   rtol=1e-6, atol=1e-6)
        far = np.abs(np.asarray(want_u) - 1.0) > 1e-5
        np.testing.assert_array_equal(got_s.numpy()[far],
                                      np.asarray(want_s)[far])

    @pytest.mark.parametrize("reset", ["subtract", "zero"])
    def test_lif_ref_matches_jax_ref(self, reset):
        """Eager JAX rounds every operation on its own, as PyTorch does."""
        rng = np.random.default_rng(8)
        u, c = (rng.normal(size=(4, 300)).astype(np.float32)
                for _ in range(2))
        s = _spikes(rng, (4, 300), 0.3)
        got = ref.lif_step_ref(_t(u), _t(s), _t(c), beta=0.95,
                               threshold=1.0, reset_mechanism=reset)
        want = jref.lif_step_ref(jnp.asarray(u), jnp.asarray(s),
                                 jnp.asarray(c), beta=0.95, threshold=1.0,
                                 reset_mechanism=reset)
        for g, wv in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wv))

    def test_all_zero_train_is_pure_lif(self):
        z = torch.zeros(4, 64)
        b = torch.full((10,), 0.75)
        u, s = ops.spike_gemm_lif_step(z, torch.ones(64, 10), b,
                                       torch.ones(4, 10), torch.zeros(4, 10),
                                       beta=0.5, threshold=1.0)
        np.testing.assert_array_equal(u.numpy(), np.full((4, 10), 1.25))
        np.testing.assert_array_equal(s.numpy(), np.ones((4, 10)))

    def test_unknown_reset_raises(self):
        with pytest.raises(ValueError, match="reset"):
            ops.spike_gemm_lif_step(torch.zeros(1, 4), torch.zeros(4, 2),
                                    torch.zeros(2), torch.zeros(1, 2),
                                    torch.zeros(1, 2), beta=0.9,
                                    threshold=1.0, reset_mechanism="hard")


class TestDispatch:
    def test_cpu_tensors_launch_nothing(self):
        ops.reset_launch_counts()
        s, w = torch.ones(8, 40), torch.ones(40, 6)
        ops.spike_gemm(s, w)
        ops.spike_conv(torch.ones(1, 5, 5, 2), torch.ones(3, 3, 2, 4))
        ops.spike_gemm_lif_step(s, w, torch.zeros(6), torch.zeros(8, 6),
                                torch.zeros(8, 6), beta=0.9, threshold=1.0)
        ops.spike_gemm_bwd_dw(s, torch.ones(8, 6))
        ops.spike_gemm_bwd_ds(torch.ones(8, 6), w)
        assert ops.launch_counts() == {"spike_gemm": 0, "spike_gemm_lif": 0,
                                       "spike_conv": 0, "spike_gemm_dw": 0,
                                       "spike_gemm_ds": 0}

    @pytest.mark.parametrize("launch", [
        lambda: spike_gemm.spike_gemm_cuda(
            torch.ones(4, 4), torch.ones(4, 4),
            torch.ones(1, 1, dtype=torch.int32)),
        lambda: spike_conv.spike_conv_cuda(
            torch.ones(4, 4), torch.ones(4, 4),
            torch.ones(1, 1, dtype=torch.int32)),
        lambda: spike_gemm_fused.spike_gemm_lif_cuda(
            torch.ones(4, 4), torch.ones(4, 4), torch.ones(4),
            torch.ones(4, 4), torch.ones(4, 4),
            torch.ones(1, 1, dtype=torch.int32), beta=0.9, threshold=1.0),
        lambda: spike_gemm_bwd.spike_gemm_dw_cuda(
            torch.ones(4, 4), torch.ones(4, 4),
            torch.ones(1, 1, dtype=torch.int32)),
        lambda: spike_gemm_bwd.spike_gemm_ds_cuda(
            torch.ones(4, 4), torch.ones(4, 4),
            torch.ones(1, 1, dtype=torch.int32)),
    ])
    def test_kernel_wrappers_refuse_cpu_tensors(self, launch):
        with pytest.raises(ValueError, match="CUDA kernel"):
            launch()

    def test_other_devices_are_refused(self):
        with pytest.raises(ValueError, match="no spike kernel"):
            ops.spike_gemm(torch.ones(4, 4, device="meta"),
                           torch.ones(4, 4, device="meta"),
                           flags=torch.ones(1, 1, dtype=torch.int32))


def _fake_nvcc(tmp_path, fail=False):
    """A stand-in compiler: writes its -o target, or fails with a message."""
    script = tmp_path / "nvcc"
    body = ("echo 'error: refused' >&2; exit 2" if fail else
            'while [ "$1" != "-o" ]; do shift; done; '
            'echo "ptxas info: built $2"; echo lib > "$2"')
    script.write_text(f"#!/bin/sh\n{body}\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


class TestBuild:
    def test_builds_each_source_once_into_its_digest_dir(self, tmp_path,
                                                         monkeypatch):
        monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "out")
        monkeypatch.setattr(build, "nvcc", lambda: _fake_nvcc(tmp_path))
        libs = build.build_all()
        assert sorted(libs) == sorted(build.SOURCES)
        for name, path in libs.items():
            assert path.read_text() == "lib\n"
            assert "ptxas info" in (path.parent / f"{name}.log").read_text()
        assert all(p.parent == build.build_dir() for p in libs.values())
        monkeypatch.setattr(build, "nvcc", lambda: pytest.fail("rebuilt"))
        assert build.build_all() == libs

    def test_failed_build_raises_with_compiler_output(self, tmp_path,
                                                      monkeypatch):
        monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "out")
        monkeypatch.setattr(build, "nvcc",
                            lambda: _fake_nvcc(tmp_path, fail=True))
        with pytest.raises(RuntimeError, match="refused"):
            build.build_all()
        assert not any(build.build_dir().glob("*.so"))

    def test_flags_carry_the_tile_and_target(self):
        flags = " ".join(build.NVCC_FLAGS)
        assert "arch=compute_90a,code=sm_90a" in flags
        for macro, key in (("BM", "block_m"), ("BN", "block_n"),
                           ("BK", "block_k")):
            assert f"-D{macro}={build.TILE[key]}" in flags
