"""The backward's input cotangent of a conv layer and the launch plans of
the backward's kernels, on the CPU.

``ops.spike_conv_bwd_ds`` is held against ``jax.vjp`` of the JAX package's
``spike_conv_train`` with respect to its input spikes, whose Pallas kernels
run in interpret mode, on NumPy inputs made from seeds: spikes in {0,1},
weights on a 2^-8 grid and cotangents on a 1/16 grid, so every sum is
exact in fp32 and the comparison is exact whatever the order.  The plans
(``spike_gemm_bwd.conv_ds_plan``, ``dw_plan``, ``ds_plan``) are the host
side of the CUDA kernels, which tests/test_torch_cuda.py holds against the
plain versions on a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref, spike_conv, spike_gemm_bwd

torch.set_num_threads(2)

GRID = 2.0 ** -8


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


class TestConvDsAgainstJax:
    @pytest.mark.parametrize("stride", [1, 2])
    @pytest.mark.parametrize("padding", ["SAME", "VALID"])
    @pytest.mark.parametrize("cin", [3, 33])
    @pytest.mark.parametrize("cout", [5, 33])
    def test_equals_the_vjp_of_spike_conv_train(self, stride, padding, cin,
                                                cout):
        rng = np.random.default_rng(1000 * stride + 10 * cin + cout)
        x = _spikes(rng, (2, 9, 7, cin), 0.3)
        w = _grid(rng, (3, 3, cin, cout))
        jout, vjp = jax.vjp(
            lambda a: jops.spike_conv_train(a, jnp.asarray(w), stride=stride,
                                            padding=padding), jnp.asarray(x))
        g = _cotangent(rng, jout.shape)
        (want,) = vjp(jnp.asarray(g))
        got = ops.spike_conv_bwd_ds(_t(g), _t(w), x.shape, stride=stride,
                                    padding=padding)
        assert got.shape == x.shape and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "VALID")])
    def test_cpu_backward_gives_the_bytes_it_gave_before(self, stride,
                                                         padding):
        """The conv Function's input gradient on the CPU on normal operands:
        the same bytes as the matrix dS in patch space folded back by
        ``conv_col2im``, which its backward computed before the conv dS
        existed."""
        rng = np.random.default_rng(7 + stride)
        x = _t(_spikes(rng, (2, 11, 9, 5), 0.3)).requires_grad_()
        w = _t(rng.standard_normal((3, 3, 5, 6)).astype(np.float32))
        out = ops.spike_conv_train(x, w, stride=stride, padding=padding)
        g = _t(rng.standard_normal(tuple(out.shape)).astype(np.float32))
        (d_s,) = torch.autograd.grad(out, x, g)
        d_p = ops.spike_gemm_bwd_ds(g.reshape(-1, 6), w.reshape(45, 6))
        want = spike_conv.conv_col2im(d_p, tuple(x.shape), 3, 3, stride,
                                      padding)
        assert torch.equal(d_s, want)
        assert torch.equal(
            ref.spike_conv_ds_ref(g, w, tuple(x.shape), stride=stride,
                                  padding=padding), want)

    def test_a_cancelling_row_is_not_skipped(self):
        """A cotangent pixel whose values are +x and -x sums to zero and
        still reaches its input pixels."""
        g = torch.zeros(1, 6, 6, 4)
        g[0, 2, 3] = torch.tensor([0.75, -0.75, 0.75, -0.75])
        w = torch.ones(3, 3, 2, 4)
        w[..., 1] = 2.0
        d_s = ops.spike_conv_bwd_ds(g, w, (1, 6, 6, 2))
        assert torch.equal(d_s[0, 1:4, 2:5], torch.full((3, 3, 2), -0.75))
        assert int((d_s != 0).sum()) == 18


#: (B, H, W, C, F, kernel, stride, padding): net-5's conv1 and conv2, the
#: dvs-conv cell's two convs, and ragged layers.
CONV_LAYERS = [(64, 128, 128, 2, 32, 3, 1, "SAME"),
               (64, 64, 64, 32, 32, 3, 1, "SAME"),
               (64, 32, 32, 2, 8, 3, 1, "SAME"),
               (64, 16, 16, 8, 16, 3, 1, "SAME"),
               (3, 17, 15, 33, 33, 3, 2, "SAME"),
               (2, 9, 11, 33, 33, 3, 1, "VALID"),
               (2, 9, 7, 3, 5, 2, 2, "VALID"),
               (1, 8, 8, 4, 600, 3, 1, "SAME")]


class TestConvDsPlan:
    """The host side of the conv dS: which kernel, its tile and shared
    memory, and what it refuses."""

    @pytest.mark.parametrize("layer", CONV_LAYERS)
    def test_takes_every_layer_the_forward_takes(self, layer):
        b, h, w, c, f, k, stride, padding = layer
        x_shape, w_shape = (b, h, w, c), (k, k, c, f)
        geo = spike_conv.conv_geometry(x_shape, w_shape, stride, padding)
        plan = spike_gemm_bwd.conv_ds_plan(x_shape, w_shape, stride, padding)
        assert plan[:12] == geo[:12]
        tr, tw, smem, strip, blocks = plan[12:]
        words = (k * 3 * f * spike_gemm_bwd.DS_CH
                 + f * spike_gemm_bwd.ds_plane(k)
                 + (spike_gemm_bwd.DS_ROWS + k - 1)
                 * spike_gemm_bwd.DS_HALO_ROW)
        fits = 4 * words <= spike_conv.MAX_SMEM
        assert strip == int(spike_conv.uses_strips(k, stride) and fits)
        if strip:
            assert (tr, tw, smem) == (spike_gemm_bwd.DS_ROWS,
                                      spike_gemm_bwd.DS_STRIP, 4 * words)
            tiles = b * -(-h // tr) * -(-w // tw)
            assert 1 <= blocks <= tiles
        else:
            assert (tr, tw, smem) == (0, 0, 0) and blocks >= 1

    def test_net5_conv2_runs_the_strip_kernel_in_one_wave(self):
        """W as [tap][f][36 channels], a 10-row halo of 36-float rows per f
        padded to 388 floats (4 mod 32), and one block an SM."""
        plan = spike_gemm_bwd.conv_ds_plan((64, 64, 64, 32), (3, 3, 32, 32),
                                           1, "SAME")
        assert spike_gemm_bwd.ds_plane(3) == 388
        assert plan[12:] == (8, 32, 4 * (9 * 32 * 36 + 32 * 388 + 10 * 36), 1,
                             spike_gemm_bwd.SMS)

    @pytest.mark.parametrize("shapes", [
        ((1, 8, 8, 512), (3, 3, 512, 4), 1, "SAME"),
        ((1, 8, 8, 2), (3, 3, 2, 4), 0, "SAME"),
        ((1, 2, 2, 2), (3, 3, 2, 4), 1, "VALID"),
        ((2 ** 17, 128, 128, 2), (3, 3, 2, 4), 1, "SAME"),
        ((1, 8, 8, 2), (3, 3, 2, 4), 1, "FULL")])
    def test_refuses_exactly_where_the_forward_does(self, shapes):
        with pytest.raises(ValueError) as forward:
            spike_conv.conv_geometry(*shapes)
        with pytest.raises(ValueError) as ds:
            spike_gemm_bwd.conv_ds_plan(*shapes)
        assert str(ds.value) == str(forward.value)


#: (M, K, N): the dense layers of net-5, dvs-conv and mnist-mlp at batch
#: 64, ragged shapes and a batch of more than 64 rows.
DENSE = [(64, 32768, 512), (64, 512, 256), (64, 256, 11), (64, 1024, 64),
         (64, 64, 16), (64, 784, 128), (70, 1000, 130), (5, 33, 7),
         (4100, 18, 32)]


class TestDensePlans:
    @pytest.mark.parametrize("m,k,n", DENSE)
    def test_dw_blocks_cover_n_and_fit_an_sm(self, m, k, n):
        f4, blocks, slices = spike_gemm_bwd.dw_plan(m, k, n)
        cols = 128 * f4
        assert f4 in (1, 2, 4) and (slices - 1) * cols < n <= slices * cols
        assert 1 <= blocks <= -(-k // spike_gemm_bwd.DW_STRIP)
        assert blocks * slices <= spike_gemm_bwd.SMS * 4
        smem = 4 * 64 * (cols + 2 * (spike_gemm_bwd.DW_STRIP + 1))
        assert smem + 1024 <= spike_conv.SM_SMEM

    def test_fc1_dw_takes_whole_rows_in_one_wave(self):
        """A lane owns 16 of fc1's 512 columns, and 132 blocks of 148 KiB
        walk its 1,024 strips."""
        assert spike_gemm_bwd.dw_plan(64, 32768, 512) == (4, 132, 1)

    @pytest.mark.parametrize("m,k,n", DENSE)
    def test_ds_blocks_cover_the_output(self, m, k, n):
        large, m_blocks, k_blocks = spike_gemm_bwd.ds_plan(m, k)
        bm, bk = (spike_gemm_bwd.DS_LARGE if large
                  else spike_gemm_bwd.DS_SMALL)
        assert (m_blocks - 1) * bm < m <= m_blocks * bm
        assert (k_blocks - 1) * bk < k <= k_blocks * bk
        assert large == ((m, k) == (64, 32768))
