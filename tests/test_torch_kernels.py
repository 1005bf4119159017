"""The port's kernel layer (repro_torch.kernels) against the JAX package's
(repro.kernels), on the same NumPy inputs.

On the CPU the port's ops run their plain PyTorch versions and the JAX ops
run their Pallas kernels in interpret mode.  Operands are spikes in {0,1}
and weights on a 2^-8 grid small enough that every partial sum is exact in
fp32, so the comparisons are exact whatever the summation order.  The CUDA
kernels themselves are held against the plain versions on a card by
tests/test_torch_cuda.py.
"""
import importlib
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import spike_conv as jconv
from repro_torch.kernels import (build, ops, ref, spike_conv,
                                 spike_gemm_bwd, spike_gemm_fused)

# the package exports the functions spike_gemm, lif_step and penc_compact
# (the JAX package's kernel API), so their binding modules are reached by
# their full names
spike_gemm = importlib.import_module("repro_torch.kernels.spike_gemm")
lif_kernel = importlib.import_module("repro_torch.kernels.lif_step")
penc_kernel = importlib.import_module("repro_torch.kernels.penc_compact")

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


#: (m, k, n): net-5's fc1-fc3, a ragged large K, the dense layers of the
#: dvs-conv and mnist-mlp cells, degenerate shapes and a large M.
SPLIT_SHAPES = [(64, 32768, 512), (64, 512, 256), (64, 256, 11),
                (70, 32768 + 37, 130), (64, 1024, 64), (64, 784, 128),
                (3, 1, 5), (5, 0, 7), (4096, 32768, 512)]


def _split_ranges(k, plan):
    """The [k0, k1) range of K each split of ``plan`` sums, in split order,
    as the kernels cut it (dense_split.cuh: split z takes slabs z*per ..
    z*per + per - 1 of the ceil(k / SLAB))."""
    splits, per = plan
    slab = spike_gemm.SLAB
    return [(min(k, p * per * slab), min(k, (p + 1) * per * slab))
            for p in range(splits)]


class TestSplitPlan:
    """The host side of the split-K dense kernels (spike_gemm.split_plan),
    which both the spike GEMM and the fused GEMM+LIF wrappers use."""

    @pytest.mark.parametrize("m,k,n", SPLIT_SHAPES)
    def test_splits_cover_k_once_in_order_on_whole_slabs(self, m, k, n):
        plan = spike_gemm.split_plan(m, n, k)
        ranges = _split_ranges(k, plan)
        assert len(ranges) == plan[0]
        assert ranges[0][0] == 0 and ranges[-1][1] == k
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        for k0, k1 in ranges:
            assert k0 % spike_gemm.SLAB == 0
            assert k1 == k or k1 % spike_gemm.SLAB == 0
            assert k1 > k0 or k == 0            # no split is empty

    def test_fc1_fills_a_wave(self):
        splits, per = spike_gemm.split_plan(64, 512, 32768)
        blocks = splits * (64 // spike_gemm.ROWS) * (512 // spike_gemm.COLS)
        assert 120 <= blocks <= spike_gemm.WAVE
        assert (splits, per) == (64, 16)

    @pytest.mark.parametrize("k", [1, 31, 32])
    @pytest.mark.parametrize("m,n", [(64, 512), (64, 11), (1, 1)])
    def test_one_split_where_k_is_one_slab(self, m, n, k):
        plan = spike_gemm.split_plan(m, n, k)
        assert plan == (1, 1)
        assert spike_gemm.workspace(m, n, plan, torch.device("cpu")) is None

    @pytest.mark.parametrize("k", [64, 256, 500, 512, 784, 1024, 32768])
    @pytest.mark.parametrize("m,n", [(64, 512), (64, 11), (1, 1), (200, 900)])
    def test_fewest_slabs_a_split_that_fit_one_wave(self, m, n, k):
        """Each split takes the fewest slabs for which the blocks fit in
        one wave: one slab for net-5's fc2 and fc3, whose few slabs would
        otherwise run one after another on a single block."""
        splits, per = spike_gemm.split_plan(m, n, k)
        slabs = -(-k // spike_gemm.SLAB)
        tiles = -(-m // spike_gemm.ROWS) * -(-n // spike_gemm.COLS)
        assert splits * tiles <= spike_gemm.WAVE
        assert per == 1 or -(-slabs // (per - 1)) * tiles > spike_gemm.WAVE
        if (m, n) == (64, 11) and k <= 1024:
            assert (splits, per) == (slabs, 1)

    @pytest.mark.parametrize("m,k,n", SPLIT_SHAPES)
    def test_workspace_is_splits_by_m_by_n_fp32(self, m, k, n):
        plan = spike_gemm.split_plan(m, n, k)
        ws = spike_gemm.workspace(m, n, plan, torch.device("cpu"))
        if plan[0] == 1:
            assert ws is None
        else:
            assert ws.shape == (plan[0], m, n)
            assert ws.dtype == torch.float32 and ws.is_contiguous()

    @pytest.mark.parametrize("m,k,n", [(8, 32768 + 37, 16), (5, 1000, 7)])
    def test_split_sums_in_split_order_equal_jax_on_grid(self, m, k, n):
        """The kernel's association (ascending k within a split, splits
        added in order) over the plan's ranges gives JAX's product exactly
        on grid operands."""
        rng = np.random.default_rng(4)
        s = _spikes(rng, (m, k), 0.2)
        w = _grid_weights(rng, (k, n), scale=0.05)
        total = np.zeros((m, n), np.float32)
        for k0, k1 in _split_ranges(
                k, spike_gemm.split_plan(m, n, k)):
            total = total + np.cumsum(
                s[:, k0:k1, None] * w[None, k0:k1], axis=1,
                dtype=np.float32)[:, -1]
        want = jref.spike_gemm_ref(jnp.asarray(s), jnp.asarray(w))
        np.testing.assert_array_equal(total, np.asarray(want))


#: (b, n, capacity) of penc_compact: net-5's five layer inputs at batch 64
#: (capacity N and the ECU's chunk), rows one short of, one past and three
#: tiles and 7 past a tile, N % 32 != 0, B = 1, 3, 257, capacities 0, 1,
#: N + 5 and 2 N, and the largest row the wrapper takes.
PENC_PLANS = [(64, 131072, 131072), (64, 131072, 100), (64, 32768, 32768),
              (64, 512, 512), (64, 256, 100), (4, 4095, 4095),
              (4, 4097, 4097), (3, 3 * 4096 + 7, 100), (1, 9000, 0),
              (3, 8192 + 31, 1), (257, 5000, 5005), (2, 12295, 2 * 12295),
              (5, 0, 3), (6, 31, 62), (7, 33, 0), (1, 2 ** 31 - 1, 100)]


def _penc_emulated(bits, capacity):
    """Both passes of csrc/penc_compact.cu on ``penc_plan``'s tiles, in
    NumPy: pass 1's bitmask (bit l of word j of a chunk is entry 4 l + j)
    and tile counts; pass 2's first slot from the tile counts before, the
    tile's addresses decoded from its words in chunk, lane, word order, and
    its share of the pad.  A row of one tile (penc_row_kernel) is the same
    round with no workspace.  Checks that each slot is written exactly
    once."""
    b, n = bits.shape
    plan = penc_kernel.penc_plan(b, n, capacity)
    chunk = penc_kernel.CHUNK
    chunks = -(-n // chunk)
    fired = np.zeros((b, chunks * chunk), bool)
    fired[:, :n] = bits > 0
    lane = np.arange(32, dtype=np.uint64)
    words = (fired.reshape(b, chunks, 32, 4).transpose(0, 1, 3, 2)
             .astype(np.uint64) << lane).sum(-1).astype(np.uint32)
    assert plan.one_launch or words.size == plan.mask_words
    spans = [plan.tile_range(t) for t in range(plan.tiles)]
    # a tile's chunks: the last tile's last chunk may reach past the row
    spans_c = [(lo // chunk, -(-hi // chunk)) for lo, hi in spans]
    popc = np.vectorize(lambda w: bin(int(w)).count("1"))
    tile_counts = np.array([[int(popc(words[r, c0:c1]).sum())
                             for c0, c1 in spans_c] for r in range(b)],
                           dtype=np.int64).reshape(b, plan.tiles)
    idx = np.zeros((b, capacity), np.int64)
    writes = np.zeros((b, capacity), np.int64)
    counts = tile_counts.sum(1)
    for r in range(b):
        for t, (c0, c1) in enumerate(spans_c):
            before, total = tile_counts[r, :t].sum(), counts[r]
            lo, hi = plan.pad_range(t)
            idx[r, max(lo, total):hi] = -1
            writes[r, max(lo, total):hi] += 1
            if before >= capacity:
                continue
            bit = (words[r, c0:c1, None, :] >> lane[None, :, None].astype(
                np.uint32)) & 1
            c, l, j = np.nonzero(bit)
            cols = chunk * (c0 + c) + 4 * l + j
            slots = before + np.arange(len(cols))
            keep = slots < capacity
            idx[r, slots[keep]] = cols[keep]
            writes[r, slots[keep]] += 1
    assert (writes == 1).all()
    return idx.astype(np.int32), counts.astype(np.int32)


class TestPencPlan:
    """The host side of the two-pass penc_compact kernels
    (penc_compact.penc_plan) and a plain emulation of both passes on it."""

    @pytest.mark.parametrize("b,n,capacity", PENC_PLANS)
    def test_tiles_cover_the_row_once_in_order(self, b, n, capacity):
        plan = penc_kernel.penc_plan(b, n, capacity)
        assert plan.tile % penc_kernel.ROUND == 0
        assert 1 <= plan.tiles <= penc_kernel.MAX_TILES
        spans = [plan.tile_range(t) for t in range(plan.tiles)]
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == c[0] for a, c in zip(spans, spans[1:]))
        assert all(hi > lo for lo, hi in spans) or n == 0
        assert b * plan.tiles < 2 ** 31

    @pytest.mark.parametrize("b,n,capacity", PENC_PLANS)
    def test_pad_ranges_partition_the_capacity(self, b, n, capacity):
        plan = penc_kernel.penc_plan(b, n, capacity)
        spans = [plan.pad_range(t) for t in range(plan.tiles)]
        assert spans[0][0] == 0 and spans[-1][1] == capacity
        assert all(a[1] == c[0] for a, c in zip(spans, spans[1:]))
        assert all(hi >= lo for lo, hi in spans)

    @pytest.mark.parametrize("b,n,capacity", PENC_PLANS)
    def test_one_launch_and_workspace_sizes(self, b, n, capacity):
        plan = penc_kernel.penc_plan(b, n, capacity)
        assert plan.one_launch == (n <= penc_kernel.ROUND)
        ws = (penc_kernel.workspace(plan, torch.device("meta"))
              if b * n < 2 ** 31 else None)
        if plan.one_launch:
            assert plan.mask_words == plan.count_words == 0 and ws is None
        else:
            assert plan.mask_words == b * 4 * -(-n // penc_kernel.CHUNK)
            assert plan.count_words == b * plan.tiles
            assert ws is None or (ws.dtype == torch.int32 and ws.numel() ==
                                  plan.mask_words + plan.count_words)

    def test_net5_inputs_fill_the_card(self):
        """conv2's input runs two waves of 1,024 blocks' worth over 132
        SMs; conv1's and fc1's 512 blocks; fc2's and fc3's one launch."""
        assert penc_kernel.penc_plan(64, 131072, 131072).tiles * 64 == 2048
        assert penc_kernel.penc_plan(64, 32768, 100).tiles * 64 == 512
        assert penc_kernel.penc_plan(64, 512, 512).one_launch
        assert penc_kernel.penc_plan(64, 256, 256).one_launch

    @pytest.mark.parametrize("shape,density", [
        ((3, 3 * 4096 + 7), 0.3), ((2, 4097), 1.0), ((4, 8192 + 31), 0.05),
        ((3, 33), 0.5), ((2, 4095), 0.0)])
    @pytest.mark.parametrize("extra", [0, 1, 100, "n", "n+5", "2n"])
    def test_two_passes_equal_the_plain_version(self, shape, density, extra):
        n = shape[1]
        capacity = {"n": n, "n+5": n + 5, "2n": 2 * n}.get(extra, extra)
        bits = _spikes(np.random.default_rng(n), shape, density)
        idx, cnt = _penc_emulated(bits, capacity)
        want_idx, want_cnt = ref.penc_compact_ref(_t(bits), capacity)
        np.testing.assert_array_equal(idx, want_idx.numpy())
        np.testing.assert_array_equal(cnt, want_cnt.numpy())

    @pytest.mark.parametrize("shape,capacity", [((3, 3 * 4096 + 7), 100),
                                                ((2, 8192 + 31), 1),
                                                ((5, 33), 40)])
    def test_two_passes_equal_jax(self, shape, capacity):
        bits = _spikes(np.random.default_rng(5), shape, 0.2)
        idx, cnt = _penc_emulated(bits, capacity)
        jidx, jcnt = jops.penc_compact(jnp.asarray(bits), capacity=capacity)
        np.testing.assert_array_equal(idx, np.asarray(jidx))
        np.testing.assert_array_equal(cnt, np.asarray(jcnt))

    def test_tiles_of_several_rounds_equal_the_plain_version(self):
        """A row of more than MAX_TILES rounds takes tiles of two rounds."""
        n = (penc_kernel.MAX_TILES + 1) * penc_kernel.ROUND + 5
        assert penc_kernel.penc_plan(1, n, 100).tile == 2 * penc_kernel.ROUND
        bits = _spikes(np.random.default_rng(8), (1, n), 0.01)
        for capacity in (100, n):
            idx, cnt = _penc_emulated(bits, capacity)
            want_idx, want_cnt = ref.penc_compact_ref(_t(bits), capacity)
            np.testing.assert_array_equal(idx, want_idx.numpy())
            np.testing.assert_array_equal(cnt, want_cnt.numpy())

    @pytest.mark.parametrize("cut", [4096, 4096 - 1, 4096 + 1, 2 * 4096])
    def test_count_reaching_capacity_at_a_tile_boundary(self, cut):
        """Every entry fires: the cut falls exactly on the end of tile 0
        (capacity 4096), just inside it, just past it, or on tile 1's end;
        tiles from the one holding slot `capacity` on write no address."""
        bits = np.ones((2, 3 * 4096 + 7), np.float32)
        bits[1, ::3] = 0.0
        idx, cnt = _penc_emulated(bits, cut)
        want_idx, want_cnt = ref.penc_compact_ref(_t(bits), cut)
        np.testing.assert_array_equal(idx, want_idx.numpy())
        np.testing.assert_array_equal(cnt, want_cnt.numpy())

    def test_values_other_than_zero_and_one(self):
        """> 0 fires: 0.5, 2 and inf do; 0, -0.0, -1 and NaN do not."""
        rng = np.random.default_rng(6)
        vals = np.array([0.0, -0.0, -1.0, np.nan, 0.5, 2.0, np.inf],
                        np.float32)
        bits = vals[rng.integers(0, len(vals), (3, 4096 + 129))]
        idx, cnt = _penc_emulated(bits, 4096 + 129)
        want_idx, want_cnt = ref.penc_compact_ref(_t(bits), 4096 + 129)
        np.testing.assert_array_equal(idx, want_idx.numpy())
        np.testing.assert_array_equal(cnt, want_cnt.numpy())


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
        # the sum as the card's kernel takes it: each output adds its
        # terms one at a time in fp32, in ascending (dy, dx, c)
        patches = spike_conv.conv_patches(_t(x), 3, 3, stride,
                                          padding).numpy()
        terms = patches[:, :, None] * w.reshape(-1, w.shape[-1])[None]
        walked = np.cumsum(terms, axis=1, dtype=np.float32)[:, -1]
        np.testing.assert_array_equal(walked.reshape(want.shape), want)

    @pytest.mark.parametrize("stride", [1, 2])
    @pytest.mark.parametrize("padding", ["SAME", "VALID"])
    @pytest.mark.parametrize("kernel", [2, 3])
    @pytest.mark.parametrize("cin", [3, 33])
    @pytest.mark.parametrize("cout", [5, 33])
    def test_col2im_is_the_vjp_of_patches(self, stride, padding, kernel,
                                          cin, cout):
        """``conv_col2im`` against ``jax.vjp`` of the JAX package's
        ``conv_patches``, exact on a patch-space cotangent on a grid (at
        most KH*KW terms meet in one input element)."""
        rng = np.random.default_rng(kernel * 100 + cin + cout)
        x = _spikes(rng, (2, 9, 8, cin), 0.3)
        patches, vjp = jax.vjp(lambda a: jconv.conv_patches(
            a, kernel, kernel, stride, padding), jnp.asarray(x))
        d_p = _grid_weights(rng, patches.shape)
        (want,) = vjp(jnp.asarray(d_p))
        got = spike_conv.conv_col2im(_t(d_p), x.shape, kernel, kernel,
                                     stride, padding)
        assert got.is_contiguous() and got.shape == x.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_rejects_mismatched_flags_and_channels(self):
        x, w = torch.zeros(1, 6, 6, 2), torch.zeros(3, 3, 2, 4)
        with pytest.raises(ValueError, match="tile grid"):
            ops.spike_conv(x, w, flags=torch.zeros(9, 9, dtype=torch.int32))
        with pytest.raises(ValueError, match="input channels"):
            ops.spike_conv(x, torch.zeros(3, 3, 5, 4))


#: (B, H, W, C, F, kernel, stride, padding): net-5's conv1 and conv2, the
#: dvs-conv cell's two convs, and ragged layers.
CONV_LAYERS = [(64, 128, 128, 2, 32, 3, 1, "SAME"),
               (64, 64, 64, 32, 32, 3, 1, "SAME"),
               (64, 32, 32, 2, 8, 3, 1, "SAME"),
               (64, 16, 16, 8, 16, 3, 1, "SAME"),
               (3, 17, 15, 33, 33, 3, 2, "SAME"),
               (2, 9, 7, 3, 5, 2, 2, "VALID"),
               (1, 300, 5, 1, 1, 3, 1, "VALID")]


def _tiled_pixels(geo):
    """Output pixels (b, oh, ow) in the order the conv kernels' tiles walk
    them: tiles in raster order, each tile's pixels row by row, pixels past
    the output's edge left out (csrc/conv_halo.cuh:tile_at)."""
    b, _, _, _, oh, ow, *_, tr, tw, _ = geo
    for bi in range(b):
        for t0 in range(0, oh, tr):
            for u0 in range(0, ow, tw):
                yield [(bi, t0 + r, u0 + c) for r in range(tr)
                       for c in range(tw) if t0 + r < oh and u0 + c < ow]


class TestConvGeometry:
    """The host side of the conv kernels: the tile, the shared memory they
    are launched with, and what they refuse."""

    @pytest.mark.parametrize("layer", CONV_LAYERS)
    @pytest.mark.parametrize("dw", [False, True])
    def test_tiles_cover_every_output_pixel_once(self, layer, dw):
        b, h, w, c, f, k, stride, padding = layer
        geo = spike_conv.conv_geometry((b, h, w, c), (k, k, c, f), stride,
                                       padding, dw=dw)
        oh, ow, tr, tw = geo[4], geo[5], geo[12], geo[13]
        assert tr * tw <= max(spike_conv.TILE_PIXELS[
            "dw" if dw else "forward"])
        if not dw and spike_conv.uses_strips(k, stride):
            assert tw % spike_conv.STRIP == 0
        seen = np.zeros((b, oh, ow), np.int64)
        for tile in _tiled_pixels(geo):
            for pix in tile:
                seen[pix] += 1
        assert (seen == 1).all()

    def test_net5_tiles_and_shared_memory(self):
        """The largest tile whose block leaves room for three forward or two
        dW blocks in an SM.  Forward, on the strip kernel: four 128-pixel
        rows of conv1 a tile, two 64-pixel rows of conv2, whose block holds
        its 32 filters (36 KiB), a 4 x 66 halo and its masks; on the pixel
        kernel (stride 2, no tile fits three) the smallest tile, with the
        offsets of the 297 events in the halo and 8 warps' event lists.  dW:
        four rows of conv1, two of conv2, and a g row per pixel."""
        conv1 = spike_conv.conv_geometry((64, 128, 128, 2), (3, 3, 2, 32),
                                         1, "SAME")
        conv2 = spike_conv.conv_geometry((64, 64, 64, 32), (3, 3, 32, 32),
                                         1, "SAME")
        assert conv1[12:14] == (4, 128) and conv2[12:14] == (2, 64)
        assert conv1[-1] == 4 * (9 * 2 * 32 + 6 * 130 * 3)
        assert conv2[-1] == 4 * (9 * 32 * 32 + 4 * 66 * 33)
        assert 3 * (conv2[-1] + 1024) <= spike_conv.SM_SMEM
        ragged = spike_conv.conv_geometry((3, 17, 15, 33), (3, 3, 33, 33), 2,
                                          "SAME")
        assert ragged[12:14] == (8, 8) and ragged[-1] == 4 * (
            9 * 33 * 32 + 17 * 17 * 35 + 9 * 300)
        dw1 = spike_conv.conv_geometry((64, 128, 128, 2), (3, 3, 2, 32), 1,
                                       "SAME", dw=True)
        dw2 = spike_conv.conv_geometry((64, 64, 64, 32), (3, 3, 32, 32), 1,
                                       "SAME", dw=True)
        assert dw1[12:14] == (4, 128) and dw2[12:14] == (2, 64)
        assert dw2[-1] == 4 * (9 * 32 * 33 + 128 * 32 + 4 * 66 * 33)
        assert 2 * (dw2[-1] + 1024) <= spike_conv.SM_SMEM

    @pytest.mark.parametrize("shapes,match", [
        (((1, 8, 8, 512), (3, 3, 512, 4), 1, "SAME"), "shared memory"),
        (((1, 8, 8, 2), (3, 3, 2, 4), 0, "SAME"), "stride"),
        (((1, 2, 2, 2), (3, 3, 2, 4), 1, "VALID"), "no output"),
        (((2 ** 17, 128, 128, 2), (3, 3, 2, 4), 1, "SAME"), "32 bits"),
        (((1, 8, 8, 2), (3, 3, 2, 4), 1, "FULL"), "padding")])
    def test_refuses_what_the_kernels_cannot_take(self, shapes, match):
        with pytest.raises(ValueError, match=match):
            spike_conv.conv_geometry(*shapes)


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
        ops.spike_conv_bwd_dw(torch.ones(1, 5, 5, 2), torch.ones(1, 5, 5, 4),
                              kernel_size=(3, 3))
        ops.spike_conv_bwd_ds(torch.ones(1, 5, 5, 4), torch.ones(3, 3, 2, 4),
                              (1, 5, 5, 2))
        ops.spike_conv_train(torch.ones(1, 5, 5, 2).requires_grad_(),
                             torch.ones(3, 3, 2, 4).requires_grad_()
                             ).sum().backward()
        ops.lif_step(torch.zeros(8, 6), torch.zeros(8, 6), torch.ones(8, 6),
                     beta=0.9, threshold=1.0)
        ops.penc_compact(s, 16)
        m = torch.zeros(1, 5, 5, 4)
        u, _, pooled = ops.conv_lif_step(m.requires_grad_(), torch.zeros(4),
                                         m, m, beta=0.9, threshold=1.0,
                                         pool_window=2)
        (u.sum() + pooled.sum()).backward()
        assert ops.launch_counts() == {"spike_gemm": 0, "spike_gemm_lif": 0,
                                       "spike_conv": 0, "spike_gemm_dw": 0,
                                       "spike_gemm_ds": 0, "lif_step": 0,
                                       "penc_compact": 0, "conv_epilogue": 0}

    @pytest.mark.parametrize("launch", [
        lambda: spike_gemm.spike_gemm_cuda(
            torch.ones(4, 4), torch.ones(4, 4),
            torch.ones(1, 1, dtype=torch.int32)),
        lambda: spike_conv.spike_conv_cuda(
            torch.ones(1, 5, 5, 2), torch.ones(3, 3, 2, 4), 1, "SAME"),
        lambda: spike_gemm_bwd.spike_conv_dw_cuda(
            torch.ones(1, 5, 5, 2), torch.ones(1, 5, 5, 4), 3, 3, 1,
            "SAME"),
        lambda: spike_gemm_fused.spike_gemm_lif_cuda(
            torch.ones(4, 4), torch.ones(4, 4), torch.ones(4),
            torch.ones(4, 4), torch.ones(4, 4),
            torch.ones(1, 1, dtype=torch.int32), beta=0.9, threshold=1.0),
        lambda: spike_gemm_bwd.spike_gemm_dw_cuda(
            torch.ones(4, 4), torch.ones(4, 4)),
        lambda: spike_gemm_bwd.spike_gemm_ds_cuda(
            torch.ones(4, 4), torch.ones(4, 4)),
        lambda: lif_kernel.lif_step_cuda(
            torch.ones(4, 4), torch.ones(4, 4), torch.ones(4, 4), beta=0.9,
            threshold=1.0),
        lambda: penc_kernel.penc_compact_cuda(torch.ones(4, 4), 4),
        lambda: spike_gemm_bwd.spike_conv_ds_cuda(
            torch.ones(1, 5, 5, 4), torch.ones(3, 3, 2, 4), (1, 5, 5, 2), 1,
            "SAME"),
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
        for macro, key in (("BM", "block_m"), ("BK", "block_k")):
            assert f"-D{macro}={build.TILE[key]}" in flags
