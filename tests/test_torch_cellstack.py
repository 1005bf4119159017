"""The port's stacked-cell trainer (``repro_torch.distributed.cellstack``)
and the cell axis of its kernels, on the CPU.

The load-bearing property is the bit-exactness contract: a cell trained in
a slab publishes the artifact a solo ``TraceCache.resolve`` trains (params,
traces, accuracy equal with ``assert_array_equal``), on every backend and
both datapaths (rate-coded MLP, event-driven conv).  One stacked train step
is held against ``jax.vmap`` of the JAX package's train step, to the
tolerance that ``test_torch_train.py::test_train_step_matches_jitted_jax``
states for one cell.  The cell-axis ops are held against the solo ops cell
by cell on grid operands, and the port's grouping of jobs against the JAX
package's.  The workloads are the JAX package's own stack tests' tiny ones
(``tests/test_cellstack.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.core import lif as jlif
from repro.core import snn as jsnn
from repro.core import train_snn as jtrain
from repro.core import workloads as jworkloads
from repro.distributed import cellfarm as jcellfarm
from repro.distributed import cellstack as jcellstack
from repro_torch import convert, optim
from repro_torch.core import lif, snn, train_snn, workloads
from repro_torch.core.workloads.cache import cell_key
from repro_torch.distributed import cellfarm, cellstack
from repro_torch.kernels import ops, ref

torch.set_num_threads(2)

GRID = 2.0 ** -8
CELLS = 3


def _mlp(mod_wl=workloads, mod_snn=snn, name="stack-mlp", **kw):
    base = dict(name=name, layers=(mod_snn.Dense(12),), pcr=1,
                input_shape=(12, 12), n_train=96, n_test=32,
                train_steps=4, batch_size=32, trace_samples=16)
    base.update(kw)
    return dataclasses.replace(mod_wl.get("mnist-mlp"), **base)


def _conv(mod_wl=workloads, mod_snn=snn, name="stack-conv", **kw):
    base = dict(name=name, layers=(mod_snn.Conv(2, 3), mod_snn.MaxPool(2),
                                   mod_snn.Dense(6)),
                input_shape=(8, 8, 2), num_classes=4, pcr=1,
                n_train=64, n_test=16, train_steps=3, batch_size=16,
                trace_samples=8)
    base.update(kw)
    return dataclasses.replace(mod_wl.get("dvs-conv"), **base)


def _job(wl, T=2, pop=1.0, seed=0, farm=cellfarm):
    return farm.CellJob(workload=wl,
                        assignment={"num_steps": T, "population": pop},
                        seed=seed)


def _cache(path):
    return workloads.TraceCache(root=str(path), device="cpu")


def _assert_same_cell(a, b):
    assert len(a.params) == len(b.params)
    for pa, pb in zip(a.params, b.params):
        assert pa.keys() == pb.keys()
        for k in pa:
            np.testing.assert_array_equal(pa[k], pb[k])
    assert len(a.counts) == len(b.counts)
    for ca, cb in zip(a.counts, b.counts):
        np.testing.assert_array_equal(ca, cb)
    assert a.accuracy == b.accuracy
    assert a.quant_acc == b.quant_acc


class TestStackedSoloParity:
    @pytest.mark.parametrize("backend", snn.MATMUL_BACKENDS)
    @pytest.mark.parametrize("make_wl", [_mlp, _conv], ids=["mlp", "conv"])
    def test_stacked_equals_solo_bit_for_bit(self, tmp_path, make_wl,
                                             backend):
        """Stack-train 2 cells, then train the same recipes solo into a
        fresh root: params, per-layer trace counts and accuracy are equal,
        and the stacked root serves the solo recipe as a hit."""
        wl = dataclasses.replace(make_wl(), matmul_backend=backend)
        T = 3 if make_wl is _conv else 2
        jobs = [dataclasses.replace(_job(wl, T=T, seed=s), quant_bits=(4,))
                for s in (0, 1)]
        stack_cache = _cache(tmp_path / "stack")
        stats = {}
        outcomes = cellstack.resolve_stacked(jobs, stack_cache.root,
                                             cache=stack_cache, stats=stats)
        assert [o.trained for o in outcomes] == [True, True]
        assert stats["cells"] == 2 and stats["train_seconds"] > 0
        assert stack_cache.stats == {"hits": 0, "misses": 2}

        solo_cache = _cache(tmp_path / "solo")
        for job in jobs:
            solo = solo_cache.resolve(job.workload, job.assignment,
                                      seed=job.seed, quant_bits=(4,))
            assert not solo.cache_hit
            stacked = stack_cache.resolve(job.workload, job.assignment,
                                          seed=job.seed, quant_bits=(4,))
            assert stacked.cache_hit
            _assert_same_cell(solo, stacked)
        assert stack_cache.stats == {"hits": 2, "misses": 2}


class TestResolveStacked:
    def test_cached_cells_resolve_without_training(self, tmp_path):
        wl = _mlp()
        cache = _cache(tmp_path)
        pre = _job(wl, seed=0)
        cache.resolve(pre.workload, pre.assignment, seed=pre.seed)
        stats = {}
        outcomes = cellstack.resolve_stacked(
            [pre, _job(wl, seed=1)], cache.root, cache=cache, stats=stats)
        assert [o.trained for o in outcomes] == [False, True]
        assert stats["cells"] == 1                    # only the miss trained
        assert outcomes[0].key == cell_key(wl, pre.assignment, 0)

    def test_max_stack_slabs_one_large_group(self, tmp_path):
        """A group larger than max_stack trains in slabs, and slab
        membership never leaks into a cell."""
        wl = _mlp()
        jobs = [_job(wl, seed=s) for s in range(3)]
        a, b = _cache(tmp_path / "a"), _cache(tmp_path / "b")
        stats = {}
        out_a = cellstack.resolve_stacked(jobs, a.root, cache=a, max_stack=2,
                                          stats=stats)
        out_b = cellstack.resolve_stacked(jobs, b.root, cache=b)
        assert all(o.trained for o in out_a + out_b)
        assert stats["cells"] == 3
        for job in jobs:
            _assert_same_cell(
                a.resolve(job.workload, job.assignment, seed=job.seed),
                b.resolve(job.workload, job.assignment, seed=job.seed))

    def test_mixed_signatures_resolve_in_job_order(self, tmp_path):
        wl = _mlp()
        jobs = [_job(wl, T=3, seed=0), _job(wl, T=2, seed=0),
                _job(wl, T=2, seed=1)]
        cache = _cache(tmp_path)
        outcomes = cellstack.resolve_stacked(jobs, cache.root, cache=cache)
        assert all(o.trained for o in outcomes)
        assert [o.key for o in outcomes] == [
            cell_key(j.workload, j.assignment, j.seed) for j in jobs]

    def test_publish_charges_the_budget_and_a_second_publish_is_a_hit(
            self, tmp_path):
        wl = _mlp()
        job = _job(wl, seed=0)
        solo = _cache(tmp_path / "solo").resolve(wl, job.assignment)
        cache = _cache(tmp_path / "pub")
        budget = workloads.TrainingBudget(1)
        kw = dict(params=solo.params, counts=solo.counts,
                  accuracy=solo.accuracy, budget=budget)
        first = cache.publish(wl, job.assignment, **kw)
        again = cache.publish(wl, job.assignment, **kw)
        assert (first.cache_hit, again.cache_hit) == (False, True)
        assert budget.spent == 1 and cache.stats == {"hits": 1, "misses": 1}
        _assert_same_cell(solo, cache.resolve(wl, job.assignment))


class TestSignatures:
    """The port groups a job list exactly as the JAX package does."""

    @staticmethod
    def _variants(mod_wl, mod_snn, mod_lif, backends):
        wl = _mlp(mod_wl, mod_snn, matmul_backend=backends[0])
        same = [dataclasses.replace(wl, name="stack-mlp-b", data_seed=17,
                                    noise=0.35, n_train=64)]
        split = [dataclasses.replace(wl, train_steps=5),
                 dataclasses.replace(wl, lr=1e-3),
                 dataclasses.replace(wl, batch_size=16),
                 dataclasses.replace(wl, n_test=16),
                 dataclasses.replace(wl, trace_samples=8),
                 dataclasses.replace(wl, matmul_backend=backends[1]),
                 dataclasses.replace(wl, layers=(mod_snn.Dense(16),)),
                 dataclasses.replace(wl, layers=(
                     mod_snn.Dense(12, lif=mod_lif.LIFParams(beta=0.8)),))]
        return wl, same, split

    @staticmethod
    def _jobs(farm, wl, same, split):
        jobs = [_job(wl, seed=0, farm=farm), _job(wl, seed=3, farm=farm),
                _job(wl, T=3, farm=farm), _job(wl, pop=0.5, farm=farm)]
        jobs += [_job(v, seed=1, farm=farm) for v in same + split]
        jobs += [_job(wl, T=3, seed=5, farm=farm)]
        return jobs

    def test_group_jobs_partitions_as_the_jax_package(self):
        port = self._jobs(cellfarm, *self._variants(
            workloads, snn, lif, ("spike_gemm_fused", "torch")))
        jax_ = self._jobs(jcellfarm, *self._variants(
            jworkloads, jsnn, jlif, ("spike_gemm_fused", "jnp")))
        got = sorted(map(sorted, cellstack.group_jobs(port).values()))
        want = sorted(map(sorted, jcellstack.group_jobs(jax_).values()))
        assert got == want
        # seeds and the dataset shard share a group; the rest split
        assert [0, 1, 4] in got and [2, 13] in got
        assert len(got) == 2 + 1 + 8
        for idxs in cellstack.group_jobs(port).values():
            assert idxs == sorted(idxs)              # order-preserving


# ---- one stacked train step against jax.vmap of the JAX package's ---------

T = 6
BATCH = 4
JAX_BACKEND = {"torch": "jnp", "spike_gemm": "spike_gemm",
               "spike_gemm_fused": "spike_gemm_fused"}


def _configs(kind):
    """One small topology as a JAX and a port ``SNNConfig``, at
    ``beta = 0.5`` (every membrane exact on grid weights)."""
    cfgs = []
    for mod, lp in ((jsnn, jlif.LIFParams), (snn, lif.LIFParams)):
        p = lp(beta=0.5)
        if kind == "mlp":
            layers = (mod.Dense(24, p), mod.Dense(8, p))
            cfgs.append(mod.SNNConfig("mlp", (30,), layers, num_classes=4,
                                      pcr=2, num_steps=T))
        else:
            layers = (mod.Conv(4, 3, lif=p), mod.MaxPool(2),
                      mod.Dense(8, p))
            cfgs.append(mod.SNNConfig("conv", (8, 8, 2), layers,
                                      num_classes=4, pcr=2, num_steps=T))
    return cfgs


def _cells(kind):
    """Per cell: grid params from the JAX package's init (NumPy), one
    batch and labels.  The MLP gets binary images, whose rate code draws
    no bit that matters (u < 0 never holds, u < 1 always does), so both
    packages encode the same train; the conv net gets events."""
    jcfg, tcfg = _configs(kind)
    rng = np.random.default_rng(7)
    cells = []
    for c in range(CELLS):
        npp = [{k: (np.round((np.asarray(v) * 2.5 + 0.05 * (k == "b"))
                             / GRID) * GRID).astype(np.float32)
                for k, v in p.items()}
               for p in jsnn.init_params(jax.random.key(c), jcfg)]
        shape = (BATCH, 30) if kind == "mlp" else (BATCH, T, 8, 8, 2)
        x = (rng.random(shape) < (0.3 + 0.1 * c)).astype(np.float32)
        y = rng.integers(0, 4, size=BATCH).astype(np.int32)
        cells.append((npp, x, y))
    return jcfg, tcfg, cells


def _close_to_max(got, want, rtol):
    """Each leaf within ``rtol`` of the leaf's max |value|."""
    for g, w in zip(got, want):
        for key in w:
            a, b = np.asarray(g[key]), np.asarray(w[key])
            np.testing.assert_allclose(
                a, b, rtol=0, atol=rtol * max(np.abs(b).max(), 1e-30),
                err_msg=key)


@pytest.mark.parametrize("kind,backend", [("mlp", "torch"),
                                          ("mlp", "spike_gemm_fused"),
                                          ("conv", "spike_gemm_fused")])
def test_stacked_train_step_matches_vmapped_jax(kind, backend):
    """One ``make_stacked_train_step`` of 3 cells against
    ``jax.jit(jax.vmap(step))`` of the JAX package's
    ``train_snn.make_train_step`` on the same NumPy params and batches:
    each cell's loss to rtol 1e-6, its gradients and new parameters to
    1e-5 of each leaf's max |value| (the tolerance of one cell's step
    against jitted JAX: XLA contracts the surrogate and Adam into FMAs)."""
    jcfg, tcfg, cells = _cells(kind)
    jb = JAX_BACKEND[backend]
    jstack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
    jp = jstack([[{k: jnp.asarray(v) for k, v in p.items()} for p in npp]
                 for npp, _, _ in cells])
    xs = np.stack([x for _, x, _ in cells])
    ys = np.stack([y for _, _, y in cells])
    keys = jax.random.split(jax.random.key(1), CELLS)
    jloss = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p, k, x, y: jtrain.loss_fn(jcfg, p, k, x, y,
                                          matmul_backend=jb))))
    jl, jgrads = jloss(jp, keys, jnp.asarray(xs), jnp.asarray(ys))
    jtx = joptim.adam(2e-3)
    jstate = jstack([jtx.init(jax.tree.map(lambda v: v[c], jp))
                     for c in range(CELLS)])
    jnew, _, jl2 = jax.jit(jax.vmap(jtrain.make_train_step(jcfg, jtx, jb)))(
        jp, jstate, keys, jnp.asarray(xs), jnp.asarray(ys))
    np.testing.assert_array_equal(np.asarray(jl2), np.asarray(jl))

    tp = cellstack.stack_params([convert.params_from_numpy(npp, "cpu")
                                 for npp, _, _ in cells])
    gens = [torch.Generator().manual_seed(1) for _ in range(CELLS)]
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    leaves = [{k: v.clone().requires_grad_() for k, v in p.items()}
              for p in tp]
    losses = train_snn.stacked_loss_fn(tcfg, leaves, gens, x, y,
                                       matmul_backend=backend)
    flat = [v for p in leaves for v in p.values()]
    it = iter(torch.autograd.grad(losses.sum(), flat))
    grads = [{k: next(it).numpy() for k in p} for p in leaves]
    tx = optim.adam(2e-3)
    new, state, losses2 = train_snn.make_stacked_train_step(
        tcfg, tx, backend)(tp, tx.init(tp), gens, x, y)

    assert losses.shape == (CELLS,) and float(losses.detach().min()) > 0.1
    np.testing.assert_array_equal(losses2.numpy(), losses.detach().numpy())
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(jl),
                               rtol=1e-6)
    assert int(state[0].count) == 1
    newn = convert.params_to_numpy(new)
    for c in range(CELLS):
        cell = lambda tree: [{k: np.asarray(v)[c] for k, v in p.items()}
                             for p in tree]
        _close_to_max(cell(grads), cell(jgrads), 1e-5)
        _close_to_max(cell(newn), cell(jnew), 1e-5)


@pytest.mark.parametrize("kind", ["mlp", "conv"])
@pytest.mark.parametrize("backend", snn.MATMUL_BACKENDS)
def test_stacked_train_step_is_each_cells_solo_step(kind, backend):
    """Cell by cell, the stacked step is the solo step bit for bit: loss,
    new params and Adam moments."""
    _, tcfg, cells = _cells(kind)
    tx = optim.adam(2e-3)
    tp = cellstack.stack_params([convert.params_from_numpy(npp, "cpu")
                                 for npp, _, _ in cells])
    gens = [torch.Generator().manual_seed(c) for c in range(CELLS)]
    x = torch.from_numpy(np.stack([x for _, x, _ in cells]))
    y = torch.from_numpy(np.stack([y for _, _, y in cells]))
    new, state, losses = train_snn.make_stacked_train_step(
        tcfg, tx, backend)(tp, tx.init(tp), gens, x, y)
    step = train_snn.make_train_step(tcfg, tx, backend)
    for c, (npp, xc, yc) in enumerate(cells):
        p = convert.params_from_numpy(npp, "cpu")
        solo, solo_state, loss = step(p, tx.init(p), torch.Generator()
                                      .manual_seed(c), torch.from_numpy(xc),
                                      torch.from_numpy(yc))
        assert torch.equal(losses[c], loss)
        for a, b in zip(new, solo):
            for k in b:
                assert torch.equal(a[k][c], b[k])
        for a, b in zip(state[0].mu + state[0].nu,
                        solo_state[0].mu + solo_state[0].nu):
            for k in b:
                assert torch.equal(a[k][c], b[k])


# ---- the cell axis of the ops, on the CPU's plain versions ----------------

def _grid(rng, shape, scale=0.5):
    return torch.from_numpy((np.round(rng.normal(scale=scale, size=shape)
                                      / GRID) * GRID).astype(np.float32))


def _spike_cells(rng, shape):
    """One spike tensor per cell, each at its own density."""
    return torch.stack([torch.from_numpy(
        (rng.random(shape) < d).astype(np.float32))
        for d in (0.0, 0.1, 0.4)])


def _grads(fn, args, cots):
    targs = [a.clone().requires_grad_() for a in args]
    outs = fn(*targs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return list(outs) + list(torch.autograd.grad(outs, targs, cots))


class TestCellAxisOps:
    """A slab of 3 cells through each op equals each cell through the solo
    op bit for bit (grid operands, M and B not multiples of 32)."""

    @pytest.mark.parametrize("m,k,n", [(45, 70, 9), (64, 100, 33)])
    def test_dense_forward_and_backward(self, m, k, n):
        rng = np.random.default_rng(m + k)
        s = _spike_cells(rng, (m, k))
        w = _grid(rng, (CELLS, k, n))
        g = _grid(rng, (CELLS, m, n), 1.0)
        flags = ops.block_flags(s)
        out = ops.spike_gemm(s, w, flags=flags)
        dw = ops.spike_gemm_bwd_dw(s, g, flags=flags)
        ds = ops.spike_gemm_bwd_ds(g, w, gflags=ops.cotangent_block_flags(g))
        for c in range(CELLS):
            assert torch.equal(flags[c], ops.block_flags(s[c]))
            assert torch.equal(out[c], ops.spike_gemm(s[c], w[c]))
            assert torch.equal(dw[c], ops.spike_gemm_bwd_dw(s[c], g[c]))
            assert torch.equal(ds[c], ops.spike_gemm_bwd_ds(g[c], w[c]))
            assert torch.equal(out[c], ref.spike_gemm_ref(s[c], w[c]))
        assert int(flags[0].sum()) == 0             # an idle cell skips all

    def test_flags_never_mix_two_cells(self):
        """B = 40: a cell's last tile row is padded inside the cell, so a
        silent cell's flags stay 0 next to a busy one."""
        s = torch.zeros(2, 40, 64)
        s[1] = 1.0
        flags = ops.block_flags(s)
        assert flags.shape == (2, 2, 2)
        assert int(flags[0].sum()) == 0 and int(flags[1].sum()) == 4
        g = torch.zeros(2, 40, 64)
        g[0, 39, 63] = -1.0
        assert ops.cotangent_block_flags(g)[1].sum() == 0
        assert ops.cotangent_block_flags(g)[0, 1, 1] == 1

    @pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "VALID")])
    def test_conv_forward_and_backward(self, stride, padding):
        rng = np.random.default_rng(stride)
        x = _spike_cells(rng, (3, 9, 11, 4))
        w = _grid(rng, (CELLS, 3, 3, 4, 5))
        conv = dict(stride=stride, padding=padding)
        out = ops.spike_conv(x, w, **conv)
        g = _grid(rng, tuple(out.shape), 1.0)
        dw = ops.spike_conv_bwd_dw(x, g, kernel_size=(3, 3), **conv)
        ds = ops.spike_conv_bwd_ds(g, w, tuple(x.shape), **conv)
        for c in range(CELLS):
            assert torch.equal(out[c], ops.spike_conv(x[c], w[c], **conv))
            assert torch.equal(dw[c], ops.spike_conv_bwd_dw(
                x[c], g[c], kernel_size=(3, 3), **conv))
            assert torch.equal(ds[c], ops.spike_conv_bwd_ds(
                g[c], w[c], tuple(x[c].shape), **conv))

    @pytest.mark.parametrize("which", ["gemm", "conv", "fused-subtract",
                                       "fused-zero"])
    def test_train_functions(self, which):
        """The three autograd Functions: outputs and every input gradient
        (the fused step's bias gradient reduced per cell)."""
        rng = np.random.default_rng(3)
        if which == "gemm":
            args = [_spike_cells(rng, (45, 60)), _grid(rng, (CELLS, 60, 9))]
            fn = ops.spike_gemm_train
        elif which == "conv":
            args = [_spike_cells(rng, (2, 8, 8, 3)),
                    _grid(rng, (CELLS, 3, 3, 3, 6))]
            fn = ops.spike_conv_train
        else:
            reset = which.split("-")[1]
            args = [_spike_cells(rng, (45, 60)), _grid(rng, (CELLS, 60, 9)),
                    _grid(rng, (CELLS, 9)), _grid(rng, (CELLS, 45, 9), 1.0),
                    _spike_cells(rng, (45, 9))]
            fn = lambda *a: ops.spike_gemm_lif_step(
                *a, beta=0.5, threshold=1.0, reset_mechanism=reset)
        outs = fn(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        cots = [_grid(rng, tuple(o.shape), 1.0) for o in outs]
        stacked = _grads(fn, args, cots)
        for c in range(CELLS):
            solo = _grads(fn, [a[c] for a in args], [t[c] for t in cots])
            for a, b in zip(stacked, solo):
                assert torch.equal(a[c], b)
