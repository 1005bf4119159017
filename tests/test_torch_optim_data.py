"""The port's optimizers, schedules and LM data pipeline against the JAX
package's (repro.optim, repro.data.pipeline), on the CPU.

The reference's transforms run eagerly here, one XLA op at a time, so no
multiply-add is contracted; the port takes its float32 square roots
correctly rounded (``optimizers._sqrt``).  Elementwise arithmetic is then
equal bit for bit; what differs is the order of a reduction's sums (the
global norm, Adafactor's means) and an ulp of ``pow`` and ``cos``, so the
updates are held to ``RTOL`` (1e-6 relative, of each leaf's largest
|value|).  Every update leaf's dtype is the reference's, bf16 leaves
included: JAX widens a bf16 leaf that meets a float32 scalar, PyTorch
would not, and the port widens it by hand.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.data import pipeline as jpipeline
from repro_torch import optim
from repro_torch.data import pipeline
from repro_torch.optim import optimizers
from repro_torch.tree import leaves, tree_map, unflatten

torch.set_num_threads(2)

RTOL = 1e-6


def _quadratic(dim=8, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((dim, dim))
    A = A @ A.T / dim + np.eye(dim)
    b = rng.standard_normal(dim)
    w_star = np.linalg.solve(A, b)
    A, b = torch.tensor(A, dtype=torch.float32), torch.tensor(
        b, dtype=torch.float32)
    return (lambda w: A @ w - b), w_star


class TestOptimizers:
    @pytest.mark.parametrize("make_tx,lr,steps,tol", [
        (lambda lr: optim.sgd(lr), 0.1, 300, 1e-2),
        (lambda lr: optim.sgd(lr, momentum=0.9), 0.05, 300, 1e-2),
        (lambda lr: optim.adam(lr), 0.1, 500, 1e-2),
        (lambda lr: optim.adamw(lr, weight_decay=0.0), 0.1, 500, 5e-2),
        (lambda lr: optim.adafactor_lite(lr), 0.3, 800, 2e-1),
    ])
    def test_converges_on_quadratic(self, make_tx, lr, steps, tol):
        grad, w_star = _quadratic()
        tx = make_tx(lr)
        w = torch.zeros(8)
        state = tx.init(w)
        for _ in range(steps):
            updates, state = tx.update(grad(w), state, w)
            w = optim.apply_updates(w, updates)
        assert np.linalg.norm(w.numpy() - w_star) < tol * (
            1 + np.linalg.norm(w_star))

    def test_clip_by_global_norm(self):
        tx = optim.clip_by_global_norm(1.0)
        g = {"a": torch.full((4,), 10.0), "b": torch.full((3,), -10.0)}
        clipped, _ = tx.update(g, tx.init(g), None)
        assert float(optim.global_norm(clipped)) <= 1.0 + 1e-5

    def test_weight_decay_changes_updates(self):
        grad, _ = _quadratic()
        w = torch.ones(8)
        tx0 = optim.adamw(0.1, weight_decay=0.0)
        tx1 = optim.adamw(0.1, weight_decay=0.5)
        u0, _ = tx0.update(grad(w), tx0.init(w), w)
        u1, _ = tx1.update(grad(w), tx1.init(w), w)
        assert not torch.allclose(u0, u1)

    def test_weight_decay_needs_params(self):
        tx = optim.adamw(0.1)
        g = {"w": torch.ones(3)}
        with pytest.raises(ValueError):
            tx.update(g, tx.init(g), None)

    def test_adafactor_state_is_factored(self):
        tx = optim.adafactor_lite(1e-2)
        params = {"w": torch.zeros((64, 32)), "b": torch.zeros((32,)),
                  "stacked": torch.zeros((3, 64, 32))}
        state = tx.init(params)
        assert state.row["w"].shape == (64,)
        assert state.col["w"].shape == (32,)
        assert state.full["b"].shape == (32,)
        assert state.row["stacked"].shape == (3, 64)
        assert state.col["stacked"].shape == (3, 32)
        assert state.full["w"].shape == state.row["b"].shape == ()

    def test_schedules(self):
        s = optim.linear_warmup_cosine(1.0, warmup_steps=10, total_steps=100)
        assert float(s(0)) == 0.0
        assert float(s(10)) == pytest.approx(1.0, abs=1e-6)
        assert float(s(100)) == pytest.approx(0.0, abs=1e-6)
        assert float(s(5)) == pytest.approx(0.5, abs=1e-6)

    def test_exports_the_reference_api(self):
        assert set(joptim.__all__) <= set(optim.__all__)
        assert set(optim.__all__) - set(joptim.__all__) == {"AdamState",
                                                            "ScaleState"}


# ---------------------------------------------------------------------------
# Each transform against the reference on the same trees
# ---------------------------------------------------------------------------

_SHAPES = {"w": ((6, 5), "float32"), "b": ((5,), "bfloat16"),
           "stack": ((2, 3, 4), "float32"), "e": ((4, 3), "bfloat16"),
           "nested": {"s": ((7,), "float32")}}


def _draw(rng, shapes=_SHAPES, scale=1.0):
    """A tree of NumPy float32 arrays on the bf16 grid where the leaf is
    bf16, and the tree's dtypes."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        shape, dtype = node
        x = (rng.standard_normal(shape) * scale).astype(np.float32)
        if dtype == "bfloat16":
            x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
        return x, dtype

    return walk(shapes)


def _jax(tree):
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    x, dtype = tree
    return jnp.asarray(x, dtype)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    x, dtype = tree
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _close(got, want, tol=RTOL):
    g, w = leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert str(a.dtype).split(".")[1] == str(b.dtype), (a.dtype, b.dtype)
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.float().numpy(), b, rtol=0,
                                   atol=tol * max(np.abs(b).max(), 1e-30))


def _decay_mask(params):
    return {k: (k != "b") if not isinstance(v, dict) else
            {kk: True for kk in v} for k, v in params.items()}


TRANSFORMS = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd-momentum": lambda m: m.sgd(0.1, momentum=0.9),
    "adam": lambda m: m.adam(1e-2),
    "adam-bf16-state": lambda m: m.adam(
        1e-2, state_dtype=jnp.bfloat16 if m is joptim else torch.bfloat16),
    "adamw": lambda m: m.adamw(1e-2),
    "adamw-mask-noclip": lambda m: m.adamw(1e-2, clip_norm=None,
                                           decay_mask_fn=_decay_mask),
    "adamw-warmup-cosine": lambda m: m.adamw(
        m.linear_warmup_cosine(1e-2, warmup_steps=2, total_steps=5)),
    "adafactor": lambda m: m.adafactor_lite(1e-2),
    "clip": lambda m: m.clip_by_global_norm(1.0),
    "linear": lambda m: m.scale_by_schedule(m.linear_schedule(1.0, 0.1, 3)),
    "cosine": lambda m: m.scale_by_schedule(
        m.cosine_decay_schedule(1.0, 3, alpha=0.1)),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_update_equals_the_reference(name):
    """Three updates from the same params and grads (bf16 leaves among
    them): every update and state leaf in the reference's dtype and within
    RTOL of its value."""
    rng = np.random.default_rng(0)
    p = _draw(rng)
    jp, tp = _jax(p), _torch(p)
    jtx, tx = TRANSFORMS[name](joptim), TRANSFORMS[name](optim)
    js, ts = jtx.init(jp), tx.init(tp)
    _close(ts, js)
    for step in range(3):
        g = _draw(rng, scale=3.0)
        ju, js = jtx.update(_jax(g), js, jp)
        tu, ts = tx.update(_torch(g), ts, tp)
        _close(tu, ju)
        _close(ts, js)
        jp, tp = joptim.apply_updates(jp, ju), optim.apply_updates(tp, tu)
        _close(tp, jp)


def test_global_norm_and_constant():
    rng = np.random.default_rng(1)
    g = _draw(rng)
    want = joptim.global_norm(_jax(g))
    got = optim.global_norm(_torch(g))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=RTOL)
    assert float(optim.global_norm({})) == 0.0
    lr = optimizers.constant(3e-4)(torch.zeros((), dtype=torch.int32))
    assert lr.dtype == torch.float32 and float(lr) == float(np.float32(3e-4))


@pytest.mark.parametrize("make", [
    lambda m: m.linear_schedule(1.0, 0.1, 7),
    lambda m: m.cosine_decay_schedule(2e-3, 9, alpha=0.05),
    lambda m: m.linear_warmup_cosine(3e-4, 4, 20, end_value=1e-5),
    lambda m: m.constant_schedule(1e-3),
])
def test_schedules_equal_the_reference(make):
    js, ts = make(joptim), make(optim)
    for step in range(0, 25, 3):
        for arg in (step, torch.tensor(step, dtype=torch.int32)):
            got = ts(arg)
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(
                float(js(jnp.asarray(step, jnp.int32))), rel=RTOL, abs=1e-12)


def test_tree_map_rebuilds_named_tuples_and_keeps_none():
    """``tree_map`` over an optimizer state: a NamedTuple is rebuilt by its
    fields, and ``None`` (SGD's trace without momentum) is an empty
    subtree, as ``jax.tree.map`` has them."""
    t = torch.ones(2, dtype=torch.int32)
    s = optimizers.ScaleState(count=t)
    got = tree_map(lambda x: x + 1, s)
    assert isinstance(got, optimizers.ScaleState)
    assert torch.equal(got.count, t + 1)
    adam = optimizers.AdamState(count=t, mu={"w": t}, nu={"w": t * 3})
    got = tree_map(lambda x, y: x + y, adam, adam)
    assert isinstance(got, optimizers.AdamState)
    assert torch.equal(got.nu["w"], t * 6)
    mom = optim.sgd(0.1).init({"w": torch.zeros(3)})
    assert mom.trace is None
    moved = tree_map(lambda x: x.clone(), mom)
    assert isinstance(moved, optimizers.MomState) and moved.trace is None
    chain = optim.adamw(0.1).init({"w": torch.zeros(3)})
    copy = tree_map(torch.clone, chain)
    assert [type(s) for s in copy] == [type(s) for s in chain]
    assert len(leaves(copy)) == len(leaves(chain)) == 4
    assert unflatten(chain, leaves(copy))[1].mu["w"].shape == (3,)


# ---------------------------------------------------------------------------
# The data pipeline
# ---------------------------------------------------------------------------

class TestDataPipeline:
    def test_deterministic_across_calls(self):
        cfg = pipeline.DataConfig(vocab=128, seq_len=16, global_batch=4)
        b1 = pipeline.synthetic_lm_batch(cfg, 5)
        b2 = pipeline.synthetic_lm_batch(cfg, 5)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])

    def test_different_steps_differ(self):
        cfg = pipeline.DataConfig(vocab=128, seq_len=16, global_batch=4)
        b1 = pipeline.synthetic_lm_batch(cfg, 1)
        b2 = pipeline.synthetic_lm_batch(cfg, 2)
        assert not np.array_equal(b1["tokens"], b2["tokens"])

    def test_labels_are_shifted_tokens(self):
        cfg = pipeline.DataConfig(vocab=128, seq_len=16, global_batch=4)
        b = pipeline.synthetic_lm_batch(cfg, 0)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_host_slice_partitions(self):
        cfg = pipeline.DataConfig(vocab=128, seq_len=8, global_batch=8)
        b = pipeline.synthetic_lm_batch(cfg, 0)
        parts = [pipeline.host_slice(b["tokens"], i, 4) for i in range(4)]
        np.testing.assert_array_equal(np.concatenate(parts), b["tokens"])
        np.testing.assert_array_equal(
            parts[2], jpipeline.host_slice(b["tokens"], 2, 4))

    def test_markov_structure_learnable(self):
        """For contexts seen often, the mode dominates against the 1/64 of
        a uniform chain (~0.04 here; the chain is order 2, so the bigram
        signal is diluted)."""
        cfg = pipeline.DataConfig(vocab=64, seq_len=128, global_batch=16)
        toks = pipeline.synthetic_lm_batch(cfg, 0)["tokens"]
        pairs = {}
        for row in toks:
            for a, c in zip(row[:-1], row[1:]):
                pairs.setdefault(int(a), []).append(int(c))
        rates = [np.bincount(v).max() / len(v)
                 for v in pairs.values() if len(v) >= 20]
        assert np.mean(rates) > 0.08

    @pytest.mark.parametrize("vocab,seq,batch,seed,step", [
        (128, 16, 4, 0, 0), (512, 33, 3, 7, 11), (32000, 64, 2, 1, 299)])
    def test_batches_equal_the_reference_bit_for_bit(self, vocab, seq, batch,
                                                      seed, step):
        got = pipeline.synthetic_lm_batch(
            pipeline.DataConfig(vocab, seq, batch, seed), step)
        want = jpipeline.synthetic_lm_batch(
            jpipeline.DataConfig(vocab, seq, batch, seed), step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])

    def test_device_batches_resume_at_a_step(self):
        cfg = pipeline.DataConfig(vocab=64, seq_len=8, global_batch=2)
        it = pipeline.device_batches(cfg, device="cpu", start_step=3)
        for step in (3, 4):
            got = next(it)
            want = pipeline.synthetic_lm_batch(cfg, step)
            for k in want:
                assert got[k].dtype == torch.int32
                assert got[k].device.type == "cpu"
                np.testing.assert_array_equal(got[k].numpy(), want[k])
