"""The port's LM training path (repro_torch.train.steps, launch.train)
against the JAX package's, on the CPU, from the same NumPy parameters and
batches: the loss and its metrics, the gradients, and AdamW steps for every
family; microbatches, Adafactor, SGD with momentum and bf16 dtypes; then
the launcher.

The reference runs jitted, as tests/test_torch_train.py's SNN step does:
XLA contracts multiply-adds into FMAs under ``jit`` and PyTorch does not,
and the two CPU back ends differ by an ulp in ``exp``, ``pow`` and the
rope's ``cos``/``sin`` (ROADMAP §3).  So, measured on the configs below:
- the loss agrees to 2.1e-7 relative (``LOSS_RTOL`` 1e-6);
- each gradient leaf to 1.21e-5 of its largest |value| (zamba2-r's ``D``,
  a sum over every position; the dense families 1.9e-6), and Adam's first
  moment, linear in the gradients, to 2.5e-5 (zamba2-r's ``A_log`` at the
  second step): ``GRAD_TOL`` 3e-5; the second moment, quadratic in them,
  to twice that;
- the parameters after an AdamW step to ``PARAM_TOL`` (1e-5 of each
  leaf's largest |value|), except where Adam divides by a gradient near
  zero: a clipped gradient of 1e-9 against an ``eps`` of 1e-8 makes the
  update ``g / (|g| + eps)`` follow the gradient's last digits, so a few
  elements (at most 31 of 262,144, 1.2e-4 of a leaf, measured) move by up
  to the learning rate.  ``ADAM_NEAR_ZERO`` bounds their share, and no
  element may differ by more than two learning rates a step.
Each second step starts from the reference's first-step state, so the two
steps' differences do not compound.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.data import pipeline as jpipeline
from repro.launch import train as jlaunch_train
from repro.train import steps as jsteps
from repro_torch import optim
from repro_torch.launch import train as launch_train
from repro_torch.models import registry
from repro_torch.train import steps
from repro_torch.tree import leaves, unflatten
from test_torch_lm import ARCH_KW, REDUCED, _cfgs, _params, _rand

torch.set_num_threads(2)

LOSS_RTOL = 1e-6
GRAD_TOL = 3e-5
PARAM_TOL = 1e-5
ADAM_NEAR_ZERO = 1e-3
B, S = 4, 16

#: One config of each family (the dense one 4:1 GQA).
FAMILIES = ["tinyllama-r", "mixtral-r", "mamba2-r", "zamba2-r", "seamless-r"]


def _kw(config, **over):
    return {**(REDUCED.get(config) or ARCH_KW[config]), **over}


def _batch(name, seed=0):
    """A ``synthetic_lm_batch`` of B x S (the same NumPy in both packages),
    with seamless-r's frames and qwen2vl-r's patch embeddings and 3-row
    positions."""
    b = jpipeline.synthetic_lm_batch(
        jpipeline.DataConfig(vocab=512, seq_len=S, global_batch=B,
                             seed=seed), 0)
    rng = np.random.default_rng(seed + 1)
    d = _kw(name)["d_model"]
    if name == "seamless-r":
        b["frames"] = _rand(rng, B, 12, d)
    if name == "qwen2vl-r":
        pos = np.tile(np.arange(S, dtype=np.int32), (3, B, 1))
        pos[1, :, :2], pos[2, :, :2] = (0, 0), (1, 0)
        b["patch_embeds"] = _rand(rng, B, 2, d)
        b["positions"] = pos
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


_JFNS = {}


def _jref(kw, settings):
    """The reference's grads_fn and train step, jitted together: one
    compile per config and settings."""
    key = (repr(sorted(kw.items())), settings)
    if key not in _JFNS:
        jcfg = _cfgs(kw)[0]
        step = jsteps.build_train_step(jcfg, settings)

        def fn(params, opt_state, batch):
            loss, metrics, grads = jsteps.grads_fn(params, jcfg, batch,
                                                   settings)
            return (loss, metrics, grads) + step(params, opt_state, batch)

        _JFNS[key] = jax.jit(fn)
    return _JFNS[key]


def _pairs(got, want):
    g, w = leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape)
        yield a.detach().float().numpy(), np.asarray(b, np.float32)


def _close_to_max(got, want, tol):
    for a, b in _pairs(got, want):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=tol * max(np.abs(b).max(), 1e-30))


def _close_after_adam(got, want, lr):
    """Parameters after one AdamW step from equal ones (module docstring):
    all but a share ADAM_NEAR_ZERO of each leaf within PARAM_TOL of its
    max, and every element within two learning rates."""
    for a, b in _pairs(got, want):
        d = np.abs(a - b)
        far = d > PARAM_TOL * np.abs(b).max()
        assert far.sum() <= math.ceil(ADAM_NEAR_ZERO * d.size), far.sum()
        assert d.max() <= 2 * lr + PARAM_TOL * np.abs(b).max()


def _metrics_close(got, want):
    assert set(got) == set(want)
    for k in want:
        w = float(want[k])
        assert float(got[k]) == pytest.approx(
            w, rel=LOSS_RTOL if k != "grad_norm" else GRAD_TOL,
            abs=1e-12), k


def _to_torch(jtree, like):
    """A JAX tree (params or an optimizer state) as the port's tree of
    ``like``'s structure and dtypes, on the CPU."""
    return unflatten(like, [torch.from_numpy(np.array(x, np.float32)).to(
        t.dtype) for x, t in zip(jax.tree.leaves(jtree), leaves(like))])


def _run_both(name, settings, kw=None):
    """Loss, metrics, grads and two train steps in both packages: the
    second step of each from the reference's first-step state."""
    kw = kw or _kw(name)
    jcfg, tcfg = _cfgs(kw)
    jp, tp = _params(kw)
    jb, tb = _batch(name)
    fn = _jref(kw, settings)
    jtx = jsteps.make_optimizer(settings)
    j1 = fn(jp, jtx.init(jp), jb)
    j2 = fn(j1[3], j1[4], jb)
    tx = steps.make_optimizer(settings)
    t_loss, t_metrics, t_grads = steps.grads_fn(tp, tcfg, tb, settings)
    step = steps.build_train_step(tcfg, settings)
    t1 = step(tp, tx.init(tp), tb)
    t2 = step(_to_torch(j1[3], tp), _to_torch(j1[4], t1[1]), tb)
    return j1, j2, (t_loss, t_metrics, t_grads), t1, t2


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_grads_and_two_adamw_steps(name):
    settings = steps.TrainSettings()
    j1, j2, (loss, metrics, grads), t1, t2 = _run_both(name, settings)
    jloss, jmetrics, jgrads = j1[:3]
    assert float(jloss) > 1.0
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    _metrics_close(metrics, jmetrics)
    _close_to_max(grads, jgrads, GRAD_TOL)
    lr = settings.learning_rate
    for (tp, tstate, tm), (jp, jstate, jm) in ((t1, j1[3:]), (t2, j2[3:])):
        _close_after_adam(tp, jp, lr)
        adam, jadam = tstate[1], jstate[1]
        assert int(adam.count) == int(jadam.count)
        assert int(tstate[3].count) == int(jstate[3].count)
        _close_to_max(adam.mu, jadam.mu, GRAD_TOL)
        _close_to_max(adam.nu, jadam.nu, 2 * GRAD_TOL)   # quadratic
        _metrics_close(tm, jm)
    assert int(t2[1][1].count) == 2


@pytest.mark.parametrize("name", ["mixtral-r", "qwen2vl-r"])
def test_microbatches(name):
    """Two microbatches (qwen2vl-r's positions split on their batch axis,
    1): float32 grads, the mean loss, the last microbatch's metrics."""
    settings = steps.TrainSettings(microbatches=2)
    j1, j2, (loss, metrics, grads), t1, t2 = _run_both(name, settings)
    assert float(loss) == pytest.approx(float(j1[0]), rel=LOSS_RTOL)
    _metrics_close(metrics, j1[1])
    _close_to_max(grads, j1[2], GRAD_TOL)
    for (tp, _, tm), (jp, _, jm) in ((t1, j1[3:]), (t2, j2[3:])):
        _close_after_adam(tp, jp, settings.learning_rate)
        _metrics_close(tm, jm)


def test_split_matches_the_reference_reshape():
    _, tb = _batch("qwen2vl-r")
    parts = steps._split(tb, 2)
    for i, mb in enumerate(parts):
        assert torch.equal(mb["tokens"], tb["tokens"][2 * i:2 * i + 2])
        assert torch.equal(mb["positions"],
                           tb["positions"][:, 2 * i:2 * i + 2])
    with pytest.raises(ValueError):
        steps._split(tb, 3)


def test_adafactor_steps():
    """Adafactor factors every leaf of two or more dims over its last two:
    a stacked (L, d_in, d_out) leaf keeps (L, d_in) rows."""
    settings = steps.TrainSettings(optimizer="adafactor")
    j1, j2, _, t1, t2 = _run_both("tinyllama-r", settings)
    for (tp, tstate, tm), (jp, jstate, jm) in ((t1, j1[3:]), (t2, j2[3:])):
        _close_to_max(tp, jp, PARAM_TOL)
        for part in ("row", "col", "full"):
            _close_to_max(getattr(tstate, part), getattr(jstate, part),
                          GRAD_TOL)
        assert int(tstate.count) == int(jstate.count)
        _metrics_close(tm, jm)
    wq = t1[1].row["layers"]["attn"]["wq"]["w"]
    assert tuple(wq.shape) == (2, 128)


def test_sgd_with_momentum_on_each_packages_grads():
    kw = _kw("tinyllama-r")
    settings = steps.TrainSettings()
    jg = _jref(kw, settings)(_params(kw)[0], jsteps.make_optimizer(
        settings).init(_params(kw)[0]), _batch("tinyllama-r")[0])[2]
    jp, tp = _params(kw)
    tg = steps.grads_fn(tp, _cfgs(kw)[1], _batch("tinyllama-r")[1],
                        settings)[2]
    jtx, tx = joptim.sgd(0.1, momentum=0.9), optim.sgd(0.1, momentum=0.9)
    js, ts = jtx.init(jp), tx.init(tp)
    for _ in range(2):
        ju, js = jax.jit(jtx.update)(jg, js, jp)
        tu, ts = tx.update(tg, ts, tp)
        jp, tp = joptim.apply_updates(jp, ju), optim.apply_updates(tp, tu)
    _close_to_max(tp, jp, PARAM_TOL)
    _close_to_max(ts.trace, js.trace, GRAD_TOL)
    assert int(ts.count) == 2


def test_bf16_dtypes_and_loose_values():
    """A bf16 model: grads bf16 (float32 with microbatches), the clipped
    update float32 (JAX promotes a bf16 leaf times a float32 scalar), the
    updated leaves bf16, every dtype the reference's.  The values agree
    loosely: bf16 rounds each product's output, and the embedding's
    gradient sums repeated tokens in other orders on each side."""
    kw = _kw("tinyllama-r", dtype="bfloat16", name="tinyllama-bf16")
    jcfg, tcfg = _cfgs(kw)
    jp, tp = _params(kw)
    jb, tb = _batch("tinyllama-r")
    for mb, grad_dtype in ((1, "bfloat16"), (2, "float32")):
        settings = steps.TrainSettings(microbatches=mb)
        j = _jref(kw, settings)(jp, jsteps.make_optimizer(settings).init(jp),
                                jb)
        loss, _, grads = steps.grads_fn(tp, tcfg, tb, settings)
        assert {str(g.dtype) for g in jax.tree.leaves(j[2])} == {grad_dtype}
        assert [str(g.dtype).split(".")[1] for g in leaves(grads)] == [
            str(g.dtype) for g in jax.tree.leaves(j[2])]
        assert float(loss) == pytest.approx(float(j[0]), rel=1e-2)
        _close_to_max(grads, j[2], 0.1)
        clip, jclip = optim.clip_by_global_norm(1.0), joptim.clip_by_global_norm(1.0)
        cu = clip.update(grads, clip.init(tp))[0]
        jcu = jclip.update(j[2], jclip.init(jp))[0]
        assert [str(u.dtype).split(".")[1] for u in leaves(cu)] == [
            str(u.dtype) for u in jax.tree.leaves(jcu)] == ["float32"] * len(
            leaves(cu))
        new = steps.build_train_step(tcfg, settings)(
            tp, steps.make_optimizer(settings).init(tp), tb)[0]
        assert [str(p.dtype).split(".")[1] for p in leaves(new)] == [
            str(p.dtype) for p in jax.tree.leaves(j[3])]
        _close_to_max(new, j[3], 0.05)


def test_remat_on_and_off_train_equally():
    kw = _kw("mixtral-r")
    tcfg = _cfgs(kw)[1]
    tp = _params(kw)[1]
    tb = _batch("mixtral-r")[1]
    outs = []
    for remat in (True, False):
        settings = steps.TrainSettings(remat=remat)
        tx = steps.make_optimizer(settings)
        outs.append(steps.build_train_step(tcfg, settings)(
            tp, tx.init(tp), tb))
    for a, b in zip(leaves(outs[0]), leaves(outs[1])):
        assert torch.equal(a, b)


def test_train_step_leaves_its_arguments_unchanged():
    """The reference donates params and state; the port returns new
    tensors and leaves the arguments as they were."""
    kw = _kw("tinyllama-r")
    tcfg, tp = _cfgs(kw)[1], _params(kw)[1]
    settings = steps.TrainSettings()
    tx = steps.make_optimizer(settings)
    state = tx.init(tp)
    before = [t.clone() for t in leaves((tp, state))]
    new_p, new_s, _ = steps.build_train_step(tcfg, settings)(
        tp, state, _batch("tinyllama-r")[1])
    assert all(torch.equal(a, b) for a, b in zip(before, leaves((tp, state))))
    assert not any(a is b for a, b in zip(leaves(new_p), leaves(tp)))


def test_abstract_state_matches_the_reference():
    kw = _kw("mamba2-r", dtype="bfloat16")
    jcfg, tcfg = _cfgs(kw)
    for opt in ("adamw", "adafactor"):
        settings = steps.TrainSettings(optimizer=opt)
        tp, ts = steps.abstract_state(tcfg, settings)
        jparams, jstate = jsteps.abstract_state(jcfg, settings)
        got = [(tuple(t.shape), str(t.dtype).split(".")[1], t.device.type)
               for t in leaves((tp, ts))]
        want = [(tuple(t.shape), str(t.dtype), "meta")
                for t in jax.tree.leaves((jparams, jstate))]
        assert got == want


def test_a_mesh_raises(monkeypatch):
    """A mesh that is not a DeviceMesh, or one that cannot be built, raises:
    nothing falls back to one device.  (The mesh path itself runs in
    tests/test_torch_distributed_ranks.py, on spawned process groups.)"""
    kw = _kw("tinyllama-r")
    tcfg = _cfgs(kw)[1]
    settings = steps.TrainSettings()
    with pytest.raises(TypeError, match="DeviceMesh"):
        steps.build_train_step(tcfg, settings, mesh="single")
    with pytest.raises(TypeError, match="DeviceMesh"):
        steps.loss_fn(_params(kw)[1], tcfg, _batch("tinyllama-r")[1],
                      settings, mesh="single")
    with pytest.raises(TypeError, match="DeviceMesh"):
        launch_train.run_training(tcfg, steps_n=1, global_batch=2,
                                  seq_len=8, mesh="single", device="cpu")
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="process group"):
        launch_train.main(["--device", "cpu", "--mesh", "single"])


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

TINY = dict(d_model=64, layers=2, vocab=256)


def _tiny_cfg():
    return launch_train.small_config(registry.load_arch("llama3_2_3b"),
                                     **TINY)


def _train(**kw):
    return launch_train.run_training(
        _tiny_cfg(), steps_n=40, global_batch=4, seq_len=32, lr=3e-3,
        data_vocab=64, log_every=100, device="cpu", **kw)


def test_run_training_loss_falls(capsys):
    out = _train()
    losses = out["losses"]
    assert len(losses) == 40 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5
    assert int(out["state"]["opt"][1].count) == 40
    assert "step     0  loss" in capsys.readouterr().out


def test_run_training_under_a_checkpoint_dir_equals_the_plain_run(tmp_path):
    plain = _train()
    sup = _train(checkpoint_dir=str(tmp_path), checkpoint_every=10)
    assert sup["losses"] == plain["losses"]
    for a, b in zip(leaves(sup["state"]), leaves(plain["state"])):
        assert torch.equal(a, b)
    assert sorted(p.name for p in tmp_path.iterdir())[-1] == "step_00000040"


def test_main_on_the_cpu(capsys):
    out = launch_train.main(["--device", "cpu", "--steps", "3", "--layers",
                             "2", "--d-model", "64", "--vocab", "256"])
    assert len(out["losses"]) == 3
    assert "first-10 mean loss" in capsys.readouterr().out


def test_small_config_equals_the_reference():
    for arch_id in ("llama3_2_3b", "qwen2_vl_72b", "mamba2_780m"):
        got = launch_train.small_config(registry.load_arch(arch_id), **TINY)
        want = jlaunch_train.small_config(
            __import__(f"repro.configs.{arch_id}",
                       fromlist=["CONFIG"]).CONFIG, **TINY)
        assert got.__dict__.keys() == want.__dict__.keys()
        assert all(getattr(got, k) == getattr(want, k)
                   for k in ("num_layers", "d_model", "n_heads", "n_kv",
                             "d_ff", "vocab", "head_dim", "dtype",
                             "mrope_sections"))
