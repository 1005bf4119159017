"""The port's distribution layer on real process groups: four rank
processes on the CPU over gloo (``tests/torch_ranks.py``), on a 2x2
("data", "model") mesh, a 4-way "data" mesh and a 4-stage pipeline.

- Training: one and two AdamW steps of a reduced fp32 config of every
  family and layout rule (``TRAIN``; mixtral-r with 2 microbatches) on
  the mesh equal the port's mesh=None step and the jitted reference step,
  to tests/test_torch_lm_train.py's tolerances; each second step starts
  from the reference's first-step state, and every leaf comes back a
  DTensor on its sharding.
- Serving, the MoE experts' collectives, ``device_batches``, elastic
  restore, ``TrainSupervisor(shardings=...)``, the int8 error-feedback toy
  and ``pipeline_apply``: one spawn; the ranks check against the
  unsharded path, and the parent holds the checkpoint and the pipeline
  against the reference.

Every group starts from a file under ``tmp_path`` (no fixed port), with a
60 s timeout on its collectives and a timeout on each rank process, so a
hung collective fails its test.
"""
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.train import steps as jsteps
from repro_torch.tree import leaves
from test_torch_lm import ARCH_KW, WINDOWED, _params
from test_torch_lm_train import (GRAD_TOL, LOSS_RTOL, PARAM_TOL, _batch,
                                 _jref)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLD = 4
RANK_TIMEOUT_S = 240

#: A reduced config of each family, and of each layout rule: dense 4:1
#: GQA, MoE with expert-parallel experts (4 over "model", 2
#: microbatches; 8 plus a dense residual) and with tensor-parallel ones (3
#: experts, whose ff dims split over "model"), the vision frontend's
#: (3, B, S) positions, SSM, hybrid, encoder-decoder.  mixtral-r and
#: qwen2vl-r train under their full models' names, which are FSDP
#: architectures, so their params shard over "data" too.  arctic-r-3h
#: has 3 heads and 1 kv head on the 2 "model" ranks: a heads dim that its
#: ranks do not split evenly (arctic-480b's 56 heads on 16), gathered
#: around each reshape into and out of heads.  {case: (config,
#: microbatches, the name on the mesh, fields changed: MoE fields under
#: "moe")}
TRAIN = {"tinyllama-r": ("tinyllama-r", 1, "tinyllama-r", None),
         "mixtral-r": ("mixtral-r", 2, "mixtral-8x7b", None),
         "mixtral-r-3e": ("mixtral-r", 1, "mixtral-8x7b",
                          {"moe": {"num_experts": 3}}),
         "arctic-r": ("arctic-r", 1, "arctic-r", None),
         "arctic-r-3h": ("arctic-r", 1, "arctic-r",
                         {"n_heads": 3, "n_kv": 1}),
         "qwen2vl-r": ("qwen2vl-r", 1, "qwen2-vl-72b", None),
         "mamba2-r": ("mamba2-r", 1, "mamba2-r", None),
         "zamba2-r": ("zamba2-r", 1, "zamba2-r", None),
         "seamless-r": ("seamless-r", 1, "seamless-r", None)}


def _train_kw(case: str) -> dict:
    config, _, _, changed = TRAIN[case]
    kw = dict(ARCH_KW[config], **(changed or {}))
    if changed and "moe" in changed:
        kw["moe"] = dict(ARCH_KW[config]["moe"], **changed["moe"])
    return kw


def start(task: str, out: str, world: int = WORLD) -> list:
    """Start ``task`` of tests/torch_ranks.py on ``world`` rank
    processes."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    init = os.path.join(out, f"pg_{task}")
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_ranks.py"), task,
         str(r), str(world), init, out], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def finish(procs: list, started: float) -> None:
    """Wait for the rank processes, ``RANK_TIMEOUT_S`` after ``started``
    at most; raise with every rank's output if one fails."""
    deadline = started + RANK_TIMEOUT_S
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append(p.communicate()[0])
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    assert not bad, "\n".join(f"--- rank {i} ---\n{o[-4000:]}"
                              for i, o in enumerate(outs))


def spawn(task: str, out: str, world: int = WORLD) -> None:
    finish(start(task, out, world), time.monotonic())


def _np(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _publish(path: str, **arrays) -> None:
    """``np.savez`` published atomically (the ranks poll for it)."""
    np.savez(path + ".tmp.npz", **arrays)
    os.replace(path + ".tmp.npz", path)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The ranks' mesh and mesh=None steps, and the reference's, from the
    same inputs: {name: (reference (j1, j2), rank results)}.  The ranks
    start on their first steps at once; the reference's first-step state,
    where their second steps start, is computed here meanwhile and
    published config by config."""
    out = str(tmp_path_factory.mktemp("train"))
    jobs = {}
    for name, (config, mb, mesh_name, _) in TRAIN.items():
        tp = _params(_train_kw(name))[1]
        arrays = {f"p0_{i}": x.float().numpy() for i, x in
                  enumerate(leaves(tp))}
        arrays.update({f"b_{k}": v.numpy()
                       for k, v in _batch(config)[1].items()})
        np.savez(os.path.join(out, f"{name}_in.npz"), **arrays)
        jobs[name] = {"kw": dict(_train_kw(name), name=mesh_name),
                      "microbatches": mb}
    with open(os.path.join(out, "train.json"), "w") as f:
        json.dump(jobs, f)
    started = time.monotonic()
    procs = start("train", out)
    refs = {}
    for name, (config, mb, _, _) in TRAIN.items():
        kw = _train_kw(name)
        settings = jsteps.TrainSettings(microbatches=mb)
        jp = _params(kw)[0]
        jb = _batch(config)[0]
        fn = _jref(kw, settings)
        j1 = fn(jp, jsteps.make_optimizer(settings).init(jp), jb)
        arrays = {f"p1_{i}": a for i, a in enumerate(_np(j1[3]))}
        arrays.update({f"o1_{i}": a for i, a in enumerate(_np(j1[4]))})
        _publish(os.path.join(out, f"{name}_ref1.npz"), **arrays)
        refs[name] = (j1, fn(j1[3], j1[4], jb))
    finish(procs, started)
    return {name: (refs[name], np.load(os.path.join(out, f"{name}_out.npz")))
            for name in TRAIN}


def _leaves(z, tag, kind):
    n = sum(1 for k in z.files if k.startswith(f"{tag}_{kind}"))
    return [z[f"{tag}_{kind}{i}"] for i in range(n)]


def _metrics(z, tag):
    p = f"{tag}_m_"
    return {k[len(p):]: float(z[k]) for k in z.files if k.startswith(p)}


def _close_metrics(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k] == pytest.approx(
            float(w), rel=LOSS_RTOL if k != "grad_norm" else GRAD_TOL,
            abs=1e-12), k


def _close_params(got, want, lr=3e-4):
    """tests/test_torch_lm_train.py's after-Adam bound: all but 1e-3 of a
    leaf within PARAM_TOL of its max, every element within two learning
    rates."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b, np.float32)
        d = np.abs(a - b)
        far = d > PARAM_TOL * np.abs(b).max()
        assert far.sum() <= np.ceil(1e-3 * d.size), far.sum()
        assert d.max() <= 2 * lr + PARAM_TOL * np.abs(b).max()


@pytest.mark.parametrize("name", list(TRAIN))
def test_mesh_train_steps_match_single_device_and_reference(trained, name):
    (j1, j2), z = trained[name]
    for tag, j in (("1", j1), ("2", j2)):
        mesh_p, plain_p = _leaves(z, "m" + tag, "p"), _leaves(z, "t" + tag, "p")
        _close_metrics(_metrics(z, "m" + tag), _metrics(z, "t" + tag))
        _close_params(mesh_p, plain_p)
        _close_metrics(_metrics(z, "m" + tag), j[5])
        _close_params(mesh_p, _np(j[3]))
        # Adam's moments (the chain's second state) against the reference
        mesh_o, ref_o = _leaves(z, "m" + tag, "o"), _np(j[4])
        assert len(mesh_o) == len(ref_o)
        for a, b in zip(mesh_o, ref_o):
            np.testing.assert_allclose(
                a, b, rtol=0, atol=2 * GRAD_TOL * max(np.abs(b).max(), 1e-30))


def test_ranks_serve_restore_supervise_compress_and_pipeline(tmp_path):
    """One spawn of four ranks: sharded serving of a dense config, a
    sliding-window one (prefill's rolling slots into a sharded cache) and
    an SSM one; the MoE experts on their weight blocks, with no gather;
    ``device_batches`` on ``batch_specs``' layout; elastic restore, a
    supervised restart, the EF-int8 toy and a 4-stage GPipe.  The parent
    then reads the mesh-written checkpoint with the reference's store and
    holds the pipeline against a sequential JAX application."""
    out = str(tmp_path)
    with open(os.path.join(out, "serve.json"), "w") as f:
        json.dump({"tinyllama-r": ARCH_KW["tinyllama-r"],
                   "window-r": WINDOWED, "mamba2-r": ARCH_KW["mamba2-r"]}, f)
    rng = np.random.default_rng(3)
    S, d, n_micro, mb = 4, 16, 6, 2
    w = (rng.standard_normal((S, d, d)) / np.sqrt(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal((S, d))).astype(np.float32)
    x = rng.standard_normal((n_micro, mb, d)).astype(np.float32)
    np.savez(os.path.join(out, "pipe_in.npz"), w=w, b=b, x=x)
    spawn("misc", out)
    with open(os.path.join(out, "misc.json")) as f:
        res = json.load(f)
    assert res["device_batches"]
    assert res["restore"] and res["supervisor"] == 1
    assert res["ef_final_loss"] < 1e-3
    assert (res["serve_tinyllama-r"][1] == res["serve_window-r"][1]
            == res["serve_mamba2-r"][1] == 4)
    assert res["experts_4"] == []                 # expert parallel: no comm
    assert res["experts_3"] and all("all_reduce" in k
                                    for k in res["experts_3"])

    # the checkpoint written from a sharded state, in the reference's store
    like = {"x": jnp.zeros((8, 8), jnp.float32),
            "w": jnp.zeros((4, 8), jnp.bfloat16)}
    back = jstore.restore(os.path.join(out, "ckpt"), like)
    np.testing.assert_array_equal(np.asarray(back["x"]),
                                  np.arange(64.0).reshape(8, 8))
    np.testing.assert_array_equal(
        np.asarray(back["w"], np.float32),
        (torch.arange(32.0).reshape(4, 8) / 7).to(torch.bfloat16).float()
        .numpy())

    # the pipeline against sequential stages, computed by JAX
    ref = jnp.asarray(x)
    for s in range(S):
        ref = jnp.tanh(ref @ jnp.asarray(w[s]) + jnp.asarray(b[s]))
    np.testing.assert_allclose(np.load(os.path.join(out, "pipe_out.npy")),
                               np.asarray(ref), rtol=0, atol=1e-5)
