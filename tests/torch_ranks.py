"""Rank processes for tests/test_torch_distributed_ranks.py: each runs one
task of the port's distribution layer on a gloo process group of the CPU,
as one rank of several.

    python tests/torch_ranks.py TASK RANK WORLD INIT_FILE OUT_DIR

The group starts from ``file://INIT_FILE`` (no fixed port, so concurrent
test workers never collide) with a 60 s timeout, so a hung collective
fails instead of waiting.  Inputs a task needs from the parent are in
``OUT_DIR``; rank 0 writes the results there.  Nothing here imports JAX:
the parent holds the results against the reference.
"""
import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

torch.set_num_threads(1)

from repro_torch.checkpoint import store                    # noqa: E402
from repro_torch.configs.base import (ArchConfig, MoEConfig,  # noqa: E402
                                      ShapeConfig, SSMConfig)
from repro_torch.data import pipeline                       # noqa: E402
from repro_torch.distributed import compression, sharding   # noqa: E402
from repro_torch.distributed import pipeline as pipe        # noqa: E402
from repro_torch.distributed.fault_tolerance import (       # noqa: E402
    SupervisorConfig, TrainSupervisor)
from repro_torch.launch.mesh import make_test_mesh          # noqa: E402
from repro_torch.models import registry                     # noqa: E402
from repro_torch.serve import engine                        # noqa: E402
from repro_torch.train import steps                         # noqa: E402
from repro_torch.tree import leaves, unflatten              # noqa: E402

FP32 = dict(rtol=1e-5, atol=5e-5)


def arch_config(kw: dict) -> ArchConfig:
    """An ArchConfig from a JSON keyword set (lists back to tuples)."""
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
    if kw.get("moe") is not None:
        kw["moe"] = MoEConfig(**kw["moe"])
    if kw.get("ssm") is not None:
        kw["ssm"] = SSMConfig(**kw["ssm"])
    return ArchConfig(**kw)


def whole(tree):
    """Every tensor leaf of ``tree`` as a NumPy float32 array, DTensors
    gathered (a collective: every rank calls this)."""
    def one(x):
        if hasattr(x, "full_tensor"):
            x = x.full_tensor()
        return x.detach().float().numpy()
    return [one(x) for x in leaves(tree)]


def all_dtensors(tree, shardings) -> None:
    """Every leaf of ``tree`` a DTensor on its sharding's placements."""
    from torch.distributed.tensor import DTensor
    for x, s in zip(leaves(tree), leaves(shardings)):
        if isinstance(x, int):
            continue                      # a cache's length, a host int
        assert isinstance(x, DTensor), type(x)
        assert tuple(x.placements) == s.placements, (x.placements,
                                                     s.placements)


def _wait_for(path: str, timeout_s: float = 180.0):
    """The NumPy archive at ``path`` once it exists."""
    import time
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.05)
    return np.load(path)


# ---------------------------------------------------------------------------
# Tasks
# ---------------------------------------------------------------------------

def task_train(rank: int, out: str) -> None:
    """One and two train steps of each of the parent's reduced configs, on
    a 2x2 mesh and with mesh=None, from the parent's params and batch (the
    second from the reference's first-step state); rank 0 writes the
    results of both."""
    mesh = make_test_mesh((2, 2), ("data", "model"))
    with open(os.path.join(out, "train.json")) as f:
        jobs = json.load(f)
    for name, job in jobs.items():
        cfg = arch_config(job["kw"])
        settings = steps.TrainSettings(microbatches=job["microbatches"])
        z = np.load(os.path.join(out, f"{name}_in.npz"))
        like = registry.init_params(torch.Generator(), cfg, device="meta")
        tx = steps.make_optimizer(settings)

        def tree(prefix, like):
            return unflatten(like, [torch.from_numpy(z[f"{prefix}{i}"]).to(
                t.dtype) for i, t in enumerate(leaves(like))])

        p0 = tree("p0_", like)
        o0 = tx.init(p0)
        batch = {k[2:]: torch.from_numpy(z[k]) for k in z.files
                 if k.startswith("b_")}

        plain = steps.build_train_step(cfg, settings)
        t1 = plain(p0, o0, batch)
        p_sh, o_sh, _, _ = steps.state_shardings(cfg, settings, mesh)
        b_sh = sharding.to_named(sharding.batch_specs(cfg, batch, mesh),
                                 mesh)
        step = steps.build_train_step(cfg, settings, mesh)
        m1 = step(sharding.place_tree(p0, p_sh),
                  sharding.place_tree(o0, o_sh),
                  sharding.place_tree(batch, b_sh))

        # the second steps start from the reference's first-step state,
        # which the parent publishes while the first steps run
        z = _wait_for(os.path.join(out, f"{name}_ref1.npz"))
        p1 = tree("p1_", like)
        o1 = tree("o1_", o0)
        t2 = plain(p1, o1, batch)
        m2 = step(sharding.place_tree(p1, p_sh),
                  sharding.place_tree(o1, o_sh),
                  sharding.place_tree(batch, b_sh))
        for got in (m1, m2):
            all_dtensors(got[0], p_sh)
            all_dtensors(got[1], o_sh)
        res = {}
        for tag, (p, o, m) in (("t1", t1), ("t2", t2), ("m1", m1),
                               ("m2", m2)):
            for i, a in enumerate(whole(p)):
                res[f"{tag}_p{i}"] = a
            for i, a in enumerate(whole(o)):
                res[f"{tag}_o{i}"] = a
            for k, v in m.items():
                res[f"{tag}_m_{k}"] = np.asarray(float(v))
        if rank == 0:
            np.savez(os.path.join(out, f"{name}_out.npz"), **res)


def _serve(cfg, params, tokens, new, max_len, mesh=None):
    """Prefill, then a greedy decode step per new token: every step's
    logits and tokens, and the final cache, whole."""
    B = tokens.shape[0]
    shape = ShapeConfig("serve", max_len, B, "decode")
    cache_sh = None
    if mesh is not None:
        params, b_sh = engine.place_for_serving(cfg, params, mesh, shape,
                                                mode="prefill")
        cache_sh = b_sh["cache"]
    prefill = engine.build_prefill_step(cfg, max_len)
    decode = engine.build_decode_step(cfg)
    logits_all, toks = [], []
    with torch.inference_mode():
        logits, cache = prefill(params, {"tokens": tokens})
        if mesh is not None:
            all_dtensors(cache, cache_sh)
            params, _ = engine.place_for_serving(cfg, params, mesh, shape,
                                                 mode="decode")
            logits = logits.full_tensor()
        logits_all.append(logits.numpy())
        token = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        for _ in range(new):
            toks.append(token[:, 0].numpy())
            o = decode(params, {"token": token, "cache": cache})
            cache = o["cache"]
            lg = o["logits"]
            logits_all.append((lg.full_tensor() if mesh is not None
                               else lg).numpy())
            token = o["next_token"][:, None]
        if mesh is not None:
            all_dtensors(cache, cache_sh)
        return logits_all, toks, whole({k: v for k, v in cache.items()
                                        if k != "length"})


def task_misc(rank: int, out: str) -> None:
    res = {}
    mesh = make_test_mesh((2, 2), ("data", "model"))
    P = sharding.P

    # -- serving on serve_shardings state, against the unsharded path --
    with open(os.path.join(out, "serve.json")) as f:
        jobs = json.load(f)
    for name, kw in jobs.items():
        cfg = arch_config(kw)
        params = registry.init_params(torch.Generator().manual_seed(0), cfg,
                                      device="cpu")
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            1, cfg.vocab, (4, 8)).astype(np.int32))
        want = _serve(cfg, params, tokens, 4, 16)
        got = _serve(cfg, params, tokens, 4, 16, mesh)
        for a, b in zip(got[0], want[0]):
            np.testing.assert_allclose(a, b, **FP32)
        for a, b in zip(got[1], want[1]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got[2], want[2]):
            np.testing.assert_allclose(a, b, **FP32)
        res[f"serve_{name}"] = [float(max(np.abs(a - b).max() for a, b in
                                          zip(got[0], want[0]))),
                                len(got[1])]

    # -- the MoE experts on their own weight blocks: expert parallel (4
    # experts) with no collective at all, tensor parallel (3 experts, ff
    # split) with one all-reduce of the partial products; no gather --
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import moe
    for E in (4, 3):
        g = torch.Generator().manual_seed(E)
        w = {"w_gate": torch.randn(E, 8, 16, generator=g),
             "w_up": torch.randn(E, 8, 16, generator=g),
             "w_down": torch.randn(E, 16, 8, generator=g)}
        xin = torch.randn(2, E, 4, 8, generator=g)
        specs = ({k: P("model", None, None) for k in w} if E == 4 else
                 {"w_gate": P(None, None, "model"),
                  "w_up": P(None, None, "model"),
                  "w_down": P(None, "model", None)})
        wd = sharding.place_tree(w, sharding.to_named(specs, mesh))
        xd = sharding.place(xin, sharding.NamedSharding(mesh, P()))
        with use_mesh(mesh), CommDebugMode() as comm:
            y = moe._experts(wd, MoEConfig(num_experts=E), xd)
        kinds = {str(k).split(".")[-1] for k, n in
                 comm.get_comm_counts().items() if n}
        assert not any("gather" in k for k in kinds), kinds
        assert (kinds == set()) if E == 4 else (
            kinds and all("all_reduce" in k for k in kinds)), kinds
        np.testing.assert_allclose(y.full_tensor().numpy(),
                                   moe._expert_ffn(w, xin).numpy(), **FP32)
        res[f"experts_{E}"] = sorted(kinds)

    # -- device_batches on the mesh: every batch on batch_specs' layout,
    # each rank holding its data rows of the seeded global batch --
    dcfg = pipeline.DataConfig(vocab=64, seq_len=8, global_batch=4, seed=0)
    host = pipeline.synthetic_lm_batch(dcfg, 3)
    b_sh = sharding.to_named(sharding.batch_specs(
        None, {k: torch.empty(v.shape, device="meta")
               for k, v in host.items()}, mesh), mesh)
    got = next(pipeline.device_batches(dcfg, start_step=3, shardings=b_sh))
    all_dtensors(got, b_sh)
    d = mesh.get_coordinate()[0]
    for k, v in host.items():
        assert tuple(got[k].placements) == (Shard(0), Replicate())
        np.testing.assert_array_equal(got[k].to_local().numpy(),
                                      v[2 * d:2 * d + 2])
        np.testing.assert_array_equal(got[k].full_tensor().numpy(), v)
    res["device_batches"] = True

    # -- elastic restore: save from a (data, model) layout, restore onto
    # others --
    from torch.distributed.device_mesh import init_device_mesh
    ck = os.path.join(out, "ckpt")
    x = torch.arange(64.0).reshape(8, 8)
    w = (torch.arange(32.0).reshape(4, 8) / 7).to(torch.bfloat16)
    saved = sharding.place_tree({"x": x, "w": w}, sharding.to_named(
        {"x": P("data", "model"), "w": P(None, "model")}, mesh))
    store.save(ck, 1, saved)
    mesh2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("model", "data"))
    mesh3 = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    for m, spec in ((mesh2, P("model", "data")), (mesh3, P(None, "data"))):
        tgt = sharding.to_named({"x": spec, "w": P("data")}, m)
        back = store.restore(ck, {"x": x, "w": w}, shardings=tgt)
        all_dtensors(back, tgt)
        assert torch.equal(back["x"].full_tensor(), x)
        assert torch.equal(back["w"].full_tensor(), w)
    back = store.restore(ck, saved)                 # onto like's own layout
    assert tuple(back["x"].placements) == tuple(saved["x"].placements)
    assert torch.equal(back["x"].to_local(), saved["x"].to_local())
    res["restore"] = True

    # -- TrainSupervisor(shardings=...) recovers from an injected failure --
    sh = sharding.to_named({"w": P("data", "model"), "n": P()}, mesh)
    init = sharding.place_tree({"w": torch.zeros(8, 4),
                                "n": torch.zeros((), dtype=torch.int32)}, sh)
    crashed = {"flag": False}

    def step_fn(state, step):
        if step == 7 and not crashed["flag"]:
            crashed["flag"] = True            # on every rank, as a lost node
            raise RuntimeError("node lost")
        return {"w": state["w"] * 0.5 + float(step), "n": state["n"] + 1}

    sup = TrainSupervisor(SupervisorConfig(
        checkpoint_dir=os.path.join(out, "sup"), checkpoint_every=2),
        init, shardings=sh)
    final = sup.run(step_fn, 12)
    ref = {"w": torch.zeros(8, 4), "n": torch.zeros((), dtype=torch.int32)}
    for i in range(12):
        ref = {"w": ref["w"] * 0.5 + float(i), "n": ref["n"] + 1}
    all_dtensors(final, sh)
    assert sup.restarts == 1
    assert torch.equal(final["w"].full_tensor(), ref["w"])
    assert int(final["n"].full_tensor()) == 12
    res["supervisor"] = sup.restarts

    # -- int8 error-feedback SGD converges on 4 data shards --
    dmesh = mesh3
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    w_true = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    y = X @ w_true

    def loss_fn(w, batch):
        xb, yb = batch
        return torch.mean((xb @ w - yb) ** 2)

    grad_step = compression.make_compressed_grad_fn(loss_fn, dmesh,
                                                    ("data",))
    wv = torch.zeros(16)
    errors = compression.init_errors(wv)
    for _ in range(150):
        loss, g, errors = grad_step(wv, (X, y), errors)
        wv = wv - 0.05 * g
    final_loss = float(loss_fn(wv, (X, y)))
    assert final_loss < 1e-3, final_loss
    res["ef_final_loss"] = final_loss

    # -- GPipe over a 4-stage mesh, stage params whole and as DTensors --
    smesh = init_device_mesh("cpu", (4,), mesh_dim_names=("stage",))
    z = np.load(os.path.join(out, "pipe_in.npz"))
    params = {"w": torch.from_numpy(z["w"]), "b": torch.from_numpy(z["b"])}
    micro = torch.from_numpy(z["x"])

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    outs = pipe.pipeline_apply(stage_fn, params, micro, smesh)
    dparams = sharding.place_tree(params, sharding.to_named(
        {"w": P("stage"), "b": P("stage")}, smesh))
    outs_d = pipe.pipeline_apply(stage_fn, dparams, micro, smesh)
    assert torch.equal(outs, outs_d)
    gathered = [torch.zeros_like(outs) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, outs)
    assert all(torch.equal(g, outs) for g in gathered)   # every rank has it
    if rank == 0:
        np.save(os.path.join(out, "pipe_out.npy"), outs.numpy())
        with open(os.path.join(out, "misc.json"), "w") as f:
            json.dump(res, f)


TASKS = {"train": task_train, "misc": task_misc}


def main():
    task, rank, world, init_file, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        TASKS[task](rank, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"RANK_OK {rank}")


if __name__ == "__main__":
    main()
