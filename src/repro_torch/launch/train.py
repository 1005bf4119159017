"""Training launcher: the LM train step for an architecture, on one
device or on a mesh, run under checkpoint/restart supervision with the
deterministic data pipeline.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_1_1b \
        --steps 100 --batch 8 --seq 256 [--full] [--device cpu]

``--full`` trains the architecture at its published widths in its own
dtype; without it ``small_config`` scales it down to ``--d-model``,
``--layers`` and ``--vocab`` in fp32.  Weights are random, drawn from
``seed`` on the device, which is the card unless ``--device cpu`` is
given.  The batches are ``pipeline.synthetic_lm_batch`` (tokens and labels
only), so, as in the JAX package, an encoder-decoder, which reads
``frames``, does not train here: ``train.steps.build_train_step`` trains it
on a batch with frames.

``--mesh single|multi`` trains on the production mesh (16 x 16, or 2 x 16
x 16) over a process group of 256 or 512 ranks, one a card, started as
``torchrun`` starts them (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` in the environment); each rank runs this same command.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data import pipeline
from repro_torch.device import DeviceLike, resolve
from repro_torch.distributed import sharding
from repro_torch.distributed.fault_tolerance import (SupervisorConfig,
                                                     TrainSupervisor)
from repro_torch.models import registry
from repro_torch.train import steps


def small_config(base: ArchConfig, d_model: int, layers: int,
                 vocab: int) -> ArchConfig:
    """Scale an arch config down (same family wiring) for host-side runs."""
    heads = max(4, base.n_heads * d_model // max(base.d_model, 1))
    heads = min(heads, d_model // 16)
    n_kv = max(1, min(base.n_kv, heads))
    while heads % n_kv:
        n_kv -= 1
    hd = d_model // heads
    sections = base.mrope_sections
    if base.rope == "mrope":
        half = hd // 2
        a = half // 4
        b = (half - a) // 2
        sections = (a, b, half - a - b)
    return dataclasses.replace(
        base, num_layers=layers, d_model=d_model, n_heads=heads, n_kv=n_kv,
        d_ff=d_model * 4 if base.d_ff else 0, vocab=vocab,
        head_dim=hd, dtype="float32", mrope_sections=sections)


def run_training(cfg: ArchConfig, *, steps_n: int, global_batch: int,
                 seq_len: int, lr: float = 3e-4, mesh=None,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 100, microbatches: int = 1,
                 log_every: int = 10, seed: int = 0,
                 data_vocab: int | None = None,
                 device: DeviceLike = None) -> dict:
    """``steps_n`` AdamW steps of ``cfg`` from random weights (seed
    ``seed``) on ``device``, remat on; under ``TrainSupervisor`` when
    ``checkpoint_dir`` is given.  Returns ``{"state": {"params", "opt"},
    "losses": [one float a step]}``.  ``data_vocab`` may be smaller than
    the model's vocabulary, so that short demo runs can learn the
    synthetic chain (token ids stay in range).

    With a ``mesh`` every rank draws the same seeded init on the mesh's
    device type (``device`` defaults to it), keeps its blocks of the
    params and optimizer state as ``steps.state_shardings`` places them,
    and each step's batch as ``sharding.batch_specs`` places it; the
    returned state holds DTensors."""
    steps.check_mesh(mesh)
    if device is None and mesh is not None:
        device = mesh.device_type
    dev = resolve(device)
    settings = steps.TrainSettings(learning_rate=lr,
                                   microbatches=microbatches, remat=True,
                                   z_loss=1e-4)
    tx = steps.make_optimizer(settings)
    params = registry.init_params(
        torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    opt_state = tx.init(params)
    dcfg = pipeline.DataConfig(vocab=data_vocab or cfg.vocab,
                               seq_len=seq_len, global_batch=global_batch,
                               seed=seed)
    shardings = batch_sh = None
    if mesh is not None:
        p_sh, o_sh, _, _ = steps.state_shardings(cfg, settings, mesh)
        params = sharding.place_tree(params, p_sh)
        opt_state = sharding.place_tree(opt_state, o_sh)
        shardings = {"params": p_sh, "opt": o_sh}
        batch_sh = sharding.to_named(sharding.batch_specs(
            cfg, {k: torch.empty((global_batch, seq_len), device="meta")
                  for k in ("tokens", "labels")}, mesh), mesh)
    step_fn = steps.build_train_step(cfg, settings, mesh)
    losses = []

    def one_step(state, i):
        batch = pipeline.device_batch(dcfg, i, dev, batch_sh)
        t0 = time.time()
        params, opt, metrics = step_fn(state["params"], state["opt"], batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if i % log_every == 0:
            tokens = global_batch * seq_len
            print(f"step {i:5d}  loss {loss:8.4f}  "
                  f"grad_norm {float(metrics['grad_norm']):8.3f}  "
                  f"{tokens/(time.time()-t0):9.0f} tok/s", flush=True)
        return {"params": params, "opt": opt}

    state = {"params": params, "opt": opt_state}
    del params, opt_state
    if checkpoint_dir:
        sup = TrainSupervisor(
            SupervisorConfig(checkpoint_dir=checkpoint_dir,
                             checkpoint_every=checkpoint_every), state,
            shardings=shardings)
        del state
        state = sup.run(one_step, steps_n)
    else:
        for i in range(steps_n):
            state = one_step(state, i)
    return {"state": state, "losses": losses}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama_1_1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--d-model", type=int, default=256,
                    help="host-run width (full config via --full)")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--full", action="store_true",
                    help="train the full assigned config")
    ap.add_argument("--mesh", default="none",
                    choices=["none", "single", "multi"])
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    base = registry.load_arch(args.arch)
    cfg = base if args.full else small_config(base, args.d_model, args.layers,
                                              args.vocab)
    mesh = None
    if args.mesh != "none":
        from repro_torch.launch.mesh import (init_distributed,
                                             make_production_mesh)
        dev_type = torch.device(args.device).type
        init_distributed(dev_type)
        mesh = make_production_mesh(multi_pod=(args.mesh == "multi"),
                                    device_type=dev_type)
    out = run_training(cfg, steps_n=args.steps, global_batch=args.batch,
                       seq_len=args.seq, lr=args.lr, mesh=mesh,
                       checkpoint_dir=args.checkpoint_dir or None,
                       device=args.device)
    losses = out["losses"]
    print(f"first-10 mean loss {np.mean(losses[:10]):.4f} -> "
          f"last-10 mean {np.mean(losses[-10:]):.4f}")
    return out


if __name__ == "__main__":
    main()
