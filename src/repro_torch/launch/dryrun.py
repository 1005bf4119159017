"""Dry run of every (architecture x input shape) cell on the production
meshes: one step of each on fake tensors over a fake process group, with
this rank's FLOPs, bytes, collectives and memory counted.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_2_3b \\
        --shape train_4k --mesh single --out artifacts/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --device cpu --out artifacts/dryrun

The JAX package lowers and compiles each cell for 256 or 512 chips and
reads the per-device module's statistics.  Here one process plays rank 0
of a fake process group of ``math.prod(mesh shape)`` ranks
(``torch.testing._internal.distributed.fake_pg``: its collectives move
nothing), every tensor is a fake one (``FakeTensorMode``: shapes, dtypes
and devices, no data), and the port's own step runs once on the sharded
state, under ``roofline.counting.count``.  No operator computes anything
on a device; the records feed ``roofline.report``.

``--device`` is the device type of the fake mesh and tensors, ``cuda`` by
default.  It decides the collectives DTensor issues: a "cpu" mesh has no
all-to-all, and DTensor replaces it there by an all-gather and a chunk, so
the collective kinds counted with ``--device cpu`` are not the card's.
Without a card, ``cuda`` raises, as every entry point of the port does.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES, ShapeConfig, shape_supported
from repro_torch.device import resolve
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import (MULTI_POD, SINGLE_POD, axis_sizes,
                                     make_production_mesh, make_test_mesh)
from repro_torch.models import registry
from repro_torch.roofline import analysis, counting
from repro_torch.serve import engine
from repro_torch.train import steps
from repro_torch.tree import tree_map


def mesh_layout(mesh_kind: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(shape, axis names) of ``"single"`` (16x16), ``"multi"`` (2x16x16),
    or a small mesh written ``"2x2"`` (over ("data", "model")) or
    ``"2x2x2"`` (over ("pod", "data", "model"))."""
    if mesh_kind == "single":
        return SINGLE_POD
    if mesh_kind == "multi":
        return MULTI_POD
    shape = tuple(int(n) for n in mesh_kind.split("x"))
    return shape, ("pod", "data", "model")[-len(shape):]


def _fake_like(x, device: torch.device):
    """A tensor of ``x``'s shape and dtype on ``device`` (a fake one under
    ``FakeTensorMode``); anything else as it is."""
    if not isinstance(x, torch.Tensor):
        return x
    return torch.empty(tuple(x.shape), dtype=x.dtype, device=device)


def _placed(tree, shardings):
    """``sharding.place_tree``, each DTensor's local block then given a
    storage of its own: a block split from a whole tensor is a view of the
    whole one, whose storage no rank holds."""
    from torch.distributed.tensor import DTensor

    def own(x):
        if not sharding.is_dtensor(x):
            return x
        return DTensor.from_local(x.to_local().clone(), x.device_mesh,
                                  x.placements, run_check=False,
                                  shape=x.shape, stride=x.stride())

    return tree_map(own, sharding.place_tree(tree, shardings))


def lower_cell(arch_id: str, shape_name: str, mesh,
               settings: steps.TrainSettings | None = None, *,
               cfg=None, shape: ShapeConfig | None = None):
    """Build one (arch x shape) cell on ``mesh``: returns (step, its
    arguments, meta), the arguments placed on the mesh.  Call it under a
    ``FakeTensorMode`` to build them as fake tensors.  ``cfg`` and
    ``shape`` replace the registry's config and ``SHAPES[shape_name]``
    (a test's reduced cell)."""
    cfg = cfg or registry.load_arch(arch_id)
    shape = shape or SHAPES[shape_name]
    ok, why = shape_supported(cfg, shape)
    if not ok:
        raise analysis.CellSkipped(why)
    settings = settings or default_settings(arch_id, shape)
    # microbatches beyond global_batch / batch_shards leave fractional rows
    # per rank: clamp to the mesh, as the JAX package's dry run does
    sizes = axis_sizes(mesh)
    batch_shards = math.prod(sizes.shape[a] for a in ("pod", "data")
                             if a in sizes.axis_names)
    max_micro = max(1, shape.global_batch // batch_shards)
    if settings.microbatches > max_micro:
        settings = dataclasses.replace(settings, microbatches=max_micro)
    dev = torch.device(mesh.device_type)

    def fake(tree):
        return tree_map(lambda x: _fake_like(x, dev), tree)

    def batch_placed(batch):
        return _placed(fake(batch), sharding.to_named(
            sharding.batch_specs(cfg, batch, mesh), mesh))

    if shape.kind == "train":
        step = steps.build_train_step(cfg, settings, mesh)
        p_shard, o_shard, params_s, opt_s = steps.state_shardings(
            cfg, settings, mesh)
        args = (_placed(fake(params_s), p_shard),
                _placed(fake(opt_s), o_shard),
                batch_placed(registry.train_input_specs(cfg, shape)))
    elif shape.kind == "prefill":
        step = engine.build_prefill_step(cfg, shape.seq_len)
        p_shard, _, params_s, _ = engine.serve_shardings(
            cfg, shape, mesh, mode="prefill")
        args = (_placed(fake(params_s), p_shard),
                batch_placed(registry.prefill_input_specs(cfg, shape)))
    else:  # decode
        step = engine.build_decode_step(cfg)
        p_shard, b_shard, params_s, _ = engine.serve_shardings(
            cfg, shape, mesh)
        batch = registry.decode_input_specs(cfg, shape)
        args = (_placed(fake(params_s), p_shard),
                _placed(fake(batch), b_shard))
    return step, args, {"arch": arch_id, "shape": shape.name,
                        "kind": shape.kind}


def default_settings(arch_id: str, shape: ShapeConfig) -> steps.TrainSettings:
    """Per-arch training settings of the JAX package's dry run
    (microbatching bounds stashed activations; Adafactor bounds optimizer
    state for the two largest models)."""
    micro = {"arctic_480b": 16, "qwen2_vl_72b": 16, "mixtral_8x7b": 16,
             "chatglm3_6b": 4, "granite_3_2b": 4, "llama3_2_3b": 4,
             "tinyllama_1_1b": 2, "zamba2_2_7b": 4, "mamba2_780m": 2,
             "seamless_m4t_large_v2": 8}.get(arch_id, 2)
    opt = "adafactor" if arch_id in ("arctic_480b", "qwen2_vl_72b") else "adamw"
    return steps.TrainSettings(microbatches=micro, optimizer=opt, remat=True)


@contextlib.contextmanager
def offsets_on_host():
    """Let DTensor's shard offsets be computed under ``FakeTensorMode``.

    torch 2.13's DTensor computes where a rank's block starts on tensors of
    indices (``torch.arange`` split, then ``.tolist()`` or ``int()``):
    planning a redistribution from a ``_StridedShard`` placement (a dim
    split over two mesh dims through a reshape, common on a 16x16 mesh)
    does, and so does ``compute_local_shape_and_global_offset``, which
    ``models.layers.write`` calls to write a sharded cache.  A fake tensor
    has no values to read.  Inside this context those two functions run
    with every dispatch mode off, on real host tensors of one dim's
    indices, which the counting mode does not see."""
    from torch.distributed.tensor import _utils
    from torch.distributed.tensor.placement_types import _StridedShard
    from torch.utils._python_dispatch import _disable_current_modes
    targets = [(_StridedShard, "local_shard_size_and_offset"),
               (_utils, "_compute_local_shape_and_global_offset")]
    saved = [(owner, name, vars(owner)[name]) for owner, name in targets
             if name in vars(owner)]

    def on_host(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with _disable_current_modes():
                return fn(*args, **kwargs)
        return run

    for owner, name, fn in saved:
        setattr(owner, name, on_host(fn))
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def _start_fake_group(world_size: int) -> None:
    import torch.distributed as dist
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group exists already; a dry run "
                           "starts its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def run_cell(arch_id: str, shape_name: str, mesh_kind: str,
             out_dir: str | None = None, *, device_type: str = "cuda",
             cfg=None, shape: ShapeConfig | None = None) -> dict:
    """One cell's record: built and stepped once on fake tensors over a
    fake group of the mesh's size (``mesh_layout``), which is destroyed
    before it returns; ``cfg`` and ``shape`` as ``lower_cell`` takes them.
    The record is written to ``<out_dir>/<arch>__<shape>__<mesh>.json``
    when ``out_dir`` is given."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    resolve(device_type)
    layout, axes = mesh_layout(mesh_kind)
    t0 = time.time()
    record = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
              "devices": math.prod(layout), "device_type": device_type}
    started = False
    try:
        _start_fake_group(math.prod(layout))
        started = True
        if mesh_kind in ("single", "multi"):
            mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                        device_type=device_type)
        else:
            mesh = make_test_mesh(layout, axes, device_type)
        with offsets_on_host(), FakeTensorMode():
            step, args, meta = lower_cell(arch_id, shape_name, mesh,
                                          cfg=cfg, shape=shape)
            t_lower = time.time() - t0
            _, stats = counting.count(step, *args)
            t_compile = time.time() - t0 - t_lower
        record.update(meta, status="ok", lower_s=round(t_lower, 1),
                      compile_s=round(t_compile, 1))
        record["memory"] = analysis.memory_summary(stats)
        record["cost"] = analysis.cost_summary(stats)
        record["collectives"] = analysis.collective_summary(stats)
        print(record["memory"])
        print(record["cost"])
    except analysis.CellSkipped as e:
        record.update(status="skipped", reason=str(e))
    except Exception as e:                                  # noqa: BLE001
        record.update(status="failed", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
    finally:
        if started:
            dist.destroy_process_group()
    record["total_s"] = round(time.time() - t0, 1)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir,
                            f"{arch_id}__{shape_name}__{mesh_kind}.json")
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose JSON already reports ok/skipped")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device type of the fake mesh and tensors")
    args = ap.parse_args(argv)
    resolve(args.device)

    archs = registry.ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                path = os.path.join(args.out,
                                    f"{arch}__{shape}__{mesh_kind}.json")
                if args.resume and os.path.exists(path):
                    with open(path) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[ resume] {arch} x {shape} x {mesh_kind}",
                              flush=True)
                        continue
                rec = run_cell(arch, shape, mesh_kind, args.out,
                               device_type=args.device)
                status = rec["status"]
                extra = (rec.get("reason") or rec.get("error") or
                         f"{rec.get('compile_s', 0)}s compile")
                print(f"[{status:>7}] {arch} x {shape} x {mesh_kind}: {extra}",
                      flush=True)
                n_fail += status == "failed"
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
