"""The port's dry run (repro_torch.launch.dryrun) on fake 2x2 and 1x1 "cpu"
meshes, with reduced configs: one step of a dense train, prefill and
decode cell and a 4-expert MoE decode and prefill cell, each on fake
tensors over a fake process group, counted per rank.

Every dry run starts a fake process group, so they all run in one
subprocess (``_CELLS``), which prints its records as JSON:
``launch.mesh.init_distributed`` keeps whatever group a process already
has, and a group left in this worker would serve every later test in it.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import shape_supported as jshape_supported

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The record keys of the JAX package's dry run (src/repro/launch/dryrun.py,
# run_cell): every record, an ok one, and its collectives' and memory's.
RECORD_KEYS = {"arch", "shape", "mesh", "devices", "status", "total_s"}
OK_KEYS = RECORD_KEYS | {"kind", "lower_s", "compile_s", "memory", "cost",
                         "collectives"}
COLLECTIVE_KEYS = {"bytes_by_kind", "total_wire_bytes", "unknown_trip_loops",
                   "parsed_flops", "parsed_bytes_accessed", "dots"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "alias_size_in_bytes",
               "total_bytes_per_device"}

_CELLS = """
    import contextlib, io, json, sys
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs.base import ArchConfig, MoEConfig, ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import registry
    from repro_torch.roofline import counting
    from repro_torch.train import steps
    from repro_torch.tree import leaves, tree_map

    out_dir = sys.argv[1]
    dense = ArchConfig(name="dense-r", family="transformer", num_layers=2,
                       d_model=128, n_heads=4, n_kv=2, d_ff=512, vocab=512,
                       head_dim=32, dtype="float32")
    moe = ArchConfig(name="mixtral-r", family="moe", num_layers=2,
                     d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512,
                     head_dim=32, window=16,
                     moe=MoEConfig(num_experts=4, top_k=2,
                                   capacity_factor=2.0),
                     dtype="float32")
    shapes = {"train": ShapeConfig("train_r", 32, 8, "train"),
              "prefill": ShapeConfig("prefill_r", 64, 4, "prefill"),
              "decode": ShapeConfig("decode_r", 64, 8, "decode")}
    recs = {}
    for kind, shape in shapes.items():
        recs[f"dense-{kind}"] = dryrun.run_cell(
            "tinyllama_1_1b", shape.name, "2x2", device_type="cpu",
            cfg=dense, shape=shape)
    recs["moe-decode"] = dryrun.run_cell(
        "mixtral_8x7b", "decode_r", "2x2", device_type="cpu", cfg=moe,
        shape=shapes["decode"])
    # 4 groups of 4096 tokens, split over "data": serving's scan over them
    recs["moe-prefill"] = dryrun.run_cell(
        "mixtral_8x7b", "prefill_g", "2x2", device_type="cpu", cfg=moe,
        shape=ShapeConfig("prefill_g", 4096, 4, "prefill"))
    recs["dense-train-1x1"] = dryrun.run_cell(
        "tinyllama_1_1b", "train_r", "1x1", device_type="cpu", cfg=dense,
        shape=shapes["train"])

    # the same train step with mesh=None, on fake tensors, no group
    settings = dryrun.default_settings("tinyllama_1_1b", shapes["train"])
    with FakeTensorMode():
        p_s, o_s = steps.abstract_state(dense, settings)
        fake = lambda t: tree_map(lambda x: torch.empty(
            tuple(x.shape), dtype=x.dtype)
            if isinstance(x, torch.Tensor) else x, t)
        batch = fake(registry.train_input_specs(dense, shapes["train"]))
        _, st = counting.count(steps.build_train_step(dense, settings),
                               fake(p_s), fake(o_s), batch)
    state_bytes = sum(x.numel() * x.element_size()
                      for x in leaves((p_s, o_s)))

    # a full-attention config at long_500k; then the registry's
    # tinyllama-1.1b there on 16x16, its record written by run_cell, which
    # the CLI resumes past
    recs["long"] = dryrun.run_cell("tinyllama_1_1b", "long_500k", "2x2",
                                   device_type="cpu", cfg=dense)
    recs["long-single"] = dryrun.run_cell(
        "tinyllama_1_1b", "long_500k", "single", out_dir, device_type="cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            dryrun.main(["--arch", "tinyllama_1_1b", "--shape", "long_500k",
                         "--mesh", "single", "--device", "cpu", "--out",
                         out_dir, "--resume"])
        except SystemExit as e:
            code = e.code
    print("RESULT " + json.dumps({
        "recs": recs, "none_flops": st.flops, "state_bytes": state_bytes,
        "resume_out": buf.getvalue(), "resume_code": code}))
"""


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(_CELLS),
                          str(out_dir)], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    line = next(l for l in res.stdout.splitlines()
                if l.startswith("RESULT "))
    return dict(json.loads(line[len("RESULT "):]), out_dir=out_dir)


OK_CELLS = ["dense-train", "dense-prefill", "dense-decode", "moe-decode",
            "moe-prefill", "dense-train-1x1"]


@pytest.mark.parametrize("cell", OK_CELLS)
def test_cell_is_ok_with_the_reference_keys(dry, cell):
    rec = dry["recs"][cell]
    assert rec["status"] == "ok", rec.get("traceback")
    assert OK_KEYS <= set(rec), OK_KEYS - set(rec)
    assert set(rec["collectives"]) == COLLECTIVE_KEYS
    assert set(rec["memory"]) == MEMORY_KEYS
    assert set(rec["cost"]) == {"flops", "bytes_accessed"}
    assert rec["device_type"] == "cpu"
    assert rec["devices"] == (1 if cell.endswith("1x1") else 4)
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
    assert rec["collectives"]["parsed_flops"] == rec["cost"]["flops"]
    assert rec["collectives"]["unknown_trip_loops"] == 0
    assert rec["collectives"]["dots"] > 0


@pytest.mark.parametrize("cell", OK_CELLS)
def test_per_rank_memory_is_below_the_whole_state(dry, cell):
    mem = dry["recs"][cell]["memory"]
    assert mem["alias_size_in_bytes"] == 0
    assert mem["total_bytes_per_device"] == (
        mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
        + mem["temp_size_in_bytes"])
    if cell == "dense-train":
        # a 2x2 rank holds half the params and AdamW moments (split on
        # "model"; these leaves are too small for ZeRO-1's "data" split),
        # and less at its peak than the one rank of a 1x1 mesh, which
        # holds them all
        assert mem["argument_size_in_bytes"] < 0.51 * dry["state_bytes"]
        whole = dry["recs"]["dense-train-1x1"]["memory"]
        assert mem["total_bytes_per_device"] < \
            0.51 * whole["total_bytes_per_device"]
    if cell == "dense-train-1x1":
        assert mem["argument_size_in_bytes"] > dry["state_bytes"]


def test_training_on_the_mesh_gathers(dry):
    coll = dry["recs"]["dense-train"]["collectives"]
    assert coll["bytes_by_kind"].get("all-gather", 0) > 0
    # the wire bytes weigh all-reduces twice
    by_kind = coll["bytes_by_kind"]
    assert coll["total_wire_bytes"] == sum(
        v * (2 if k == "all-reduce" else 1) for k, v in by_kind.items())
    # the 1x1 mesh has nothing to gather from
    assert dry["recs"]["dense-train-1x1"]["collectives"]["bytes_by_kind"] \
        .get("all-gather", 0) == 0


def test_one_rank_mesh_counts_the_unsharded_step(dry):
    assert dry["recs"]["dense-train-1x1"]["cost"]["flops"] == \
        dry["none_flops"]
    # a 2x2 rank does less than the whole step
    assert dry["recs"]["dense-train"]["cost"]["flops"] < dry["none_flops"]


def test_long_context_on_full_attention_is_skipped(dry):
    rec = dry["recs"]["long"]
    cfg = JArchConfig(name="dense-r", family="transformer", num_layers=2,
                      d_model=128, n_heads=4, n_kv=2, d_ff=512, vocab=512)
    assert rec["status"] == "skipped"
    assert rec["reason"] == jshape_supported(cfg, JSHAPES["long_500k"])[1]
    assert RECORD_KEYS <= set(rec)


def test_run_cell_writes_its_record_and_resume_skips_it(dry):
    path = dry["out_dir"] / "tinyllama_1_1b__long_500k__single.json"
    assert json.loads(path.read_text()) == dry["recs"]["long-single"]
    assert dry["recs"]["long-single"]["devices"] == 256
    assert dry["resume_code"] == 0
    assert "[ resume] tinyllama_1_1b x long_500k x single" in \
        dry["resume_out"]
