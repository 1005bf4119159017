"""The port's roofline accounting (repro_torch.roofline: counting, analysis,
report) against the JAX package's (repro.roofline: hlo_parse, analysis,
report), on the reference test's own programs and records
(tests/test_roofline.py), on whole steps of reduced configs, and on every
architecture's MODEL_FLOPS.

The JAX side is compiled, never run: ``hlo_parse.analyze`` reads the
optimized HLO of ``jax.jit(f).lower(shapes).compile()``.  The port's side
runs on fake tensors (``FakeTensorMode``), which carry shapes and no data,
so neither side computes anything.  A per-rank count on a fake 16x16 or
8-rank mesh needs a fake process group, which the per-rank tests start in
one subprocess: ``launch.mesh.init_distributed`` keeps whatever group a
process already has, so a group left in this worker would serve every
later test in it.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.base import SHAPES as JSHAPES
from repro.models import registry as jregistry
from repro.roofline import analysis as janalysis
from repro.roofline import hlo_parse
from repro.roofline import report as jreport
from repro.train import steps as jsteps
from repro_torch.configs.base import SHAPES
from repro_torch.models import registry
from repro_torch.roofline import analysis, counting, report
from repro_torch.train import steps
from repro_torch.tree import tree_map
from test_torch_lm import ARCH_KW, REDUCED, _cfgs

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A whole step's count against the reference's: within 1e-2 relative.
# Measured: the dense and MoE configs' counts equal the reference's exactly
# in all four steps; mamba2-r's train step counts 0.30% fewer (0.35%
# without remat), in the backward of the SSD scan (ROADMAP §3).
STEP_RTOL = 1e-2


def _jflops(fn, *args) -> float:
    """``hlo_parse``'s FLOPs of ``fn`` jitted and compiled for ``args``."""
    text = jax.jit(fn).lower(*args).compile().as_text()
    return hlo_parse.analyze(text).flops


# ---------------------------------------------------------------------------
# 1. The counter against hlo_parse on the reference test's programs
# ---------------------------------------------------------------------------

class TestCounterAgainstHloParse:
    def test_single_matmul_flops_and_bytes(self):
        a, b = torch.ones(64, 128), torch.ones(128, 32)
        _, st = counting.count(lambda a, b: a @ b, a, b)
        ref = _jflops(lambda a, b: a @ b, jnp.ones((64, 128)),
                      jnp.ones((128, 32)))
        assert st.flops == ref == 2 * 64 * 128 * 32
        assert st.dots == 1
        # bytes: at least read a + b, write out
        assert st.bytes_accessed >= (64 * 128 + 128 * 32 + 64 * 32) * 4

    def test_loop_counts_every_layer(self):
        # the reference's lax.scan over 7 layers is a Python loop here
        L = 7

        def torch_f(x, ws):
            for w in ws:
                x = torch.tanh(x @ w)
            return x

        def jax_f(x, ws):
            out, _ = jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), x,
                                  ws)
            return out

        _, st = counting.count(torch_f, torch.ones(32, 64),
                               torch.ones(L, 64, 64))
        ref = _jflops(jax_f, jnp.ones((32, 64)), jnp.ones((L, 64, 64)))
        assert st.flops == ref == L * 2 * 32 * 64 * 64
        assert st.unknown_trip_loops == 0

    def test_nested_loops_multiply(self):
        def torch_f(x, ws):
            for w_outer in ws:
                for w in w_outer:
                    x = x @ w
            return x

        def jax_f(x, ws):
            def outer(c, w_outer):
                ci, _ = jax.lax.scan(lambda ci, w: (ci @ w, None), c,
                                     w_outer)
                return ci, None
            out, _ = jax.lax.scan(outer, x, ws)
            return out

        _, st = counting.count(torch_f, torch.ones(16, 16),
                               torch.ones(3, 5, 16, 16))
        ref = _jflops(jax_f, jnp.ones((16, 16)), jnp.ones((3, 5, 16, 16)))
        assert st.flops == ref == 15 * 2 * 16 * 16 * 16

    def test_batched_einsum(self):
        eq = "bik,bkj->bij"
        _, st = counting.count(lambda a, b: torch.einsum(eq, a, b),
                               torch.ones(4, 8, 16), torch.ones(4, 16, 8))
        ref = _jflops(lambda a, b: jnp.einsum(eq, a, b),
                      jnp.ones((4, 8, 16)), jnp.ones((4, 16, 8)))
        assert st.flops == ref == 2 * 4 * 8 * 16 * 8

    def test_convolution_flops(self):
        # NCHW x OIHW here, NHWC x HWIO there: the same convolution
        x, w = torch.ones(2, 3, 8, 8), torch.ones(4, 3, 3, 3)
        _, st = counting.count(
            lambda x, w: torch.nn.functional.conv2d(x, w, padding=1), x, w)
        ref = _jflops(lambda x, w: jax.lax.conv_general_dilated(
            x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")),
            jnp.ones((2, 8, 8, 3)), jnp.ones((3, 3, 3, 4)))
        assert st.flops == ref == 2 * (2 * 4 * 8 * 8) * (3 * 3 * 3)
        # the backward computes both gradients, each the forward's products
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()

        def grads(x, w):
            y = torch.nn.functional.conv2d(x, w, padding=1)
            return torch.autograd.grad(y.sum(), (x, w))

        _, st = counting.count(grads, xg, wg)
        assert st.flops == 3 * ref

    def test_counting_changes_no_value(self):
        rng = np.random.default_rng(0)
        a = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
        w = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))

        def f(a, w):
            return torch.softmax(torch.tanh(a @ w), -1)

        out, st = counting.count(f, a, w)
        assert torch.equal(out, f(a, w))
        # the arguments' storages, the result's, and at least both at once
        assert st.argument_bytes == (8 * 16 + 16 * 4) * 4
        assert st.output_bytes == 8 * 4 * 4
        assert st.peak_bytes >= st.argument_bytes + st.output_bytes

    def test_views_and_allocations_move_no_bytes(self):
        x = torch.ones(64, 32)

        def f(x):
            y = x.t().reshape(-1)[1:].unsqueeze(0).expand(2, 2047)
            torch.empty(1000)
            return y

        _, st = counting.count(f, x)
        # only flattening the transposed view copies: read and write
        assert st.bytes_accessed == 2 * 64 * 32 * 4
        assert st.flops == 0
        assert st.output_bytes == 64 * 32 * 4


# ---------------------------------------------------------------------------
# 2. The per-rank rule on fake meshes (a subprocess, see the docstring)
# ---------------------------------------------------------------------------

_PER_RANK = """
    import json
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.roofline import counting

    out = {}
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
    with FakeTensorMode():
        a = torch.empty(4096, 8192)
        b = torch.empty(8192, 8192)
        sa = distribute_tensor(a, mesh, [Shard(0), Replicate()],
                               src_data_rank=None)
        sb = distribute_tensor(b, mesh, [Replicate(), Shard(1)],
                               src_data_rank=None)
        c, st = counting.count(lambda x, y: x @ y, sa, sb)
        out["sharded"] = [st.flops, [repr(p) for p in c.placements],
                          st.bytes_accessed]
        ra = distribute_tensor(a, mesh, [Replicate(), Replicate()],
                               src_data_rank=None)
        rb = distribute_tensor(b, mesh, [Replicate(), Replicate()],
                               src_data_rank=None)
        c, st = counting.count(lambda x, y: x @ y, ra, rb)
        out["replicated"] = [st.flops, [repr(p) for p in c.placements]]
    dist.destroy_process_group()

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(64, 32), mesh, [Shard(0)],
                              src_data_rank=None)
        s, st = counting.count(lambda x: x.sum().full_tensor(), x)
        out["sum"] = [st.collective_bytes_by_kind, st.collective_wire_bytes]
        # Shard(0) -> Shard(1): an all-to-all on the card's mesh
        y, st = counting.count(
            lambda x: x.redistribute(mesh, [Shard(1)]), x)
        out["reshard"] = [st.collective_bytes_by_kind,
                          list(y.to_local().shape)]
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def per_rank():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(_PER_RANK)],
                         capture_output=True, text=True, env=env,
                         timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    line = next(l for l in res.stdout.splitlines()
                if l.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


class TestPerRankRule:
    def test_sharded_product_counts_a_rank_share(self, per_rank):
        flops, placements, nbytes = per_rank["sharded"]
        # output Shard(0) on data and Shard(1) on model: 256 shares
        assert placements == ["Shard(dim=0)", "Shard(dim=1)"]
        assert flops == 2 * 4096 * 8192 * 8192 / 256
        # the local blocks: (256, 8192) @ (8192, 512) -> (256, 512), fp32
        assert nbytes == (256 * 8192 + 8192 * 512 + 256 * 512) * 4

    def test_replicated_product_costs_every_rank_the_whole(self, per_rank):
        flops, placements = per_rank["replicated"]
        assert placements == ["Replicate()", "Replicate()"]
        assert flops == 2 * 4096 * 8192 * 8192

    def test_sum_of_a_sharded_tensor_all_reduces(self, per_rank):
        by_kind, wire = per_rank["sum"]
        # a scalar partial sum: wire = 2 x 4 bytes
        assert "all-reduce" in by_kind, by_kind
        assert wire >= 8


    def test_shard_to_shard_on_a_cpu_mesh_gathers(self, per_rank):
        # a "cpu" mesh has no all-to-all: DTensor gathers the whole
        # (64, 32) tensor and keeps a chunk, so the kinds counted on the
        # CPU are not the card's
        by_kind, local_shape = per_rank["reshard"]
        assert local_shape == [64, 4]
        assert "all-to-all" not in by_kind
        assert by_kind["all-gather"] == 64 * 32 * 4


# ---------------------------------------------------------------------------
# 3. Whole steps against the reference, one device, fp32
# ---------------------------------------------------------------------------

B, S, MAX_LEN = 2, 16, 32
STEP_CONFIGS = ["tinyllama-r", "mixtral-r", "mamba2-r"]
STEPS = ["forward", "prefill", "decode", "train"]


def _fake(tree):
    return tree_map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype)
                    if isinstance(x, torch.Tensor) else x, tree)


def _ref_step_flops(jcfg, step: str) -> float:
    params = jax.eval_shape(lambda: jregistry.init_params(jax.random.key(0),
                                                          jcfg))
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    if step == "forward":
        return _jflops(lambda p, b: jregistry.forward(p, jcfg, b), params,
                       {"tokens": tok})
    if step == "prefill":
        return _jflops(lambda p, b: jregistry.prefill(p, jcfg, b, MAX_LEN),
                       params, {"tokens": tok})
    if step == "decode":
        cache = jax.eval_shape(lambda: jregistry.init_cache(jcfg, B, MAX_LEN))
        return _jflops(lambda p, t, c: jregistry.decode_step(p, jcfg, t, c),
                       params, jax.ShapeDtypeStruct((B, 1), jnp.int32), cache)
    settings = jsteps.TrainSettings(remat=True)
    p_s, o_s = jsteps.abstract_state(jcfg, settings)
    return _jflops(jsteps.build_train_step(jcfg, settings), p_s, o_s,
                   {"tokens": tok, "labels": tok})


def _port_step_flops(tcfg, step: str) -> float:
    settings = steps.TrainSettings(remat=True)
    with FakeTensorMode():
        p_s, o_s = steps.abstract_state(tcfg, settings)
        params = _fake(p_s)
        tokens = torch.empty((B, S), dtype=torch.int32)
        if step == "forward":
            fn = lambda: registry.forward(params, tcfg, {"tokens": tokens})
        elif step == "prefill":
            fn = lambda: registry.prefill(params, tcfg, {"tokens": tokens},
                                          MAX_LEN)
        elif step == "decode":
            cache = _fake(registry.init_cache(tcfg, B, MAX_LEN,
                                              device="meta"))
            token = torch.empty((B, 1), dtype=torch.int32)
            fn = lambda: registry.decode_step(params, tcfg, token, cache)
        else:
            train_step = steps.build_train_step(tcfg, settings)
            opt = _fake(o_s)
            fn = lambda: train_step(params, opt, {"tokens": tokens,
                                                  "labels": tokens})
        return counting.count(fn)[1].flops


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("config", STEP_CONFIGS)
def test_step_flops_match_the_reference(config, step):
    jcfg, tcfg = _cfgs(REDUCED.get(config) or ARCH_KW[config])
    ref = _ref_step_flops(jcfg, step)
    got = _port_step_flops(tcfg, step)
    assert ref > 0
    assert abs(got - ref) <= STEP_RTOL * ref, (got, ref, got / ref - 1)


# ---------------------------------------------------------------------------
# 4. analysis against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_model_flops_equal_the_reference(arch):
    jcfg, tcfg = jregistry.load_arch(arch), registry.load_arch(arch)
    for name in SHAPES:
        ref = janalysis.model_flops(jcfg, JSHAPES[name])
        assert analysis.model_flops(tcfg, SHAPES[name]) == pytest.approx(
            ref, rel=1e-12), (arch, name)


# tests/test_roofline.py::TestRooflineTerms::test_terms_and_bottleneck
RECORD = {
    "devices": 256,
    "cost": {"flops": 1e12, "bytes_accessed": 1e9},
    "collectives": {"total_wire_bytes": 5e9, "parsed_flops": 2e12,
                    "parsed_bytes_accessed": 2e9},
}


def test_terms_and_bottleneck_over_the_cards_peaks():
    rl = analysis.roofline_from_record(RECORD, model_flops=1e14)
    ref = janalysis.roofline_from_record(RECORD, model_flops=1e14)
    assert rl.hlo_flops == ref.hlo_flops == 2e12
    assert rl.compute_s == 2e12 / 989e12 == 2e12 / analysis.PEAK_FLOPS
    assert rl.memory_s == 2e9 / 3.35e12 == 2e9 / analysis.HBM_BW
    assert rl.collective_s == 5e9 / 450e9 == 5e9 / analysis.LINK_BW
    assert rl.useful_ratio == ref.useful_ratio == 1e14 / (2e12 * 256)
    assert rl.bottleneck == "collective"
    # a record without parsed counts falls back to cost, as the reference's
    bare = {"devices": 1, "cost": {"flops": 4e15, "bytes_accessed": 1e9}}
    assert analysis.roofline_from_record(bare, 1e15).bottleneck == "compute"


def test_summaries_of_a_count():
    st = counting.ModuleStats(
        flops=3e9, bytes_accessed=7e8,
        collective_bytes_by_kind={"all-gather": 100.0, "all-reduce": 10.0},
        collective_wire_bytes=120.0, unknown_trip_loops=0, dots=5,
        argument_bytes=1000, output_bytes=300, peak_bytes=2500)
    assert analysis.memory_summary(st) == {
        "argument_size_in_bytes": 1000, "output_size_in_bytes": 300,
        "temp_size_in_bytes": 1200, "alias_size_in_bytes": 0,
        "total_bytes_per_device": 2500}
    assert analysis.cost_summary(st) == {"flops": 3e9,
                                         "bytes_accessed": 7e8}
    assert analysis.collective_summary(st) == {
        "bytes_by_kind": {"all-gather": 100, "all-reduce": 10},
        "total_wire_bytes": 120, "unknown_trip_loops": 0,
        "parsed_flops": 3e9, "parsed_bytes_accessed": 7e8, "dots": 5}


# ---------------------------------------------------------------------------
# 5. report against the reference
# ---------------------------------------------------------------------------

def test_fmt_s_equals_the_reference():
    for x in (0.0, 3e-7, 4.2e-5, 1e-3, 0.0123, 0.999, 1.0, 12.345):
        assert report.fmt_s(x) == jreport.fmt_s(x)


ROWS = [
    {"arch": "tinyllama_1_1b", "shape": "long_500k", "skip": "skip: x"},
    {"arch": "mixtral_8x7b", "shape": "decode_32k", "compute_s": 2.5e-4,
     "memory_s": 0.0771, "collective_s": 1.3, "bottleneck": "collective",
     "useful_ratio": 0.125, "roofline_fraction": 0.00321,
     "mem_gb": 3.58},
]


def test_markdown_table_equals_the_reference():
    assert report.markdown_table(ROWS) == jreport.markdown_table(ROWS)


def test_write_marker_and_load_records_equal_the_reference(tmp_path):
    text = ("# Doc\n\n<!-- ROOFLINE_TABLE -->\n\n| old | table |\n|---|---|"
            "\n\nAfter the table.\n")
    table = report.markdown_table(ROWS)
    for name, mod in (("port.md", report), ("ref.md", jreport)):
        (tmp_path / name).write_text(text)
        mod.write_marker(str(tmp_path / name), "ROOFLINE_TABLE", table)
        mod.write_marker(str(tmp_path / name), "ROOFLINE_TABLE", table)
    assert (tmp_path / "port.md").read_text() == \
        (tmp_path / "ref.md").read_text()
    with pytest.raises(SystemExit):
        report.write_marker(str(tmp_path / "port.md"), "ABSENT", table)

    recs = tmp_path / "recs"
    recs.mkdir()
    for i, r in enumerate([{"arch": "b", "n": 1}, {"arch": "a", "n": 2}]):
        (recs / f"{'ba'[i]}__x__single.json").write_text(json.dumps(r))
    assert report.load_records(str(recs)) == \
        jreport.load_records(str(recs)) == [{"arch": "a", "n": 2},
                                            {"arch": "b", "n": 1}]


def test_roofline_rows_follow_the_formula():
    rec = {"arch": "tinyllama_1_1b", "shape": "train_4k", "mesh": "single",
           "devices": 256, "status": "ok",
           "memory": {"total_bytes_per_device": 3.2e10},
           "cost": {"flops": 5e13, "bytes_accessed": 2e12},
           "collectives": {"total_wire_bytes": 9e10, "parsed_flops": 5e13,
                           "parsed_bytes_accessed": 2e12}}
    skipped = {"arch": "tinyllama_1_1b", "shape": "long_500k",
               "mesh": "single", "status": "skipped", "reason": "skip: x"}
    failed = {"arch": "mamba2_780m", "shape": "train_4k", "mesh": "single",
              "status": "failed", "error": "E"}
    other_mesh = dict(rec, mesh="multi")
    rows = report.roofline_rows([rec, skipped, failed, other_mesh])
    assert [r.get("skip") for r in rows] == [None, "skip: x", "FAILED: E"]
    row = rows[0]
    mf = analysis.model_flops(registry.load_arch("tinyllama_1_1b"),
                              SHAPES["train_4k"])
    terms = {"compute": 5e13 / 989e12, "memory": 2e12 / 3.35e12,
             "collective": 9e10 / 450e9}
    assert row["compute_s"] == terms["compute"]
    assert row["memory_s"] == terms["memory"]
    assert row["collective_s"] == terms["collective"]
    assert row["bottleneck"] == max(terms, key=terms.get)
    assert row["useful_ratio"] == mf / (5e13 * 256)
    assert row["roofline_fraction"] == pytest.approx(
        mf / 256 / 989e12 / max(terms.values()), rel=1e-15)
    assert row["mem_gb"] == 32.0
    # the reference's rows of the same record: its own peaks, same shape
    ref = jreport.roofline_rows([rec, skipped, failed, other_mesh])
    assert [sorted(r) for r in ref] == [sorted(r) for r in rows]
    assert ref[0]["model_flops"] == pytest.approx(row["model_flops"],
                                                  rel=1e-12)


def test_status_table_gives_each_cell_on_both_meshes():
    recs = [{"arch": "tinyllama_1_1b", "shape": "train_4k", "mesh": m,
             "status": "ok", "compile_s": t}
            for m, t in (("single", 25.8), ("multi", 30.1))]
    recs += [{"arch": "tinyllama_1_1b", "shape": "long_500k",
              "mesh": "single", "status": "skipped"},
             {"arch": "llama3_2_3b", "shape": "train_4k", "mesh": "multi",
              "status": "failed"}]
    assert report.status_table(recs).splitlines() == [
        "| arch | train_4k | long_500k |",
        "|---|---|---|",
        "| llama3_2_3b | — / failed | — / — |",
        "| tinyllama_1_1b | ok 25.8 s / ok 30.1 s | skipped / — |"]
