"""The port's distribution layer against the JAX package's, in this process:
the sharding rules at full width (metadata only, on stand-in meshes of the
production sizes), the registry's input specs and ``concrete_batch``, the
int8 quantizer and a one-shard error-feedback all-reduce, ``stack_stages``,
the cell-axis rules, the mesh helpers and the mesh-aware layer helpers on
plain tensors.  The spawned process groups are in
tests/test_torch_distributed_ranks.py.

The rules are compared leaf by leaf, keyed by path: the port's on its
meta-device trees, the reference's on ``jax.eval_shape`` trees.  Both
read a mesh only through ``axis_names`` and ``shape[axis]``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import shape_supported as jshape_supported
from repro.distributed import compression as jcompression
from repro.distributed import pipeline as jpipeline
from repro.distributed import sharding as jsharding
from repro.models import registry as jregistry
from repro.train import steps as jsteps
from repro_torch import optim
from repro_torch.configs.base import SHAPES
from repro_torch.distributed import cellstack, compression, pipeline
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import layers, registry
from repro_torch.train import steps
from repro_torch.tree import leaves


class MockMesh:
    def __init__(self, shape, axes):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


MESHES = {"16x16": MockMesh((16, 16), ("data", "model")),
          "2x16x16": MockMesh((2, 16, 16), ("pod", "data", "model"))}


def _jkey(path) -> str:
    return jsharding._keystr(path)


def _jspecs(tree) -> dict:
    """{path: spec entries} of a reference tree of PartitionSpecs."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {_jkey(p): tuple(s) for p, s in flat}


def _tspecs(tree, prefix="") -> dict:
    """{path: spec entries} of a port tree of specs."""
    if isinstance(tree, sharding.P):
        return {prefix[:-1]: tuple(tree)}
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_tspecs(v, f"{prefix}{k}/"))
    return out


_SHAPES = {}


def _shapes(arch):
    """(reference eval_shape params, port meta params, both configs)."""
    if arch not in _SHAPES:
        jcfg, tcfg = jregistry.load_arch(arch), registry.load_arch(arch)
        jp = jax.eval_shape(
            lambda: jregistry.init_params(jax.random.key(0), jcfg))
        tp = registry.init_params(torch.Generator(), tcfg, device="meta")
        _SHAPES[arch] = (jp, tp, jcfg, tcfg)
    return _SHAPES[arch]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_specs_equal_the_reference_at_full_width(arch, mesh):
    jp, tp, jcfg, tcfg = _shapes(arch)
    m = MESHES[mesh]
    for fsdp in (None, False):
        want = _jspecs(jsharding.param_specs(jcfg, jp, m, fsdp=fsdp))
        got = _tspecs(sharding.param_specs(tcfg, tp, m, fsdp=fsdp))
        assert want and got == want
    want = _jspecs(jsharding.serve_param_specs(jcfg, jp, m))
    assert _tspecs(sharding.serve_param_specs(tcfg, tp, m)) == want


def _spec_list(tree, jax_side):
    if jax_side:
        return [tuple(s) for s in jax.tree.leaves(
            tree, is_leaf=lambda x: isinstance(x, JP))]
    return [tuple(s) for s in leaves(tree, is_leaf=sharding.is_spec)]


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "mixtral_8x7b",
                                  "mamba2_780m", "zamba2_2_7b",
                                  "seamless_m4t_large_v2", "qwen2_vl_72b"])
def test_opt_state_and_state_shardings_equal_the_reference(arch, opt):
    """opt_state_specs matches the optimizer state against the params by
    structure; state_shardings adds ZeRO-1 (fsdp_extend at 4096) to every
    leaf of rank two or more."""
    jp, tp, jcfg, tcfg = _shapes(arch)
    m = MESHES["2x16x16"]
    jset, tset = (jsteps.TrainSettings(optimizer=opt),
                  steps.TrainSettings(optimizer=opt))
    jo = jax.eval_shape(jsteps.make_optimizer(jset).init, jp)
    to = steps.make_optimizer(tset).init(tp)
    jps = jsharding.param_specs(jcfg, jp, m)
    jos = jsharding.opt_state_specs(jo, jp, jps)
    tos = sharding.opt_state_specs(to, tp, sharding.param_specs(tcfg, tp, m))
    assert _spec_list(tos, False) == _spec_list(jos, True)
    jzero = jax.tree.map(
        lambda spec, leaf: (jsharding.fsdp_extend(
            spec, leaf.shape, m, min_size=4096, skip_tp_experts=False)
            if leaf.ndim >= 2 else spec), jos, jo,
        is_leaf=lambda x: isinstance(x, JP))
    p_sh, o_sh, _, _ = steps.state_shardings(tcfg, tset, m)
    assert ([tuple(s.spec) for s in leaves(o_sh)]
            == _spec_list(jzero, True))
    assert ([tuple(s.spec) for s in leaves(p_sh)]
            == _spec_list(jps, True))


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_batch_and_cache_specs_equal_the_reference(arch):
    _, _, jcfg, tcfg = _shapes(arch)
    for mesh in MESHES.values():
        for name, jshape in JSHAPES.items():
            if not jshape_supported(jcfg, jshape)[0]:
                continue
            want = _jspecs(jsharding.batch_specs(
                jcfg, jregistry.train_input_specs(jcfg, jshape), mesh))
            got = _tspecs(sharding.batch_specs(
                tcfg, registry.train_input_specs(tcfg, SHAPES[name]), mesh))
            assert want and got == want, name
        for B in (1, 128):
            jc = jax.eval_shape(lambda: jregistry.init_cache(jcfg, B, 4096))
            tc = registry.init_cache(tcfg, B, 4096, device="meta")
            want = _jspecs(jsharding.cache_specs(jcfg, jc, mesh, B))
            got = _tspecs(sharding.cache_specs(tcfg, tc, mesh, B))
            assert want and got == want, B


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "qwen2_vl_72b",
                                  "seamless_m4t_large_v2", "mamba2_780m"])
def test_input_specs_and_concrete_batch_equal_the_reference(arch):
    jcfg, tcfg = jregistry.load_arch(arch), registry.load_arch(arch)
    shape = JSHAPES["train_4k"]
    small = type(shape)("t", 32, 4, "train")
    for jfn, tfn in ((jregistry.train_input_specs,
                      registry.train_input_specs),
                     (jregistry.prefill_input_specs,
                      registry.prefill_input_specs)):
        js, ts = jfn(jcfg, small), tfn(tcfg, small)
        assert set(js) == set(ts)
        for k in js:
            assert tuple(js[k].shape) == tuple(ts[k].shape)
            assert str(js[k].dtype) == str(ts[k].dtype).split(".")[1]
        jb, tb = (jregistry.concrete_batch(js, seed=3),
                  registry.concrete_batch(ts, seed=3))
        for k in jb:
            np.testing.assert_array_equal(
                np.asarray(jb[k], np.float32), tb[k].float().numpy())
    jd = jregistry.decode_input_specs(jcfg, small)
    td = registry.decode_input_specs(tcfg, small)
    assert tuple(td["token"].shape) == tuple(jd["token"].shape)
    tb = registry.concrete_batch(td, seed=0)
    assert all(float(v.abs().sum()) == 0 for v in tb["cache"].values()
               if isinstance(v, torch.Tensor))


def test_quantizer_and_one_shard_all_reduce_equal_the_reference():
    rng = np.random.default_rng(0)
    g = rng.standard_normal((33, 17)).astype(np.float32) * 3
    e = rng.standard_normal((33, 17)).astype(np.float32) * 1e-2
    # a value at an exact half step: round half to even on both sides
    g[0, 0] = 2.5 * float(np.abs(g).max()) / 127.0 / 1.0
    jq, js = jcompression.quantize_int8(jnp.asarray(g))
    tq, ts = compression.quantize_int8(torch.from_numpy(g))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    assert float(js) == float(ts)
    np.testing.assert_array_equal(
        np.asarray(jcompression.dequantize(jq, js)),
        compression.dequantize(tq, ts).numpy())
    from jax.experimental.shard_map import shard_map
    jmesh = jax.make_mesh((1,), ("data",))
    grads = {"a": g, "b": g[:5, :3] * 7}
    errs = {"a": e, "b": e[:5, :3]}
    jfn = shard_map(
        lambda gg, ee: jcompression.ef_compress_allreduce(gg, ee, ("data",)),
        mesh=jmesh, in_specs=(JP(), JP()), out_specs=(JP(), JP()),
        check_rep=False)
    jg, je = jfn(jax.tree.map(jnp.asarray, grads),
                 jax.tree.map(jnp.asarray, errs))
    tg, te = compression.ef_compress_allreduce(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        {k: torch.from_numpy(v) for k, v in errs.items()}, ())
    for k in grads:
        np.testing.assert_array_equal(np.asarray(jg[k]), tg[k].numpy())
        np.testing.assert_array_equal(np.asarray(je[k]), te[k].numpy())
    with pytest.raises(ValueError):
        compression.ef_compress_allreduce(tg, te, ("data",))
    z = compression.init_errors({"w": torch.ones(3, 2)})
    assert z["w"].dtype == torch.float32 and not z["w"].any()


def test_stack_stages_equals_the_reference():
    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((8, 3, 4)).astype(np.float32),
            "b": rng.standard_normal((8, 4)).astype(np.float32)}
    want = jpipeline.stack_stages(jax.tree.map(jnp.asarray, tree), 4)
    got = pipeline.stack_stages({k: torch.from_numpy(v)
                                 for k, v in tree.items()}, 4)
    for k in tree:
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy())
    with pytest.raises(ValueError):
        pipeline.stack_stages({"w": torch.zeros(6, 2)}, 4)


def test_cell_axis_rules():
    """No card here, so no cells mesh, as the reference's one CPU device
    gives none; with 3 cells a mesh could not divide them either."""
    assert cellstack.stack_mesh(4) is None
    assert cellstack.stack_mesh(3) is None
    specs = cellstack.cell_specs({"w": torch.zeros(2, 3),
                                  "b": [torch.zeros(2)]})
    assert tuple(specs["w"]) == ("cells",) == tuple(specs["b"][0])
    devs = (torch.device("cpu"), torch.device("cpu"))
    mesh = cellstack.CellMesh(devs)
    assert mesh.shape == {"cells": 2} and mesh.axis_names == ("cells",)
    parts = cellstack._shard(list("abcd"), mesh, torch.device("cpu"))
    assert [p[1] for p in parts] == [["a", "b"], ["c", "d"]]
    assert cellstack._shard(list("abc"), None, devs[0]) == [
        (devs[0], ["a", "b", "c"])]


def test_mesh_helpers_without_a_process_group():
    m = MESHES["2x16x16"]
    assert mesh_lib.batch_axes(m) == ("pod", "data")
    assert mesh_lib.batch_axes(MESHES["16x16"]) == ("data",)
    assert mesh_lib.model_axis(m) == "model"
    assert mesh_lib.num_chips(m) == 512
    assert mesh_lib.axis_sizes(m).shape == {"pod": 2, "data": 16,
                                            "model": 16}
    assert mesh_lib.current_mesh() is None
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_production_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_test_mesh((2, 2))
    with pytest.raises(RuntimeError, match="RANK"):
        mesh_lib.init_distributed("cpu")


def test_placements_of_specs():
    """Each mesh dimension shards the tensor dim that names its axis; a
    dim named by two axes is split by both, in mesh-dimension order."""
    from torch.distributed.tensor import Replicate, Shard

    class Dm:
        mesh_dim_names = ("data", "model")

    P = sharding.P
    ns = sharding.NamedSharding
    assert ns(Dm(), P("model", None)).placements == (Replicate(), Shard(0))
    assert ns(Dm(), P(None, ("model", "data"))).placements == (Shard(1),
                                                                Shard(1))
    assert ns(Dm(), P()).placements == (Replicate(), Replicate())
    assert ns(Dm(), P(("pod", "data"), None)).placements == (Shard(0),
                                                             Replicate())


def test_layer_helpers_on_plain_tensors():
    """Outside a mesh: maybe_shard is the identity, replicated calls its
    function, new_cache fills plain tensors, and write is an index
    assignment."""
    x = torch.randn(2, 3)
    assert layers.maybe_shard(x, "batch", None) is x
    assert layers.replicated(lambda a, b: a + b, x, 1.0).equal(x + 1.0)
    cache = layers.new_cache(None, {"c": ((2, 4, 3), torch.float32, 0),
                                    "f": ((2, 2), torch.int32, -1)}, 2, x)
    c, f = cache["c"], cache["f"]
    assert type(c) is torch.Tensor and f.dtype == torch.int32
    layers.write(c, (1, slice(None), 2), torch.arange(4.0))
    assert c[1, :, 2].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert float(c.sum()) == 6.0
    layers.write(f, (torch.tensor([[0], [1]]), torch.tensor([[1], [0]])),
                 torch.tensor([[5], [6]], dtype=torch.int32))
    assert f.tolist() == [[-1, 5], [6, -1]]
    with mesh_lib.use_mesh(None) as m:
        assert m is None and mesh_lib.current_mesh() is None


def test_use_mesh_nests_and_restores_implicit_replication():
    before = torch._C._get_dtensor_allow_implicit_replication()
    token = object()
    with mesh_lib.use_mesh(token):
        with mesh_lib.use_mesh(token):
            assert torch._C._get_dtensor_allow_implicit_replication()
        assert torch._C._get_dtensor_allow_implicit_replication()
        assert mesh_lib.current_mesh() is token
    assert torch._C._get_dtensor_allow_implicit_replication() == before
    assert mesh_lib.current_mesh() is None


def test_the_mesh_path_replaces_the_refusal():
    """The single-device guard is gone; Adam's moments have the params'
    structure, which opt_state_specs matches them by."""
    assert not hasattr(steps, "no_mesh")
    tp = registry.init_params(torch.Generator(),
                              registry.load_arch("tinyllama_1_1b"),
                              device="meta")
    assert (sharding._structure(optim.adamw(1e-3).init(tp)[1].mu)
            == sharding._structure(tp))
