"""The port's mixture of experts (``repro_torch.models.moe`` and the MoE
branches of ``transformer``) against the JAX package's, on the same NumPy
inputs and parameters: ``moe_apply`` in both group modes and both dispatch
flavours, with and without capacity drops; the routing in bf16, bit for
bit, on a group large enough that the reference's bf16 queue positions
collide; and ``mixtral-r`` (window 16) and ``arctic-r`` (dense residual)
through the registry and the serving loop.  fp32 results are held to
``FP32`` (rtol 1e-5, atol 5e-5), tokens exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.serve import engine as jengine
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe, registry
from repro_torch.serve import engine
from test_torch_lm import (ARCH_KW, _cfgs, _close, _close_caches, _jforward,
                           _jserve, _params, _rand, _tokens, _tree_signature,
                           _tserve, backward_cases, check_backward)

torch.set_num_threads(2)

MIXTRAL, ARCTIC = ARCH_KW["mixtral-r"], ARCH_KW["arctic-r"]
B, S = 2, 8
D, F_ = 32, 48


def _moe_params(seed, E, dense):
    rng = np.random.default_rng(seed)
    p = {"router": {"w": _rand(rng, D, E, scale=1 / np.sqrt(D))},
         "w_gate": _rand(rng, E, D, F_, scale=1 / np.sqrt(D)),
         "w_up": _rand(rng, E, D, F_, scale=1 / np.sqrt(D)),
         "w_down": _rand(rng, E, F_, D, scale=1 / np.sqrt(F_))}
    if dense:
        p["dense"] = {n: {"w": _rand(rng, *s, scale=0.2)} for n, s in (
            ("w_gate", (D, 24)), ("w_up", (D, 24)), ("w_down", (24, D)))}
    return p


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(torch.from_numpy, tree))


@pytest.mark.parametrize("cap", [0.5, 8.0], ids=["drops", "no-drops"])
@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
@pytest.mark.parametrize("group_mode", ["scan", "vmap"])
def test_moe_apply(group_mode, dispatch, cap):
    """24 tokens in groups of 10 (the last group padded), 4 experts top-2
    with a dense residual: capacity factor 0.5 drops tokens, 8.0 none."""
    kw = dict(num_experts=4, top_k=2, capacity_factor=cap,
              dense_residual=True, dense_d_ff=24, dispatch=dispatch)
    jc, tc = JMoEConfig(**kw), MoEConfig(**kw)
    jp, tp = _both(_moe_params(1, 4, True))
    x = _rand(np.random.default_rng(2), 2, 12, D)
    jout, jaux = jax.jit(lambda p, x: jmoe.moe_apply(
        p, jc, x, group_size=10, group_mode=group_mode))(jp, jnp.asarray(x))
    tout, taux = moe.moe_apply(tp, tc, torch.from_numpy(x), group_size=10,
                               group_mode=group_mode)
    assert tout.shape == x.shape and taux.dtype == torch.float32
    _close(tout, jout)
    _close(taux, jaux)


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
def test_scan_steps_through_each_blocks_groups(monkeypatch, dispatch):
    """On a mesh whose batch axes split the groups' dim into k blocks,
    ``"scan"`` takes group i of every block at step i.  With k = 2 forced
    on plain tensors (40 tokens in 4 groups of 10) the output and the aux
    loss equal k = 1's bit for bit: the groups are independent, and only
    their order of visit changes."""
    kw = dict(num_experts=4, top_k=2, capacity_factor=0.5,
              dispatch=dispatch)
    tp = _both(_moe_params(6, 4, False))[1]
    x = torch.from_numpy(_rand(np.random.default_rng(7), 2, 20, D))
    want = moe.moe_apply(tp, MoEConfig(**kw), x, group_size=10)
    monkeypatch.setattr(moe.sharding, "splits", lambda t, dim: 2)
    got = moe.moe_apply(tp, MoEConfig(**kw), x, group_size=10)
    assert torch.equal(got[0], want[0])
    _close(got[1], want[1])


def test_group_modes_and_dispatch_flavours_agree():
    """The four ways to route the same tokens give one output (to fp32
    rounding): a group mode changes only the batching, a dispatch flavour
    only how tokens reach their slots.  The aux losses of the two
    flavours differ by design (E^2/S against E, as in the reference)."""
    kw = dict(num_experts=4, top_k=2, capacity_factor=0.5)
    tp = _both(_moe_params(3, 4, False))[1]
    x = torch.from_numpy(_rand(np.random.default_rng(4), 2, 12, D))
    outs = {(d, m): moe.moe_apply(tp, MoEConfig(**kw, dispatch=d), x,
                                  group_size=10, group_mode=m)
            for d in ("gather", "einsum") for m in ("scan", "vmap")}
    for (d, m), (out, aux) in outs.items():
        _close(out, outs["gather", "scan"][0])
        _close(aux, outs[d, "scan"][1])


def _bf16_probs(n=600, E=8, seed=5):
    """Router probabilities of ``n`` tokens in bf16, skewed towards expert
    0 so its queue outgrows 256 positions."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, E)).astype(np.float32)
    logits[:, 0] += 3.0
    p32 = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    j = jnp.asarray(p32, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).bfloat16()


def test_bf16_routing_equals_the_reference_bit_for_bit():
    """One bf16 group of 600 tokens, 8 experts, top-2: expert choice
    (first maximum among bf16 ties), gates, queue positions (a bf16
    cumsum, which above 256 rounds onto neighbours), keep and the aux loss
    are the reference's exactly."""
    jprobs, tprobs = _bf16_probs()
    cap = 400
    ref = jax.jit(lambda p: jmoe._topk_routing(p, 2, cap))(jprobs)
    got = moe._topk_routing(tprobs, 2, cap)
    for name, t, j in zip(("expert_idx", "gates", "pos", "keep", "aux"),
                          got, ref):
        j = np.asarray(j, np.float32) if j.dtype == jnp.bfloat16 else \
            np.asarray(j)
        t = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        np.testing.assert_array_equal(t, j, err_msg=name)
    # the case the test is for: ties among bf16 probabilities, and two
    # tokens that share a queue position of expert 0
    assert (tprobs == tprobs.max(-1, keepdim=True).values).sum(-1).max() > 1
    idx, _, pos, _, _ = got
    first = pos[:, 0][idx[:, 0] == 0]
    assert first.max() > 256 and len(first.unique()) < len(first)
    # the gather dispatch's slots: kept duplicates exist only through the
    # bf16 collision; an fp32 routing of the same probabilities has none
    exact = moe._topk_routing(tprobs.float(), 2, cap)[2]
    assert len(exact[:, 0][idx[:, 0] == 0].unique()) == len(first)


def test_bf16_dispatch_equals_the_reference_bit_for_bit():
    jprobs, tprobs = _bf16_probs(n=300, seed=6)
    ref = jax.jit(lambda p: jmoe._topk_dispatch(p, 2, 90))(jprobs)
    got = moe._topk_dispatch(tprobs, 2, 90)
    for t, j in zip(got, ref):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))


def test_expert_activation_stats():
    c = MoEConfig(num_experts=4)
    jp, tp = _both(_moe_params(7, 4, False))
    x = _rand(np.random.default_rng(8), 3, 10, D)
    j = jmoe.expert_activation_stats(jp, c, jnp.asarray(x))
    t = moe.expert_activation_stats(tp, c, torch.from_numpy(x))
    assert t.dtype == torch.float32 and float(t.sum()) == pytest.approx(1.0)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("kw", [MIXTRAL, ARCTIC], ids=["mixtral", "arctic"])
def test_forward(kw):
    """The forward routes all groups at once (the reference's training
    mode) and sums the layers' aux losses."""
    jcfg, tcfg = _cfgs(kw)
    jp, tp = _params(kw)
    toks = _tokens(B, S)
    jl, jaux = _jforward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, taux = registry.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (B, S, tcfg.vocab_padded)
    assert float(taux) > 0
    _close(tl, jl)
    _close(taux, jaux)


@pytest.mark.parametrize("kw,max_len", [(MIXTRAL, 2 * S), (MIXTRAL, S // 2),
                                        (ARCTIC, 2 * S)],
                         ids=["mixtral-pad", "mixtral-rolling", "arctic"])
def test_prefill_then_decode(kw, max_len):
    """Prefill (one group of B*S tokens), then three decode steps (one
    group of B tokens, capacity 1 or 2 a expert): logits and caches."""
    jcfg, tcfg = _cfgs(kw)
    jp, tp = _params(kw)
    toks = _tokens(B, S, seed=1)
    new = _tokens(B, 3, seed=2)
    ref = _jserve(jp, jcfg, jnp.asarray(toks), jnp.asarray(new), max_len)
    got = _tserve(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(new),
                  max_len)
    for (tl, tc), (jl, jc) in zip(got, ref):
        _close(tl, jl)
        _close_caches(tc, jc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [MIXTRAL, ARCTIC], ids=["mixtral", "arctic"])
def test_init_params_tree_matches_the_reference(kw, dtype):
    """Keys, shapes and dtypes: each layer holds ``moe`` (router, expert
    stacks, arctic's dense residual) and no dense ``mlp``."""
    jcfg, tcfg = _cfgs(dict(kw, dtype=dtype))
    jshape = jax.eval_shape(
        lambda: jregistry.init_params(jax.random.key(0), jcfg))
    tp = registry.init_params(torch.Generator().manual_seed(0), tcfg,
                              device="cpu")
    assert _tree_signature(tp) == _tree_signature(jshape)
    assert "mlp" not in tp["layers"] and "moe" in tp["layers"]
    w = tp["layers"]["moe"]["w_gate"].float()
    assert abs(float(w.std()) * np.sqrt(tcfg.d_model) - 1) < 0.05


def test_serve_loop_tokens_equal_the_reference():
    jcfg, tcfg = _cfgs(MIXTRAL)
    jp, tp = _params(MIXTRAL)
    out = []
    for mod, cfg, params in ((jengine, jcfg, jp), (engine, tcfg, tp)):
        loop = mod.ServeLoop(cfg, params, batch_size=4, max_len=12)
        rng = np.random.default_rng(0)
        reqs = [mod.Request(uid=i, prompt=rng.integers(
                    1, cfg.vocab, size=int(rng.integers(4, 12))).astype(
                    np.int32), max_new_tokens=6 + i) for i in range(4)]
        out.append([r.generated for r in loop.run(reqs)])
    assert [len(g) for g in out[1]] == [6, 7, 8, 9]
    assert out[1] == out[0]


def test_unknown_group_mode_raises():
    tp = _both(_moe_params(9, 4, False))[1]
    with pytest.raises(ValueError, match="group_mode"):
        moe.moe_apply(tp, MoEConfig(num_experts=4), torch.zeros(1, 2, D),
                      group_mode="map")


@pytest.mark.parametrize("n", [5, 16, 17, 300, 600])
def test_cumsum_rounds_as_the_reference(n):
    """``moe._cumsum`` equals ``jnp.cumsum`` in bf16 bit for bit, on
    one-hot and on normal rows (``torch.cumsum`` does not)."""
    rng = np.random.default_rng(n)
    for x in (np.eye(8, dtype=np.float32)[rng.integers(0, 2, n)],
              10 * _rand(rng, n, 8)):
        j = jnp.asarray(x, jnp.bfloat16)
        want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=0))(j),
                          np.float32)
        t = torch.from_numpy(np.asarray(j, np.float32)).bfloat16()
        got = moe._cumsum(t, 0)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("name", backward_cases("moe"))
def test_backward_with_and_without_remat(name):
    check_backward(name)
