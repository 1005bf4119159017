"""The port's Mamba2 (``repro_torch.models.ssm``) against the JAX
package's, on the same NumPy inputs and parameters: the chunked SSD scan,
one block's forward (with its decode state) and decode step, and the
whole ``mamba2-r`` model through the registry and the serving loop.

In fp32 both run the same ops in the same order up to the summation order
of their CPU products and cumsums, and an ulp in ``exp``: held to
``FP32`` (rtol 1e-5, atol 5e-5 of the largest value), tokens exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as jregistry
from repro.models import ssm as jssm
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch.models import layers, registry, ssm
from repro_torch.serve import engine
from test_torch_lm import (ARCH_KW, FP32, _cfgs, _close, _close_caches,
                           _jforward, _jserve, _np, _params, _rand, _tokens,
                           _tree_signature, _tserve, backward_cases,
                           check_backward)

torch.set_num_threads(2)

KW = ARCH_KW["mamba2-r"]
B = 2


def _rel_close(actual, desired):
    """FP32's atol taken relative to the largest |desired|."""
    scale = max(float(np.abs(_np(desired)).max()), 1.0)
    np.testing.assert_allclose(_np(actual), _np(desired), rtol=FP32["rtol"],
                               atol=FP32["atol"] * scale)


def _ssd_inputs(S, seed=0, H=3, P=4, N=5):
    rng = np.random.default_rng(seed)
    x = _rand(rng, B, S, H, P)
    dt = np.log1p(np.exp(_rand(rng, B, S, H) - 1.0)).astype(np.float32)
    A = -np.exp(_rand(rng, H, scale=0.5)).astype(np.float32)
    Bm = _rand(rng, B, S, N, scale=0.5)
    Cm = _rand(rng, B, S, N, scale=0.5)
    h0 = _rand(rng, B, H, N, P)
    return x, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk,S", [(1, 7), (2, 7), (4, 7), (8, 7),
                                     (4, 8), (4, 9)])
def test_ssd_chunked(chunk, S, with_h0):
    """Chunks of 1, 2, 4 and 8 over 7 tokens (padded with dt = 0 to whole
    chunks, or one chunk shorter than ``chunk``), 8 and 9 tokens in chunks
    of 4; with and without an entering state."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(S, seed=chunk * 10 + S)
    args = (x, dt, A, Bm, Cm)
    h0 = h0 if with_h0 else None
    jy, jh = jax.jit(lambda *a: jssm.ssd_chunked(*a[:5], chunk, a[5]))(
        *(jnp.asarray(a) for a in args),
        None if h0 is None else jnp.asarray(h0))
    ty, th = ssm.ssd_chunked(*(torch.from_numpy(a) for a in args), chunk,
                             None if h0 is None else torch.from_numpy(h0))
    assert th.dtype == torch.float32 and ty.shape == x.shape
    _rel_close(ty, jy)
    _rel_close(th, jh)


def test_ssd_chunk_size_changes_only_the_grouping():
    """One chunk or many: the same scan, to fp32 rounding."""
    x, dt, A, Bm, Cm, h0 = (torch.from_numpy(a) for a in _ssd_inputs(9))
    y1, h1 = ssm.ssd_chunked(x, dt, A, Bm, Cm, 9, h0)
    y4, h4 = ssm.ssd_chunked(x, dt, A, Bm, Cm, 4, h0)
    _rel_close(y4, y1)
    _rel_close(h4, h1)


def _block(kw=KW, l=0):
    """Layer ``l``'s params of both packages."""
    jp, tp = _params(kw)
    return (jax.tree.map(lambda a: a[l], jp["layers"]),
            layers.layer_params(tp["layers"], l))


@pytest.mark.parametrize("S", [2, 7])
def test_block_forward_with_state(S):
    """One block with its decode state: 2 tokens (fewer than W-1 = 3, so
    the conv history is zero-padded in front) and 7 (two chunks of 4)."""
    jcfg, tcfg = _cfgs(KW)
    jlp, tlp = _block()
    x = _rand(np.random.default_rng(S), B, S, KW["d_model"])
    jout, (jh, jconv) = jax.jit(lambda lp, x: jssm.block_forward(
        lp, jcfg, x, return_state=True))(jlp, jnp.asarray(x))
    tout, (th, tconv) = ssm.block_forward(tlp, tcfg, torch.from_numpy(x),
                                          return_state=True)
    _rel_close(tout, jout)
    _rel_close(th, jh)
    _rel_close(tconv, jconv)
    assert tconv.shape == (B, 3, ssm.dims(tcfg)["conv_ch"])
    if S < 3:
        assert not tconv[:, :3 - S].any()
    # without the state, the same output
    _close(ssm.block_forward(tlp, tcfg, torch.from_numpy(x)), tout,
           dict(rtol=0, atol=0))


def test_block_decode():
    jcfg, tcfg = _cfgs(KW)
    jlp, tlp = _block(l=1)
    d = ssm.dims(tcfg)
    rng = np.random.default_rng(5)
    x = _rand(rng, B, 1, KW["d_model"])
    h = _rand(rng, B, d["n_heads"], d["N"], d["P"])
    conv = _rand(rng, B, d["W"] - 1, d["conv_ch"])
    jout, (jh, jconv) = jax.jit(lambda lp, *a: jssm.block_decode(
        lp, jcfg, *a))(jlp, *(jnp.asarray(a) for a in (x, h, conv)))
    tout, (th, tconv) = ssm.block_decode(tlp, tcfg, *(torch.from_numpy(a)
                                                      for a in (x, h, conv)))
    _rel_close(tout, jout)
    _rel_close(th, jh)
    np.testing.assert_array_equal(_np(tconv)[:, :-1], conv[:, 1:])
    _rel_close(tconv, jconv)


def test_forward():
    jcfg, tcfg = _cfgs(KW)
    jp, tp = _params(KW)
    toks = _tokens(B, 8)
    jl, _ = _jforward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, aux = registry.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (B, 8, tcfg.vocab_padded) and float(aux) == 0.0
    _close(tl, jl)


@pytest.mark.parametrize("S", [2, 7])
def test_prefill_then_decode(S):
    """Prompts of 2 and 7 tokens, then three decode steps: logits, every
    layer's state and conv history, and ``length``."""
    jcfg, tcfg = _cfgs(KW)
    jp, tp = _params(KW)
    toks = _tokens(B, S, seed=S)
    new = _tokens(B, 3, seed=S + 1)
    ref = _jserve(jp, jcfg, jnp.asarray(toks), jnp.asarray(new), 16)
    got = _tserve(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(new), 16)
    for (tl, tc), (jl, jc) in zip(got, ref):
        _close(tl, jl)
        assert tc["h"].dtype == torch.float32
        _close_caches(tc, jc)


def test_prefill_decode_matches_forward():
    """decode(t) after prefill(<t) equals the forward at t, in the port."""
    tcfg = _cfgs(KW)[1]
    tp = _params(KW)[1]
    toks = torch.from_numpy(_tokens(B, 9, seed=4))
    with torch.inference_mode():
        ref, _ = registry.forward(tp, tcfg, {"tokens": toks})
        pre, cache = registry.prefill(tp, tcfg, {"tokens": toks[:, :8]}, 9)
        _close(pre[:, 0], ref[:, 7])
        dec, _ = registry.decode_step(tp, tcfg, toks[:, 8:], cache)
        _close(dec[:, 0], ref[:, 8])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_tree_matches_the_reference(dtype):
    """The port's init draws the reference's tree: keys, stacked shapes
    and dtypes, with float32 ``A_log``, ``dt_bias`` and ``D`` in bf16."""
    jcfg, tcfg = _cfgs(dict(KW, dtype=dtype))
    jshape = jax.eval_shape(
        lambda: jregistry.init_params(jax.random.key(0), jcfg))
    tp = registry.init_params(torch.Generator().manual_seed(0), tcfg,
                              device="cpu")
    assert _tree_signature(tp) == _tree_signature(jshape)
    lp = tp["layers"]
    assert not torch.equal(lp["in_proj"]["w"][0], lp["in_proj"]["w"][1])
    assert float(lp["dt_bias"][0, 0]) == -2.0 and float(lp["D"][0, 0]) == 1.0


def test_converter_keeps_the_fp32_leaves_of_a_bf16_model():
    """A bf16 mamba2-r tree from the reference: ``A_log``, ``dt_bias`` and
    ``D`` stay float32 (values that bf16 would round included), every
    other leaf is bf16, and the tree round-trips through NumPy."""
    kw = dict(KW, dtype="bfloat16")
    jcfg, tcfg = _cfgs(kw)
    jp, tp = _params(kw)
    np_tree = jax.tree.map(np.array, jp)
    assert np_tree["layers"]["A_log"].dtype == np.float32
    # a value bf16 cannot hold
    np_tree["layers"]["D"][0, 0] = 1.0 + 2.0 ** -20
    tp = convert.lm_params_from_numpy(np_tree, tcfg, device="cpu")
    for name in ("A_log", "dt_bias", "D"):
        assert tp["layers"][name].dtype == torch.float32
    assert float(tp["layers"]["D"][0, 0]) == 1.0 + 2.0 ** -20
    sig = _tree_signature(tp)
    assert {p for p, (_, dt) in sig.items() if dt == "float32"} == {
        "/layers/A_log", "/layers/dt_bias", "/layers/D"}
    back = convert.lm_params_to_numpy(tp)
    again = convert.lm_params_from_numpy(back, tcfg, device="cpu")
    assert _tree_signature(again) == sig
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(again)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        bad = dict(np_tree, lm_head={"w": np.zeros((3, 3), np.float32)})
        convert.lm_params_from_numpy(bad, tcfg, device="cpu")


def test_bf16_forward_keeps_its_dtypes():
    """In bf16 the activations and logits are bf16, and the logits agree
    with the reference's to a loose bound (XLA's and PyTorch's CPU bf16
    products round differently) on 90% of argmax tokens."""
    kw = dict(KW, dtype="bfloat16")
    jcfg, tcfg = _cfgs(kw)
    jp, tp = _params(kw)
    toks = _tokens(B, 8, seed=6)
    jl, _ = _jforward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, _ = registry.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.bfloat16
    jl32, tl32 = np.asarray(jl, np.float32), tl.float().numpy()
    np.testing.assert_allclose(tl32, jl32, rtol=0.05, atol=0.05)
    assert np.mean(tl32.argmax(-1) == jl32.argmax(-1)) >= 0.9


def test_serve_loop_tokens_equal_the_reference():
    jcfg, tcfg = _cfgs(KW)
    jp, tp = _params(KW)
    out = []
    for mod, cfg, params in ((jengine, jcfg, jp), (engine, tcfg, tp)):
        loop = mod.ServeLoop(cfg, params, batch_size=4, max_len=12)
        rng = np.random.default_rng(0)
        reqs = [mod.Request(uid=i, prompt=rng.integers(
                    1, cfg.vocab, size=int(rng.integers(2, 9))).astype(
                    np.int32), max_new_tokens=5 + i) for i in range(3)]
        out.append([r.generated for r in loop.run(reqs)])
    assert [len(g) for g in out[1]] == [5, 6, 7]
    assert out[1] == out[0]


def test_init_cache_ignores_max_len():
    cfg = _cfgs(KW)[1]
    a = registry.init_cache(cfg, 3, 8, device="cpu")
    b = registry.init_cache(cfg, 3, 4096, device="cpu")
    assert _tree_signature(a) == _tree_signature(b)


@pytest.mark.parametrize("name", backward_cases("ssm"))
def test_backward_with_and_without_remat(name):
    check_backward(name)
