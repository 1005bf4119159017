"""The port's encoder-decoder (``repro_torch.models.encdec``) against the
JAX package's, on the same NumPy inputs and parameters: ``seamless-r`` (2
encoder and 2 decoder layers) over precomputed frames, through the
registry and the engine's prefill/decode steps.  fp32, held to ``FP32``
(rtol 1e-5, atol 5e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jencdec
from repro.models import registry as jregistry
from repro.serve import engine as jengine
from repro_torch.models import encdec, registry
from repro_torch.serve import engine
from test_torch_lm import (ARCH_KW, _cfgs, _close, _close_caches, _jforward,
                           _jserve, _params, _rand, _tokens, _tree_signature,
                           _tserve, backward_cases, check_backward)

torch.set_num_threads(2)

KW = ARCH_KW["seamless-r"]
B, S, S_ENC = 2, 8, 6


def _frames(seed=0, s_enc=S_ENC):
    return _rand(np.random.default_rng(seed), B, s_enc, KW["d_model"])


def test_encode_is_bidirectional():
    """The encoder equals the reference's, and its first frame sees the
    last (no causal mask)."""
    jcfg, tcfg = _cfgs(KW)
    jp, tp = _params(KW)
    frames = _frames()
    jm = jax.jit(lambda p, f: jencdec.encode(p, jcfg, f))(
        jp, jnp.asarray(frames))
    tm = encdec.encode(tp, tcfg, torch.from_numpy(frames))
    _close(tm, jm)
    moved = frames.copy()
    moved[:, -1] += 1.0
    tm2 = encdec.encode(tp, tcfg, torch.from_numpy(moved))
    assert not torch.allclose(tm2[:, 0], tm[:, 0])


def test_forward():
    jcfg, tcfg = _cfgs(KW)
    jp, tp = _params(KW)
    toks, frames = _tokens(B, S), _frames(1)
    jl, _ = _jforward(jp, jcfg, {"tokens": jnp.asarray(toks),
                                 "frames": jnp.asarray(frames)})
    tl, aux = registry.forward(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                          "frames": torch.from_numpy(frames)})
    assert tl.shape == (B, S, tcfg.vocab_padded) and float(aux) == 0.0
    _close(tl, jl)


@pytest.mark.parametrize("max_len", [16, S + 1])
def test_prefill_then_decode(max_len):
    """Prefill with frames, then three decode steps: logits, the self and
    cross caches, ``length``.  At max_len = S + 1 the last two steps run
    past the cache, where the reference's update clamps to the last
    slot."""
    jcfg, tcfg = _cfgs(KW)
    jp, tp = _params(KW)
    toks, frames = _tokens(B, S, seed=2), _frames(2)
    new = _tokens(B, 3, seed=3)
    ref = _jserve(jp, jcfg, jnp.asarray(toks), jnp.asarray(new), max_len,
                  {"frames": jnp.asarray(frames)})
    got = _tserve(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(new),
                  max_len, {"frames": torch.from_numpy(frames)})
    for (tl, tc), (jl, jc) in zip(got, ref):
        _close(tl, jl)
        _close_caches(tc, jc)
    assert got[0][1]["cross_k"].shape[2] == S_ENC


def test_prefill_decode_matches_forward():
    """decode(t) after prefill(<t) equals the forward at t, in the port."""
    tcfg = _cfgs(KW)[1]
    tp = _params(KW)[1]
    toks = torch.from_numpy(_tokens(B, S, seed=4))
    frames = torch.from_numpy(_frames(4))
    with torch.inference_mode():
        ref, _ = registry.forward(tp, tcfg, {"tokens": toks,
                                             "frames": frames})
        pre, cache = registry.prefill(
            tp, tcfg, {"tokens": toks[:, :S - 1], "frames": frames},
            max_len=S)
        _close(pre[:, 0], ref[:, S - 2])
        dec, _ = registry.decode_step(tp, tcfg, toks[:, S - 1:], cache)
        _close(dec[:, 0], ref[:, S - 1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_and_cache_trees_match_the_reference(dtype):
    jcfg, tcfg = _cfgs(dict(KW, dtype=dtype))
    jshape = jax.eval_shape(
        lambda: jregistry.init_params(jax.random.key(0), jcfg))
    tp = registry.init_params(torch.Generator().manual_seed(0), tcfg,
                              device="cpu")
    assert _tree_signature(tp) == _tree_signature(jshape)
    jc = jax.eval_shape(lambda: jencdec.init_cache(jcfg, 3, 8, enc_len=5))
    tc = encdec.init_cache(tcfg, 3, 8, enc_len=5, device="cpu")
    assert _tree_signature(tc) == _tree_signature(jc)


def test_serve_loop_cannot_serve_it_as_in_the_reference():
    """Both packages' ServeLoop pass tokens only, and this family reads
    ``frames``: both fail for want of them."""
    jcfg, tcfg = _cfgs(KW)
    jp, tp = _params(KW)
    for mod, cfg, params in ((jengine, jcfg, jp), (engine, tcfg, tp)):
        loop = mod.ServeLoop(cfg, params, batch_size=2, max_len=8)
        req = mod.Request(uid=0, prompt=np.arange(1, 4, dtype=np.int32),
                          max_new_tokens=2)
        with pytest.raises(KeyError, match="frames"):
            loop.run([req])


def test_engine_steps_serve_it():
    """The engine's prefill and decode steps pass the whole batch: greedy
    tokens equal the reference's."""
    jcfg, tcfg = _cfgs(KW)
    jp, tp = _params(KW)
    toks, frames = _tokens(B, 5, seed=5), _frames(5)
    out = []
    for mod, cfg, params, conv in (
            (jengine, jcfg, jp, jnp.asarray),
            (engine, tcfg, tp, torch.from_numpy)):
        logits, cache = mod.build_prefill_step(cfg, 16)(
            params, {"tokens": conv(toks), "frames": conv(frames)})
        token = np.asarray(logits[:, -1].argmax(-1)).astype(np.int32)[:, None]
        got = [token[:, 0].tolist()]
        step = mod.build_decode_step(cfg)
        for _ in range(4):
            o = step(params, {"token": conv(token), "cache": cache})
            cache = o["cache"]
            token = np.asarray(o["next_token"]).astype(np.int32)[:, None]
            got.append(token[:, 0].tolist())
        out.append(got)
    assert out[1] == out[0]


@pytest.mark.parametrize("name", backward_cases("encdec"))
def test_backward_with_and_without_remat(name):
    check_backward(name)
