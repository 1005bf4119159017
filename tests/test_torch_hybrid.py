"""The port's zamba2 hybrid (``repro_torch.models.hybrid``) against the JAX
package's, on the same NumPy inputs and parameters: ``zamba2-r`` (4 Mamba2
blocks in 2 groups, each followed by the shared attention block), with a
window added for the rolling KV path, through the registry and the serving
loop.  fp32, held to ``FP32`` (rtol 1e-5, atol 5e-5); tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as jregistry
from repro.serve import engine as jengine
from repro_torch.models import hybrid, registry
from repro_torch.serve import engine
from test_torch_lm import (ARCH_KW, _cfgs, _close, _close_caches, _jforward,
                           _jserve, _params, _tokens, _tree_signature,
                           _tserve, backward_cases, check_backward)

torch.set_num_threads(2)

KW = ARCH_KW["zamba2-r"]
WINDOWED = dict(KW, name="zamba2-window-r", window=5)
B, S = 2, 8


def test_forward():
    jcfg, tcfg = _cfgs(KW)
    jp, tp = _params(KW)
    toks = _tokens(B, S)
    jl, _ = _jforward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, aux = registry.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (B, S, tcfg.vocab_padded) and float(aux) == 0.0
    _close(tl, jl)


@pytest.mark.parametrize("kw,max_len", [(KW, 2 * S), (KW, S // 2),
                                        (WINDOWED, 2 * S)],
                         ids=["pad", "rolling", "window"])
def test_prefill_then_decode(kw, max_len):
    """The pad path (max_len >= S) and the rolling path (max_len < S, or a
    window of 5 under the 8-token prompt), then three decode steps: logits,
    the states, every application's KV cache and the slot positions."""
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
    assert got[0][1]["k"].shape[:3] == (2, B, min(max_len, kw.get("window")
                                                  or max_len))


@pytest.mark.parametrize("kw", [KW, WINDOWED], ids=["full", "window"])
def test_prefill_decode_matches_forward(kw):
    """decode(t) after prefill(<t) equals the forward at t, in the port."""
    tcfg = _cfgs(kw)[1]
    tp = _params(kw)[1]
    toks = torch.from_numpy(_tokens(B, S, seed=3))
    with torch.inference_mode():
        ref, _ = registry.forward(tp, tcfg, {"tokens": toks})
        pre, cache = registry.prefill(tp, tcfg, {"tokens": toks[:, :S - 1]},
                                      max_len=S)
        _close(pre[:, 0], ref[:, S - 2])
        dec, _ = registry.decode_step(tp, tcfg, toks[:, S - 1:], cache)
        _close(dec[:, 0], ref[:, S - 1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_tree_matches_the_reference(dtype):
    """Keys, shapes (the mamba leaves carry (num_groups, every) leading
    dims, the shared block none) and dtypes, float32 SSM leaves in bf16."""
    jcfg, tcfg = _cfgs(dict(KW, dtype=dtype))
    jshape = jax.eval_shape(
        lambda: jregistry.init_params(jax.random.key(0), jcfg))
    tp = registry.init_params(torch.Generator().manual_seed(0), tcfg,
                              device="cpu")
    assert _tree_signature(tp) == _tree_signature(jshape)
    w = tp["mamba"]["in_proj"]["w"]
    assert w.shape[:2] == (2, 2)
    assert not torch.equal(w[0, 1], w[1, 0])


def test_groups_must_divide_the_layers():
    cfg = dataclasses.replace(_cfgs(KW)[1], num_layers=5)
    with pytest.raises(ValueError, match="shared_attn_every"):
        hybrid.init_cache(cfg, 1, 8, device="cpu")


def test_serve_loop_tokens_equal_the_reference():
    """Left-padded requests, more new tokens than max_len holds (the KV
    caches roll), the same greedy tokens."""
    jcfg, tcfg = _cfgs(KW)
    jp, tp = _params(KW)
    out = []
    for mod, cfg, params in ((jengine, jcfg, jp), (engine, tcfg, tp)):
        loop = mod.ServeLoop(cfg, params, batch_size=4, max_len=10)
        rng = np.random.default_rng(0)
        reqs = [mod.Request(uid=i, prompt=rng.integers(
                    1, cfg.vocab, size=int(rng.integers(4, 10))).astype(
                    np.int32), max_new_tokens=6 + i) for i in range(3)]
        out.append([r.generated for r in loop.run(reqs)])
    assert [len(g) for g in out[1]] == [6, 7, 8]
    assert out[1] == out[0]


@pytest.mark.parametrize("name", backward_cases("hybrid"))
def test_backward_with_and_without_remat(name):
    check_backward(name)
