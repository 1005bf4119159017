"""The port's LM serving path (repro_torch.models, serve.engine, launch,
configs) against the JAX package's, on the same NumPy inputs and
parameters: the dense transformer family here, the helpers the per-family
files (``test_torch_{ssm,hybrid,encdec,moe}.py``) share, and the registry
over every architecture.

Parameters are drawn with NumPy from a seed into the reference's tree
(``jax.eval_shape`` of ``repro.models.registry.init_params``) and cross
with ``repro_torch.convert.lm_params_from_numpy``.  In fp32 the two packages run
the same ops in the same order; what differs is the summation order of
XLA's and PyTorch's CPU products and an ulp in ``pow``/``cos``/``sin`` of
the rope angles.  Measured on the reduced configs below: logits differ by
at most 3.4e-6 against magnitudes up to 4.5, caches by 2.1e-6.  Hence
``FP32`` (rtol 1e-5, atol 5e-5); greedy tokens are compared exactly, in
fp32 only.  bf16 rounds every product's output, and XLA's and PyTorch's
CPU bf16 products round differently, so a bf16 forward is held to ``BF16``
(a stated loose bound) against the reference's own output.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.launch import train as jlaunch_train
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import (encdec, hybrid, layers, registry, ssm,
                                transformer)
from repro_torch.serve import engine
from repro_torch.tree import leaves, unflatten
from test_archs import REDUCED as _ARCH_REDUCED

torch.set_num_threads(2)

FP32 = dict(rtol=1e-5, atol=5e-5)
BF16 = dict(rtol=0.05, atol=0.05)

# The dense configs of tests/test_archs.py:REDUCED, as keyword sets that
# build either package's ArchConfig.  tinyllama-r is 4:1 GQA, llama-r and
# granite-r 4:2 (granite ties its embeddings), chatglm-r has 2-D rope;
# window-r adds a sliding window, so its cache is a rolling buffer.
REDUCED = {
    "llama-r": dict(
        name="llama-r", family="transformer", num_layers=2, d_model=128,
        n_heads=4, n_kv=2, d_ff=256, vocab=512, head_dim=32,
        rope="1d", rope_theta=500000.0, dtype="float32"),
    "granite-r": dict(
        name="granite-r", family="transformer", num_layers=2, d_model=128,
        n_heads=4, n_kv=2, d_ff=256, vocab=512, head_dim=32,
        tie_embeddings=True, dtype="float32"),
    "tinyllama-r": dict(
        name="tinyllama-r", family="transformer", num_layers=2, d_model=128,
        n_heads=4, n_kv=1, d_ff=192, vocab=512, head_dim=32,
        dtype="float32"),
    "chatglm-r": dict(
        name="chatglm-r", family="transformer", num_layers=2, d_model=128,
        n_heads=4, n_kv=2, d_ff=256, vocab=512, head_dim=32, rope="2d",
        dtype="float32"),
}
DENSE = list(REDUCED)
WINDOWED = dict(REDUCED["llama-r"], name="window-r", window=6)
#: Every reduced config of tests/test_archs.py, by name, as a keyword set
#: (nested MoE and SSM configs as dicts): mixtral-r, arctic-r, qwen2vl-r,
#: seamless-r, mamba2-r and zamba2-r beside the dense ones above.
ARCH_KW = {c.name: dataclasses.asdict(c) for c in _ARCH_REDUCED.values()}
ARCH_OF = {arch_id: c.name for arch_id, c in _ARCH_REDUCED.items()}

B, S = 2, 8

# The reference runs jitted, as tests/test_archs.py's serving path does:
# one compile per config and shape instead of one per op (run eagerly, the
# small checks below take longer: each primitive compiles on its own).
_jforward = jax.jit(jregistry.forward, static_argnums=1)
_jprefill = jax.jit(jregistry.prefill, static_argnums=(1, 3))
_jdecode = jax.jit(jregistry.decode_step, static_argnums=1)


def _jserve(params, cfg, tokens, new_tokens, max_len, extra=None):
    """The reference's prefill (of ``tokens`` and the batch's ``extra``
    entries), then a decode step for each column of ``new_tokens``: every
    (logits, cache) along the way.  The decode steps share one compile."""
    outs = [_jprefill(params, cfg, dict(extra or {}, tokens=tokens),
                      max_len)]
    for t in range(new_tokens.shape[1]):
        outs.append(_jdecode(params, cfg, new_tokens[:, t:t + 1],
                             outs[-1][1]))
    return outs


def _cfgs(kw):
    """Both packages' ArchConfig from one keyword set."""
    def build(arch, moe, ssm_):
        kw2 = dict(kw)
        if kw2.get("moe") is not None:
            kw2["moe"] = moe(**kw2["moe"])
        if kw2.get("ssm") is not None:
            kw2["ssm"] = ssm_(**kw2["ssm"])
        return arch(**kw2)

    return (build(JArchConfig, JMoEConfig, JSSMConfig),
            build(ArchConfig, MoEConfig, SSMConfig))


def _tserve(params, cfg, tokens, new_tokens, max_len, extra=None):
    """``_jserve`` in the port: the cache is copied before each decode
    step, which advances it in place."""
    outs = [registry.prefill(params, cfg, dict(extra or {}, tokens=tokens),
                             max_len)]
    for t in range(new_tokens.shape[1]):
        cache = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                 for k, v in outs[-1][1].items()}
        outs.append(registry.decode_step(params, cfg,
                                         new_tokens[:, t:t + 1], cache))
    return outs


def _close_caches(tc, jc, tol=FP32):
    """Every leaf of a port cache against the reference's: float leaves
    to ``tol``, integer leaves exactly, ``length`` as a host int."""
    assert set(tc) == set(jc)
    for leaf, want in jc.items():
        got = tc[leaf]
        if leaf == "length":
            assert got == int(want)
        elif jnp.issubdtype(want.dtype, jnp.integer):
            np.testing.assert_array_equal(_np(got), _np(want))
        else:
            _close(got, want, tol)


def _tree_signature(tree, prefix=""):
    """{path: (shape, dtype name)} of a tree of torch or JAX arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree_signature(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, int):
        return {prefix: ((), "int32")}
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


_PARAMS = {}


def _np_params(jcfg, seed=0):
    """The reference's param tree, every leaf drawn with NumPy (norm
    scales near 1, biases and weights at init's scales) and held in the
    reference's own dtype for it (a bf16 Mamba2 keeps float32 ``A_log``,
    ``dt_bias`` and ``D``)."""
    shapes = jax.eval_shape(
        lambda: jregistry.init_params(jax.random.key(0), jcfg))
    rng = np.random.default_rng(seed)

    def leaf(path, sds):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(sds.shape).astype(np.float32)
        if "scale" in name:
            x = 1.0 + 0.1 * x
        elif "embedding" in name:
            x = 0.02 * x
        else:
            x = x / np.sqrt(sds.shape[-2])
        return jnp.asarray(x, sds.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _params(kw):
    """(jax params, torch params on the CPU) from one NumPy draw."""
    key = repr(sorted(kw.items()))
    if key not in _PARAMS:
        jcfg, tcfg = _cfgs(kw)
        jp = _np_params(jcfg)
        tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                          device="cpu")
        _PARAMS[key] = (jp, tp)
    return _PARAMS[key]


def _tokens(n, s, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, (n, s)).astype(
        np.int32)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(actual, desired, tol=FP32):
    np.testing.assert_allclose(_np(actual), _np(desired), **tol)


# ---------------------------------------------------------------------------
# layers.py, function by function
# ---------------------------------------------------------------------------

def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both_call(fn, *args):
    """``fn(mod, *args)`` in both packages: the JAX side jitted, NumPy
    arrays (or None) converted."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    return (jax.jit(lambda *a: fn(jlayers, *a))(*jargs),
            fn(layers, *targs))


class TestNormsAndLinear:
    @pytest.mark.parametrize("kind", ["rms", "ln"])
    def test_norm(self, kind):
        rng = np.random.default_rng(1)
        x = _rand(rng, 2, 5, 64, scale=3.0)
        p = {"scale": _rand(rng, 64), "bias": _rand(rng, 64)}
        if kind == "rms":
            p.pop("bias")

        def run(mod, x, p):
            return mod.norm_apply(kind, p, x)

        jp = {k: jnp.asarray(v) for k, v in p.items()}
        tp = {k: torch.from_numpy(v) for k, v in p.items()}
        _close(run(layers, torch.from_numpy(x), tp),
               run(jlayers, jnp.asarray(x), jp), dict(rtol=1e-6, atol=1e-6))

    def test_rmsnorm_bf16_casts_before_the_scale(self):
        """fp32 statistics, cast to bf16, then the bf16 scale: equal to
        the reference bit for bit on exact bf16 inputs."""
        rng = np.random.default_rng(2)
        x = _rand(rng, 4, 64, scale=2.0)
        s = _rand(rng, 64)
        j = jlayers.rmsnorm({"scale": jnp.asarray(s, jnp.bfloat16)},
                            jnp.asarray(x, jnp.bfloat16))
        t = layers.rmsnorm({"scale": torch.from_numpy(s).bfloat16()},
                           torch.from_numpy(x).bfloat16())
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))

    @pytest.mark.parametrize("bias", [False, True])
    def test_linear(self, bias):
        rng = np.random.default_rng(3)
        x = _rand(rng, 3, 7, 32)
        p = {"w": _rand(rng, 32, 48)}
        if bias:
            p["b"] = _rand(rng, 48)
        _close(layers.linear({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x)),
               jlayers.linear({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x)))

    def test_embed(self):
        rng = np.random.default_rng(4)
        table = _rand(rng, 40, 16)
        toks = rng.integers(0, 40, (3, 5)).astype(np.int32)
        np.testing.assert_array_equal(
            _np(layers.embed({"embedding": torch.from_numpy(table)},
                             torch.from_numpy(toks))),
            _np(jlayers.embed({"embedding": jnp.asarray(table)},
                              jnp.asarray(toks))))

    @pytest.mark.parametrize("kind", ["swiglu", "gelu"])
    def test_mlp(self, kind):
        rng = np.random.default_rng(5)
        x = _rand(rng, 2, 6, 32)
        names = (("w_gate", "w_up", "w_down") if kind == "swiglu"
                 else ("w_up", "w_down"))
        p = {n: {"w": _rand(rng, *((64, 32) if n == "w_down" else (32, 64)),
                            scale=0.2)} for n in names}
        jp = jax.tree.map(jnp.asarray, p)
        tp = {n: {"w": torch.from_numpy(v["w"])} for n, v in p.items()}
        _close(layers.mlp(tp, torch.from_numpy(x), kind),
               jlayers.mlp(jp, jnp.asarray(x), kind))


class TestRope:
    def test_frequencies(self):
        for hd, theta, rd in ((64, 10000.0, None), (128, 5e5, 64)):
            _close(layers.rope_frequencies(hd, theta, rd, device="cpu"),
                   jlayers.rope_frequencies(hd, theta, rd),
                   dict(rtol=1e-6, atol=0))

    def test_rotate_is_interleaved(self):
        """Pairs are (0::2, 1::2), not the two halves."""
        x = np.arange(8, dtype=np.float32).reshape(1, 8)
        ang = np.full((1, 4), np.pi / 2, np.float32)
        t = layers._rotate(torch.from_numpy(x), torch.from_numpy(ang))
        _close(t, jlayers._rotate(jnp.asarray(x), jnp.asarray(ang)))
        np.testing.assert_allclose(_np(t)[0, :2], [-1.0, 0.0], atol=1e-6)

    @pytest.mark.parametrize("frac", [1.0, 0.5])
    def test_apply_rope(self, frac):
        rng = np.random.default_rng(6)
        x = _rand(rng, 2, 9, 3, 32)
        pos = rng.integers(0, 300, (2, 9)).astype(np.int32)
        j, t = _both_call(lambda m, x, p: m.apply_rope(x, p, 10000.0, frac),
                          x, pos)
        _close(t, j)
        if frac < 1:
            np.testing.assert_array_equal(_np(t)[..., 16:], x[..., 16:])

    def test_apply_rope_2d(self):
        rng = np.random.default_rng(7)
        x = _rand(rng, 2, 5, 2, 32)
        pos = rng.integers(0, 50, (2, 2, 5)).astype(np.int32)
        j, t = _both_call(lambda m, x, p: m.apply_rope_2d(x, p), x, pos)
        _close(t, j)

    def test_apply_mrope(self):
        rng = np.random.default_rng(8)
        x = _rand(rng, 2, 5, 2, 32)
        pos = rng.integers(0, 50, (3, 2, 5)).astype(np.int32)
        j, t = _both_call(lambda m, x, p: m.apply_mrope(x, p, (4, 6, 6), 1e6),
                          x, pos)
        _close(t, j)


def _acfg(mod, **kw):
    base = dict(d_model=64, n_heads=4, n_kv=2, head_dim=16)
    return mod.AttnConfig(**dict(base, **kw))


class TestAttention:
    @pytest.mark.parametrize("window,valid", [(0, False), (3, False),
                                              (0, True), (4, True)])
    def test_mask_bias(self, window, valid):
        rng = np.random.default_rng(9)
        qp = rng.integers(0, 12, (2, 5)).astype(np.int32)
        kp = rng.integers(0, 12, (2, 7)).astype(np.int32)
        kv = rng.random((2, 7)) < 0.7 if valid else None
        j = jlayers._mask_bias(_acfg(jlayers, window=window), jnp.asarray(qp),
                               jnp.asarray(kp),
                               None if kv is None else jnp.asarray(kv))
        t = layers._mask_bias(_acfg(layers, window=window),
                              torch.from_numpy(qp), torch.from_numpy(kp),
                              None if kv is None else torch.from_numpy(kv))
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(_np(t), _np(j))

    def test_attend_block_and_decode(self):
        rng = np.random.default_rng(10)
        q = _rand(rng, 2, 3, 4, 16)
        k = _rand(rng, 2, 9, 2, 16)
        v = _rand(rng, 2, 9, 2, 16)
        bias = np.where(rng.random((2, 3, 9)) < 0.8, 0.0, -1e30).astype(
            np.float32)
        j, t = _both_call(lambda m, *a: m._attend_decode(_acfg(m), *a),
                          q, k, v, bias)
        _close(t, j)
        kf, vf = np.repeat(k, 2, axis=2), np.repeat(v, 2, axis=2)
        j, t = _both_call(lambda m, *a: m._attend_block(_acfg(m), *a),
                          q, kf, vf, bias)
        _close(t, j)

    @pytest.mark.parametrize("n_kv", [1, 2, 4])
    @pytest.mark.parametrize("masked,valid", [(True, False), (True, True),
                                              (False, True), (False, False)])
    def test_decode_branch(self, n_kv, masked, valid):
        """Sq <= 8 against a longer cache takes the grouped decode path."""
        rng = np.random.default_rng(11)
        Sq, Skv = 2, 12
        q = _rand(rng, 2, Sq, 4, 16)
        k = _rand(rng, 2, Skv, n_kv, 16)
        v = _rand(rng, 2, Skv, n_kv, 16)
        qa = np.tile(np.arange(10, 10 + Sq, dtype=np.int32), (2, 1))
        ka = np.tile(np.arange(Skv, dtype=np.int32), (2, 1))
        kv = (rng.random((2, Skv)) < 0.8) if valid else None
        kv = None if kv is None else kv | (ka <= 10)

        def run(m, q, k, v, qa, ka, kv):
            return m._attend(_acfg(m, n_kv=n_kv), q, k, v, qa, ka, kv, masked)

        j, t = _both_call(run, q, k, v, qa, ka, kv)
        _close(t, j)

    @pytest.mark.parametrize("window,masked", [(0, True), (5, True),
                                               (0, False)])
    def test_chunked(self, window, masked):
        """Sq > chunk: query chunks, causal truncation, window bound."""
        rng = np.random.default_rng(12)
        S_ = 32
        q = _rand(rng, 2, S_, 4, 16)
        k = _rand(rng, 2, S_, 2, 16)
        v = _rand(rng, 2, S_, 2, 16)
        pos = np.tile(np.arange(S_, dtype=np.int32), (2, 1))
        kv = None if masked else rng.random((2, S_)) < 0.8

        def run(chunk):
            return lambda m, q, k, v, pos, kv: m._attend(
                _acfg(m, window=window), q, k, v, pos, pos, kv, masked,
                chunk=chunk)

        j, t = _both_call(run(8), q, k, v, pos, kv)
        _close(t, j)
        # chunking changes nothing but the grouping of the work
        whole = run(1024)(layers, *(None if a is None else torch.from_numpy(a)
                                    for a in (q, k, v, pos, kv)))
        _close(t, whole)

    @pytest.mark.parametrize("rope", ["1d", "2d", "mrope", "none"])
    def test_attention_and_project_kv(self, rope):
        rng = np.random.default_rng(13)
        extra = dict(rope=rope, qkv_bias=rope == "none")
        if rope == "mrope":
            extra["mrope_sections"] = (2, 3, 3)
        p = {n: {"w": _rand(rng, 64, 64 if n in ("wq", "wo") else 32,
                            scale=0.15)} for n in ("wq", "wk", "wv", "wo")}
        if extra["qkv_bias"]:
            for n in ("wq", "wk", "wv"):
                p[n]["b"] = _rand(rng, p[n]["w"].shape[1], scale=0.1)
        x = _rand(rng, 2, 6, 64)
        pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
        if rope in ("2d", "mrope"):
            pos = np.stack([pos] * (2 if rope == "2d" else 3))
        jp = jax.tree.map(jnp.asarray, p)
        tp = {n: {k: torch.from_numpy(a) for k, a in d.items()}
              for n, d in p.items()}
        jc, tc = _acfg(jlayers, **extra), _acfg(layers, **extra)
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
        jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
        jattention = jax.jit(lambda *a, **k: jlayers.attention(jp, jc, *a,
                                                               **k))
        _close(layers.attention(tp, tc, tx, tpos), jattention(jx, jpos))
        jk, jv = jax.jit(lambda *a: jlayers.project_kv(jp, jc, *a))(jx, jpos)
        tk, tv = layers.project_kv(tp, tc, tx, tpos)
        _close(tk, jk)
        _close(tv, jv)
        mem = _rand(rng, 2, 10, 64)
        valid = rng.random((2, 10)) < 0.7
        _close(layers.attention(tp, tc, tx, tpos,
                                cross_kv=torch.from_numpy(mem),
                                kv_valid=torch.from_numpy(valid)),
               jattention(jx, jpos, cross_kv=jnp.asarray(mem),
                          kv_valid=jnp.asarray(valid)))


# ---------------------------------------------------------------------------
# transformer.py through the registry, per reduced config
# ---------------------------------------------------------------------------

def _extras(name, n, s, seed=0):
    """The batch entries beside the tokens, as NumPy: qwen2vl-r's two
    patch embeddings and explicit 3-row M-RoPE positions (the patches'
    rows differ; from position 2 on, text, all three rows are the
    position, as decode's own positions are)."""
    if name != "qwen2vl-r":
        return {}
    rng = np.random.default_rng(seed)
    pos = np.tile(np.arange(s, dtype=np.int32), (3, n, 1))
    pos[1, :, :2] = (0, 0)
    pos[2, :, :2] = (1, 0)
    return {"patch_embeds": _rand(rng, n, 2, ARCH_KW[name]["d_model"]),
            "positions": pos}


def _head(extra, t):
    """A batch's extras cut to its first ``t`` tokens."""
    return {k: (v[..., :t] if k == "positions" else v)
            for k, v in extra.items()}


def _to(mod, extra):
    conv = jnp.asarray if mod == "jax" else torch.from_numpy
    return {k: conv(v) for k, v in extra.items()}


@pytest.mark.parametrize("name", DENSE + ["window-r", "qwen2vl-r"])
class TestTransformer:
    @staticmethod
    def _kw(name):
        if name == "qwen2vl-r":
            return ARCH_KW[name]
        return WINDOWED if name == "window-r" else REDUCED[name]

    def test_forward(self, name):
        kw = self._kw(name)
        jcfg, tcfg = _cfgs(kw)
        jp, tp = _params(kw)
        toks = _tokens(B, S)
        extra = _extras(name, B, S)
        jl, _ = _jforward(jp, jcfg, dict(_to("jax", extra),
                                         tokens=jnp.asarray(toks)))
        tl, aux = registry.forward(
            tp, tcfg, dict(_to("torch", extra), tokens=torch.from_numpy(toks)))
        assert tl.shape == (B, S, tcfg.vocab_padded)
        assert float(aux) == 0.0
        _close(tl, jl)

    @pytest.mark.parametrize("max_len", [2 * S, S // 2])
    def test_prefill_then_decode(self, name, max_len):
        """max_len >= S pads the cache; max_len < S (or a window shorter
        than the prompt) fills a rolling buffer by scatter.  Then two
        decode steps on each."""
        if name == "window-r" and max_len < S:
            max_len = S       # its window already makes the buffer roll
        kw = self._kw(name)
        jcfg, tcfg = _cfgs(kw)
        jp, tp = _params(kw)
        toks = _tokens(B, S, seed=1)
        new = _tokens(B, 2, seed=2)
        extra = _extras(name, B, S, seed=1)
        ref = _jserve(jp, jcfg, jnp.asarray(toks), jnp.asarray(new), max_len,
                      _to("jax", extra))
        got = _tserve(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(new),
                      max_len, _to("torch", extra))
        for (tl, tc), (jl, jc) in zip(got, ref):
            _close(tl, jl)
            _close_caches(tc, jc)
        assert got[0][1]["length"] == S

    def test_prefill_decode_matches_forward(self, name):
        """decode(t) after prefill(<t) equals the teacher-forced forward at
        t, within the port itself (as tests/test_archs.py checks the
        reference)."""
        kw = self._kw(name)
        tcfg = _cfgs(kw)[1]
        _, tp = _params(kw)
        toks = torch.from_numpy(_tokens(B, S, seed=3))
        extra = _to("torch", _extras(name, B, S, seed=3))
        with torch.inference_mode():
            ref, _ = registry.forward(tp, tcfg, dict(extra, tokens=toks))
            t = S - 1
            pre, cache = registry.prefill(
                tp, tcfg, dict(_head(extra, t), tokens=toks[:, :t]),
                max_len=S)
            _close(pre[:, 0], ref[:, t - 1])
            dec, _ = registry.decode_step(tp, tcfg, toks[:, t:t + 1], cache)
            _close(dec[:, 0], ref[:, t])


# ---------------------------------------------------------------------------
# Backward through every family's forward, with and without remat
# ---------------------------------------------------------------------------

#: The configs whose backward runs in each family's file: the dense ones
#: here (qwen2vl-r's patch embeddings are written in place into the
#: embedding's output), the others in test_torch_{ssm,hybrid,encdec,moe}.py.
BACKWARD_CASES = DENSE + ["window-r", "qwen2vl-r", "mamba2-r", "zamba2-r",
                          "seamless-r", "mixtral-r", "arctic-r"]


def backward_cases(*families):
    return [n for n in BACKWARD_CASES
            if (REDUCED.get(n) or ARCH_KW.get(n) or WINDOWED)["family"]
            in families]


def _backward_extras(name):
    if name == "seamless-r":
        return {"frames": torch.from_numpy(_rand(
            np.random.default_rng(9), B, 6, ARCH_KW[name]["d_model"]))}
    return _to("torch", _extras(name, B, S, seed=9))


def _grads_through_forward(name, remat):
    """A next-token cross-entropy (plus the aux loss) through
    ``registry.forward`` on the CPU, and its grads of every param leaf."""
    kw = REDUCED.get(name) or (WINDOWED if name == "window-r"
                               else ARCH_KW[name])
    tcfg = _cfgs(kw)[1]
    flat = [p.detach().requires_grad_() for p in leaves(_params(kw)[1])]
    toks = torch.from_numpy(_tokens(B, S, seed=9))
    logits, aux = registry.forward(
        unflatten(_params(kw)[1], flat), tcfg,
        dict(_backward_extras(name), tokens=toks), remat=remat)
    loss = torch.nn.functional.cross_entropy(
        logits[:, :-1].flatten(0, 1).float(),
        toks[:, 1:].flatten().long()) + aux
    return loss.detach(), torch.autograd.grad(loss, flat)


def check_backward(name):
    """Backward runs through the family's forward (no in-place write
    touches a tensor autograd saved), every leaf gets a finite gradient
    that is not all zeros, and remat gives the loss and grads of the plain
    forward bit for bit: the recompute runs the same ops."""
    loss, grads = _grads_through_forward(name, remat=False)
    loss_r, grads_r = _grads_through_forward(name, remat=True)
    assert torch.isfinite(loss) and float(loss) == float(loss_r)
    for g, gr in zip(grads, grads_r):
        assert torch.isfinite(g).all() and bool(g.abs().sum() > 0)
        assert torch.equal(g, gr)


@pytest.mark.parametrize("name", backward_cases("transformer"))
def test_backward_with_and_without_remat(name):
    check_backward(name)


def test_init_params_tree_matches_the_reference():
    """The port's own init draws the reference's tree: the same keys, the
    stacked layer axis, the shapes and dtypes, and init's scales."""
    for name in ("tinyllama-r", "granite-r"):
        kw = dict(REDUCED[name], dtype="bfloat16")
        jcfg, tcfg = _cfgs(kw)
        jshape = jax.eval_shape(
            lambda: jregistry.init_params(jax.random.key(0), jcfg))
        tp = registry.init_params(torch.Generator().manual_seed(0), tcfg,
                                  device="cpu")
        jflat = jax.tree_util.tree_flatten_with_path(jshape)[0]
        tflat = jax.tree_util.tree_flatten_with_path(tp)[0]
        assert [p for p, _ in jflat] == [p for p, _ in tflat]
        for (_, j), (_, t) in zip(jflat, tflat):
            assert tuple(t.shape) == tuple(j.shape)
            assert t.dtype == torch.bfloat16
        assert abs(float(tp["embed"]["embedding"].float().std()) - 0.02) < 2e-3
        w = tp["layers"]["attn"]["wq"]["w"].float()
        assert abs(float(w.std()) * np.sqrt(tcfg.d_model) - 1) < 0.05
        # the stacked layers are distinct draws
        assert not torch.equal(w[0], w[1])


@pytest.mark.parametrize("make", [
    lambda: layers.rmsnorm_init(8),
    lambda: layers.layernorm_init(8),
    lambda: layers.norm_init("rms", 8),
    lambda: layers.linear_init(torch.Generator(), 4, 8),
    lambda: layers.embed_init(torch.Generator(), 16, 8),
    lambda: layers.attn_init(torch.Generator(), _acfg(layers)),
    lambda: layers.mlp_init(torch.Generator(), 8, 16),
    lambda: layers.rope_frequencies(16),
    lambda: transformer.init_layer(
        torch.Generator(), ArchConfig(**REDUCED["llama-r"]), torch.float32),
    lambda: transformer.make_positions(ArchConfig(**REDUCED["llama-r"]),
                                       1, 4),
], ids=["rmsnorm", "layernorm", "norm", "linear", "embed", "attn", "mlp",
        "rope_frequencies", "init_layer", "make_positions"])
def test_tensor_builders_need_an_explicit_device(make):
    """The helpers that build tensors from nothing take ``device`` as a
    required keyword, so none of them quietly builds on the CPU; the entry
    points pass the device they resolved."""
    with pytest.raises(TypeError, match="device"):
        make()


def test_bf16_forward_loosely_matches():
    """One bf16 forward on the same (bf16) weights: XLA's and PyTorch's CPU
    bf16 products round differently, so the logits agree only to
    ``BF16``; the argmax tokens agree on at least 90% of positions."""
    kw = dict(REDUCED["tinyllama-r"], dtype="bfloat16")
    jcfg, tcfg = _cfgs(kw)
    jp, tp = _params(kw)
    assert tp["embed"]["embedding"].dtype == torch.bfloat16
    toks = _tokens(B, S, seed=4)
    jl, _ = _jforward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, _ = registry.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.bfloat16
    jl32, tl32 = np.asarray(jl, np.float32), tl.float().numpy()
    np.testing.assert_allclose(tl32, jl32, **BF16)
    assert np.mean(tl32.argmax(-1) == jl32.argmax(-1)) >= 0.9


# ---------------------------------------------------------------------------
# serve.engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tinyllama-r", "chatglm-r"])
def test_serve_loop_tokens_equal_the_reference(name):
    """The same requests (left-padded with token 0, prompts of different
    lengths, more new tokens than max_len leaves, so decode wraps the
    rolling cache) give the same greedy tokens."""
    kw = REDUCED[name]
    jcfg, tcfg = _cfgs(kw)
    jp, tp = _params(kw)
    out = []
    for mod, cfg, params in ((jengine, jcfg, jp), (engine, tcfg, tp)):
        loop = mod.ServeLoop(cfg, params, batch_size=4, max_len=12)
        rng = np.random.default_rng(0)
        reqs = [mod.Request(uid=i, prompt=rng.integers(
                    1, cfg.vocab, size=int(rng.integers(4, 12))).astype(
                    np.int32), max_new_tokens=6 + 2 * i) for i in range(3)]
        out.append([r.generated for r in loop.run(reqs)])
    assert [len(g) for g in out[1]] == [6, 8, 10]
    assert out[1] == out[0]


def test_launch_serve_requests_match_the_reference():
    """``launch/serve.py`` draws the reference launcher's prompts."""
    cfg = ArchConfig(**REDUCED["tinyllama-r"])
    reqs = launch_serve.make_requests(cfg, 4, 16)
    rng = np.random.default_rng(0)
    for r in reqs:
        want = rng.integers(1, cfg.vocab, size=int(rng.integers(4, 12)))
        np.testing.assert_array_equal(r.prompt, want)
        assert r.max_new_tokens == 16 and 4 <= len(r.prompt) <= 11


def test_launch_serve_main_on_the_cpu(capsys):
    launch_serve.main(["--device", "cpu", "--d-model", "64", "--layers", "1",
                       "--vocab", "256", "--requests", "5",
                       "--max-new-tokens", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"req {i}: 3 tokens" for i in range(5)] + ["done"]


@pytest.mark.parametrize("arch_id,layers_", [
    ("mamba2_780m", 1), ("zamba2_2_7b", 6), ("mixtral_8x7b", 1),
    ("arctic_480b", 1)])
def test_launch_serve_every_servable_family(arch_id, layers_, capsys):
    """The ssm, hybrid (whole groups of 6) and moe families serve through
    the launcher at small_config sizes on the CPU."""
    launch_serve.main(["--device", "cpu", "--arch", arch_id, "--d-model",
                       "64", "--layers", str(layers_), "--vocab", "256",
                       "--requests", "2", "--max-new-tokens", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"req {i}: 3 tokens" for i in range(2)] + ["done"]


def test_launch_serve_refuses_encdec_for_want_of_frames():
    """As the reference's launcher: its ServeLoop passes tokens only."""
    with pytest.raises(KeyError, match="frames"):
        launch_serve.main(["--device", "cpu", "--arch",
                           "seamless_m4t_large_v2", "--d-model", "64",
                           "--layers", "1", "--vocab", "256", "--requests",
                           "1", "--max-new-tokens", "2"])


# ---------------------------------------------------------------------------
# configs, registry, convert
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", registry.ARCH_IDS)
def test_load_arch_equal(arch_id):
    assert registry.ARCH_IDS == jregistry.ARCH_IDS
    t, j = registry.load_arch(arch_id), jregistry.load_arch(arch_id)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.resolved_head_dim, t.vocab_padded) == (j.resolved_head_dim,
                                                     j.vocab_padded)
    t_small = launch_train.small_config(t, 256, 4, 2048)
    j_small = jlaunch_train.small_config(j, 256, 4, 2048)
    assert dataclasses.asdict(t_small) == dataclasses.asdict(j_small)


def test_shapes_equal():
    from repro.configs import base as jbase
    from repro_torch.configs import base as tbase
    assert ({k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()})
    for arch_id in registry.ARCH_IDS:
        for name in tbase.SHAPES:
            assert (tbase.shape_supported(registry.load_arch(arch_id),
                                          tbase.SHAPES[name])
                    == jbase.shape_supported(jregistry.load_arch(arch_id),
                                             jbase.SHAPES[name]))


_FAMILY_MODULE = {"transformer": transformer, "moe": transformer,
                  "ssm": ssm, "hybrid": hybrid, "encdec": encdec}


@pytest.mark.parametrize("arch_id", registry.ARCH_IDS)
def test_every_arch_resolves_to_its_family(arch_id):
    """Every architecture resolves to its family's module (the reference's
    family by name), and at its reduced config of tests/test_archs.py the
    port's empty cache is the reference's tree: keys, shapes and dtypes,
    in fp32 and bf16 (``length`` is a host int here)."""
    full = registry.load_arch(arch_id)
    mod = registry.family_module(full)
    assert mod is _FAMILY_MODULE[full.family]
    jmod = jregistry.family_module(jregistry.load_arch(arch_id))
    assert mod.__name__.rsplit(".", 1)[1] == jmod.__name__.rsplit(".", 1)[1]
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = _cfgs(dict(ARCH_KW[ARCH_OF[arch_id]], dtype=dtype))
        jc = jax.eval_shape(lambda: jregistry.init_cache(jcfg, 2, 8))
        tc = registry.init_cache(tcfg, 2, 8, device="cpu")
        assert _tree_signature(tc) == _tree_signature(jc)
        assert tc["length"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_params_round_trip(dtype):
    kw = dict(REDUCED["granite-r"], dtype=dtype)
    jcfg, tcfg = _cfgs(kw)
    np_tree = jax.tree.map(np.asarray, _params(kw)[0])
    tp = convert.lm_params_from_numpy(np_tree, tcfg, device="cpu")
    back = convert.lm_params_to_numpy(tp)
    jflat = jax.tree_util.tree_flatten_with_path(np_tree)[0]
    bflat = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in jflat] == [p for p, _ in bflat]
    for (_, a), (_, b) in zip(jflat, bflat):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, np.asarray(a, np.float32))
