"""Shared model layers: norms, rotary variants, GQA attention (with KV cache
and sliding windows), and gated MLPs.  Plain functions on dicts of tensors,
the JAX package's ``repro.models.layers`` op for op.

Every product, softmax and norm here is an explicit PyTorch op, as the
reference leaves them to XLA outside any Pallas kernel.  Attention keeps the
reference's numerics: scores in fp32 (operands widened, so a bf16 product is
exact before the fp32 sum), an additive ``-1e30`` mask, probabilities cast
to the activation dtype before the second product, and the same query
chunking.  No fused library attention is used.

On a mesh (``launch.mesh.use_mesh``) the same functions run on DTensors:
``maybe_shard`` is the reference's sharding constraint, a redistribute
against the ambient mesh (a no-op outside one, or on a plain tensor);
``on_blocks`` runs an op on each rank's blocks (attention, the embedding
lookup, the MoE experts) and ``replicated`` on whole tensors (the MoE
dispatch and combine), where DTensor lacks a sharding rule in some torch
release; and the cache helpers (``new_cache``, ``write``) build and write a
cache whether it is a tensor or a DTensor, a sharded one in its own
layout, block by block.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding

PyTree = Any


# ---------------------------------------------------------------------------
# Sharding against the ambient mesh
# ---------------------------------------------------------------------------

def _rep(mesh) -> list:
    from torch.distributed.tensor import Replicate
    return [Replicate()] * mesh.ndim


def maybe_shard(x: torch.Tensor, *spec) -> torch.Tensor:
    """Sharding constraint against the ambient mesh (``use_mesh``).

    ``spec`` entries: axis name, tuple of names, None, or the sentinel
    "batch", tried as ("pod", "data"), then "data", then None: the first
    candidate whose axes are all on the mesh wins, as the reference's first
    constraint that lowers does.  Outside a mesh, or on a tensor that is
    not a DTensor, this is a no-op.  Uneven dims are fine (DTensor splits
    them as ``torch.chunk`` does).
    """
    from repro_torch.launch.mesh import current_mesh
    mesh = current_mesh()
    if mesh is None or not sharding.is_dtensor(x):
        return x
    return x.redistribute(mesh, _placements(mesh, spec))


def _placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, its "batch" entries
    resolved as ``maybe_shard`` resolves them."""
    names = set(mesh.mesh_dim_names)

    def on_mesh(e):
        return e is None or (e in names if isinstance(e, str)
                             else all(a in names for a in e))

    cand = tuple(None for _ in spec)
    for batch_axes in (("pod", "data"), "data", None):
        resolved = tuple(batch_axes if s == "batch" else s for s in spec)
        if all(on_mesh(e) for e in resolved):
            cand = resolved
            break
    return sharding.NamedSharding(mesh, sharding.P(*cand)).placements


def on_blocks(fn: Callable, args: tuple, in_specs: tuple, out_spec,
              out_shape, partial: Optional[str] = None):
    """``fn`` on each rank's blocks: the reference's ``shard_map`` for a
    function that is independent along the sharded dims (attention, per
    batch row and head; experts, per expert; the SSD scan, per batch row
    and head).  On the ambient mesh each tensor argument is put on its spec
    (a plain tensor counts as replicated) and ``fn`` runs on the local
    tensors; its output is a DTensor of global shape ``out_shape`` on
    ``out_spec`` (for an ``fn`` of several outputs, lists of one each,
    split on the same mesh dims).  ``partial`` names a mesh axis over which
    the local outputs are partial sums (a product whose contracted dim is
    split there): they are summed over it (an all-reduce) into
    ``out_spec``.  A None spec passes its argument as it is.  Without a
    mesh, or without a DTensor argument, this is ``fn(*args)``."""
    from repro_torch.launch.mesh import current_mesh
    mesh = current_mesh()
    if mesh is None or not any(sharding.is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial
    many = isinstance(out_spec, list)
    specs, shapes = (out_spec, out_shape) if many else ([out_spec],
                                                        [out_shape])
    out_pls = [_placements(mesh, spec) for spec in specs]
    local_pls = out_pls
    if partial is not None and partial in mesh.mesh_dim_names:
        i = mesh.mesh_dim_names.index(partial)
        local_pls = [pl[:i] + (Partial(),) + pl[i + 1:] for pl in out_pls]
    local = []
    for a, spec in zip(args, in_specs):
        if spec is not None and isinstance(a, torch.Tensor):
            if not sharding.is_dtensor(a):
                a = DTensor.from_local(a, mesh, _rep(mesh), run_check=False)
            pl = _placements(mesh, spec)
            # an argument whole along a mesh dim that the output is split
            # or summed on gets, from each rank, the gradient of its block
            # alone: a partial sum over that dim
            grad_pl = tuple(Partial() if p.is_replicate() and not
                            o.is_replicate() else p
                            for p, o in zip(pl, local_pls[0]))
            a = a.redistribute(mesh, pl).to_local(grad_placements=grad_pl)
        local.append(a)
    outs = fn(*local)
    wrapped = []
    for out, shape, local_pl, out_pl in zip(outs if many else [outs], shapes,
                                            local_pls, out_pls):
        out = out.contiguous()          # the stride stated below
        stride, n = [], 1
        for d in reversed(shape):
            stride.insert(0, n)
            n *= d
        out = DTensor.from_local(out, mesh, local_pl, run_check=False,
                                 shape=torch.Size(shape),
                                 stride=tuple(stride))
        wrapped.append(out if local_pl == out_pl
                       else out.redistribute(mesh, out_pl))
    return tuple(wrapped) if many else wrapped[0]


def replicated(fn: Callable, *args):
    """``fn(*args)`` with every DTensor among ``args`` (also inside dicts,
    lists and tuples) gathered whole on every rank, and the tensors ``fn``
    returns as replicated DTensors: the explicit redistribute around an op
    that DTensor has no sharding rule for (each use is listed in PERF.md).
    Autograd runs through the gather.  Without a DTensor argument this is
    ``fn(*args)``."""
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import tree_map
    mesh = sharding.mesh_of(list(args))
    if mesh is None:
        return fn(*args)
    rep = _rep(mesh)
    local = tree_map(lambda x: x.redistribute(mesh, rep).to_local()
                     if sharding.is_dtensor(x) else x, list(args))
    out = fn(*local)
    return tree_map(lambda o: DTensor.from_local(o, mesh, rep,
                                                 run_check=False)
                    if isinstance(o, torch.Tensor) else o, out)


def new_cache(cfg, leaves: dict, batch_size: int,
              like: torch.Tensor) -> dict:
    """A cache's tensors, ``{key: (shape, dtype, fill)}`` each filled on
    ``like``'s device.  When ``like`` is a DTensor, each is a DTensor on
    its mesh in ``sharding.cache_specs``'s layout for the key, so that
    every rank allocates its own block alone (the batch-1 layout splits
    the sequence over data x model)."""
    if not sharding.is_dtensor(like):
        return {k: torch.full(tuple(shape), fill, dtype=dt,
                              device=like.device)
                for k, (shape, dt, fill) in leaves.items()}
    from torch.distributed import tensor as dt_
    mesh = like.device_mesh
    specs = sharding.cache_specs(
        cfg, {k: torch.empty(tuple(shape), dtype=dt, device="meta")
              for k, (shape, dt, _) in leaves.items()}, mesh, batch_size)
    return {k: dt_.full(tuple(shape), fill, dtype=dt, device_mesh=mesh,
                        placements=sharding.NamedSharding(
                            mesh, specs[k]).placements)
            for k, (shape, dt, fill) in leaves.items()}


def write(dst: torch.Tensor, index, value) -> None:
    """``dst[index] = value`` in place, for a cache leaf that may be a
    DTensor.  A replicated DTensor takes any index (each rank writes its
    whole copy).  A sharded one: ints and step-1 slices are written by
    each rank into the part of the region that lies in its own block
    (nothing when none does), at the block's local index, since DTensor
    has no sharding rule for an in-place write into a slice; an index
    with tensors (prefill's rolling slots) gathers the sub-block under its
    leading ints, scatters into that, and writes it back so."""
    whole = sharding.whole
    index = index if isinstance(index, tuple) else (index,)
    if not sharding.is_dtensor(dst):
        dst[tuple(whole(i) for i in index)] = whole(value)
        return
    value = whole(value)
    if all(p.is_replicate() for p in dst.placements):
        dst.to_local()[tuple(whole(i) for i in index)] = value
        return
    n = next((d for d, e in enumerate(index) if not isinstance(e, int)),
             len(index))
    if any(isinstance(e, torch.Tensor) for e in index[n:]):
        sub = whole(dst[index[:n]] if n else dst).clone()
        sub[tuple(whole(i) for i in index[n:])] = value
        write(dst, index[:n], sub)
        return
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    lshape, offset = compute_local_shape_and_global_offset(
        dst.shape, dst.device_mesh, dst.placements)
    index = index + (slice(None),) * (dst.ndim - len(index))
    local, region, want = [], [], []
    for d, e in enumerate(index):
        n, off, lo_n = dst.shape[d], offset[d], lshape[d]
        if isinstance(e, int):
            e %= n
            if not off <= e < off + lo_n:
                return
            local.append(e - off)
            continue
        start, stop, step = e.indices(n)
        if step != 1:
            raise ValueError(f"a sharded cache takes step-1 slices, not {e}")
        lo, hi = max(start, off), min(stop, off + lo_n)
        want.append(stop - start)
        if lo >= hi:
            return
        local.append(slice(lo - off, hi - off))
        region.append(slice(lo - start, hi - start))
    dst.to_local()[tuple(local)] = value.expand(want)[tuple(region)]


# ---------------------------------------------------------------------------
# Stacked layers
# ---------------------------------------------------------------------------

def layer_params(tree: PyTree, l: int) -> PyTree:
    """Layer ``l``'s params: every stacked leaf indexed at ``l`` (views).
    The reference's ``lax.scan`` over a stacked tree is a Python loop over
    ``l`` here."""
    if isinstance(tree, dict):
        return {k: layer_params(v, l) for k, v in tree.items()}
    return tree[l]


def unstack(tree: PyTree) -> list[PyTree]:
    """Every layer's params of a stacked tree, each leaf unbound along its
    leading axis once (views).  ``forward`` walks its layers this way: the
    backward of one ``unbind`` is a single ``stack``, where indexing each
    layer out of a stacked leaf (``layer_params``) would give every layer's
    gradient a zero tensor of the whole leaf with one slice filled."""
    if isinstance(tree, dict):
        parts = {k: unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[l] for k, v in parts.items()} for l in range(n)]
    return list(torch.unbind(tree))


def maybe_remat(fn: Callable, remat: bool) -> Callable:
    """``fn``, or with ``remat`` ``fn`` under activation checkpointing: the
    reference's ``jax.checkpoint(policy=nothing_saveable)``.  Only its
    arguments are kept for the backward, which runs ``fn`` again to
    recompute the rest; pass a layer's params as arguments.  Nothing in
    these models draws random numbers, so no RNG state is stashed."""
    if not remat:
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False)


def _stack_into(dst: PyTree, src: PyTree, l: int) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _stack_into(dst[k], v, l)
        else:
            dst[k][l].copy_(v)


def _empty_stacked(tree: PyTree, n: int) -> PyTree:
    if isinstance(tree, dict):
        return {k: _empty_stacked(v, n) for k, v in tree.items()}
    return tree.new_empty((n,) + tuple(tree.shape))


def _one_stacked(tree: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: _one_stacked(v) for k, v in tree.items()}
    return tree.unsqueeze(0)


def init_stacked(make_layer: Callable[[], PyTree], n: int) -> PyTree:
    """``n`` calls of ``make_layer`` stacked on a new leading axis (the
    reference's ``vmap`` of a layer init).  Each layer is drawn and copied
    into the stacked leaves in turn, so init holds one layer beyond the
    model; a single layer is its own leaves viewed with the axis, with no
    copy."""
    if n == 1:
        return _one_stacked(make_layer())
    stacked = None
    for l in range(n):
        lp = make_layer()
        if stacked is None:
            stacked = _empty_stacked(lp, n)
        _stack_into(stacked, lp, l)
        del lp
    return stacked


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype=torch.float32, *,
                 device: torch.device) -> PyTree:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: PyTree, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """fp32 statistics, cast back, then the scale in the activation dtype."""
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * p["scale"].to(dt)


def layernorm_init(d: int, dtype=torch.float32, *,
                   device: torch.device) -> PyTree:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: PyTree, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return out.to(dt) * p["scale"].to(dt) + p["bias"].to(dt)


def norm_init(kind: str, d: int, dtype=torch.float32, *,
              device: torch.device) -> PyTree:
    return (rmsnorm_init(d, dtype, device=device) if kind == "rms"
            else layernorm_init(d, dtype, device=device))


def norm_apply(kind: str, p: PyTree, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if kind == "rms" else layernorm(p, x)


# ---------------------------------------------------------------------------
# Rotary position embeddings (1D, 2D-ChatGLM, 3D M-RoPE)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     rotary_dim: Optional[int] = None, *,
                     device: torch.device) -> torch.Tensor:
    rd = rotary_dim or head_dim
    exps = torch.arange(0, rd, 2, dtype=torch.float32, device=device) / rd
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs (even, odd) of the last dim by per-pair
    angles.  x: (..., rd) with rd even; angles: broadcastable (..., rd//2).
    """
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0,
               rotary_frac: float = 1.0) -> torch.Tensor:
    """Standard 1D RoPE.  x: (B, S, H, D); positions: (B, S) int.

    ``rotary_frac < 1`` rotates only the leading fraction of head dims and
    passes the rest through.
    """
    D = x.shape[-1]
    rd = int(D * rotary_frac)
    rd -= rd % 2
    freqs = rope_frequencies(D, theta, rd, device=x.device)   # (rd/2,)
    ang = positions[..., None, None].float() * freqs          # (B,S,1,rd/2)
    rotated = _rotate(x[..., :rd].float(), ang).to(x.dtype)
    return torch.cat([rotated, x[..., rd:]], dim=-1) if rd < D else rotated


def apply_rope_2d(x: torch.Tensor, positions: torch.Tensor,
                  theta: float = 10000.0) -> torch.Tensor:
    """ChatGLM-style 2D RoPE: the head dim is split in halves, each rotated
    by its own positional channel.  positions: (2, B, S)."""
    half = x.shape[-1] // 2
    a = apply_rope(x[..., :half], positions[0], theta)
    b = apply_rope(x[..., half:], positions[1], theta)
    return torch.cat([a, b], dim=-1)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: tuple[int, ...],
                theta: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL M-RoPE: rotary pairs are partitioned into (temporal, h, w)
    sections, each driven by its own position id.  positions: (3, B, S);
    ``sections`` are pair counts summing to D//2."""
    D = x.shape[-1]
    assert sum(sections) == D // 2, (sections, D)
    freqs = rope_frequencies(D, theta, device=x.device)      # (D/2,)
    # each pair's section, from the host ints (a repeat_interleave by a
    # tensor of counts has a data-dependent shape, which a fake tensor
    # cannot give)
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=x.device)
    pos = positions[sec_id]                                  # (D/2, B, S)
    ang = pos.permute(1, 2, 0).float() * freqs               # (B, S, D/2)
    return _rotate(x.float(), ang[:, :, None, :]).to(x.dtype)


# ---------------------------------------------------------------------------
# Linear / embedding
# ---------------------------------------------------------------------------

def linear_init(generator: torch.Generator, d_in: int, d_out: int,
                dtype=torch.float32, bias: bool = False, *,
                device: torch.device) -> PyTree:
    w = torch.randn((d_in, d_out), generator=generator, dtype=dtype,
                    device=device) / math.sqrt(d_in)
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def linear(p: PyTree, x: torch.Tensor) -> torch.Tensor:
    # the cast is a no-op when the weight is already in x's dtype, so a
    # bf16 model keeps no fp32 copy of its weights
    out = x @ p["w"].to(x.dtype)
    if "b" in p:
        out = out + p["b"].to(x.dtype)
    return out


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype=torch.float32, *, device: torch.device) -> PyTree:
    return {"embedding": torch.randn((vocab, d), generator=generator,
                                     dtype=dtype, device=device) * 0.02}


def embed(p: PyTree, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the table.  On a mesh each rank looks up its batch rows in
    the whole table (the vocab-sharded table gathered): DTensor's rule for
    the lookup's backward (an ``index_put``) fails on a sharded table in
    some torch releases."""
    table = p["embedding"]
    return on_blocks(lambda w, t: w[t], (table, tokens),
                     ((None, None), ("batch",) + (None,) * (tokens.ndim - 1)),
                     ("batch",) + (None,) * tokens.ndim,
                     tuple(tokens.shape) + (table.shape[-1],))


# ---------------------------------------------------------------------------
# Attention (GQA, causal / bidirectional / sliding window, KV cache)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    rope: str = "1d"                 # "1d" | "2d" | "mrope" | "none"
    rope_theta: float = 10000.0
    rope_frac: float = 1.0
    mrope_sections: tuple[int, ...] = ()
    window: int = 0                  # sliding window (0 = full)
    causal: bool = True
    qkv_bias: bool = False


def attn_init(generator: torch.Generator, cfg: AttnConfig,
              dtype=torch.float32, *, device: torch.device) -> PyTree:
    def lin(d_in, d_out, bias):
        return linear_init(generator, d_in, d_out, dtype, bias,
                           device=device)

    return {
        "wq": lin(cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.qkv_bias),
        "wk": lin(cfg.d_model, cfg.n_kv * cfg.head_dim, cfg.qkv_bias),
        "wv": lin(cfg.d_model, cfg.n_kv * cfg.head_dim, cfg.qkv_bias),
        "wo": lin(cfg.n_heads * cfg.head_dim, cfg.d_model, False),
    }


def _apply_positional(cfg: AttnConfig, x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    if cfg.rope == "1d":
        return apply_rope(x, positions, cfg.rope_theta, cfg.rope_frac)
    if cfg.rope == "2d":
        return apply_rope_2d(x, positions, cfg.rope_theta)
    if cfg.rope == "mrope":
        return apply_mrope(x, positions, cfg.mrope_sections, cfg.rope_theta)
    return x


def _where_bias(ok: torch.Tensor) -> torch.Tensor:
    """0 where ``ok``, ``-1e30`` elsewhere, in fp32."""
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, torch.full_like(zero, -1e30))


def _mask_bias(cfg: AttnConfig, q_pos: torch.Tensor, kv_pos: torch.Tensor,
               kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, Sq, Skv) additive mask from causality + window + cache validity.

    q_pos: (B, Sq); kv_pos: (B, Skv) absolute positions.
    """
    q = q_pos[:, :, None]
    k = kv_pos[:, None, :]
    ok = torch.ones((q.shape[0], q.shape[1], k.shape[2]), dtype=torch.bool,
                    device=q.device)
    if cfg.causal:
        ok = ok & (k <= q)
    if cfg.window:
        ok = ok & (k > q - cfg.window)
    if kv_valid is not None:
        ok = ok & kv_valid[:, None, :]
    return _where_bias(ok)


ATTN_CHUNK = 1024     # query-chunk length for memory-efficient attention


def _attend_block(cfg: AttnConfig, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """One (q-chunk x kv) attention block.  q: (B,Sq,H,D); k/v: (B,Skv,H,D)
    (kv already expanded to full heads); bias: (B,Sq,Skv) additive."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * (1.0 / math.sqrt(cfg.head_dim))
    scores = maybe_shard(scores, "batch", "model", None, None)
    probs = torch.softmax(scores + bias[:, None], dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _attend_decode(cfg: AttnConfig, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Short-query (decode) attention: grouped GQA einsum against the cache
    in its native layout, with no kv repeat (query head ``h`` reads kv head
    ``h // groups``)."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores * (1.0 / math.sqrt(D))
    probs = torch.softmax(scores + bias[:, None, None], dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, H * D)


def _attend(cfg: AttnConfig, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, q_abs: Optional[torch.Tensor],
            kv_abs: Optional[torch.Tensor], kv_valid: Optional[torch.Tensor],
            masked: bool, chunk: int = ATTN_CHUNK) -> torch.Tensor:
    """Chunked GQA attention core: queries processed in chunks so the score
    tensor never exceeds (B, H, chunk, Skv); causal chunks also truncate the
    KV span they can see."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if Sq <= 8 and Skv > Sq:      # decode against a cache
        if masked:
            bias = _mask_bias(cfg, q_abs, kv_abs, kv_valid)
        elif kv_valid is not None:
            bias = _where_bias(kv_valid[:, None, :])
        else:
            bias = torch.zeros((B, Sq, Skv), dtype=torch.float32,
                               device=q.device)
        # every rank its batch rows, all heads: the cache's split-KV
        # layout (seq on "model") is gathered for the step
        spec = ("batch", None, None, None)
        return on_blocks(functools.partial(_attend_decode, cfg),
                         (q, k, v, bias), (spec, spec, spec,
                                           ("batch", None, None)),
                         ("batch", None, None), (B, Sq, H * D))
    groups = cfg.n_heads // cfg.n_kv
    if groups > 1:
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)

    def bias_for(q_abs_c, lo, hi, qlen):
        if not masked:
            if kv_valid is not None:
                return _where_bias(kv_valid[:, None, lo:hi])
            return torch.zeros((B, qlen, hi - lo), dtype=torch.float32,
                               device=q.device)
        kvv = kv_valid[:, lo:hi] if kv_valid is not None else None
        return _mask_bias(cfg, q_abs_c, kv_abs[:, lo:hi], kvv)

    # every rank its batch rows and heads (the reference's scores layout,
    # ("batch", "model", None, None))
    heads = ("batch", None, "model", None)

    def block(qc, kc, vc, bias):
        return on_blocks(functools.partial(_attend_block, cfg),
                         (qc, kc, vc, bias), (heads, heads, heads,
                                              ("batch", None, None)),
                         heads, tuple(qc.shape))

    if Sq <= chunk:
        out = block(q, k, v, bias_for(q_abs, 0, Skv, Sq))
    else:
        assert Sq % chunk == 0, (Sq, chunk)
        outs = []
        causal_trunc = (masked and cfg.causal and kv_abs is not None
                        and Sq == Skv)
        for i in range(Sq // chunk):
            qc = q[:, i * chunk:(i + 1) * chunk]
            qa = (q_abs[:, i * chunk:(i + 1) * chunk]
                  if q_abs is not None else None)
            lo = 0
            hi = (i + 1) * chunk if causal_trunc else Skv
            if causal_trunc and cfg.window:
                lo = max(0, (i + 1) * chunk - cfg.window - chunk)
            outs.append(block(qc, k[:, lo:hi], v[:, lo:hi],
                                      bias_for(qa, lo, hi, chunk)))
        out = torch.cat(outs, dim=1)
    return _merge_heads(out)


def _heads_reshape(t: torch.Tensor, dim: int, n: int,
                   shape: tuple) -> torch.Tensor:
    """``t.reshape(shape)``, where dim ``dim`` of ``t`` holds ``n`` heads
    (or ``n`` heads flattened with their head dim).  On a mesh, that dim
    split over a count of ranks that ``n`` does not divide is gathered
    first (an explicit redistribute), and so is the gradient that comes
    back (an identity redistribute after the reshape): DTensor's view
    rules cannot flatten or unflatten an uneven split (arctic-480b's 56
    heads on 16 ranks), or put the whole split on the heads dim and leave
    some ranks an empty block (2 kv heads flattened on 4 ranks), where
    XLA's reshape splits the dim as it is."""
    if n % sharding.splits(t, dim) == 0:
        return t.reshape(shape)
    from torch.distributed.tensor import Replicate
    mesh = t.device_mesh
    t = t.redistribute(mesh, [Replicate() if q.is_shard(dim) else q
                              for q in t.placements])
    out = t.reshape(shape)
    return out.redistribute(mesh, out.placements)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(..., n, hd) -> (..., n * hd)."""
    return _heads_reshape(t, t.ndim - 2, t.shape[-2],
                          (*t.shape[:-2], t.shape[-2] * t.shape[-1]))


def _split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(..., n * hd) -> (..., n, hd)."""
    return _heads_reshape(t, t.ndim - 1, n, (*t.shape[:-1], n, hd))


def attention(p: PyTree, cfg: AttnConfig, x: torch.Tensor,
              positions: torch.Tensor,
              kv_override: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
              kv_positions: Optional[torch.Tensor] = None,
              kv_valid: Optional[torch.Tensor] = None,
              cross_kv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """General GQA attention.

    x: (B, Sq, d); positions: (B, Sq) (or (2/3, B, Sq) for 2d/mrope).
    kv_override: precomputed (k, v) each (B, Skv, n_kv, hd): decode cache or
    cross-attention memory.  kv_positions (B, Skv) and kv_valid mask apply.
    cross_kv: (B, Skv, d) source sequence for cross-attention (k/v projected
    from it, no positional rotation).
    """
    q = _split_heads(linear(p["wq"], x), cfg.n_heads, cfg.head_dim)
    q = _apply_positional(cfg, q, positions)

    if kv_override is not None:
        k, v = kv_override
    elif cross_kv is not None:
        k = _split_heads(linear(p["wk"], cross_kv), cfg.n_kv, cfg.head_dim)
        v = _split_heads(linear(p["wv"], cross_kv), cfg.n_kv, cfg.head_dim)
    else:
        k = _split_heads(linear(p["wk"], x), cfg.n_kv, cfg.head_dim)
        v = _split_heads(linear(p["wv"], x), cfg.n_kv, cfg.head_dim)
        k = _apply_positional(cfg, k, positions)

    if cross_kv is not None:
        out = _attend(cfg, q, k, v, None, None, kv_valid, masked=False)
    else:
        q_abs = positions if positions.ndim == 2 else positions[0]
        kv_abs = kv_positions if kv_positions is not None else (
            q_abs if kv_override is None else None)
        assert kv_abs is not None, "kv_positions required with kv_override"
        out = _attend(cfg, q, k, v, q_abs, kv_abs, kv_valid, masked=True)
    return linear(p["wo"], out)


def project_kv(p: PyTree, cfg: AttnConfig, x: torch.Tensor,
               positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K/V projection for cache fill.  x: (B, S, d) -> (B, S, n_kv, hd)."""
    k = _split_heads(linear(p["wk"], x), cfg.n_kv, cfg.head_dim)
    v = _split_heads(linear(p["wv"], x), cfg.n_kv, cfg.head_dim)
    k = _apply_positional(cfg, k, positions)
    return k, v


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(generator: torch.Generator, d_model: int, d_ff: int,
             kind: str = "swiglu", dtype=torch.float32, *,
             device: torch.device) -> PyTree:
    def lin(d_in, d_out):
        return linear_init(generator, d_in, d_out, dtype, False,
                           device=device)

    if kind == "swiglu":
        return {"w_gate": lin(d_model, d_ff), "w_up": lin(d_model, d_ff),
                "w_down": lin(d_ff, d_model)}
    return {"w_up": lin(d_model, d_ff), "w_down": lin(d_ff, d_model)}


def mlp(p: PyTree, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    if kind == "swiglu":
        return linear(p["w_down"],
                      F.silu(linear(p["w_gate"], x)) * linear(p["w_up"], x))
    # jax.nn.gelu defaults to the tanh approximation
    return linear(p["w_down"], F.gelu(linear(p["w_up"], x),
                                      approximate="tanh"))
