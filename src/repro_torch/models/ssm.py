"""Mamba2 (SSD, state-space duality, arXiv:2405.21060), the JAX package's
``repro.models.ssm`` op for op.

The prefill path is the chunked matmul form of SSD (quadratic inside a
chunk, linear across chunks); the decode path is the one-token recurrence
on the (H, N, P) state.  A block is one fused in_proj to (z, x, B, C, dt), a
width-4 causal conv over the (x, B, C) channels, a scalar decay per head,
a gated RMSNorm and out_proj.

Dtypes follow the reference cast for cast: ``A_log``, ``dt_bias`` and
``D`` are float32 in every model, and so is the state ``h``; the decay
algebra runs in float32 and is cast to the activation dtype before each
product with activations.  Stacked leaves and a Python loop over layers
stand for the reference's ``vmap``/``lax.scan``; ``decode_step`` writes
the cache in place.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import layers

PyTree = Any


def _dtype(cfg: ArchConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def dims(cfg: ArchConfig) -> dict:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.state_dim          # x + B + C channels (G=1)
    return dict(d_inner=d_inner, n_heads=n_heads, conv_ch=conv_ch,
                N=s.state_dim, P=s.head_dim, W=s.conv_width, Q=s.chunk)


def init_block(generator: torch.Generator, cfg: ArchConfig, dtype, *,
               device: torch.device) -> PyTree:
    d = dims(cfg)
    H = d["n_heads"]
    in_dim = 2 * d["d_inner"] + 2 * d["N"] + H
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "norm": layers.rmsnorm_init(cfg.d_model, dtype, device=device),
        "in_proj": layers.linear_init(generator, cfg.d_model, in_dim, dtype,
                                      device=device),
        "conv_w": torch.randn((d["W"], d["conv_ch"]), generator=generator,
                              dtype=dtype, device=device) * 0.2,
        "conv_b": torch.zeros((d["conv_ch"],), dtype=dtype, device=device),
        "A_log": torch.zeros((H,), **f32),
        "dt_bias": torch.full((H,), -2.0, **f32),
        "D": torch.ones((H,), **f32),
        "gate_norm": layers.rmsnorm_init(d["d_inner"], dtype, device=device),
        "out_proj": layers.linear_init(generator, d["d_inner"], cfg.d_model,
                                       dtype, device=device),
    }


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    d = dims(cfg)
    di, N, H = d["d_inner"], d["N"], d["n_heads"]
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * N]
    dt = zxbcdt[..., di + di + 2 * N:]
    assert dt.shape[-1] == H
    return z, xBC, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)`` (``F.softplus``
    switches to ``x`` above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Width-W causal depthwise conv over (B, S, C) channels.  On a mesh
    each rank convolves its batch rows and channels (``layers.on_blocks``:
    the conv is independent along both), since torch 2.11's DTensor fails
    to plan the redistribution of the shifted products on a 16x16 mesh."""
    def conv(x, w, b):
        W = w.shape[0]
        pad = F.pad(x, (0, 0, W - 1, 0))
        out = sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(W))
        return F.silu(out + b)

    return layers.on_blocks(conv, (xBC, w, b),
                            (("batch", None, "model"), (None, "model"),
                             ("model",)),
                            ("batch", None, "model"), tuple(xBC.shape))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x:  (B, S, H, P)   per-head inputs
    dt: (B, S, H)      softplus'd step sizes
    A:  (H,)           negative decay rates (a = exp(A*dt))
    Bm: (B, S, N)      input projections (shared across heads, G=1)
    Cm: (B, S, N)      output projections
    Returns y (B, S, H, P) and the final state (B, H, N, P) in float32.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        # dt = 0 padding is exact: the decay exp(A*0) = 1 keeps the state,
        # and the update term is dt-scaled, so it vanishes
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    S_pad = S + pad
    nc = S_pad // Q

    xc = x.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)

    # log-decay within a chunk: la[..., i] = sum_{j<=i} A*dt_j  (B,nc,Q,H)
    la = torch.cumsum(A[None, None, None, :] * dtc, dim=2)
    seg = la[:, :, :, None, :] - la[:, :, None, :, :]         # (B,nc,Q,Q,H)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    # exp first, then select: above the diagonal seg can be large and
    # positive, so exp gives inf there, which a 0/1 multiply would turn
    # into NaN
    decay = torch.where(causal[None, None, :, :, None], torch.exp(seg),
                        torch.zeros((), dtype=seg.dtype, device=x.device))
    # the (B,nc,Q,Q,H) intermediates dominate SSD memory: heads on "model"
    decay = layers.maybe_shard(decay, "batch", None, None, None, "model")

    # intra-chunk (quadratic): scores C_i . B_j, summed in float32 (the
    # reference's preferred_element_type; bf16 products are exact there)
    g = torch.einsum("bcin,bcjn->bcij", Cc.float(), Bc.float())
    m = g[..., None] * decay * dtc[:, :, None, :, :]          # (B,nc,Q,Q,H)
    m = layers.maybe_shard(m, "batch", None, None, None, "model")
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m.to(x.dtype), xc)

    # chunk summaries: S_c = sum_j exp(la_Q - la_j) dt_j B_j x_j
    tail = torch.exp(la[:, :, -1:, :] - la) * dtc             # (B,nc,Q,H)
    states = torch.einsum("bcqh,bcqn,bcqhp->bchnp", tail.to(x.dtype), Bc, xc)
    chunk_decay = torch.exp(la[:, :, -1, :])                  # (B,nc,H)

    # inter-chunk recurrence over the nc chunks, carrying the fp32 state
    # and keeping the state each chunk enters with
    h = (torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c].float()
    h_prevs = torch.stack(h_prevs, dim=1)                     # (B,nc,H,N,P)

    # inter-chunk contribution: y_inter_i = C_i . (exp(la_i) * h_{c-1})
    inter_decay = torch.exp(la)                               # (B,nc,Q,H)
    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", Cc,
                           inter_decay.to(x.dtype), h_prevs.to(x.dtype))
    y = (y_intra + y_inter).reshape(Bsz, S_pad, H, P)[:, :S]
    return y, h


def block_forward(lp: PyTree, cfg: ArchConfig, x_in: torch.Tensor,
                  h0: Optional[torch.Tensor] = None,
                  return_state: bool = False):
    """One Mamba2 block (residual included).  x_in: (B, S, D).  With
    ``return_state``, also the decode state: (the final fp32 state, the
    last W-1 raw (pre-conv) xBC rows, zero-padded in front for a prompt
    shorter than W-1)."""
    d = dims(cfg)
    h = layers.rmsnorm(lp["norm"], x_in)
    zxbcdt = layers.linear(lp["in_proj"], h)
    z, xBC_raw, dt_raw = _split_proj(cfg, zxbcdt)
    xBC = _causal_conv(xBC_raw, lp["conv_w"], lp["conv_b"])
    xm = xBC[..., :d["d_inner"]]
    Bm = xBC[..., d["d_inner"]:d["d_inner"] + d["N"]]
    Cm = xBC[..., d["d_inner"] + d["N"]:]
    Bsz, S, _ = xm.shape
    xh = xm.reshape(Bsz, S, d["n_heads"], d["P"])
    dt = _softplus(dt_raw.float() + lp["dt_bias"]).to(x_in.dtype)
    A = -torch.exp(lp["A_log"])
    # on a mesh each rank scans its batch rows and heads: the scan is
    # independent along both, and torch 2.11's DTensor cannot flatten the
    # einsums' sharded head dims
    heads = ("batch", None, "model", None)
    rows = ("batch", None, None)
    y, h_final = layers.on_blocks(
        lambda x, dt, A, Bm, Cm, h0: ssd_chunked(x, dt, A, Bm, Cm,
                                                 cfg.ssm.chunk, h0),
        (xh, dt, A, Bm, Cm, h0),
        (heads, ("batch", None, "model"), ("model",), rows, rows,
         ("batch", "model", None, None)),
        [heads, ("batch", "model", None, None)],
        [tuple(xh.shape), (Bsz, d["n_heads"], d["N"], d["P"])])
    y = y + xh * lp["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(Bsz, S, d["d_inner"])
    y = layers.rmsnorm(lp["gate_norm"], y * F.silu(z))
    out = x_in + layers.linear(lp["out_proj"], y)
    if return_state:
        # the reference recomputes in_proj here (_pre_conv); the same
        # product of the same operands gives the same raw channels
        conv_state = torch.cat(
            [zxbcdt.new_zeros((Bsz, max(d["W"] - 1 - S, 0), d["conv_ch"])),
             xBC_raw[:, -(d["W"] - 1):, :]], dim=1)
        return out, (h_final, conv_state)
    return out


def block_decode(lp: PyTree, cfg: ArchConfig, x_in: torch.Tensor,
                 h: torch.Tensor, conv_state: torch.Tensor):
    """One-token recurrence.  x_in: (B, 1, D); h: (B, H, N, P) float32;
    conv_state: (B, W-1, conv_ch) raw xBC history.  Returns (out, (the new
    state, the new conv history)), both new tensors."""
    d = dims(cfg)
    hn = layers.rmsnorm(lp["norm"], x_in)
    zxbcdt = layers.linear(lp["in_proj"], hn)
    z, xBC_new, dt_raw = _split_proj(cfg, zxbcdt)
    window = torch.cat([conv_state, xBC_new], dim=1)         # (B, W, C)
    conv_out = torch.einsum("bwc,wc->bc", window, lp["conv_w"]) + lp["conv_b"]
    xBC = F.silu(conv_out)[:, None, :]
    xm = xBC[..., :d["d_inner"]]
    Bm = xBC[..., d["d_inner"]:d["d_inner"] + d["N"]][:, 0]  # (B, N)
    Cm = xBC[..., d["d_inner"] + d["N"]:][:, 0]
    Bsz = xm.shape[0]
    xh = xm.reshape(Bsz, d["n_heads"], d["P"])
    dt = _softplus(dt_raw.float() + lp["dt_bias"])[:, 0]     # (B, H) fp32
    A = -torch.exp(lp["A_log"])
    a = torch.exp(A[None, :] * dt)                           # (B, H)
    upd = torch.einsum("bh,bn,bhp->bhnp", dt.to(xh.dtype), Bm, xh)
    h = h * a[:, :, None, None] + upd.float()
    y = torch.einsum("bn,bhnp->bhp", Cm, h.to(xh.dtype))
    y = y + xh * lp["D"].to(y.dtype)[None, :, None]
    y = y.reshape(Bsz, 1, d["d_inner"])
    y = layers.rmsnorm(lp["gate_norm"], y * F.silu(z))
    out = x_in + layers.linear(lp["out_proj"], y)
    return out, (h, window[:, 1:, :])


# ---------------------------------------------------------------------------
# Full model (mamba2-780m): stacked blocks + embedding/unembedding
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: ArchConfig,
                device: DeviceLike = None) -> PyTree:
    """Random params on ``device``, drawn from ``generator`` (which lives
    on that device): ``cfg.dtype`` leaves, and the float32 ``A_log``,
    ``dt_bias`` and ``D``."""
    dev = resolve(device)
    dtype = _dtype(cfg)
    embed = layers.embed_init(generator, cfg.vocab_padded, cfg.d_model,
                              dtype, device=dev)
    stacked = layers.init_stacked(
        lambda: init_block(generator, cfg, dtype, device=dev),
        cfg.num_layers)
    return {
        "embed": embed,
        "layers": stacked,
        "final_norm": layers.rmsnorm_init(cfg.d_model, dtype, device=dev),
        "lm_head": layers.linear_init(generator, cfg.d_model,
                                      cfg.vocab_padded, dtype, device=dev),
    }


def forward(params: PyTree, cfg: ArchConfig, batch: dict,
            remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits, aux_loss = 0).  ``remat``
    recomputes each block's activations in the backward."""
    x = layers.maybe_shard(layers.embed(params["embed"], batch["tokens"]),
                           "batch", None, None)
    body = layers.maybe_remat(lambda lp, x: block_forward(lp, cfg, x), remat)
    for lp in layers.unstack(params["layers"]):
        x = body(lp, x)
    x = layers.rmsnorm(params["final_norm"], x)
    return (layers.linear(params["lm_head"], x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def init_cache(cfg: ArchConfig, batch_size: int, max_len: int,
               device: DeviceLike = None) -> PyTree:
    """An empty state on ``device``: float32 ``h`` (L, B, H, N, P), the
    raw conv history (L, B, W-1, conv_ch), and ``length`` as a host int.
    The state is O(1) in the sequence, so ``max_len`` is unused."""
    del max_len
    dev = resolve(device)
    return {**{k: torch.zeros(shape, dtype=dt, device=dev)
               for k, (shape, dt) in _state_shapes(cfg, batch_size).items()},
            "length": 0}


def _state_shapes(cfg: ArchConfig, batch_size: int) -> dict:
    """Each state leaf's (shape, dtype)."""
    d = dims(cfg)
    L = cfg.num_layers
    return {"h": ((L, batch_size, d["n_heads"], d["N"], d["P"]),
                  torch.float32),
            "conv": ((L, batch_size, d["W"] - 1, d["conv_ch"]),
                     _dtype(cfg))}


def prefill(params: PyTree, cfg: ArchConfig, batch: dict,
            max_len: int) -> tuple[torch.Tensor, PyTree]:
    """Run the prompt, build the state, return last-token logits."""
    x = layers.maybe_shard(layers.embed(params["embed"], batch["tokens"]),
                           "batch", None, None)
    S = x.shape[1]
    B = x.shape[0]
    cache = {**layers.new_cache(
        cfg, {k: (shape, dt, 0)
              for k, (shape, dt) in _state_shapes(cfg, B).items()}, B, x),
             "length": 0}
    for l in range(cfg.num_layers):
        x, (h, conv) = block_forward(layers.layer_params(params["layers"], l),
                                     cfg, x, return_state=True)
        layers.write(cache["h"], l, h)
        layers.write(cache["conv"], l, conv)
    x = layers.rmsnorm(params["final_norm"], x)
    logits = layers.linear(params["lm_head"], x[:, -1:, :])
    cache["length"] = S
    return logits, cache


def decode_step(params: PyTree, cfg: ArchConfig, token: torch.Tensor,
                cache: PyTree) -> tuple[torch.Tensor, PyTree]:
    """One-token decode.  The new states are written into the cache's
    tensors in place, so the cache passed in is the one returned."""
    x = layers.maybe_shard(layers.embed(params["embed"], token),
                           "batch", None, None)
    for l in range(cfg.num_layers):
        x, (h, conv) = block_decode(layers.layer_params(params["layers"], l),
                                    cfg, x, cache["h"][l], cache["conv"][l])
        layers.write(cache["h"], l, h)
        layers.write(cache["conv"], l, conv)
    x = layers.rmsnorm(params["final_norm"], x)
    logits = layers.linear(params["lm_head"], x)
    cache["length"] = int(cache["length"]) + 1
    return logits, cache
