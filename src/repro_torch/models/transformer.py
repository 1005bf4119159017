"""Decoder-only transformer family (llama3.2, granite, tinyllama,
chatglm3, the qwen2-vl backbone, and mixtral and arctic with a mixture of
experts in place of the MLP, ``cfg.moe``).

Layers are *stacked*: every layer-param leaf carries a leading ``L`` dim,
as in the JAX package, whose ``lax.scan`` over ``params["layers"]`` is a
Python loop here over the stacked leaves' layers.  Params and caches are
plain dicts of tensors on one device; functions take the device of their
inputs, and ``init_params``/``init_cache`` take an explicit ``device``.
As in the reference, ``forward`` routes a MoE layer's groups all at once
(its training mode, ``group_mode="vmap"``) and ``prefill``/``decode_step``
one group at a time (``"scan"``).
"""
from __future__ import annotations

from typing import Any, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import layers, moe as moe_lib

PyTree = Any


def _dtype(cfg: ArchConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def attn_config(cfg: ArchConfig) -> layers.AttnConfig:
    return layers.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.resolved_head_dim, rope=cfg.rope,
        rope_theta=cfg.rope_theta, mrope_sections=cfg.mrope_sections,
        window=cfg.window, causal=True)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_layer(generator: torch.Generator, cfg: ArchConfig, dtype, *,
               device: torch.device) -> PyTree:
    p = {
        "attn_norm": layers.norm_init(cfg.norm, cfg.d_model, dtype,
                                      device=device),
        "attn": layers.attn_init(generator, attn_config(cfg), dtype,
                                 device=device),
        "mlp_norm": layers.norm_init(cfg.norm, cfg.d_model, dtype,
                                     device=device),
    }
    if cfg.moe is not None:
        p["moe"] = moe_lib.moe_init(generator, cfg.d_model, cfg.d_ff,
                                    cfg.moe, dtype, device=device)
    else:
        p["mlp"] = layers.mlp_init(generator, cfg.d_model, cfg.d_ff,
                                   cfg.mlp_kind, dtype, device=device)
    return p


def init_params(generator: torch.Generator, cfg: ArchConfig,
                device: DeviceLike = None) -> PyTree:
    """Random params in ``cfg.dtype`` on ``device``, drawn from
    ``generator`` (which lives on that device)."""
    dev = resolve(device)
    dtype = _dtype(cfg)
    embed = layers.embed_init(generator, cfg.vocab_padded, cfg.d_model,
                              dtype, device=dev)
    params = {
        "embed": embed,
        "layers": layers.init_stacked(
            lambda: init_layer(generator, cfg, dtype, device=dev),
            cfg.num_layers),
        "final_norm": layers.norm_init(cfg.norm, cfg.d_model, dtype,
                                      device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.linear_init(generator, cfg.d_model,
                                               cfg.vocab_padded, dtype,
                                               device=dev)
    return params


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------

def make_positions(cfg: ArchConfig, B: int, S: int,
                   offset: Union[torch.Tensor, int] = 0, *,
                   device: torch.device) -> torch.Tensor:
    """Default position ids per rope flavour (explicit ids may override:
    qwen2-vl's M-RoPE ids come from the batch)."""
    pos = torch.arange(S, dtype=torch.int32, device=device)[None, :] + offset
    pos = pos.expand(B, S)
    if cfg.rope == "2d":
        return torch.stack([pos, pos])
    if cfg.rope == "mrope":
        return torch.stack([pos, pos, pos])
    return pos


def _abs_positions(positions: torch.Tensor) -> torch.Tensor:
    return positions if positions.ndim == 2 else positions[0]


def _batch_positions(cfg: ArchConfig, batch: dict) -> torch.Tensor:
    positions = batch.get("positions")
    if positions is None:
        B, S = batch["tokens"].shape
        positions = make_positions(cfg, B, S, device=batch["tokens"].device)
    return positions


# ---------------------------------------------------------------------------
# Forward (prefill and the teacher-forced reference)
# ---------------------------------------------------------------------------

def _ffn(cfg: ArchConfig, lp: PyTree, h: torch.Tensor,
         group_mode: str = "scan") -> tuple[torch.Tensor, Any]:
    """The layer's MLP, or its mixture of experts with the aux loss (None
    for an MLP)."""
    if cfg.moe is not None:
        return moe_lib.moe_apply(lp["moe"], cfg.moe, h, group_mode=group_mode)
    return layers.mlp(lp["mlp"], h, cfg.mlp_kind), None


def _layer_fwd(cfg: ArchConfig, acfg: layers.AttnConfig, lp: PyTree,
               x: torch.Tensor, positions: torch.Tensor):
    h = layers.norm_apply(cfg.norm, lp["attn_norm"], x)
    x = x + layers.attention(lp["attn"], acfg, h, positions)
    h = layers.norm_apply(cfg.norm, lp["mlp_norm"], x)
    # all groups at once: the reference's training mode
    out, aux = _ffn(cfg, lp, h, group_mode="vmap")
    return x + out, aux


def embed_inputs(params: PyTree, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Token embedding + modality-frontend merge (vision stub: precomputed
    patch embeddings overwrite the leading positions)."""
    x = layers.embed(params["embed"], batch["tokens"])
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        # out of place, as the reference's dynamic_update_slice: the
        # patches (B, P, d) replace the first P positions
        pe = batch["patch_embeds"].to(x.dtype)
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    # pin the residual stream to the canonical activation layout (batch
    # sharded, d replicated)
    return layers.maybe_shard(x, "batch", None, None)


def forward(params: PyTree, cfg: ArchConfig, batch: dict,
            remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits, aux_loss): the sum of the
    MoE layers' load-balancing losses, 0 for a dense model.  ``remat``
    recomputes each layer's activations in the backward."""
    x = embed_inputs(params, cfg, batch)
    positions = _batch_positions(cfg, batch)
    acfg = attn_config(cfg)
    body = layers.maybe_remat(
        lambda lp, x: _layer_fwd(cfg, acfg, lp, x, positions), remat)
    auxs = []
    for lp in layers.unstack(params["layers"]):
        x, aux = body(lp, x)
        auxs.append(aux)
    x = layers.norm_apply(cfg.norm, params["final_norm"], x)
    logits = unembed(params, cfg, x)
    if cfg.moe is None:
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, torch.sum(torch.stack(auxs))


def unembed(params: PyTree, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"]["embedding"].T.to(x.dtype)
    return layers.linear(params["lm_head"], x)


# ---------------------------------------------------------------------------
# KV cache serving
# ---------------------------------------------------------------------------

def cache_capacity(cfg: ArchConfig, max_len: int) -> int:
    """Rolling-buffer capacity: windowed archs cap the cache at the
    window."""
    return min(max_len, cfg.window) if cfg.window else max_len


def init_cache(cfg: ArchConfig, batch_size: int, max_len: int,
               device: DeviceLike = None) -> PyTree:
    """An empty cache on ``device``.  ``length`` (tokens seen so far) is a
    host int, so a decode step needs no read from the card to find its
    slot."""
    dev = resolve(device)
    C = cache_capacity(cfg, max_len)
    shape = (cfg.num_layers, batch_size, C, cfg.n_kv, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
        "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
        # absolute position stored in each slot (-1 = empty)
        "slot_pos": torch.full((batch_size, C), -1, dtype=torch.int32,
                               device=dev),
        "length": 0,
    }


def prefill(params: PyTree, cfg: ArchConfig, batch: dict,
            max_len: int) -> tuple[torch.Tensor, PyTree]:
    """Run the full prompt, build the cache, return last-token logits."""
    x = embed_inputs(params, cfg, batch)
    B, S = batch["tokens"].shape
    positions = _batch_positions(cfg, batch)
    acfg = attn_config(cfg)
    C = cache_capacity(cfg, max_len)
    abs_pos = _abs_positions(positions)
    dev = x.device

    # The cache keeps the last C tokens only: their absolute positions map
    # to C distinct rolling slots (consecutive ints mod C), so the scatter
    # has no duplicate indices.  When C >= S nothing wraps and slot i holds
    # token i (a pad); decode then writes at slot length % C == S.
    keep = min(C, S)
    shape = (cfg.num_layers, B, C, cfg.n_kv, cfg.resolved_head_dim)
    cache = layers.new_cache(cfg, {"k": (shape, x.dtype, 0),
                                   "v": (shape, x.dtype, 0),
                                   "slot_pos": ((B, C), torch.int32, -1)},
                             B, x)
    cache_k, cache_v, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    pos_last = abs_pos[:, S - keep:]
    if C >= S:
        layers.write(slot_pos, (slice(None), slice(0, S)), pos_last)
    else:
        slots = (pos_last % C).long()                       # (B, keep)
        bidx = torch.arange(B, device=dev)[:, None]
        layers.write(slot_pos, (bidx, slots), pos_last.to(torch.int32))

    for l in range(cfg.num_layers):
        lp = layers.layer_params(params["layers"], l)
        h = layers.norm_apply(cfg.norm, lp["attn_norm"], x)
        k, v = layers.project_kv(lp["attn"], acfg, h, positions)
        x = x + layers.attention(lp["attn"], acfg, h, positions,
                                 kv_override=(k, v), kv_positions=abs_pos)
        h2 = layers.norm_apply(cfg.norm, lp["mlp_norm"], x)
        x = x + _ffn(cfg, lp, h2)[0]
        # cache entries in their split-KV layout (seq on "model")
        k = layers.maybe_shard(k, "batch", "model", None, None)
        v = layers.maybe_shard(v, "batch", "model", None, None)
        if C >= S:
            layers.write(cache_k, (l, slice(None), slice(0, S)), k)
            layers.write(cache_v, (l, slice(None), slice(0, S)), v)
        else:
            layers.write(cache_k, (l, bidx, slots), k[:, S - keep:])
            layers.write(cache_v, (l, bidx, slots), v[:, S - keep:])

    x = layers.norm_apply(cfg.norm, params["final_norm"], x)
    logits = unembed(params, cfg, x[:, -1:, :])
    cache = {"k": cache_k, "v": cache_v, "slot_pos": slot_pos, "length": S}
    return logits, cache


def decode_step(params: PyTree, cfg: ArchConfig, token: torch.Tensor,
                cache: PyTree) -> tuple[torch.Tensor, PyTree]:
    """One-token decode against the cache.

    token: (B, 1) int.  Returns (logits (B,1,V), the cache advanced by one
    token).  The new token's k/v and slot position are written into the
    cache's tensors in place (the reference's ``dynamic_update_slice``,
    without a copy of the cache), so the cache passed in is the one
    returned.
    """
    B = token.shape[0]
    length = int(cache["length"])
    positions = make_positions(cfg, B, 1, offset=length, device=token.device)
    acfg = attn_config(cfg)
    x = layers.embed(params["embed"], token)
    C = cache["k"].shape[2]
    slot = length % C
    abs_pos = _abs_positions(positions)                     # (B, 1)
    slot_pos = cache["slot_pos"]
    layers.write(slot_pos, (slice(None), slot), abs_pos[:, 0])
    kv_valid = slot_pos >= 0                                # (B, C)
    kv_positions = slot_pos.clamp(min=0)

    for l in range(cfg.num_layers):
        lp = layers.layer_params(params["layers"], l)
        h = layers.norm_apply(cfg.norm, lp["attn_norm"], x)
        k, v = layers.project_kv(lp["attn"], acfg, h, positions)  # (B,1,kv,hd)
        layers.write(cache["k"], (l, slice(None), slot), k[:, 0])
        layers.write(cache["v"], (l, slice(None), slot), v[:, 0])
        ck, cv = cache["k"][l], cache["v"][l]
        x = x + layers.attention(lp["attn"], acfg, h, positions,
                                 kv_override=(ck, cv),
                                 kv_positions=kv_positions,
                                 kv_valid=kv_valid)
        h2 = layers.norm_apply(cfg.norm, lp["mlp_norm"], x)
        x = x + _ffn(cfg, lp, h2)[0]

    x = layers.norm_apply(cfg.norm, params["final_norm"], x)
    logits = unembed(params, cfg, x)
    cache["length"] = length + 1
    return logits, cache
