"""Zamba2-style hybrid: a Mamba2 backbone with a *shared* attention block
(one parameter set) applied every ``shared_attn_every`` blocks
(arXiv:2411.15242), the JAX package's ``repro.models.hybrid`` op for op.

The model is ``num_groups = L / every`` groups, each ``every`` Mamba2
blocks and then one application of the shared attention + MLP block to
the residual stream.  The mamba params carry two stacked leading dims,
(num_groups, every, ...).  The attention parameters are shared across
applications, but each application keeps its own KV cache (its inputs
differ).  This follows the reference's wiring, not Hugging Face's zamba2:
the shared block sees the residual stream ``x`` only.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import layers, ssm, transformer

PyTree = Any


def _groups(cfg: ArchConfig) -> tuple[int, int]:
    every = cfg.shared_attn_every
    if not every or cfg.num_layers % every:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not split "
                         f"into groups of shared_attn_every={every}")
    return cfg.num_layers // every, every


def _mamba_params(params: PyTree, g: int, e: int) -> PyTree:
    """Block ``e`` of group ``g``: both stacked dims indexed (views)."""
    return layers.layer_params(layers.layer_params(params["mamba"], g), e)


def _reshape_leading(tree: PyTree, lead: tuple[int, int]) -> PyTree:
    if isinstance(tree, dict):
        return {k: _reshape_leading(v, lead) for k, v in tree.items()}
    return tree.reshape(lead + tuple(tree.shape[1:]))


def init_params(generator: torch.Generator, cfg: ArchConfig,
                device: DeviceLike = None) -> PyTree:
    """Random params on ``device``, drawn from ``generator`` (which lives
    on that device)."""
    dev = resolve(device)
    dtype = ssm._dtype(cfg)
    ng, every = _groups(cfg)
    embed = layers.embed_init(generator, cfg.vocab_padded, cfg.d_model,
                              dtype, device=dev)
    flat = layers.init_stacked(
        lambda: ssm.init_block(generator, cfg, dtype, device=dev),
        cfg.num_layers)
    mamba = _reshape_leading(flat, (ng, every))
    shared = {
        "attn_norm": layers.norm_init(cfg.norm, cfg.d_model, dtype,
                                      device=dev),
        "attn": layers.attn_init(generator, transformer.attn_config(cfg),
                                 dtype, device=dev),
        "mlp_norm": layers.norm_init(cfg.norm, cfg.d_model, dtype,
                                     device=dev),
        "mlp": layers.mlp_init(generator, cfg.d_model, cfg.d_ff,
                               cfg.mlp_kind, dtype, device=dev),
    }
    return {
        "embed": embed,
        "mamba": mamba,
        "shared": shared,
        "final_norm": layers.rmsnorm_init(cfg.d_model, dtype, device=dev),
        "lm_head": layers.linear_init(generator, cfg.d_model,
                                      cfg.vocab_padded, dtype, device=dev),
    }


def _shared_attn(sp: PyTree, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """One application of the shared attention + MLP block (params
    ``sp``) to the residual stream."""
    acfg = transformer.attn_config(cfg)
    h = layers.norm_apply(cfg.norm, sp["attn_norm"], x)
    x = x + layers.attention(sp["attn"], acfg, h, positions)
    h = layers.norm_apply(cfg.norm, sp["mlp_norm"], x)
    return x + layers.mlp(sp["mlp"], h, cfg.mlp_kind)


def forward(params: PyTree, cfg: ArchConfig, batch: dict,
            remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits, aux_loss = 0).  ``remat``
    recomputes each group's activations (its Mamba2 blocks and the shared
    block's application) in the backward, as the reference checkpoints its
    group body."""
    x = layers.maybe_shard(layers.embed(params["embed"], batch["tokens"]),
                           "batch", None, None)
    B, S = batch["tokens"].shape
    positions = transformer.make_positions(cfg, B, S, device=x.device)

    def group(gp, shared, x):
        for lp in layers.unstack(gp):
            x = ssm.block_forward(lp, cfg, x)
        return _shared_attn(shared, cfg, x, positions)

    body = layers.maybe_remat(group, remat)
    for gp in layers.unstack(params["mamba"]):
        x = body(gp, params["shared"], x)
    x = layers.rmsnorm(params["final_norm"], x)
    return (layers.linear(params["lm_head"], x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def init_cache(cfg: ArchConfig, batch_size: int, max_len: int,
               device: DeviceLike = None) -> PyTree:
    """An empty cache on ``device``: the mamba states (num_groups, every,
    ...), one KV cache per shared-attention application (num_groups, B,
    C, n_kv, hd), the slots' absolute positions (-1 = empty) and
    ``length`` as a host int."""
    dev = resolve(device)
    return {**{k: torch.full(shape, fill, dtype=dt, device=dev)
               for k, (shape, dt, fill) in _cache_leaves(
                   cfg, batch_size, max_len).items()},
            "length": 0}


def _cache_leaves(cfg: ArchConfig, batch_size: int, max_len: int) -> dict:
    """Each cache leaf's (shape, dtype, initial value)."""
    ng, every = _groups(cfg)
    d = ssm.dims(cfg)
    dtype = ssm._dtype(cfg)
    C = transformer.cache_capacity(cfg, max_len)
    hd = cfg.resolved_head_dim
    return {
        "h": ((ng, every, batch_size, d["n_heads"], d["N"], d["P"]),
              torch.float32, 0),
        "conv": ((ng, every, batch_size, d["W"] - 1, d["conv_ch"]), dtype, 0),
        "k": ((ng, batch_size, C, cfg.n_kv, hd), dtype, 0),
        "v": ((ng, batch_size, C, cfg.n_kv, hd), dtype, 0),
        "slot_pos": ((batch_size, C), torch.int32, -1),
    }


def prefill(params: PyTree, cfg: ArchConfig, batch: dict,
            max_len: int) -> tuple[torch.Tensor, PyTree]:
    """Run the prompt, build the states and the KV caches, return
    last-token logits.  As in ``transformer.prefill``, the KV caches keep
    the last C tokens: a pad when C >= S, else a scatter into rolling
    slots."""
    x = layers.maybe_shard(layers.embed(params["embed"], batch["tokens"]),
                           "batch", None, None)
    B, S = batch["tokens"].shape
    dev = x.device
    positions = transformer.make_positions(cfg, B, S, device=dev)
    abs_pos = positions if positions.ndim == 2 else positions[0]
    acfg = transformer.attn_config(cfg)
    C = transformer.cache_capacity(cfg, max_len)
    keep = min(C, S)
    pad_path = C >= S            # no wrap: the cache layout is a plain pad
    sp = params["shared"]
    ng, every = _groups(cfg)
    cache = {**layers.new_cache(cfg, _cache_leaves(cfg, B, max_len), B, x),
             "length": 0}
    pos_last = abs_pos[:, S - keep:]
    if pad_path:
        layers.write(cache["slot_pos"], (slice(None), slice(0, keep)),
                     pos_last)
    else:
        slots = (pos_last % C).long()                       # (B, keep)
        bidx = torch.arange(B, device=dev)[:, None]
        layers.write(cache["slot_pos"], (bidx, slots),
                     pos_last.to(torch.int32))

    for g in range(ng):
        for e in range(every):
            x, (h, conv) = ssm.block_forward(_mamba_params(params, g, e), cfg,
                                             x, return_state=True)
            layers.write(cache["h"], (g, e), h)
            layers.write(cache["conv"], (g, e), conv)
        h = layers.norm_apply(cfg.norm, sp["attn_norm"], x)
        k, v = layers.project_kv(sp["attn"], acfg, h, positions)
        x = x + layers.attention(sp["attn"], acfg, h, positions,
                                 kv_override=(k, v), kv_positions=abs_pos)
        h2 = layers.norm_apply(cfg.norm, sp["mlp_norm"], x)
        x = x + layers.mlp(sp["mlp"], h2, cfg.mlp_kind)
        if pad_path:
            layers.write(cache["k"], (g, slice(None), slice(0, keep)),
                         k[:, S - keep:])
            layers.write(cache["v"], (g, slice(None), slice(0, keep)),
                         v[:, S - keep:])
        else:
            layers.write(cache["k"], (g, bidx, slots), k[:, S - keep:])
            layers.write(cache["v"], (g, bidx, slots), v[:, S - keep:])

    x = layers.rmsnorm(params["final_norm"], x)
    logits = layers.linear(params["lm_head"], x[:, -1:, :])
    cache["length"] = S
    return logits, cache


def decode_step(params: PyTree, cfg: ArchConfig, token: torch.Tensor,
                cache: PyTree) -> tuple[torch.Tensor, PyTree]:
    """One-token decode.  The new states, k/v and slot position are
    written into the cache's tensors in place, so the cache passed in is
    the one returned."""
    B = token.shape[0]
    length = int(cache["length"])
    positions = transformer.make_positions(cfg, B, 1, offset=length,
                                           device=token.device)
    abs_pos = positions if positions.ndim == 2 else positions[0]
    acfg = transformer.attn_config(cfg)
    x = layers.maybe_shard(layers.embed(params["embed"], token),
                           "batch", None, None)
    C = cache["k"].shape[2]
    slot = length % C
    # one slot position for every application, written before the groups
    slot_pos = cache["slot_pos"]
    layers.write(slot_pos, (slice(None), slot), abs_pos[:, 0])
    kv_valid = slot_pos >= 0
    kv_positions = slot_pos.clamp(min=0)
    sp = params["shared"]
    ng, every = _groups(cfg)

    for g in range(ng):
        for e in range(every):
            x, (h, conv) = ssm.block_decode(
                _mamba_params(params, g, e), cfg, x, cache["h"][g, e],
                cache["conv"][g, e])
            layers.write(cache["h"], (g, e), h)
            layers.write(cache["conv"], (g, e), conv)
        h = layers.norm_apply(cfg.norm, sp["attn_norm"], x)
        k, v = layers.project_kv(sp["attn"], acfg, h, positions)
        layers.write(cache["k"], (g, slice(None), slot), k[:, 0])
        layers.write(cache["v"], (g, slice(None), slot), v[:, 0])
        ck, cv = cache["k"][g], cache["v"][g]
        x = x + layers.attention(sp["attn"], acfg, h, positions,
                                 kv_override=(ck, cv),
                                 kv_positions=kv_positions,
                                 kv_valid=kv_valid)
        h2 = layers.norm_apply(cfg.norm, sp["mlp_norm"], x)
        x = x + layers.mlp(sp["mlp"], h2, cfg.mlp_kind)

    x = layers.rmsnorm(params["final_norm"], x)
    logits = layers.linear(params["lm_head"], x)
    cache["length"] = length + 1
    return logits, cache
