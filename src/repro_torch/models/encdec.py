"""Encoder-decoder backbone (seamless-m4t-large-v2, arXiv:2308.11596), the
JAX package's ``repro.models.encdec`` op for op.

The modality frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings ``frames`` (B, S_enc, d), and no speech
feature extractor runs.  The backbone is a bidirectional encoder over the
frames and a causal decoder with self- and cross-attention.  Prefill
projects each decoder layer's cross K/V once; ``decode_step`` attends to
them and writes the self-attention cache in place.

Every entry point reads ``batch["frames"]``.  The serving loop passes
tokens only, as the reference's does, so it cannot serve this family;
drive it through ``serve.engine.build_prefill_step``/``build_decode_step``,
which pass the whole batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import layers, transformer

PyTree = Any


def _acfg(cfg: ArchConfig, causal: bool) -> layers.AttnConfig:
    return dataclasses.replace(transformer.attn_config(cfg), causal=causal)


def _arange_positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def init_params(generator: torch.Generator, cfg: ArchConfig,
                device: DeviceLike = None) -> PyTree:
    """Random params in ``cfg.dtype`` on ``device``, drawn from
    ``generator`` (which lives on that device)."""
    dev = resolve(device)
    dtype = transformer._dtype(cfg)
    acfg = transformer.attn_config(cfg)

    def norm():
        return layers.norm_init(cfg.norm, cfg.d_model, dtype, device=dev)

    def attn():
        return layers.attn_init(generator, acfg, dtype, device=dev)

    def mlp():
        return layers.mlp_init(generator, cfg.d_model, cfg.d_ff,
                               cfg.mlp_kind, dtype, device=dev)

    def enc_layer():
        return {"attn_norm": norm(), "attn": attn(), "mlp_norm": norm(),
                "mlp": mlp()}

    def dec_layer():
        return {"self_norm": norm(), "self_attn": attn(),
                "cross_norm": norm(), "cross_attn": attn(),
                "mlp_norm": norm(), "mlp": mlp()}

    return {
        "embed": layers.embed_init(generator, cfg.vocab_padded, cfg.d_model,
                                   dtype, device=dev),
        "encoder": layers.init_stacked(enc_layer, cfg.encoder_layers),
        "decoder": layers.init_stacked(dec_layer, cfg.num_layers),
        "enc_norm": norm(),
        "final_norm": norm(),
        "lm_head": layers.linear_init(generator, cfg.d_model,
                                      cfg.vocab_padded, dtype, device=dev),
    }


def encode(params: PyTree, cfg: ArchConfig, frames: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """frames: (B, S_enc, d) precomputed frame embeddings (the frontend
    stub) -> the encoder's memory (B, S_enc, d).  ``remat`` recomputes
    each layer's activations in the backward."""
    acfg = _acfg(cfg, causal=False)
    B, S, _ = frames.shape
    positions = _arange_positions(B, S, frames.device)

    def layer(lp, x):
        h = layers.norm_apply(cfg.norm, lp["attn_norm"], x)
        x = x + layers.attention(lp["attn"], acfg, h, positions)
        h = layers.norm_apply(cfg.norm, lp["mlp_norm"], x)
        return x + layers.mlp(lp["mlp"], h, cfg.mlp_kind)

    body = layers.maybe_remat(layer, remat)
    x = frames
    for lp in layers.unstack(params["encoder"]):
        x = body(lp, x)
    return layers.norm_apply(cfg.norm, params["enc_norm"], x)


def _cross_kv_args(B: int, S_enc: int, device) -> dict:
    """Precomputed cross K/V: every source position valid and at 0, so the
    causal mask never hides one."""
    return dict(kv_positions=torch.zeros((B, S_enc), dtype=torch.int32,
                                         device=device),
                kv_valid=torch.ones((B, S_enc), dtype=torch.bool,
                                    device=device))


def _decoder_layer(cfg: ArchConfig, lp: PyTree, x, positions, memory):
    acfg = transformer.attn_config(cfg)
    h = layers.norm_apply(cfg.norm, lp["self_norm"], x)
    x = x + layers.attention(lp["self_attn"], acfg, h, positions)
    h = layers.norm_apply(cfg.norm, lp["cross_norm"], x)
    x = x + layers.attention(lp["cross_attn"], acfg, h, positions,
                             cross_kv=memory)
    h = layers.norm_apply(cfg.norm, lp["mlp_norm"], x)
    return x + layers.mlp(lp["mlp"], h, cfg.mlp_kind)


def forward(params: PyTree, cfg: ArchConfig, batch: dict,
            remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward over ``frames`` and ``tokens``.  Returns
    (logits, aux_loss = 0).  ``remat`` recomputes each encoder and decoder
    layer's activations in the backward."""
    memory = encode(params, cfg, batch["frames"], remat=remat)
    x = layers.maybe_shard(layers.embed(params["embed"], batch["tokens"]),
                           "batch", None, None)
    B, S = batch["tokens"].shape
    positions = _arange_positions(B, S, x.device)
    body = layers.maybe_remat(
        lambda lp, x, memory: _decoder_layer(cfg, lp, x, positions, memory),
        remat)
    for lp in layers.unstack(params["decoder"]):
        x = body(lp, x, memory)
    x = layers.norm_apply(cfg.norm, params["final_norm"], x)
    return (layers.linear(params["lm_head"], x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def init_cache(cfg: ArchConfig, batch_size: int, max_len: int,
               enc_len: int = 0, device: DeviceLike = None) -> PyTree:
    """An empty cache on ``device``: the decoder's self K/V of ``max_len``
    slots, the cross K/V of ``enc_len`` source positions (``max_len`` if
    0), and ``length`` as a host int."""
    dev = resolve(device)
    return {**{k: torch.zeros(shape, dtype=dt, device=dev)
               for k, (shape, dt, _) in _cache_leaves(
                   cfg, batch_size, max_len, enc_len).items()},
            "length": 0}


def _cache_leaves(cfg: ArchConfig, batch_size: int, max_len: int,
                  enc_len: int) -> dict:
    """Each cache tensor's (shape, dtype, initial value)."""
    dtype = transformer._dtype(cfg)
    shape = (cfg.num_layers, batch_size, 0, cfg.n_kv, cfg.resolved_head_dim)

    def kv(n):
        return (shape[:2] + (n,) + shape[3:], dtype, 0)

    enc_len = enc_len or max_len
    return {"k": kv(max_len), "v": kv(max_len),
            "cross_k": kv(enc_len), "cross_v": kv(enc_len)}


def prefill(params: PyTree, cfg: ArchConfig, batch: dict,
            max_len: int) -> tuple[torch.Tensor, PyTree]:
    """Encode the source frames, project each layer's cross K/V once, and
    prime the decoder's self cache with the prompt tokens."""
    memory = encode(params, cfg, batch["frames"])
    B, S = batch["tokens"].shape
    S_enc = memory.shape[1]
    acfg = transformer.attn_config(cfg)
    x = layers.maybe_shard(layers.embed(params["embed"], batch["tokens"]),
                           "batch", None, None)
    dev = x.device
    positions = _arange_positions(B, S, dev)
    cross = _cross_kv_args(B, S_enc, dev)
    hd = cfg.resolved_head_dim
    cache = {**layers.new_cache(cfg, _cache_leaves(cfg, B, max_len, S_enc),
                                B, x),
             "length": 0}
    for l in range(cfg.num_layers):
        lp = layers.layer_params(params["decoder"], l)
        h = layers.norm_apply(cfg.norm, lp["self_norm"], x)
        k, v = layers.project_kv(lp["self_attn"], acfg, h, positions)
        x = x + layers.attention(lp["self_attn"], acfg, h, positions,
                                 kv_override=(k, v), kv_positions=positions)
        ck = layers.linear(lp["cross_attn"]["wk"], memory).reshape(
            B, -1, cfg.n_kv, hd)
        cv = layers.linear(lp["cross_attn"]["wv"], memory).reshape(
            B, -1, cfg.n_kv, hd)
        h = layers.norm_apply(cfg.norm, lp["cross_norm"], x)
        x = x + layers.attention(lp["cross_attn"], acfg, h, positions,
                                 kv_override=(ck, cv), **cross)
        h = layers.norm_apply(cfg.norm, lp["mlp_norm"], x)
        x = x + layers.mlp(lp["mlp"], h, cfg.mlp_kind)
        layers.write(cache["k"], (l, slice(None), slice(0, S)), k)
        layers.write(cache["v"], (l, slice(None), slice(0, S)), v)
        layers.write(cache["cross_k"], l, ck)
        layers.write(cache["cross_v"], l, cv)
    x = layers.norm_apply(cfg.norm, params["final_norm"], x)
    logits = layers.linear(params["lm_head"], x[:, -1:, :])
    cache["length"] = S
    return logits, cache


def decode_step(params: PyTree, cfg: ArchConfig, token: torch.Tensor,
                cache: PyTree) -> tuple[torch.Tensor, PyTree]:
    """One-token decode against the self and cross caches.  The new k/v
    are written into the cache's tensors in place, so the cache passed in
    is the one returned."""
    B = token.shape[0]
    length = int(cache["length"])
    dev = token.device
    positions = torch.full((B, 1), length, dtype=torch.int32, device=dev)
    acfg = transformer.attn_config(cfg)
    x = layers.maybe_shard(layers.embed(params["embed"], token),
                           "batch", None, None)
    C = cache["k"].shape[2]
    kv_positions = _arange_positions(B, C, dev)
    kv_valid = kv_positions <= length
    # the reference's dynamic_update_slice clamps its start into the
    # cache: past max_len it overwrites the last slot
    slot = min(length, C - 1)
    cross = _cross_kv_args(B, cache["cross_k"].shape[2], dev)
    for l in range(cfg.num_layers):
        lp = layers.layer_params(params["decoder"], l)
        h = layers.norm_apply(cfg.norm, lp["self_norm"], x)
        k, v = layers.project_kv(lp["self_attn"], acfg, h, positions)
        layers.write(cache["k"], (l, slice(None), slot), k[:, 0])
        layers.write(cache["v"], (l, slice(None), slot), v[:, 0])
        ck, cv = cache["k"][l], cache["v"][l]
        x = x + layers.attention(lp["self_attn"], acfg, h, positions,
                                 kv_override=(ck, cv),
                                 kv_positions=kv_positions, kv_valid=kv_valid)
        h = layers.norm_apply(cfg.norm, lp["cross_norm"], x)
        x = x + layers.attention(
            lp["cross_attn"], acfg, h, positions,
            kv_override=(cache["cross_k"][l], cache["cross_v"][l]), **cross)
        h = layers.norm_apply(cfg.norm, lp["mlp_norm"], x)
        x = x + layers.mlp(lp["mlp"], h, cfg.mlp_kind)
    x = layers.norm_apply(cfg.norm, params["final_norm"], x)
    logits = layers.linear(params["lm_head"], x)
    cache["length"] = length + 1
    return logits, cache
