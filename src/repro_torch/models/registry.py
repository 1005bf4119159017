"""Architecture registry: architecture id -> ``ArchConfig``, and family ->
(init, forward, prefill, decode_step, init_cache), for every family of the
JAX package, plus batch ``input_specs`` for every shape: meta-device
tensors in place of the reference's ``ShapeDtypeStruct``s (shapes and
dtypes, no allocation), which the sharding rules read."""
from __future__ import annotations

import importlib
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import DeviceLike
from repro_torch.models import encdec, hybrid, ssm, transformer

PyTree = Any

_FAMILY = {
    "transformer": transformer,
    "moe": transformer,           # MoE rides the transformer stack
    "ssm": ssm,
    "hybrid": hybrid,
    "encdec": encdec,
}

ARCH_IDS = [
    "llama3_2_3b", "granite_3_2b", "tinyllama_1_1b", "chatglm3_6b",
    "mixtral_8x7b", "arctic_480b", "qwen2_vl_72b", "seamless_m4t_large_v2",
    "mamba2_780m", "zamba2_2_7b",
]


def load_arch(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def family_module(cfg: ArchConfig):
    return _FAMILY[cfg.family]


def init_params(generator: torch.Generator, cfg: ArchConfig,
                device: DeviceLike = None) -> PyTree:
    return family_module(cfg).init_params(generator, cfg, device=device)


def forward(params, cfg: ArchConfig, batch, remat: bool = False):
    return family_module(cfg).forward(params, cfg, batch, remat=remat)


def prefill(params, cfg: ArchConfig, batch, max_len: int):
    return family_module(cfg).prefill(params, cfg, batch, max_len)


def decode_step(params, cfg: ArchConfig, token, cache):
    return family_module(cfg).decode_step(params, cfg, token, cache)


def init_cache(cfg: ArchConfig, batch_size: int, max_len: int,
               device: DeviceLike = None) -> PyTree:
    return family_module(cfg).init_cache(cfg, batch_size, max_len,
                                         device=device)


# ---------------------------------------------------------------------------
# input_specs: meta-device stand-ins per (arch x shape)
# ---------------------------------------------------------------------------

def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    batch = {
        "tokens": _sds((B, S), torch.int32),
        "labels": _sds((B, S), torch.int32),
    }
    if cfg.family == "encdec":
        batch["frames"] = _sds((B, S, cfg.d_model), torch.bfloat16)
    if cfg.frontend == "vision":
        n_patch = min(1024, S // 2)
        batch["patch_embeds"] = _sds((B, n_patch, cfg.d_model),
                                     torch.bfloat16)
        batch["positions"] = _sds((3, B, S), torch.int32)
    return batch


def prefill_input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    batch = train_input_specs(cfg, shape)
    batch.pop("labels")
    return batch


def decode_input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """One new token against a KV/state cache of ``seq_len``."""
    B, S = shape.global_batch, shape.seq_len
    return {"token": _sds((B, 1), torch.int32),
            "cache": init_cache(cfg, B, S, device="meta")}


def concrete_batch(specs: dict, seed: int = 0,
                   device: DeviceLike = "cpu") -> dict:
    """Materialize a spec dict with deterministic host data (smoke tests),
    drawn from ``np.random.default_rng(seed)`` in the reference's order:
    integer entries from ``integers(0, 64)``, float entries from
    ``standard_normal`` in float32 then cast; a nested dict (a cache) is
    zeros and draws nothing."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in specs.items():
        if isinstance(s, dict) or not isinstance(s, torch.Tensor):
            out[name] = {k: (torch.zeros(v.shape, dtype=v.dtype,
                                         device=device)
                             if isinstance(v, torch.Tensor) else v)
                         for k, v in s.items()}
        elif not s.dtype.is_floating_point:
            out[name] = torch.from_numpy(
                rng.integers(0, 64, size=tuple(s.shape))).to(
                    device=device, dtype=s.dtype)
        else:
            out[name] = torch.from_numpy(
                rng.standard_normal(tuple(s.shape)).astype(np.float32)).to(
                    device=device, dtype=s.dtype)
    return out
