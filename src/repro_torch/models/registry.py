"""Architecture registry: architecture id -> ``ArchConfig``, and family ->
(init, forward, prefill, decode_step, init_cache), for every family of the
JAX package.  The reference's ``*_input_specs`` and ``concrete_batch``
belong to the dry-run contract (``launch/dryrun.py``) and come with it.
"""
from __future__ import annotations

import importlib
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
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
