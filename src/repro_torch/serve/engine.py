"""Serving engine: batched prefill + decode steps with a KV cache, greedy
sampling, and the host-side bookkeeping of a fixed decode batch.

The JAX package's ``serve_shardings`` places params and caches on a mesh;
it comes with ``distributed/sharding.py`` (ROADMAP §1).  Here a loop runs
on the one device that holds its params.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import registry

PyTree = Any


def build_prefill_step(cfg: ArchConfig, max_len: int) -> Callable:
    def prefill_step(params, batch):
        return registry.prefill(params, cfg, batch, max_len)

    return prefill_step


def build_decode_step(cfg: ArchConfig) -> Callable:
    """serve_step: one new token for every sequence in the batch."""

    def decode_step(params, batch):
        logits, cache = registry.decode_step(params, cfg, batch["token"],
                                             batch["cache"])
        # greedy; ties take the first index, as jnp.argmax does
        next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return {"logits": logits, "next_token": next_token, "cache": cache}

    return decode_step


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


def params_device(params: PyTree) -> torch.device:
    """The device of a param tree's first leaf."""
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


class ServeLoop:
    """Minimal batched serving loop (single host): left-pads requests with
    token 0 into a fixed decode batch, runs prefill once and decode steps
    until done, on the device of ``params`` under ``torch.inference_mode``.
    Padded positions attend (no pad mask), as in the JAX package."""

    def __init__(self, cfg: ArchConfig, params, batch_size: int,
                 max_len: int):
        self.cfg, self.params = cfg, params
        self.batch_size, self.max_len = batch_size, max_len
        self.device = params_device(params)
        self._prefill = build_prefill_step(cfg, max_len)
        self._decode = build_decode_step(cfg)

    def run(self, requests: list[Request]) -> list[Request]:
        if not 0 < len(requests) <= self.batch_size:
            raise ValueError(f"{len(requests)} requests for a decode batch "
                             f"of {self.batch_size}")
        prompts = [r.prompt for r in requests]
        plen = max(len(p) for p in prompts)
        toks = np.zeros((self.batch_size, plen), np.int32)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p                     # left-pad
        with torch.inference_mode():
            tokens = torch.from_numpy(toks).to(self.device)
            logits, cache = self._prefill(self.params, {"tokens": tokens})
            token = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
            steps = max(r.max_new_tokens for r in requests)
            for _ in range(steps):
                host = token[:, 0].tolist()                 # one read a step
                for i, r in enumerate(requests):
                    if not r.done:
                        r.generated.append(int(host[i]))
                        r.done = len(r.generated) >= r.max_new_tokens
                if all(r.done for r in requests):
                    break
                out = self._decode(self.params,
                                   {"token": token, "cache": cache})
                token, cache = out["next_token"][:, None], out["cache"]
        return requests
