"""Serving engine: batched prefill + decode steps with sharded KV/state
caches, greedy sampling, and the host-side bookkeeping of a fixed decode
batch.

``serve_shardings`` gives the layouts of params and caches on a mesh, and
``place_for_serving`` puts the params there; the steps of
``build_prefill_step`` and ``build_decode_step`` then run on that sharded
state (each rank on its blocks, against the params' mesh).  Prefill builds
the cache in ``cache_specs``' layout from the start, each rank allocating
its own block (``models.layers.new_cache``), and a decode step writes the
new token's k/v into each rank's own block, at the block's local slot
(``models.layers.write``): DTensor has no sharding rule for an in-place
write into a slice, and an out-of-place update would copy the whole cache
every token.  ``ServeLoop`` runs on the one device that holds its params.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import use_mesh
from repro_torch.models import registry

PyTree = Any


@contextlib.contextmanager
def _grad_off(mesh):
    """On a mesh, a serve step runs under ``no_grad``, even inside a
    caller's ``inference_mode``, under which a view of a DTensor fails;
    without one, as the caller runs it."""
    if mesh is None:
        yield
        return
    with torch.inference_mode(False), torch.no_grad():
        yield


def build_prefill_step(cfg: ArchConfig, max_len: int) -> Callable:
    """prefill_step(params, batch) -> (last-token logits, cache).  On
    sharded params the prompt runs on the params' mesh, and the cache it
    builds is in ``serve_shardings``' cache layout for a decode batch of
    the prompt's size and ``max_len``."""
    def prefill_step(params, batch):
        mesh = sharding.mesh_of(params)
        with _grad_off(mesh), use_mesh(mesh):
            return registry.prefill(params, cfg, batch, max_len)

    return prefill_step


def build_decode_step(cfg: ArchConfig) -> Callable:
    """serve_step: one new token for every sequence in the batch.  On
    sharded params and cache the step runs on their mesh and writes the
    cache in place, block by block; ``next_token`` comes back whole on
    every rank."""

    def decode_step(params, batch):
        mesh = sharding.mesh_of(params)
        with _grad_off(mesh), use_mesh(mesh):
            logits, cache = registry.decode_step(params, cfg, batch["token"],
                                                 batch["cache"])
            # greedy; ties take the first index, as jnp.argmax does.  On a
            # mesh every rank takes it from the gathered logits: 2D-TP
            # splits the vocab over two mesh dims, which DTensor's argmax
            # cannot reduce when the batch is whole (a batch of one)
            next_token = torch.argmax(sharding.whole(logits[:, -1]),
                                      dim=-1).to(torch.int32)
        return {"logits": logits, "next_token": next_token, "cache": cache}

    return decode_step


def serve_shardings(cfg: ArchConfig, shape: ShapeConfig, mesh,
                    mode: str = "decode"):
    """(params, decode-batch) ``NamedSharding`` trees for the serve step,
    and the params' and cache's meta stand-ins.

    decode: 2D-TP weights (no FSDP all-gathers; see
    ``sharding.serve_param_specs``).  prefill: training-style sharding
    incl. FSDP: a long prefill amortizes the per-layer weight gathers, and
    FSDP keeps the per-device resident weights smaller.  The decode batch
    is ``{"token": ..., "cache": ...}``, the cache on ``cache_specs``.
    """
    params_s = registry.init_params(torch.Generator(), cfg, device="meta")
    if mode == "decode":
        p_specs = sharding.serve_param_specs(cfg, params_s, mesh)
    else:
        p_specs = sharding.param_specs(cfg, params_s, mesh)
    cache_s = registry.init_cache(cfg, shape.global_batch, shape.seq_len,
                                  device="meta")
    c_specs = sharding.cache_specs(cfg, cache_s, mesh, shape.global_batch)
    tok_spec = sharding.batch_specs(
        cfg, {"token": torch.empty((shape.global_batch, 1),
                                   dtype=torch.int32, device="meta")},
        mesh)["token"]
    batch_specs = {"token": tok_spec, "cache": c_specs}
    return (sharding.to_named(p_specs, mesh),
            sharding.to_named(batch_specs, mesh), params_s, cache_s)


def place_for_serving(cfg: ArchConfig, params: PyTree, mesh,
                      shape: ShapeConfig, mode: str = "decode"):
    """``params`` (whole on every rank, or DTensors) placed for ``mode`` on
    ``mesh``: returns (params, the decode batch's ``NamedSharding``
    tree)."""
    p_sh, b_sh, _, _ = serve_shardings(cfg, shape, mesh, mode)
    return sharding.place_tree(params, p_sh), b_sh


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
