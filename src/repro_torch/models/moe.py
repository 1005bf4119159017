"""Mixture-of-Experts FFN (GShard-style top-k token choice with capacity),
the JAX package's ``repro.models.moe`` op for op.

Used by mixtral-8x7b (8 experts, top-2) and arctic-480b (128 experts, top-2,
plus a dense residual MLP).  Tokens are routed in groups of ``group_size``.
The routing and dispatch functions take any leading dims before the token
axis (the second-to-last of ``probs``, ``xg``): the reference's ``vmap``
over groups is one call on (groups, tokens, ...) here, and its ``scan``
a loop of calls on one group each.

Routing runs in ``probs.dtype`` as in the reference, bf16 in a bf16 model:
the ``argmax`` takes the first maximum (``torch.argmax``'s contract, as
``jnp.argmax``'s), the ``-inf`` masking is in that dtype, and the queue
positions are a cumsum in that dtype (``_cumsum``).  Above 256 tokens of a
group in one expert's queue, bf16 positions round onto their neighbours,
in the reference as here (ROADMAP §3: a reference behaviour kept).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.distributed import sharding
from repro_torch.models import layers

PyTree = Any


def moe_init(generator: torch.Generator, d_model: int, d_ff: int,
             cfg: MoEConfig, dtype=torch.float32, *,
             device: torch.device) -> PyTree:
    E = cfg.num_experts

    def experts(d_in, d_out):
        # scaled in place: an expert stack is the model's largest leaf
        w = torch.randn((E, d_in, d_out), generator=generator, dtype=dtype,
                        device=device)
        return w.mul_(1.0 / math.sqrt(d_in))

    p = {
        "router": layers.linear_init(generator, d_model, E, dtype,
                                     device=device),
        "w_gate": experts(d_model, d_ff),
        "w_up": experts(d_model, d_ff),
        "w_down": experts(d_ff, d_model),
    }
    if cfg.dense_residual:
        p["dense"] = layers.mlp_init(generator, d_model,
                                     cfg.dense_d_ff or d_ff, "swiglu", dtype,
                                     device=device)
    return p


#: The block of XLA's CPU rewrite of a cumulative sum (see ``_cumsum``).
SCAN_BLOCK = 16


def _scan_last(v: torch.Tensor, dtype) -> torch.Tensor:
    """Inclusive prefix sums of fp32 ``v`` along its last dim, each sum
    rounded to ``dtype``: in order within blocks of SCAN_BLOCK, then the
    blocks' totals scanned the same way and added to each block."""
    n = v.shape[-1]
    if n <= SCAN_BLOCK:
        acc = torch.zeros(v.shape[:-1], dtype=torch.float32, device=v.device)
        out = []
        for i in range(n):
            acc = (acc + v[..., i]).to(dtype).float()
            out.append(acc)
        return torch.stack(out, dim=-1)
    nb = -(-n // SCAN_BLOCK)
    blocks = F.pad(v, (0, nb * SCAN_BLOCK - n)).reshape(
        v.shape[:-1] + (nb, SCAN_BLOCK))
    within = _scan_last(blocks, dtype)
    before = F.pad(_scan_last(within[..., -1], dtype)[..., :-1], (1, 0))
    out = (within + before[..., None]).to(dtype).float()
    return out.reshape(v.shape[:-1] + (nb * SCAN_BLOCK,))[..., :n]


def _cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The reference's ``jnp.cumsum`` in ``x.dtype``, sum for sum as XLA
    computes it on the CPU (its reduce-window rewrite: blocks of 16, every
    partial sum rounded to the dtype).  ``torch.cumsum`` rounds otherwise
    in bf16, so queue positions above 256 would differ from the
    reference's; in fp32 every count is exact either way."""
    v = x.float().movedim(dim, -1)
    return _scan_last(v, x.dtype).movedim(-1, dim).to(x.dtype)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros
    (``F.one_hot`` would raise)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _mask_chosen(masked: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    return masked.masked_fill(onehot > 0, float("-inf"))


def _topk_dispatch(router_probs: torch.Tensor, top_k: int, capacity: int):
    """Token-choice top-k with per-expert capacity.

    router_probs: (..., S, E).  Returns dispatch (..., S, E, C) in {0, 1}
    as its dtype, combine (..., S, E, C) weights, and the load-balancing
    aux loss (...,).
    """
    S, E = router_probs.shape[-2:]
    probs = router_probs
    dispatch_parts, combine_parts = [], []
    # running per-expert fill for capacity bookkeeping across the k passes
    fill_base = torch.zeros(probs.shape[:-2] + (E,), dtype=torch.int32,
                            device=probs.device)
    masked = probs
    for _ in range(top_k):
        idx = torch.argmax(masked, dim=-1)                    # (..., S)
        onehot = _one_hot(idx, E, probs.dtype)                # (..., S, E)
        gate = torch.sum(probs * onehot, dim=-1)              # (..., S)
        # position of each token within its chosen expert's queue
        pos = _cumsum(onehot, -2) - onehot + fill_base[..., None, :]
        pos_tok = torch.sum(pos * onehot, dim=-1).to(torch.int32)
        keep = pos_tok < capacity
        slot = _one_hot(pos_tok, capacity, probs.dtype)       # (..., S, C)
        disp = (onehot[..., :, None] * slot[..., None, :]
                * keep[..., None, None])
        dispatch_parts.append(disp)
        combine_parts.append(disp * gate[..., None, None])
        fill_base = fill_base + torch.sum(onehot, dim=-2).to(torch.int32)
        masked = _mask_chosen(masked, onehot)
    dispatch = sum(dispatch_parts)
    combine = sum(combine_parts)
    # Switch-style load-balance loss over the top-1 assignment
    density = torch.mean(dispatch_parts[0].sum(-1), dim=-2)   # (..., E)
    density_proxy = torch.mean(probs, dim=-2)
    aux = torch.sum(density * density_proxy, dim=-1) * (E ** 2) / max(S, 1)
    return dispatch, combine, aux


def _topk_routing(probs: torch.Tensor, top_k: int, capacity: int):
    """Shared routing bookkeeping: expert choice, gate and slot position
    per (token, k) assignment, O(S*E) with no (S, E, C) tensor.

    probs: (..., S, E).  Returns expert_idx (..., S, k), gates (..., S, k),
    pos_in_expert (..., S, k), keep (..., S, k) and the aux loss (...,).
    """
    S, E = probs.shape[-2:]
    masked = probs
    experts, gates, positions = [], [], []
    fill = torch.zeros(probs.shape[:-2] + (E,), dtype=torch.int32,
                       device=probs.device)
    top1_onehot = None
    for _ in range(top_k):
        idx = torch.argmax(masked, dim=-1)                    # (..., S)
        onehot = _one_hot(idx, E, probs.dtype)
        if top1_onehot is None:
            top1_onehot = onehot
        gate = torch.sum(probs * onehot, dim=-1)
        pos = _cumsum(onehot, -2) - onehot + fill[..., None, :]
        pos_tok = torch.sum(pos * onehot, dim=-1).to(torch.int32)
        experts.append(idx)
        gates.append(gate)
        positions.append(pos_tok)
        fill = fill + torch.sum(onehot, dim=-2).to(torch.int32)
        masked = _mask_chosen(masked, onehot)
    expert_idx = torch.stack(experts, -1)
    gates_k = torch.stack(gates, -1)
    pos_k = torch.stack(positions, -1)
    keep = pos_k < capacity
    density = torch.mean(top1_onehot, dim=-2)
    density_proxy = torch.mean(probs, dim=-2)
    aux = torch.sum(density * density_proxy, dim=-1) * E
    return expert_idx, gates_k, pos_k, keep, aux


def _expert_ffn(p: PyTree, xin: torch.Tensor) -> torch.Tensor:
    """(..., E, C, d) slots through each expert's SwiGLU -> (..., E, C, d)."""
    h = F.silu(xin @ p["w_gate"]) * (xin @ p["w_up"])
    return h @ p["w_down"]


def _experts(p: PyTree, cfg: MoEConfig, xin: torch.Tensor) -> torch.Tensor:
    """``_expert_ffn`` in ``sharding.param_spec``'s layout of the expert
    weights on the ambient mesh: each rank runs its own experts when
    "model" divides their count (expert parallel), else its slice of every
    expert's ff dim, and those partial products are summed over "model";
    a leading group dim of ``xin`` splits over the batch axes.  Without a
    mesh this is ``_expert_ffn``."""
    from repro_torch.launch.mesh import axis_sizes, current_mesh
    mesh = current_mesh()
    lead = ("batch",) + (None,) * (xin.ndim - 4) if xin.ndim > 3 else ()
    sizes = axis_sizes(mesh) if mesh is not None else None
    if sizes is not None and "model" in sizes.axis_names and (
            cfg.num_experts % sizes.shape["model"] == 0):
        x_spec = lead + ("model", None, None)
        w_specs, partial = (("model", None, None),) * 3, None
    else:
        x_spec = lead + (None, None, None)
        w_specs = ((None, None, "model"), (None, None, "model"),
                   (None, "model", None))
        partial = "model"

    def ffn(x, w_gate, w_up, w_down):
        return _expert_ffn({"w_gate": w_gate, "w_up": w_up,
                            "w_down": w_down}, x)

    return layers.on_blocks(ffn, (xin, p["w_gate"], p["w_up"], p["w_down"]),
                            (x_spec,) + w_specs, x_spec, tuple(xin.shape),
                            partial=partial)


def _router_probs(p: PyTree, xg: torch.Tensor) -> torch.Tensor:
    logits = layers.linear(p["router"], xg).float()
    return torch.softmax(logits, dim=-1).to(xg.dtype)


def _einsum_dispatch(probs: torch.Tensor, xg: torch.Tensor, top_k: int,
                     capacity: int):
    """(slots (..., E, C, d), combine weights, aux) of one-hot dispatch."""
    dispatch, combine, aux = _topk_dispatch(probs, top_k, capacity)
    xin = torch.einsum("...sd,...sec->...ecd", xg, dispatch)
    return xin, combine, aux


def _einsum_combine(y: torch.Tensor, combine: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ecd,...sec->...sd", y, combine)


def _group_einsum(p: PyTree, cfg: MoEConfig, xg: torch.Tensor,
                  capacity: int):
    """GShard-faithful one-hot dispatch (the baseline; see
    ``MoEConfig.dispatch``).  xg: (..., S, d).  On a mesh the router and
    the experts run on their placements, the dispatch and combine on
    whole tensors (``layers.replicated``)."""
    probs = _router_probs(p, xg)
    xin, combine, aux = layers.replicated(_einsum_dispatch, probs, xg,
                                          cfg.top_k, capacity)
    y = _experts(p, cfg, xin)                                 # (..., E, C, d)
    return layers.replicated(_einsum_combine, y, combine), aux


def _gather_dispatch(probs: torch.Tensor, xg3: torch.Tensor, top_k: int,
                     capacity: int):
    """Routing, then tokens into expert slots by a scatter of row indices
    and one gather.  probs: (G, S, E); xg3: (G, S, d).  Returns the slots
    (G, E, C, d), each assignment's slot (G, S, k) and gate, and aux."""
    G, S, E = probs.shape
    d, C, k = xg3.shape[-1], capacity, top_k
    expert_idx, gates, pos, keep, aux = _topk_routing(probs, k, C)
    # slot id per assignment; dropped tokens land in a trash slot E*C
    slot = torch.where(keep, expert_idx * C + pos,
                       torch.full_like(pos, E * C)).long()    # (G, S, k)
    # the token row feeding each slot; row S is zeros.  A slot kept twice
    # would be a duplicate index with an undefined winner, here as in the
    # reference's scatter; kept slots are distinct while queue positions
    # are exact (fp32, or at most 256 tokens an expert in bf16), so then
    # duplicates land only in the trash slot, which is dropped.
    gidx = torch.arange(G, device=xg3.device)[:, None]
    token_for_slot = torch.full((G, E * C + 1), S, dtype=torch.long,
                                device=xg3.device)
    # jnp.repeat, each token id k times in a row: repeat_interleave, not
    # Tensor.repeat (which would tile 0..S-1 k times)
    rows = torch.arange(S, device=xg3.device).repeat_interleave(k)
    token_for_slot[gidx, slot.reshape(G, S * k)] = rows
    xg_pad = torch.cat([xg3, xg3.new_zeros((G, 1, d))], dim=1)
    xin = xg_pad[gidx, token_for_slot[:, :-1]].reshape(G, E, C, d)
    return xin, slot, gates, aux


def _gather_combine(y: torch.Tensor, slot: torch.Tensor,
                    gates: torch.Tensor) -> torch.Tensor:
    """A gather per assignment from the expert outputs y (G, E, C, d) and
    the gate-weighted sum: (G, S, d)."""
    G, E, C, d = y.shape
    gidx = torch.arange(G, device=y.device)[:, None]
    y_flat = torch.cat([y.reshape(G, E * C, d), y.new_zeros((G, 1, d))], 1)
    picked = y_flat[gidx[:, :, None], slot]                   # (G, S, k, d)
    return torch.sum(picked * gates[..., None].to(y.dtype), dim=-2)


def _group_gather(p: PyTree, cfg: MoEConfig, xg: torch.Tensor,
                  capacity: int):
    """Gather-based dispatch: tokens land in expert slots by a scatter of
    row indices and one gather; the combine is a gather per assignment and
    a weighted sum.  xg: (..., S, d).  On a mesh the router and the
    experts run on their placements, the routing, dispatch and combine on
    whole tensors (``layers.replicated``)."""
    *lead, S, d = xg.shape
    xg3 = xg.reshape(-1, S, d)                                # (G, S, d)
    probs = _router_probs(p, xg3)
    xin, slot, gates, aux = layers.replicated(
        _gather_dispatch, probs, xg3, cfg.top_k, capacity)
    y = _experts(p, cfg, xin)                                 # (G, E, C, d)
    out = layers.replicated(_gather_combine, y, slot, gates)
    return out.reshape(*lead, S, d), aux.reshape(lead)


def moe_apply(p: PyTree, cfg: MoEConfig, x: torch.Tensor,
              group_size: int = 4096,
              group_mode: str = "scan") -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss).

    Tokens are flattened and routed in groups of ``group_size``: one group
    at a time (``"scan"``, serving's mode, which bounds live memory) or all
    groups as one batch (``"vmap"``, the reference's training mode).  The
    dispatch flavour is ``cfg.dispatch``.
    """
    B, S, d = x.shape
    tokens = x.reshape(B * S, d)
    T = tokens.shape[0]
    g = min(group_size, T)
    n_groups = -(-T // g)
    pad = n_groups * g - T
    if pad:
        tokens = torch.cat([tokens, tokens.new_zeros((pad, d))], dim=0)
    groups = tokens.reshape(n_groups, g, d)
    capacity = max(int(cfg.top_k * g / cfg.num_experts * cfg.capacity_factor),
                   1)
    group_fn = _group_gather if cfg.dispatch == "gather" else _group_einsum

    if group_mode == "vmap":
        outs, auxs = group_fn(p, cfg, groups, capacity)
        aux_total = torch.sum(auxs)
    elif group_mode == "scan":
        # one group of each rank's block a step: on a mesh the groups' dim
        # may be split over the batch axes, and a split dim cannot be
        # iterated; the k blocks' groups are interleaved so that step i
        # takes group i of every block
        k = sharding.splits(groups, 0)
        k = k if n_groups % k == 0 else 1
        steps = groups.reshape(k, n_groups // k, g, d).transpose(0, 1)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        outs = []
        for xs in steps:
            out, aux = group_fn(p, cfg, xs, capacity)
            aux_total = aux_total + aux.sum()
            outs.append(out)
        outs = torch.stack(outs).transpose(0, 1).reshape(n_groups, g, d)
    else:
        raise ValueError(f"unknown group_mode {group_mode!r}")
    out = outs.reshape(n_groups * g, d)[:T].reshape(B, S, d)
    if cfg.dense_residual:
        out = out + layers.mlp(p["dense"], x, "swiglu")
    return out, aux_total / n_groups


def expert_activation_stats(p: PyTree, cfg: MoEConfig,
                            x: torch.Tensor) -> torch.Tensor:
    """Per-expert activation frequency of the top-1 choice: the MoE
    analogue of the paper's Fig.-1 layer-wise firing analysis."""
    logits = layers.linear(p["router"], x.reshape(-1, x.shape[-1]))
    top1 = torch.argmax(logits, dim=-1)
    return torch.bincount(top1, minlength=cfg.num_experts) / top1.shape[0]
