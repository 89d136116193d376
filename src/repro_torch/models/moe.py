"""Top-k routed Mixture-of-Experts with grouped, capacity-based dispatch
(counterpart of repro.models.moe).

Tokens are processed in groups of ``S_g`` tokens (``GROUP_TOKENS`` a group,
``g`` shrunk to a divisor of T); within a group, each (token, choice) slot
takes a position in its expert by a stable sort, and slots past the
expert's capacity ``int(cf * S_g * k / E) + 1`` are dropped (they land in a
spare row at ``E * cap`` that is sliced off). The reference vmaps the
dispatch over groups; here every step is batched over a leading group axis.

As in the reference, neither the f32 router nor the expert SwiGLU goes
through the engine: the router is a plain f32 matmul and the experts are
grouped products ``(E, G*cap, d) @ (E, d, ff)`` (the reference's
``jnp.einsum``, outside any Pallas kernel), so the MoE FFN logs no xmnmc
instruction and launches no port kernel.

Under expert parallelism (``mg``: the experts' leaves sharded on E over the
model ranks) the tokens and the router stay replicated: every rank
dispatches as above, runs its E/m experts on their slots, and combines
them; the ranks' partial combines are summed in f32 (only the order of the
combine's sum changes). No all-to-all is needed while the tokens are
replicated over the model ranks.

A step whose batch rows are split over data ranks (``rows``: each rank
holds a block of the batch; a train step's ``sharded_step``, a serve
step's ``serve_on_mesh``) keeps the one device's groups, which are the
whole step's tokens in batch order: where they do not fall into whole
groups a rank, each rank routes its own tokens, the
ranks' expert ids are all-gathered (T·k int32: the only input that couples
a group's tokens is which slots an expert keeps), and every rank computes
each slot's position in its expert over the whole group, as one device
does. The expert rows of the group are then shared over the data ranks as
the reference's ``constrain(xe, "model", "batch")`` lays them out: each
rank fills the rows of its own kept slots (zeros elsewhere), a
reduce-scatter over the data ranks hands each its block of every expert's
rows, it runs its experts on that block only (no expert FLOP repeats over
data), and an all-gather of the outputs lets it combine its own tokens.
Per layer, over the data ranks: the ids, and the expert rows in and out
(E_l × G·cap × d each, E_l the rank's experts). In a train step the
backward mirrors the two row collectives: the outputs' gradients are
reduce-scattered, so each rank's block sums every rank's tokens' share,
and the capacity rows' gradients all-gathered, so each rank reads its own
slots' (under remat a period's forward, these collectives included, runs
again in the backward, in the same order on every rank).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import ArcaneEngine
from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.distributed.sharding import batch_mean, constrain
from repro_torch.models.layers import activation, dense_init, truncated_normal_init

# Target tokens per dispatch group.
GROUP_TOKENS = 8192


def dispatch_groups(t: int) -> tuple[int, int]:
    """(groups, tokens a group) of ``t`` tokens: ``t // GROUP_TOKENS``
    groups (at least one), shrunk to the nearest divisor of ``t``."""
    g = max(1, t // GROUP_TOKENS)
    while t % g:           # g must divide T; shrink to the nearest divisor
        g -= 1
    return g, t // g


def moe_init(gen, cfg: ModelConfig, device) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    e = cfg.moe.n_experts
    dt = cfg.pdtype
    scale = 1.0 / math.sqrt(d)
    return {
        "router": dense_init(gen, d, e, torch.float32, device),
        "gate": truncated_normal_init(gen, (e, d, ff), dt, scale, device),
        "up": truncated_normal_init(gen, (e, d, ff), dt, scale, device),
        "down": truncated_normal_init(gen, (e, ff, d), dt, 1.0 / math.sqrt(ff),
                                      device),
    }


def _slot_positions(slot_expert: torch.Tensor, e: int) -> torch.Tensor:
    """(G, n) expert ids of each group's slots in group order → each slot's
    position in its expert within its group (a stable sort by expert)."""
    g, n_slots = slot_expert.shape
    dev = slot_expert.device
    order = torch.argsort(slot_expert, dim=-1, stable=True)
    sorted_e = torch.gather(slot_expert, 1, order)
    group_start = torch.searchsorted(
        sorted_e, torch.arange(e, device=dev).expand(g, e).contiguous())
    pos_sorted = torch.arange(n_slots, device=dev) - torch.gather(
        group_start, 1, sorted_e)
    return torch.zeros_like(pos_sorted).scatter_(1, order, pos_sorted)


def _group_dispatch(xt, expert_ids, gate_vals, e: int, cap: int):
    """Group-local dispatch of G groups. xt: (G, S_g, d); ids/gates:
    (G, S_g, k).

    Returns (dispatched (G, E·cap, d), flat_idx (G, S_g·k), keep, slot_gate).
    """
    g, s_g, d = xt.shape
    k = expert_ids.shape[-1]
    dev = xt.device
    slot_expert = expert_ids.reshape(g, s_g * k)
    slot_gate = gate_vals.reshape(g, s_g * k)
    slot_pos = _slot_positions(slot_expert, e)
    keep = slot_pos < cap
    flat_idx = torch.where(keep, slot_expert * cap + slot_pos,
                           torch.full_like(slot_pos, e * cap))
    token_of_slot = torch.arange(s_g, device=dev).repeat_interleave(k)
    dispatched = xt.new_zeros((g, e * cap + 1, d))
    rows = torch.arange(g, device=dev)[:, None]
    # kept slots hit distinct rows; dropped ones all hit the spare row
    dispatched[rows, flat_idx] = xt[:, token_of_slot]
    return dispatched[:, : e * cap], flat_idx, keep, slot_gate


def _group_combine(y, flat_idx, keep, slot_gate, k: int, sum_dtype=None):
    """Inverse of _group_dispatch. y: (G, E·cap, d) → (G, S_g, d), the sum
    over a token's k slots in ``sum_dtype`` (default y's)."""
    g, e_cap, d = y.shape
    rows = torch.arange(g, device=y.device)[:, None]
    gathered = y[rows, flat_idx.clamp(0, e_cap - 1)]
    gathered = torch.where(keep[..., None], gathered, torch.zeros_like(gathered))
    weighted = gathered * slot_gate[..., None].to(gathered.dtype)
    return weighted.reshape(g, -1, k, d).sum(dim=2, dtype=sum_dtype)


def _expert_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, C, a) @ (E, a, b) → f32, the products and sums in f32 (the
    reference's ``preferred_element_type=jnp.float32``). On the card a bf16
    pair that autograd does not record (serving) runs as one batched cuBLAS
    product that accumulates in f32 and writes f32 (``out_dtype``), so the
    weights are read once, as they are. Under autograd (training), and off
    the card, both operands are widened to f32 first, which is exact:
    ``aten::bmm.dtype`` has no derivative."""
    if x.is_cuda and x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16 \
            and not (torch.is_grad_enabled()
                     and (x.requires_grad or w.requires_grad)):
        return torch.bmm(x, w, out_dtype=torch.float32)
    return torch.bmm(x.float(), w.float())


def splits_whole(t_local: int, n: int) -> bool:
    """Whether ``n`` ranks of ``t_local`` tokens each hold whole dispatch
    groups of their ``n · t_local`` tokens, the same groups as their own
    tokens make (so a rank's dispatch needs no other rank's tokens)."""
    g, s_g = dispatch_groups(n * t_local)
    return g % n == 0 and dispatch_groups(t_local) == (g // n, s_g)


def _swiglu_experts(params: dict, cfg: ModelConfig, xe: torch.Tensor,
                    dtype) -> torch.Tensor:
    """The grouped expert SwiGLU of (E_l, C, d) rows → (E_l, C, d) in
    ``dtype``."""
    act = activation(cfg.act)
    gg = act(_expert_matmul(xe, params["gate"]))
    uu = _expert_matmul(xe, params["up"])
    return _expert_matmul((gg * uu).to(xe.dtype), params["down"]).to(dtype)


def _moe_rows(params: dict, cfg: ModelConfig, xt: torch.Tensor,
              expert_ids: torch.Tensor, gate_vals: torch.Tensor,
              mg: Optional[tpm.ModelGroup], rows: tpm.RowsGroup) -> torch.Tensor:
    """The rank's tokens xt (T_l, d), routed (ids, gates (T_l, k)), through
    the one device's dispatch groups of the ``rows.size`` ranks' T_l tokens
    each (module docstring) → (T_l, d). Under ``mg`` a rank dispatches and
    combines its experts' slots only, so the tokens' and the gates'
    gradients are summed over the model ranks (``copy_to_model``)."""
    if mg is not None:
        xt, gate_vals = tpm.copy_to_model(xt, mg), tpm.copy_to_model(gate_vals, mg)
    t_l, d = xt.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    n, dev = rows.size, xt.device
    t = n * t_l
    g, s_g = dispatch_groups(t)
    cap = int(cfg.moe.capacity_factor * s_g * k / e) + 1
    every = tpm.gather_rows(expert_ids.to(torch.int32), rows).long()  # (T, k)
    slot_pos = _slot_positions(every.reshape(g, s_g * k), e).reshape(t * k)
    first = rows.rank * t_l * k           # the rank's first slot in the step
    slot = torch.arange(first, first + t_l * k, device=dev)
    slot_pos = slot_pos[first:first + t_l * k]
    # an expert's capacity rows, G·cap, in group order; each rank's block c
    c = -(-g * cap // n)
    row = slot // (s_g * k) * cap + slot_pos
    e_l = params["gate"].shape[0]
    e0 = 0 if mg is None else mg.rank * e_l
    local_e = expert_ids.reshape(-1) - e0
    mine = (slot_pos < cap) & (local_e >= 0) & (local_e < e_l)
    spare = e_l * n * c
    flat_idx = torch.where(mine, local_e * (n * c) + row, torch.full_like(row, spare))
    token_of_slot = torch.arange(t_l, device=dev).repeat_interleave(k)
    dispatched = xt.new_zeros((spare + 1, d))
    # kept slots of the rank's experts hit distinct rows; the rest the spare
    dispatched[flat_idx] = xt[token_of_slot]
    # (E_l, n·c, d) → (n·E_l, c, d): the ranks' blocks of every expert's rows
    blocks = dispatched[:spare].reshape(e_l, n, c, d).transpose(0, 1)
    xe = tpm.reduce_scatter_rows(blocks.reshape(n * e_l, c, d), rows)  # (E_l, c, d)
    y = _swiglu_experts(params, cfg, xe, xt.dtype)
    y = tpm.gather_rows(y, rows).reshape(n, e_l, c, d).transpose(0, 1).reshape(spare, d)
    gathered = y[flat_idx.clamp(max=spare - 1)]
    gathered = torch.where(mine[:, None], gathered, torch.zeros_like(gathered))
    weighted = gathered * gate_vals.reshape(-1)[:, None].to(gathered.dtype)
    out = weighted.reshape(t_l, k, d).sum(
        dim=1, dtype=None if mg is None else torch.float32)
    return out if mg is None else tpm.reduce_from_model(out, mg)


def moe(engine: ArcaneEngine, params: dict, cfg: ModelConfig,
        x: torch.Tensor, mg: Optional[tpm.ModelGroup] = None,
        rows: Optional[tpm.RowsGroup] = None
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (out, aux_loss); with ``mg``, the rank's experts;
    with ``rows``, a step's batch rows split over data ranks, the groups
    the whole step's (module docstring). The aux loss's per-expert means
    are the rank's tokens', averaged over the ranks where a train step
    splits the batch (``batch_mean``: the shares are equal)."""
    b, s, d = x.shape
    mcfg = cfg.moe
    e, k = mcfg.n_experts, mcfg.top_k
    t = b * s
    xt = x.reshape(t, d)

    # ---- router (f32 for numerical stability of the softmax) -------------
    logits = xt.float() @ params["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)       # (T, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # ---- load-balancing aux loss (Switch/GShard) --------------------------
    # means over the whole batch: a train step that splits the batch over
    # data ranks averages them over those ranks (batch_mean)
    me = batch_mean(probs.mean(dim=0))
    ce = batch_mean(F.one_hot(expert_ids, e).float().sum(dim=1).mean(dim=0))
    aux = e * torch.sum(me * ce) * mcfg.router_aux_coef

    if rows is not None and not splits_whole(t, rows.size):
        out = _moe_rows(params, cfg, xt, expert_ids, gate_vals, mg, rows)
        return out.reshape(b, s, d).to(x.dtype), aux.float()

    # ---- grouped dispatch --------------------------------------------------
    g, s_g = dispatch_groups(t)
    cap = int(mcfg.capacity_factor * s_g * k / e) + 1
    dispatched, flat_idx, keep, slot_gate = _group_dispatch(
        xt.reshape(g, s_g, d) if mg is None else tpm.copy_to_model(
            xt.reshape(g, s_g, d), mg),
        expert_ids.reshape(g, s_g, k), gate_vals.reshape(g, s_g, k), e, cap)
    # (G, E, cap, d) → (E, G·cap, d)
    xe = dispatched.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
    xe = constrain(xe, "model", "batch", None)
    if mg is not None:                # the rank's experts [e0, e0 + e_l)
        e_l = params["gate"].shape[0]
        e0 = mg.rank * e_l
        xe = xe[e0:e0 + e_l]

    # ---- grouped expert SwiGLU --------------------------------------------
    y = constrain(_swiglu_experts(params, cfg, xe, xt.dtype), "model", "batch", None)

    # ---- combine ------------------------------------------------------------
    if mg is not None:                # the other ranks' experts' rows: zero
        y = F.pad(y, (0, 0, 0, 0, e0, e - e0 - e_l))
    yg = y.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
    if mg is None:
        out = _group_combine(yg, flat_idx, keep, slot_gate, k)  # (G, S_g, d)
    else:
        out = tpm.reduce_from_model(_group_combine(
            yg, flat_idx, keep, tpm.copy_to_model(slot_gate, mg), k,
            torch.float32), mg)
    return out.reshape(b, s, d).to(x.dtype), aux.float()
