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
    n_slots = s_g * k
    order = torch.argsort(slot_expert, dim=-1, stable=True)
    sorted_e = torch.gather(slot_expert, 1, order)
    group_start = torch.searchsorted(
        sorted_e, torch.arange(e, device=dev).expand(g, e).contiguous())
    pos_sorted = torch.arange(n_slots, device=dev) - torch.gather(
        group_start, 1, sorted_e)
    slot_pos = torch.zeros_like(pos_sorted).scatter_(1, order, pos_sorted)
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


def moe(engine: ArcaneEngine, params: dict, cfg: ModelConfig,
        x: torch.Tensor, mg: Optional[tpm.ModelGroup] = None
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (out, aux_loss); with ``mg``, the rank's experts
    (module docstring)."""
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
    act = activation(cfg.act)
    gg = act(_expert_matmul(xe, params["gate"]))
    uu = _expert_matmul(xe, params["up"])
    y = _expert_matmul((gg * uu).to(xe.dtype), params["down"]).to(xt.dtype)
    y = constrain(y, "model", "batch", None)

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
