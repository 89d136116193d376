"""Multi-head Latent Attention, MiniCPM3 / DeepSeek style (counterpart of
repro.models.mla).

Forward and prefill expand the latent KV to per-head K and V and run the
flash-attention kernel (v padded to the qk head). Decode uses the absorbed
identity

    score_h = q_nope_hᵀ W_uk_h c + q_rope_hᵀ k_rope
            = [W_uk_hᵀ q_nope_h ; q_rope_h] · [c ; k_rope]

so one token's attention is the decode kernel's sweep over the latent
cache, with one KV head for all H query heads (G = H) and D = kv_lora_rank
+ rope: ``engine.mla_decode_attention`` over ``c`` and ``kr`` as they are
held, V the first r columns of the key rows (no copy of the cache where
the kernel takes the operands); W_uv is applied to the latent output
afterwards. The cache holds ``c`` (B, S, r) and ``kr`` (B, S, rope),
written in place.

With an ``AttnTP`` (``tp``) whose ``heads`` is set a rank computes its
heads: q_up is column-parallel, k_up and v_up are the rank's heads, o is
row-parallel; q_down and kv_down are replicated over ``model``, so the
latents are computed whole on every rank and enter the rank's k_up/v_up
products through ``col_input``. A latent cache sharded by sequence
(``tp.cache == "seq"``) holds the rank's slice of the positions: a
prefill writes the slice of the whole latents, a decode step attends
every head over the slice (the ranks' absorbed queries gathered), the
decode kernel returning each row's log-sum-exp, and the ranks merge.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import ArcaneEngine
from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.models.attention import seq_lengths
from repro_torch.models.layers import (apply_rope, dense, dense_col, dense_init,
                                       dense_row, rmsnorm, rmsnorm_init,
                                       truncated_normal_init)


def mla_init(gen, cfg: ModelConfig, device) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    dt = cfg.pdtype
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    up_scale = 1.0 / math.sqrt(m.kv_lora_rank)
    return {
        "q_down": dense_init(gen, d, m.q_lora_rank, dt, device),
        "q_norm": rmsnorm_init(m.q_lora_rank, dt, device),
        "q_up": dense_init(gen, m.q_lora_rank, h * qk_head, dt, device),
        "kv_down": dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim, dt,
                              device),
        "kv_norm": rmsnorm_init(m.kv_lora_rank, dt, device),
        "k_up": truncated_normal_init(
            gen, (h, m.kv_lora_rank, m.qk_nope_head_dim), dt, up_scale, device),
        "v_up": truncated_normal_init(
            gen, (h, m.kv_lora_rank, m.v_head_dim), dt, up_scale, device),
        "o": dense_init(gen, h * m.v_head_dim, d, dt, device),
    }


def _heads(tp) -> bool:
    return tp is not None and tp.heads


def _seq(tp) -> bool:
    return tp is not None and tp.cache == "seq"


def _n_heads(cfg, tp) -> int:
    """The heads this rank computes."""
    return cfg.n_heads // tp.mg.size if _heads(tp) else cfg.n_heads


def _project_qkv(engine, params, cfg, x, positions, tp=None):
    """Shared q/latent computation. x: (B, S, d) → q_nope (B, H, S, nope),
    q_rope (B, H, S, rope) of the rank's heads, c_kv (B, S, r), k_rope
    (B, 1, S, rope), whole."""
    m = cfg.mla
    h = _n_heads(cfg, tp)
    b, s = x.shape[0], x.shape[1]
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    q_lat = rmsnorm(params["q_norm"], dense(engine, params["q_down"], x))
    q = (dense_col(engine, params["q_up"], q_lat, tp.mg) if _heads(tp)
         else dense(engine, params["q_up"], q_lat))
    q = q.reshape(b, s, h, qk_head).transpose(1, 2)               # (B,H,S,qk)
    q_nope, q_rope = q[..., : m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    kv = dense(engine, params["kv_down"], x)                      # (B,S,r+rope)
    c_kv = rmsnorm(params["kv_norm"], kv[..., : m.kv_lora_rank])
    k_rope = kv[..., m.kv_lora_rank:][:, None]                    # (B,1,S,rope)
    q_rope = apply_rope(q_rope, positions, theta=cfg.rope_theta)
    k_rope = apply_rope(k_rope, positions, theta=cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _up(c, w, dtype):
    """(B, S, r) latents through the (H, r, hd) up-projection of the rank's
    heads → (B, H, S, hd) in ``dtype``."""
    if c.dtype == w.dtype:
        return torch.einsum("bsr,hrd->bhsd", c, w)
    return torch.einsum("bsr,hrd->bhsd", c, w.to(c.dtype)).to(dtype)


def mla_forward(engine: ArcaneEngine, params: dict, cfg: ModelConfig,
                x: torch.Tensor, positions: torch.Tensor, tp=None) -> torch.Tensor:
    """Forward: expand latents to per-head K/V, flash attention (the rank's
    heads under a head-parallel ``tp``)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = _n_heads(cfg, tp)
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    q_nope, q_rope, c_kv, k_rope = _project_qkv(engine, params, cfg, x,
                                                positions, tp)
    dtype = torch.result_type(c_kv, params["k_up"])
    if _heads(tp):
        # replicated latents into the rank's heads: their grads summed
        c_kv, k_rope = tpm.col_input(c_kv, tp.mg), tpm.col_input(k_rope, tp.mg)
    k_nope = _up(c_kv, params["k_up"], dtype)
    v = _up(c_kv, params["v_up"], dtype)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, h, s, m.qk_rope_head_dim)
                   .to(k_nope.dtype)], dim=-1)
    scale = 1.0 / math.sqrt(qk_head)
    # v's head dim may be below the qk head's: pad it for the shared kernel
    if m.v_head_dim < qk_head:
        v = F.pad(v, (0, qk_head - m.v_head_dim))
    out = engine.attention(q, k, v, causal=True, scale=scale)
    out = out[..., : m.v_head_dim]
    out = out.transpose(1, 2).reshape(b, s, h * m.v_head_dim)
    if _heads(tp):
        return dense_row(engine, params["o"], out, tp.mg)
    return dense(engine, params["o"], out)


def mla_prefill(engine, params, cfg, x, positions, cache_c, cache_kr, tp=None):
    """Prefill: run forward and write the *latent* stream into the cache at
    [0, S), in place (a cache sharded by sequence: the rank's slice of
    it). The latents are projected once for the cache and once more inside
    the forward, as the reference does."""
    s = x.shape[1]
    _, _, c_kv, k_rope = _project_qkv(engine, params, cfg, x, positions, tp)
    out = mla_forward(engine, params, cfg, x, positions, tp)
    lo, n = 0, s
    if _seq(tp):
        s_l = cache_c.shape[1]
        lo = min(tp.mg.rank * s_l, s)
        n = min(s, lo + s_l) - lo
    cache_c[:, :n] = c_kv[:, lo:lo + n].to(cache_c.dtype)
    cache_kr[:, :n] = k_rope[:, 0, lo:lo + n].to(cache_kr.dtype)
    return out, cache_c, cache_kr


def mla_decode(engine: ArcaneEngine, params: dict, cfg: ModelConfig,
               x: torch.Tensor, position: torch.Tensor,
               cache_c: torch.Tensor, cache_kr: torch.Tensor, tp=None):
    """Absorbed single-token decode over the latent cache.

    x: (B, d); position: (B,) on the device; cache_c: (B, S, r);
    cache_kr: (B, S, rope) (a cache sharded by sequence: the rank's slice,
    whose owner writes the new row). The new latent row is written in
    place.
    """
    m = cfg.mla
    b = x.shape[0]
    rope = m.qk_rope_head_dim
    qk_head = m.qk_nope_head_dim + rope
    q_nope, q_rope, c_new, kr_new = _project_qkv(
        engine, params, cfg, x[:, None, :], position[:, None], tp)
    rows = torch.arange(b, device=x.device)
    if _seq(tp):
        slot, lengths = seq_lengths(position, cache_c.shape[1], tp.mg, False)
        own = ((slot >= 0) & (slot < cache_c.shape[1]))[:, None]
        slot = slot.clamp(0, cache_c.shape[1] - 1)
        for c, new in ((cache_c, c_new[:, 0]), (cache_kr, kr_new[:, 0, 0])):
            c[rows, slot] = torch.where(own, new.to(c.dtype), c[rows, slot])
    else:
        cache_c[rows, position] = c_new[:, 0].to(cache_c.dtype)
        cache_kr[rows, position] = kr_new[:, 0, 0].to(cache_kr.dtype)
        lengths = position + 1

    # absorb W_uk into q: q_eff = W_ukᵀ q_nope → (B, H, r)
    q_eff = torch.einsum("bhd,hrd->bhr", q_nope[:, :, 0, :], params["k_up"])
    q_full = torch.cat([q_eff, q_rope[:, :, 0, :]], dim=-1)      # (B,H,r+rope)
    scale = 1.0 / math.sqrt(qk_head)
    lengths = lengths.to(torch.int32)
    if _seq(tp):
        # every head over the rank's slice, the ranks merged, its heads kept
        h = q_full.shape[1]
        if _heads(tp):
            q_full = tpm.gather_heads(q_full, tp.mg)
        out, lse = engine.mla_decode_attention(q_full, cache_c, cache_kr, lengths,
                                               scale=scale, return_lse=True)
        out = tpm.merge_partials(out, lse, tp.mg).to(q_full.dtype)
        if _heads(tp):
            out = out[:, tp.mg.rank * h:(tp.mg.rank + 1) * h]
    else:
        out = engine.mla_decode_attention(q_full, cache_c, cache_kr, lengths,
                                          scale=scale)                # (B,H,r)
    out_v = torch.einsum("bhr,hrd->bhd", out, params["v_up"])
    out_v = out_v.reshape(b, out_v.shape[1] * m.v_head_dim)
    if _heads(tp):
        return dense_row(engine, params["o"], out_v, tp.mg), cache_c, cache_kr
    return dense(engine, params["o"], out_v), cache_c, cache_kr
