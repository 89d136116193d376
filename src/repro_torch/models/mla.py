"""Multi-head Latent Attention, MiniCPM3 / DeepSeek style (counterpart of
repro.models.mla).

Forward and prefill expand the latent KV to per-head K and V and run the
flash-attention kernel (v padded to the qk head). Decode uses the absorbed
identity

    score_h = q_nope_hᵀ W_uk_h c + q_rope_hᵀ k_rope
            = [W_uk_hᵀ q_nope_h ; q_rope_h] · [c ; k_rope]

so one token's attention is the decode kernel's sweep over the latent
cache, with one KV head for all H query heads (G = H) and D = kv_lora_rank
+ rope; W_uv is applied to the latent output afterwards. The cache holds
``c`` (B, S, r) and ``kr`` (B, S, rope), written in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import ArcaneEngine
from repro_torch.models.layers import (apply_rope, dense, dense_init, rmsnorm,
                                       rmsnorm_init, truncated_normal_init)


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


def _project_qkv(engine, params, cfg, x, positions):
    """Shared q/latent computation. x: (B, S, d) → q_nope (B, H, S, nope),
    q_rope (B, H, S, rope), c_kv (B, S, r), k_rope (B, 1, S, rope)."""
    m = cfg.mla
    h = cfg.n_heads
    b, s = x.shape[0], x.shape[1]
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    q_lat = rmsnorm(params["q_norm"], dense(engine, params["q_down"], x))
    q = dense(engine, params["q_up"], q_lat).reshape(b, s, h, qk_head)
    q = q.transpose(1, 2)                                         # (B,H,S,qk)
    q_nope, q_rope = q[..., : m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    kv = dense(engine, params["kv_down"], x)                      # (B,S,r+rope)
    c_kv = rmsnorm(params["kv_norm"], kv[..., : m.kv_lora_rank])
    k_rope = kv[..., m.kv_lora_rank:][:, None]                    # (B,1,S,rope)
    q_rope = apply_rope(q_rope, positions, theta=cfg.rope_theta)
    k_rope = apply_rope(k_rope, positions, theta=cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(engine: ArcaneEngine, params: dict, cfg: ModelConfig,
                x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Forward: expand latents to per-head K/V, flash attention."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    q_nope, q_rope, c_kv, k_rope = _project_qkv(engine, params, cfg, x,
                                                positions)
    k_nope = torch.einsum("bsr,hrd->bhsd", c_kv, params["k_up"])
    v = torch.einsum("bsr,hrd->bhsd", c_kv, params["v_up"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, h, s, m.qk_rope_head_dim)], dim=-1)
    scale = 1.0 / math.sqrt(qk_head)
    # v's head dim may be below the qk head's: pad it for the shared kernel
    if m.v_head_dim < qk_head:
        v = F.pad(v, (0, qk_head - m.v_head_dim))
    out = engine.attention(q, k, v, causal=True, scale=scale)
    out = out[..., : m.v_head_dim]
    out = out.transpose(1, 2).reshape(b, s, h * m.v_head_dim)
    return dense(engine, params["o"], out)


def mla_prefill(engine, params, cfg, x, positions, cache_c, cache_kr):
    """Prefill: run forward and write the *latent* stream into the cache at
    [0, S), in place. The latents are projected once for the cache and once
    more inside the forward, as the reference does."""
    s = x.shape[1]
    _, _, c_kv, k_rope = _project_qkv(engine, params, cfg, x, positions)
    out = mla_forward(engine, params, cfg, x, positions)
    cache_c[:, :s] = c_kv.to(cache_c.dtype)
    cache_kr[:, :s] = k_rope[:, 0].to(cache_kr.dtype)
    return out, cache_c, cache_kr


def mla_decode(engine: ArcaneEngine, params: dict, cfg: ModelConfig,
               x: torch.Tensor, position: torch.Tensor,
               cache_c: torch.Tensor, cache_kr: torch.Tensor):
    """Absorbed single-token decode over the latent cache.

    x: (B, d); position: (B,) on the device; cache_c: (B, S, r);
    cache_kr: (B, S, rope). The new latent row is written in place.
    """
    m = cfg.mla
    b = x.shape[0]
    r, rope = m.kv_lora_rank, m.qk_rope_head_dim
    qk_head = m.qk_nope_head_dim + rope
    q_nope, q_rope, c_new, kr_new = _project_qkv(
        engine, params, cfg, x[:, None, :], position[:, None])
    rows = torch.arange(b, device=x.device)
    cache_c[rows, position] = c_new[:, 0].to(cache_c.dtype)
    cache_kr[rows, position] = kr_new[:, 0, 0].to(cache_kr.dtype)

    # absorb W_uk into q: q_eff = W_ukᵀ q_nope → (B, H, r)
    q_eff = torch.einsum("bhd,hrd->bhr", q_nope[:, :, 0, :], params["k_up"])
    q_full = torch.cat([q_eff, q_rope[:, :, 0, :]], dim=-1)      # (B,H,r+rope)
    keys = torch.cat([cache_c, cache_kr], dim=-1)[:, None]        # (B,1,S,r+rope)
    vals = F.pad(cache_c, (0, rope))[:, None]                     # pad to r+rope
    lengths = (position + 1).to(torch.int32)
    scale = 1.0 / math.sqrt(qk_head)
    out = engine.decode_attention(q_full, keys.to(q_full.dtype),
                                  vals.to(q_full.dtype), lengths,
                                  scale=scale)                    # (B,H,r+rope)
    out_v = torch.einsum("bhr,hrd->bhd", out[..., :r], params["v_up"])
    out_v = out_v.reshape(b, cfg.n_heads * m.v_head_dim)
    return dense(engine, params["o"], out_v), cache_c, cache_kr
