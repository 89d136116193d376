"""GQA attention: forward, prefill-with-cache, single-token decode
(counterpart of repro.models.attention).

Projections run through the engine's xmk0 dispatch; prefill attention goes
through the flash-attention kernel and decode through the cache-resident
decode kernel. Unlike the reference's pure functions, prefill and decode
write the new K/V rows into the cache tensors in place (they are views of
the model's stacked cache) and return them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import ArcaneEngine
from repro_torch.distributed.sharding import constrain
from repro_torch.models.layers import apply_rope, dense, dense_init


def attention_init(gen, cfg: ModelConfig, device) -> dict:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    dt = cfg.pdtype
    return {
        "q": dense_init(gen, d, cfg.n_heads * hd, dt, device, bias=cfg.qkv_bias),
        "k": dense_init(gen, d, cfg.n_kv_heads * hd, dt, device, bias=cfg.qkv_bias),
        "v": dense_init(gen, d, cfg.n_kv_heads * hd, dt, device, bias=cfg.qkv_bias),
        "o": dense_init(gen, cfg.n_heads * hd, d, dt, device),
    }


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    out = x.reshape(b, s, n, -1).transpose(1, 2)      # (B, H, S, D) view
    return constrain(out, "batch", "model", None, None)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _qkv(engine, params, cfg, x, positions):
    q = _split_heads(dense(engine, params["q"], x), cfg.n_heads)
    k = _split_heads(dense(engine, params["k"], x), cfg.n_kv_heads)
    v = _split_heads(dense(engine, params["v"], x), cfg.n_kv_heads)
    q = apply_rope(q, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
    k = apply_rope(k, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
    return q, k, v


def attention_forward(engine: ArcaneEngine, params: dict, cfg: ModelConfig,
                      x: torch.Tensor, positions: torch.Tensor, *,
                      window: Optional[int] = None,
                      kv_override: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
                      causal: bool = True) -> torch.Tensor:
    """Training/prefill forward. x: (B, S, d). kv_override: the (B, Hkv,
    Skv, hd) K and V of a cross-attention (the encoder's, projected); then
    only q is projected, and neither q nor k is rotated."""
    if kv_override is None:
        q, k, v = _qkv(engine, params, cfg, x, positions)
    else:
        q = _split_heads(dense(engine, params["q"], x), cfg.n_heads)
        k, v = kv_override
    out = engine.attention(q, k, v, causal=causal, window=window,
                           softcap=cfg.attn_softcap)
    return dense(engine, params["o"], _merge_heads(out))


def attention_prefill(engine: ArcaneEngine, params: dict, cfg: ModelConfig,
                      x: torch.Tensor, positions: torch.Tensor,
                      cache_k: torch.Tensor, cache_v: torch.Tensor, *,
                      window: Optional[int] = None, ring: bool = False):
    """Prefill: forward + write K/V into the cache at [0, S) in place.

    Ring mode (window-sized cache for local layers): only the last
    ``window`` rows are kept, at slot ``pos % window``.
    """
    s = x.shape[1]
    q, k, v = _qkv(engine, params, cfg, x, positions)
    out = engine.attention(q, k, v, causal=True, window=window,
                           softcap=cfg.attn_softcap)
    if ring:
        w = cache_k.shape[2]
        keep = min(w, s)
        slots = torch.arange(s - keep, s, device=x.device) % w
        cache_k[:, :, slots] = k[:, :, s - keep:].to(cache_k.dtype)
        cache_v[:, :, slots] = v[:, :, s - keep:].to(cache_v.dtype)
    else:
        cache_k[:, :, :s] = k.to(cache_k.dtype)
        cache_v[:, :, :s] = v.to(cache_v.dtype)
    return dense(engine, params["o"], _merge_heads(out)), cache_k, cache_v


def attention_decode(engine: ArcaneEngine, params: dict, cfg: ModelConfig,
                     x: torch.Tensor, position: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, *,
                     window: Optional[int] = None, ring: bool = False):
    """One-token decode. x: (B, d); position: (B,) current index, on the
    device. The new K/V row is scattered into the cache (one row per
    sequence, in place), then the decode kernel sweeps the cache."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k, v = _qkv(engine, params, cfg, x[:, None, :], position[:, None])
    w = cache_k.shape[2]
    slot = position % w if ring else position
    rows = torch.arange(b, device=x.device)
    cache_k[rows, :, slot] = k[:, :, 0].to(cache_k.dtype)
    cache_v[rows, :, slot] = v[:, :, 0].to(cache_v.dtype)
    lengths = torch.clamp(position + 1, max=w) if ring else position + 1
    out = engine.decode_attention(q[:, :, 0], cache_k, cache_v,
                                  lengths.to(torch.int32),
                                  softcap=cfg.attn_softcap,
                                  window=None if ring else window)  # (B,Hq,hd)
    out = dense(engine, params["o"], out.reshape(b, cfg.n_heads * hd))
    return out, cache_k, cache_v
