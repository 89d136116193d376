"""Layer blocks: norm/residual wiring around attention + FFN
(counterpart of repro.models.blocks, for the kinds ``attn`` and
``attn_local``).

A block is one position in the config's repeating layer pattern, with three
entry points: forward, prefill (cache write) and decode (one token). The
cache of a block is a dict of (B, Hkv, S, hd) tensors, updated in place.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.engine import ArcaneEngine
from repro_torch.models import attention as attn
from repro_torch.models.layers import make_norm
from repro_torch.models.mlp import mlp, mlp_init

KINDS = ("attn", "attn_local")


def _check_kind(cfg: ModelConfig, spec: LayerSpec) -> None:
    if spec.kind not in KINDS or spec.moe or cfg.enc_dec or cfg.vision_prefix:
        raise NotImplementedError(
            f"{cfg.name}: layer kind {spec.kind!r} (moe={spec.moe}, "
            f"enc_dec={cfg.enc_dec}, vision_prefix={cfg.vision_prefix}) is "
            "not ported yet; see ROADMAP.md, Queue 1 items 7-10")


def _window(cfg: ModelConfig, spec: LayerSpec):
    return cfg.local_window if spec.kind == "attn_local" else None


def _ring(cfg: ModelConfig, spec: LayerSpec, cache: dict) -> bool:
    window = _window(cfg, spec)
    return (window is not None and cfg.ring_local_cache
            and cache["k"].shape[2] == window)


def block_init(gen, cfg: ModelConfig, spec: LayerSpec, device) -> dict:
    _check_kind(cfg, spec)
    ninit, _ = make_norm(cfg.norm)
    d, dt = cfg.d_model, cfg.pdtype
    p: dict[str, Any] = {"ln1": ninit(d, dt, device)}
    p["attn"] = attn.attention_init(gen, cfg, device)
    p["ln2"] = ninit(d, dt, device)
    p["ffn"] = mlp_init(gen, cfg, device)
    return p


def block_forward(engine: ArcaneEngine, params: dict, cfg: ModelConfig,
                  spec: LayerSpec, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    _check_kind(cfg, spec)
    _, napply = make_norm(cfg.norm)
    h = attn.attention_forward(engine, params["attn"], cfg,
                               napply(params["ln1"], x), positions,
                               window=_window(cfg, spec))
    x = x + h
    return x + mlp(engine, params["ffn"], cfg, napply(params["ln2"], x))


def init_block_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype, device) -> dict:
    _check_kind(cfg, spec)
    s_len = max_len
    if (spec.kind == "attn_local" and cfg.ring_local_cache
            and cfg.local_window and cfg.local_window < max_len):
        s_len = cfg.local_window          # ring buffer
    shape = (batch, cfg.n_kv_heads, s_len, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def block_prefill(engine, params, cfg, spec, x, positions, cache):
    """Prefill from position 0; returns (x, cache)."""
    _check_kind(cfg, spec)
    _, napply = make_norm(cfg.norm)
    h, cache["k"], cache["v"] = attn.attention_prefill(
        engine, params["attn"], cfg, napply(params["ln1"], x), positions,
        cache["k"], cache["v"], window=_window(cfg, spec),
        ring=_ring(cfg, spec, cache))
    x = x + h
    return x + mlp(engine, params["ffn"], cfg, napply(params["ln2"], x)), cache


def block_decode(engine, params, cfg, spec, x, position, cache):
    """One-token step. x: (B, d); returns (x, cache)."""
    _check_kind(cfg, spec)
    _, napply = make_norm(cfg.norm)
    h, cache["k"], cache["v"] = attn.attention_decode(
        engine, params["attn"], cfg, napply(params["ln1"], x), position,
        cache["k"], cache["v"], window=_window(cfg, spec),
        ring=_ring(cfg, spec, cache))
    x = x + h
    h = mlp(engine, params["ffn"], cfg, napply(params["ln2"], x)[:, None, :])
    return x + h[:, 0], cache
