"""Layer blocks: norm/residual wiring around the sequence mixers + FFN/MoE
(counterpart of repro.models.blocks, for the kinds ``attn``, ``attn_local``
and ``mla``, each with a dense or an MoE FFN).

A block is one position in the config's repeating layer pattern, with three
entry points: forward, prefill (cache write) and decode (one token). The
cache of a block is a dict of tensors updated in place: ``k``, ``v``
(B, Hkv, S, hd) for attention, ``c`` (B, S, r) and ``kr`` (B, S, rope) for
MLA's latent stream.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.engine import ArcaneEngine
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models.layers import make_norm
from repro_torch.models.mlp import mlp, mlp_init
from repro_torch.models.moe import moe, moe_init

KINDS = ("attn", "attn_local", "mla")


def _check_kind(cfg: ModelConfig, spec: LayerSpec) -> None:
    if spec.kind not in KINDS or cfg.enc_dec or cfg.vision_prefix:
        raise NotImplementedError(
            f"{cfg.name}: layer kind {spec.kind!r} (enc_dec={cfg.enc_dec}, "
            f"vision_prefix={cfg.vision_prefix}) is not ported yet; see "
            "ROADMAP.md, Queue 1 items 9-10")


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
    if spec.kind == "mla":
        p["attn"] = mla_mod.mla_init(gen, cfg, device)
    else:
        p["attn"] = attn.attention_init(gen, cfg, device)
    p["ln2"] = ninit(d, dt, device)
    p["ffn"] = (moe_init if spec.moe else mlp_init)(gen, cfg, device)
    return p


def _ffn_apply(engine, params, cfg, spec, x):
    """The FFN of the block: (h, MoE aux loss; 0.0 for a dense FFN, a
    Python float, so that the decode step launches nothing for it)."""
    if spec.moe:
        return moe(engine, params["ffn"], cfg, x)
    return mlp(engine, params["ffn"], cfg, x), 0.0


def block_forward(engine: ArcaneEngine, params: dict, cfg: ModelConfig,
                  spec: LayerSpec, x: torch.Tensor,
                  positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | float]:
    """Returns (x, moe_aux_loss): an f32 scalar tensor, or 0.0 for a dense
    FFN."""
    _check_kind(cfg, spec)
    _, napply = make_norm(cfg.norm)
    h = napply(params["ln1"], x)
    if spec.kind == "mla":
        h = mla_mod.mla_forward(engine, params["attn"], cfg, h, positions)
    else:
        h = attn.attention_forward(engine, params["attn"], cfg, h, positions,
                                   window=_window(cfg, spec))
    x = x + h
    h, aux = _ffn_apply(engine, params, cfg, spec, napply(params["ln2"], x))
    return x + h, aux


def init_block_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype, device) -> dict:
    _check_kind(cfg, spec)
    if spec.kind == "mla":
        m = cfg.mla
        return {"c": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                                 device=device),
                "kr": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}
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
    h = napply(params["ln1"], x)
    if spec.kind == "mla":
        h, cache["c"], cache["kr"] = mla_mod.mla_prefill(
            engine, params["attn"], cfg, h, positions, cache["c"], cache["kr"])
    else:
        h, cache["k"], cache["v"] = attn.attention_prefill(
            engine, params["attn"], cfg, h, positions, cache["k"], cache["v"],
            window=_window(cfg, spec), ring=_ring(cfg, spec, cache))
    x = x + h
    h, _ = _ffn_apply(engine, params, cfg, spec, napply(params["ln2"], x))
    return x + h, cache


def block_decode(engine, params, cfg, spec, x, position, cache):
    """One-token step. x: (B, d); returns (x, cache)."""
    _check_kind(cfg, spec)
    _, napply = make_norm(cfg.norm)
    h = napply(params["ln1"], x)
    if spec.kind == "mla":
        h, cache["c"], cache["kr"] = mla_mod.mla_decode(
            engine, params["attn"], cfg, h, position, cache["c"], cache["kr"])
    else:
        h, cache["k"], cache["v"] = attn.attention_decode(
            engine, params["attn"], cfg, h, position, cache["k"], cache["v"],
            window=_window(cfg, spec), ring=_ring(cfg, spec, cache))
    x = x + h
    h, _ = _ffn_apply(engine, params, cfg, spec,
                      napply(params["ln2"], x)[:, None, :])
    return x + h[:, 0], cache
