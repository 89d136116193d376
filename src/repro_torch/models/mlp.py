"""Gated (SwiGLU) and classic two-layer MLPs — all GeMMs via xmk0 dispatch
(counterpart of repro.models.mlp)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import ArcaneEngine
from repro_torch.distributed.sharding import constrain
from repro_torch.models.layers import activation, dense, dense_init


def classic(cfg: ModelConfig) -> bool:
    """Whisper-style classic two-layer MLP with biases (gelu, enc-dec)."""
    return cfg.act == "gelu" and cfg.enc_dec


def mlp_init(gen, cfg: ModelConfig, device) -> dict:
    d, ff, dt = cfg.d_model, cfg.d_ff, cfg.pdtype
    if classic(cfg):
        return {"up": dense_init(gen, d, ff, dt, device, bias=True),
                "down": dense_init(gen, ff, d, dt, device, bias=True)}
    return {"gate": dense_init(gen, d, ff, dt, device),
            "up": dense_init(gen, d, ff, dt, device),
            "down": dense_init(gen, ff, d, dt, device)}


def mlp(engine: ArcaneEngine, params: dict, cfg: ModelConfig,
        x: torch.Tensor) -> torch.Tensor:
    act = activation(cfg.act)
    if "gate" not in params:
        h = constrain(act(dense(engine, params["up"], x)), "batch", None, "model")
        return dense(engine, params["down"], h)
    g = act(dense(engine, params["gate"], x))
    u = dense(engine, params["up"], x)
    h = constrain(g * u, "batch", None, "model")
    return dense(engine, params["down"], h)
