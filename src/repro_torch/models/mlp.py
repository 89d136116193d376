"""Gated (SwiGLU) and classic two-layer MLPs — all GeMMs via xmk0 dispatch
(counterpart of repro.models.mlp). Under tensor parallelism (``mg``) gate
and up are column-parallel and down row-parallel: a rank computes its
columns of the hidden layer and the ranks' partial outputs are summed."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import ArcaneEngine
from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.distributed.sharding import constrain
from repro_torch.models.layers import (activation, dense, dense_col,
                                       dense_init, dense_row)


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


def _up_bias_slice(up: dict, mg: tpm.ModelGroup) -> dict:
    """The classic MLP's up weight shard with its slice of the replicated
    bias (its gradient summed over the ranks, each giving its slice's)."""
    if "b" not in up:
        return up
    n = up["w"].shape[-1]
    b = tpm.copy_to_model(up["b"], mg)
    return {"w": up["w"], "b": b[mg.rank * n:(mg.rank + 1) * n]}


def mlp(engine: ArcaneEngine, params: dict, cfg: ModelConfig,
        x: torch.Tensor, mg: Optional[tpm.ModelGroup] = None) -> torch.Tensor:
    act = activation(cfg.act)
    if mg is None:
        col = lambda p: dense(engine, p, x)            # noqa: E731
        row = lambda p, h: dense(engine, p, h)         # noqa: E731
    else:
        col = lambda p: dense_col(engine, p, x, mg)    # noqa: E731
        row = lambda p, h: dense_row(engine, p, h, mg)  # noqa: E731
    if "gate" not in params:
        up = params["up"] if mg is None else _up_bias_slice(params["up"], mg)
        h = constrain(act(col(up)), "batch", None, "model")
        return row(params["down"], h)
    g = act(col(params["gate"]))
    u = col(params["up"])
    h = constrain(g * u, "batch", None, "model")
    return row(params["down"], h)
