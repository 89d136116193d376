"""AdamW with f32 master weights, global-norm clipping and LR schedules
(counterpart of repro.optim.adamw).

State = {master, m, v, step}, as the reference's: the master copy lives in
f32 (``master_dtype``) even when the live params are bf16, the moments in
``moment_dtype``, ``step`` an int32 scalar. The schedule and the bias
corrections are f32 tensors, as JAX computes them (a Python double would
give other bits at late steps).

``adamw_update`` computes the reference's arithmetic op for op, leaf by
leaf, and writes the results into the state's and the params' tensors in
place under ``torch.no_grad()`` (the reference's launcher donates both), so
a step holds one copy of the optimizer state. It returns the same trees.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.configs.base import DTYPES
from repro_torch.models.transformer import tree_leaves, tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"
    master_dtype: str = "float32"


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_ratio, in f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    frac = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp(frac, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(cfg: AdamWConfig, params: PyTree) -> PyTree:
    mdt = DTYPES[cfg.moment_dtype]
    sdt = DTYPES[cfg.master_dtype]
    dev = tree_leaves(params)[0].device
    return {
        # a copy even where the dtypes agree: the update writes the master
        # in place, and it must not write the params through an alias
        "master": tree_map(lambda p: p.detach().to(sdt, copy=True), params),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device),
                      params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device),
                      params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: PyTree, state: PyTree,
                 params: PyTree, *, grad_norm: Optional[torch.Tensor] = None,
                 ) -> tuple[PyTree, PyTree, dict]:
    """One AdamW step: (params, state, {"grad_norm", "lr"}), the params and
    the state updated in place. ``grad_norm``: the gradients' global norm
    where ``grads`` holds only this rank's shards of them (a sharded step
    computes it across ranks); by default ``global_norm(grads)``."""
    step = state["step"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    f32 = torch.float32

    def upd(g, m, v, master, p):
        g = g.to(f32) * scale
        m_new = cfg.b1 * m.to(f32) + (1 - cfg.b1) * g
        v_new = cfg.b2 * v.to(f32) + (1 - cfg.b2) * g * g
        update = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
        mf = master.to(f32)
        mf = mf - lr * (update + cfg.weight_decay * mf)
        m.copy_(m_new)
        v.copy_(v_new)
        master.copy_(mf)
        p.copy_(master)

    # by key, not by leaf order: the trees may have been built apart
    tree_map(upd, grads, state["m"], state["v"], state["master"], params)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
