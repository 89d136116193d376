"""Decoder-only LM (counterpart of repro.models.transformer, for the
attention, MLA, MoE and recurrent (Mamba, RWKV-6) families).

Params keep the reference layout: per pattern position, a dict of stacked
leaves with a leading ``n_periods`` axis. A Python loop over periods takes
the place of the reference's ``lax.scan``; each step indexes the stacks
(views, no copies). The cache has the same layout and is updated in place.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import ArcaneEngine, default_engine
from repro_torch.models import blocks as blk
from repro_torch.models.layers import embed, embedding_init, make_norm, unembed

PyTree = Any


def tree_map(fn: Callable, *trees):
    """Map ``fn`` over the leaves of nested dicts/tuples/lists of tensors."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _stack_init(n: int, init_fn: Callable[[], PyTree]) -> PyTree:
    """``n`` initialisations of a block, stacked on a new leading axis. The
    stacks are allocated once and filled copy by copy, so the peak is the
    stack plus one block."""
    first = init_fn()
    stacked = tree_map(lambda x: x.new_empty((n, *x.shape)), first)
    for i in range(n):
        tree = first if i == 0 else init_fn()
        tree_map(lambda s, x: s[i].copy_(x), stacked, tree)
    return stacked


def _index(tree: PyTree, i: int) -> PyTree:
    return tree_map(lambda x: x[i], tree)


class LM:
    """Decoder-only language model on one device."""

    def __init__(self, cfg: ModelConfig, engine: Optional[ArcaneEngine] = None,
                 *, device=None):
        self.cfg = cfg
        self.engine = engine or default_engine()
        self.device = resolve_device(device)
        for spec in cfg.pattern:
            blk._check_kind(cfg, spec)

    # ------------------------------------------------------------- params
    def init_params(self, gen: torch.Generator) -> PyTree:
        """Random weights drawn on the model's device from ``gen``."""
        cfg, dev = self.cfg, self.device
        ninit, _ = make_norm(cfg.norm)
        params: dict[str, Any] = {
            "embed": embedding_init(gen, cfg.vocab, cfg.d_model, cfg.pdtype, dev),
            "final_norm": ninit(cfg.d_model, cfg.pdtype, dev),
        }
        params["blocks"] = tuple(
            _stack_init(cfg.n_periods,
                        lambda spec=spec: blk.block_init(gen, cfg, spec, dev))
            for spec in cfg.pattern)
        if not cfg.tie_embeddings:
            params["unembed"] = embedding_init(gen, cfg.vocab, cfg.d_model,
                                               cfg.pdtype, dev)
        return params

    def _unembed(self, params, x):
        _, napply = make_norm(self.cfg.norm)
        x = napply(params["final_norm"], x)
        table = params["unembed" if "unembed" in params else "embed"]
        return unembed(self.engine, table, x, softcap=self.cfg.final_softcap)

    # ------------------------------------------------------------ forward
    def forward(self, params, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """→ (logits (B, S, V) f32, MoE aux loss summed over layers)."""
        cfg = self.cfg
        x = embed(params["embed"], batch["tokens"],
                  scale=cfg.embed_scale).to(cfg.cdtype)
        positions = torch.arange(x.shape[1], device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.n_periods):
            for j, spec in enumerate(cfg.pattern):
                x, a = blk.block_forward(self.engine,
                                         _index(params["blocks"][j], i), cfg,
                                         spec, x, positions)
                aux = aux + a
        return self._unembed(params, x), aux

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, max_len: int, *, dtype=None) -> tuple:
        cfg = self.cfg
        dtype = dtype or cfg.cdtype

        def one(spec):
            c = blk.init_block_cache(cfg, spec, batch, max_len, dtype,
                                     self.device)
            return {k: v.new_zeros((cfg.n_periods, *v.shape))
                    for k, v in c.items()}

        return tuple(one(spec) for spec in cfg.pattern)

    def prefill(self, params, batch, cache) -> tuple[torch.Tensor, tuple]:
        """Process the full prompt; returns (last-position logits, cache)."""
        cfg = self.cfg
        x = embed(params["embed"], batch["tokens"],
                  scale=cfg.embed_scale).to(cfg.cdtype)
        positions = torch.arange(x.shape[1], device=x.device)
        for i in range(cfg.n_periods):
            for j, spec in enumerate(cfg.pattern):
                x, _ = blk.block_prefill(self.engine,
                                         _index(params["blocks"][j], i), cfg,
                                         spec, x, positions,
                                         _index(cache[j], i))
        return self._unembed(params, x[:, -1:])[:, 0], cache

    def decode_step(self, params, tokens: torch.Tensor,
                    position: torch.Tensor, cache: tuple):
        """tokens: (B,) int; position: (B,) int on the device →
        (logits (B, V) f32, cache)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, scale=cfg.embed_scale).to(cfg.cdtype)
        for i in range(cfg.n_periods):
            for j, spec in enumerate(cfg.pattern):
                x, _ = blk.block_decode(self.engine,
                                        _index(params["blocks"][j], i), cfg,
                                        spec, x, position, _index(cache[j], i))
        return self._unembed(params, x), cache
