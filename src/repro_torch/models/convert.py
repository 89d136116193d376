"""Carry weights, caches and optimizer state across from the reference:
numpy pytree → the port's params (cache, AdamW state), and the port's trees
back to numpy (``tree_to_numpy``) to set beside the reference's.

The reference's params pytree, after ``np.asarray`` on every leaf, has the
same nesting as the port's (dicts, a tuple of per-pattern-position stacks).
A bf16 leaf arrives as a numpy array of the ``bfloat16`` extension dtype;
its bits are read through ``view(np.uint16)`` and re-typed as
``torch.bfloat16``, so no bf16-aware numpy package is needed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import tree_leaves, tree_map


def tensor_from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def params_from_numpy(tree, cfg: ModelConfig, device=None):
    """The reference's params (numpy leaves) as the port's params on
    ``device`` (the card unless told otherwise)."""
    dev = resolve_device(device)
    if len(tree["blocks"]) != cfg.period:
        raise ValueError(f"{cfg.name}: {len(tree['blocks'])} block stacks, "
                         f"the pattern has {cfg.period}")
    for key, n, what in (("blocks", cfg.n_periods, "periods"),
                         ("enc_blocks", cfg.n_enc_layers, "encoder layers")):
        for leaf in tree_leaves(tree.get(key, ())):
            if leaf.shape[0] != n:
                raise ValueError(f"{cfg.name}: a {key} leaf of shape "
                                 f"{leaf.shape} is not stacked over {n} {what}")
    return tree_map(lambda x: tensor_from_numpy(x, dev), tree)


def cache_from_numpy(tree, cfg: ModelConfig, device=None) -> tuple:
    """The reference's cache (``LM.init_cache`` / ``prefill`` output, numpy
    leaves: per pattern position a dict of (n_periods, B, ...) stacks, the
    cross cache ``xk``/``xv`` of an encoder-decoder included) as
    the port's cache on ``device``, so that the port decodes on from a
    reference prefill."""
    dev = resolve_device(device)
    if len(tree) != cfg.period:
        raise ValueError(f"{cfg.name}: {len(tree)} cache stacks, the pattern "
                         f"has {cfg.period}")
    for leaf in tree_leaves(tree):
        if leaf.shape[0] != cfg.n_periods:
            raise ValueError(f"{cfg.name}: a cache leaf of shape {leaf.shape} "
                             f"is not stacked over {cfg.n_periods} periods")
    return tuple(tree_map(lambda x: tensor_from_numpy(x, dev), c)
                 for c in tree)


def opt_state_from_numpy(tree, cfg: ModelConfig, device=None) -> dict:
    """The reference's AdamW state (``adamw_init`` / ``adamw_update``
    output, numpy leaves: ``master``, ``m`` and ``v`` shaped as the params,
    ``step`` an int32 scalar) as the port's on ``device``."""
    dev = resolve_device(device)
    out = {k: params_from_numpy(tree[k], cfg, dev) for k in ("master", "m", "v")}
    out["step"] = torch.tensor(int(tree["step"]), dtype=torch.int32, device=dev)
    return out


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bf16 widened to f32 (numpy
    has no bf16 of its own), exactly."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def tree_to_numpy(tree):
    """A tree of tensors as numpy arrays (``tensor_to_numpy``)."""
    return tree_map(tensor_to_numpy, tree)
