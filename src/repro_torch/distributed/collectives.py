"""Data-parallel driver with compressed gradient all-reduce (counterpart of
repro.distributed.collectives).

The sharded train step (``train/step.py``) reduces gradients through DTensor
redistributions. This explicit driver exists for the paper-style
distributed-optimisation tricks that need *manual* collectives:

  * int8 gradient all-reduce with error feedback (4× wire bytes reduction,
    `optim/compression.py`),
  * per-shard optimizer update on replicated params (each replica applies
    the identical update — ZeRO-0 with compressed comms).

Every rank of the group runs the step on the same global batch and takes
its share of it, as the reference's ``shard_map`` over the ``data`` axis
gives each device its block.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.compression import all_reduce_flat, tree_compressed_psum
from repro_torch.train.step import loss_and_grads

PyTree = Any


def make_compressed_dp_step(model, opt_cfg: AdamWConfig, group=None, *,
                            compress: bool = True):
    """Returns ``step(params, opt_state, err, batch) -> (params, opt, err,
    metrics)``.

    params/opt replicated (the same on every rank of ``group``, updated in
    place); the batch's leading dim split over the group, each rank's loss
    and grads computed on its block alone (an MoE layer's aux loss too);
    gradients all-reduced in int8 with error feedback when ``compress``
    (``err`` updated in place), else a mean all-reduce in the grads' own
    dtype; the loss averaged over the group.
    """

    def step(params, opt_state, err, batch):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        b = batch["tokens"].shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} does not split over {n} ranks")
        w = b // n
        local = {k: v[r * w:(r + 1) * w] for k, v in batch.items()}
        loss, _, grads = loss_and_grads(model, params, local)
        if compress:
            grads, err = tree_compressed_psum(grads, group, err)
        else:
            grads = tree_pmean(grads, group)
        params, opt_state, om = adamw_update(opt_cfg, grads, opt_state, params)
        loss = loss.clone()
        dist.all_reduce(loss, group=group)
        return params, opt_state, err, {"loss": loss / n, **om}

    return step


def tree_pmean(grads: PyTree, group=None) -> PyTree:
    """The mean of every leaf over ``group``, in the leaf's own dtype (a
    SUM all-reduce, then / n: gloo has no AVG); the leaves batched by dtype
    into buckets (``all_reduce_flat``)."""
    n = dist.get_world_size(group)
    leaves = tree_leaves(grads)
    out = [None] * len(leaves)
    for dt in dict.fromkeys(g.dtype for g in leaves):
        idx = [i for i, g in enumerate(leaves) if g.dtype == dt]
        for i, s in zip(idx, all_reduce_flat([leaves[i] for i in idx], group)):
            out[i] = s / n
    it = iter(out)
    return tree_map(lambda _: next(it), grads)


def init_error_feedback(params: PyTree) -> PyTree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
