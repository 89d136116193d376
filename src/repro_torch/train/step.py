"""Train/serve step factories (counterpart of repro.train.step).

``make_train_step`` builds the update: the loss and its gradients by
autograd (remat is inside the model's period loop), optional microbatch
gradient accumulation into f32 accumulators, then the AdamW update.
``make_serve_steps`` builds the prefill and single-token decode steps.

The step runs the model on ``ArcaneEngine("ref")`` only: the reference's
Pallas kernels define no backward and the port's CUDA kernels have none
either (their outputs carry no ``grad_fn``), so a train step on another
engine would lose its gradients. Every product and attention of the step
is plain PyTorch under autograd, as the reference's train step computes
them outside any Pallas kernel (``tests/test_models.py`` trains on ref).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.transformer import LM, tree_leaves, tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

PyTree = Any


def loss_and_grads(model: LM, params: PyTree, batch: dict) -> tuple:
    """(loss, metrics, grads) of one batch: the grads by
    ``torch.autograd.grad`` over the param leaves, made ``requires_grad``
    here (detached views of the params), in the params' dtypes; the loss and
    metrics detached."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(live)
    loss, metrics = model.loss(live, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), live))


def step_grads(model: LM, params: PyTree, batch: dict, microbatches: int = 1):
    """(loss, metrics, grads) of a step. With ``microbatches`` > 1 the batch
    is split along its first axis (``reshape(microbatches, B // mb, ...)``,
    as the reference does), each microbatch's grads are added into f32
    accumulators and divided by ``microbatches`` at the end, and the
    metrics hold none of the microbatches' aux metrics."""
    if microbatches == 1:
        return loss_and_grads(model, params, batch)
    n = next(iter(batch.values())).shape[0]
    if n % microbatches:
        raise ValueError(f"a batch of {n} does not split into {microbatches} "
                         f"microbatches")
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    loss = 0.0
    mbs = {k: v.reshape(microbatches, n // microbatches, *v.shape[1:])
           for k, v in batch.items()}
    for i in range(microbatches):
        l, _, g = loss_and_grads(model, params, {k: v[i] for k, v in mbs.items()})
        tree_map(lambda a, b: a.add_(b), acc, g)      # b widened exactly
        loss = loss + l
        del g
    tree_map(lambda a: a.div_(microbatches), acc)
    return loss / microbatches, {}, acc


def make_train_step(model: LM, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, grad_shardings: PyTree = None):
    """→ ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``loss``, the scalar aux metrics (``ce``, ``aux``,
    ``tokens``) when ``microbatches`` is 1, ``grad_norm`` and ``lr``. The
    params and the optimizer state are updated in place and returned.
    ``grad_shardings`` (the reference's ZeRO layout) belongs to the
    multi-device path, which the port does not have: only ``None``."""
    if grad_shardings is not None:
        raise NotImplementedError(
            "grad_shardings needs the multi-device path, which the port does "
            "not have yet; pass None")
    if model.engine.backend != "ref":
        raise ValueError(
            f"a train step needs ArcaneEngine('ref'), not "
            f"{model.engine.backend!r}: the CUDA kernels have no backward (on "
            f"the card their outputs carry no grad_fn, so the gradients would "
            f"be lost), and the reference's Pallas backend cannot be "
            f"differentiated either")

    def train_step(params: PyTree, opt_state: PyTree, batch: dict):
        loss, metrics, grads = step_grads(model, params, batch, microbatches)
        params, opt_state, om = adamw_update(opt_cfg, grads, opt_state, params)
        return params, opt_state, {
            "loss": loss, **{k: v for k, v in metrics.items() if v.dim() == 0},
            **om}

    return train_step


def make_serve_steps(model: LM, *, enc_len: int = 0):
    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)

    def decode_step(params, tokens, position, cache):
        return model.decode_step(params, tokens, position, cache,
                                 enc_len=enc_len)

    return prefill_step, decode_step


def init_train_state(model: LM, opt_cfg: AdamWConfig,
                     gen: torch.Generator) -> tuple:
    params = model.init_params(gen)
    return params, adamw_init(opt_cfg, params)
