"""Train/serve step factories (counterpart of repro.train.step).

``make_train_step`` builds the update: the loss and its gradients by
autograd (remat is inside the model's period loop), optional microbatch
gradient accumulation into f32 accumulators, then the AdamW update.
``make_serve_steps`` builds the prefill and single-token decode steps;
``serve_on_mesh`` runs one of them on DTensor params and cache.

The step runs the model on ``ArcaneEngine("ref")`` only: the reference's
Pallas kernels define no backward and the port's CUDA kernels have none
either (their outputs carry no ``grad_fn``), so a train step on another
engine would lose its gradients. Every product and attention of the step
is plain PyTorch under autograd, as the reference's train step computes
them outside any Pallas kernel (``tests/test_models.py`` trains on ref).
"""
from __future__ import annotations

import math
import sys
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.distributed.sharding import (axis_size, batch_entry,
                                              batch_split, map_with_path,
                                              mesh_sizes)
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
    ``tokens``) when ``microbatches`` is 1, ``grad_norm`` and ``lr``.

    On plain tensors the params and the optimizer state are updated in
    place and returned. On DTensors (params laid out by ``param_pspecs``,
    the state by ``zero_pspecs``, on one mesh over every rank) the step
    runs sharded (``sharded_step``) and its metrics add ``data_split``.
    ``grad_shardings`` (the reference's ZeRO layout: ``to_shardings`` of
    ``zero_pspecs``) is where the reduced gradients land; by default the
    optimizer state's own layout. It needs DTensor params."""
    if model.engine.backend != "ref":
        raise ValueError(
            f"a train step needs ArcaneEngine('ref'), not "
            f"{model.engine.backend!r}: the CUDA kernels have no backward (on "
            f"the card their outputs carry no grad_fn, so the gradients would "
            f"be lost), and the reference's Pallas backend cannot be "
            f"differentiated either")

    def train_step(params: PyTree, opt_state: PyTree, batch: dict):
        if is_sharded(params):
            return sharded_step(model, opt_cfg, params, opt_state, batch,
                                microbatches, grad_shardings)
        if grad_shardings is not None:
            raise ValueError("grad_shardings lays out the gradients of DTensor "
                             "params; these params are plain tensors")
        loss, metrics, grads = step_grads(model, params, batch, microbatches)
        params, opt_state, om = adamw_update(opt_cfg, grads, opt_state, params)
        return params, opt_state, {
            "loss": loss, **{k: v for k, v in metrics.items() if v.dim() == 0},
            **om}

    return train_step


# ------------------------------------------------------------- sharded step
def is_sharded(params: PyTree) -> bool:
    """Whether the params are DTensors (no DTensor exists before its module
    is imported, an import of a second)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(tree_leaves(params)[0], mod.DTensor)


def data_split(mesh, batch: dict, microbatches: int = 1) -> tuple:
    """The mesh axes a sharded step splits the batch over: those that
    ``batch_pspecs`` gives a microbatch's leading dim, for every model and
    batch. The split changes no result: a ``loss_mask``'s count is the
    whole batch's (``LM.loss``: ``batch_sum``), an MoE layer's aux loss
    averages its per-expert means over the ranks (``batch_mean``; the
    shares are equal), and its dispatch groups stay the one device's:
    where they do not fall into whole groups a rank, its ranks share
    their routing (``rows_group``, ``models/moe.py``)."""
    return _batch_axes(mesh, batch["tokens"].shape[0] // microbatches)


def _batch_axes(mesh, rows: int) -> tuple:
    """The mesh axes ``batch_pspecs`` gives a leading dim of ``rows``."""
    entry = batch_entry(rows, mesh)
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def rows_block(mesh, axes: tuple) -> tuple[int, int]:
    """(this rank's block, the number of blocks) of a batch split over
    ``axes``: its coordinate there, pod-major."""
    sizes, coord = mesh_sizes(mesh), dict(zip(mesh.mesh_dim_names,
                                              mesh.get_coordinate()))
    idx, n = 0, 1
    for a in axes:
        idx, n = idx * sizes[a] + coord[a], n * sizes[a]
    return idx, n


def split_batch(batch: dict, mesh, axes: tuple, microbatches: int = 1) -> dict:
    """This rank's part of the batch along ``axes`` (``rows_block``): of
    each microbatch the same share, so that each of its microbatches is its
    share of the reference's microbatch."""
    if not axes:
        return batch
    idx, n = rows_block(mesh, axes)

    def part(v):
        mb = v.reshape(microbatches, -1, *v.shape[1:])
        w = mb.shape[1] // n
        return mb[:, idx * w:(idx + 1) * w].reshape(-1, *v.shape[1:])

    return {k: part(v) for k, v in batch.items()}


def _group(mesh, axes: tuple):
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def rows_group(mesh, axes: tuple):
    """The ``tensor_parallel.RowsGroup`` of a train or serve step whose
    batch rows are split over ``axes``, or None where they are not split
    over more than one rank."""
    idx, n = rows_block(mesh, axes)
    if n == 1:
        return None
    group = _group(mesh, axes)
    if dist.get_rank(group) != idx:
        raise RuntimeError(f"the group of {axes} holds this rank at "
                           f"{dist.get_rank(group)}, its block of the rows is {idx}")
    return tpm.RowsGroup(group, idx, n)


def tp_view(model: LM, params, mesh, cache=None, rows=None) -> tuple:
    """(the model computing on this rank's ``model`` shards, each param
    leaf's compute placements): the plan (``tensor_parallel.plan``) reads
    the params' layout and, while serving, the cache's; ``rows``
    (``rows_group``: the data ranks the batch rows are split over) goes to
    its MoE blocks."""
    plan = tpm.plan(model.cfg, tpm.model_dims(params, mesh),
                    tpm.ModelGroup.of(mesh),
                    None if cache is None else tpm.model_dims(cache, mesh), rows)
    return (model.tensor_parallel(plan),
            tpm.compute_placements(params, mesh, plan.gathered))


def sharded_grads(model: LM, params, batch, microbatches: int = 1,
                  grad_shardings=None, master=None) -> tuple:
    """Steps 1-3 of ``sharded_step`` → (loss, scalar metrics, grads, the
    split axes): the loss and metrics averaged over the ranks the batch is
    split across (each rank's share of the loss is scaled so that their
    mean is the whole batch's, ``LM.loss``), the grads this rank's local
    shards in ``master``'s placements (default: the params'), reduced over
    the split axes through ``grad_shardings``' placements."""
    from torch.distributed.tensor import DTensor, Partial
    mesh = tree_leaves(params)[0].device_mesh
    names = mesh.mesh_dim_names
    axes = data_split(mesh, batch, microbatches)
    group = _group(mesh, axes)
    n = axis_size(mesh, axes)

    tp_model, compute = tp_view(model, params, mesh, rows=rows_group(mesh, axes))
    local = tree_map(lambda p, pl: p.redistribute(mesh, pl).to_local(),
                     params, compute)
    with batch_split(group):
        loss, metrics, grads = step_grads(tp_model, local,
                                          split_batch(batch, mesh, axes,
                                                      microbatches),
                                          microbatches)
    del local
    master = params if master is None else master
    if grad_shardings is None:
        grad_shardings = tree_map(lambda m: m.placements, master)
    else:
        grad_shardings = tree_map(lambda sh: sh.placements, grad_shardings)

    def reduce(g, pl, target, m):
        src = [Partial() if a in axes else p for a, p in zip(names, pl)]
        d = DTensor.from_local(g, mesh, src, run_check=False)
        d = d.redistribute(mesh, target)
        if tuple(target) != tuple(m.placements):
            d = d.redistribute(mesh, m.placements)
        local = d.to_local()
        return local / n if n > 1 else local

    local_grads = tree_map(reduce, grads, compute, grad_shardings, master)
    del grads

    def mean(v):                   # over the ranks the batch is split across
        if n == 1:
            return v
        v = v.clone()
        dist.all_reduce(v, group=group)
        return v / n

    out = {"loss": mean(loss)}
    for k, v in metrics.items():
        if v.dim() == 0:
            out[k] = mean(v)
    return out.pop("loss"), out, local_grads, axes


def sharded_step(model: LM, opt_cfg: AdamWConfig, params, opt_state, batch,
                 microbatches: int = 1, grad_shardings=None):
    """The step on DTensor params and optimizer state, computed on local
    tensors, tensor-parallel over the mesh's ``model`` axis:

      1. the params are gathered over the data axes (an all-gather where
         ZeRO-3 shards them there) and keep their ``model`` shards, but for
         the leaves the plan computes whole (``tp_view``), gathered over
         ``model`` too;
      2. the model runs on the rank's shards (``LM.tensor_parallel``: its
         products' shares, the collectives over ``model`` inside) on its
         share of the batch, split over the axes of ``data_split`` (every
         model and batch: an MoE layer's dispatch groups shared over them
         through ``rows_group``, a ``loss_mask``'s count taken over the
         whole batch);
      3. the grads, model-local as the params were, are reduced over the
         split axes to the optimizer's placements (a reduce-scatter where
         the optimizer leaf is sharded over them, an all-reduce elsewhere)
         and divided by their size; a leaf computed whole takes its
         ``model`` shard of its grad (``sharded_grads``);
      4. ``adamw_update`` runs on each rank's shards with the global norm
         (the shards' squared sums all-reduced, a shard replicated over
         any mesh axis, ``model`` included, counted once); the updated
         shards, gathered to the params' placements, become the new
         params."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = tree_leaves(params)[0].device_mesh
    master = opt_state["master"]
    loss, metrics, local_grads, axes = sharded_grads(
        model, params, batch, microbatches, grad_shardings, master)

    def sq(g, m):
        copies = math.prod(s for s, p in zip(mesh.shape, m.placements)
                           if p == Replicate())
        t = torch.sum(torch.square(g.to(torch.float32)))
        return t / copies if copies > 1 else t

    sq_sum = sum(tree_leaves(tree_map(sq, local_grads, master)))
    dist.all_reduce(sq_sum)        # the mesh spans the world
    gnorm = torch.sqrt(sq_sum)

    local_state = {k: tree_map(lambda t: t.to_local(), opt_state[k])
                   for k in ("master", "m", "v")}
    local_state["step"] = opt_state["step"].to_local()
    pdtype = tree_map(lambda p: p.dtype, params)
    new_local = tree_map(lambda m, dt: torch.empty_like(m, dtype=dt),
                         local_state["master"], pdtype)
    _, local_state, om = adamw_update(opt_cfg, local_grads, local_state,
                                      new_local, grad_norm=gnorm)
    opt_state["step"] = DTensor.from_local(local_state["step"], mesh,
                                           opt_state["step"].placements,
                                           run_check=False)
    params = tree_map(
        lambda p, new, m: DTensor.from_local(new, mesh, m.placements,
                                             run_check=False
                                             ).redistribute(mesh, p.placements),
        params, new_local, master)
    return params, opt_state, {"loss": loss, **metrics, **om,
                               "data_split": bool(axes)}


def make_serve_steps(model: LM, *, enc_len: int = 0):
    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)

    def decode_step(params, tokens, position, cache):
        return model.decode_step(params, tokens, position, cache,
                                 enc_len=enc_len)

    return prefill_step, decode_step


def serve_split(mesh, tokens) -> tuple:
    """The mesh axes a serve step splits its rows over: those that shard
    the cache's rows (``batch_entry``), for every model. An MoE layer's
    dispatch groups stay the whole step's tokens: where they do not fall
    into whole groups a rank, its ranks share their routing
    (``models/moe.py``), so the split changes no result."""
    return _batch_axes(mesh, tokens.shape[0])


def serve_on_mesh(model: LM, kind: str, params, cache, batch: dict, mesh, *,
                  enc_len: int = 0):
    """``make_serve_steps``' prefill or decode step on DTensor params and
    cache, tensor-parallel over ``model`` as ``sharded_step`` runs a train
    step: the params gathered over the data axes with their ``model``
    shards kept (``tp_view``, which reads the cache's layout too); this
    rank's rows of the batch and the cache (the axes that shard the cache's
    rows, ``serve_split``; an MoE layer's routing shared over them,
    ``rows_group``, so its dispatch groups are the whole step's); the
    cache's ``model`` shards kept where the layer computes on
    them (``tensor_parallel.cache_kept``: heads of a head-parallel layer,
    a sequence slice of every kv head or of MLA's latents, the heads or
    channels of a recurrent mixer's state) and gathered elsewhere, a rank then
    keeping its shard of the result. ``batch`` holds ``tokens`` and, for a
    prompt, the embeddings of a vision prefix or an encoder's frames
    (``vision_embeds``, ``audio_embeds``; ``enc_len``: the frames a decode
    step's cross-attention reads), split with the rows of ``tokens``; for a
    decode step, ``position``. → (the logits of the rank's rows, whole over
    the vocab; the new cache as DTensors). A cache sharded by sequence decodes on any engine:
    the decode kernel returns each row's log-sum-exp, and the ranks merge
    their slices."""
    from torch.distributed.tensor import DTensor, Replicate
    names = mesh.mesh_dim_names
    axes = serve_split(mesh, batch["tokens"])

    tp_model, compute = tp_view(model, params, mesh, cache, rows_group(mesh, axes))
    prefill_step, decode_step = make_serve_steps(tp_model, enc_len=enc_len)
    plan = tp_model.tp

    def kept(path, c):
        model_kept = tpm.cache_kept(plan, path)
        return tuple(p if (a in axes or (a == "model" and model_kept)) else Replicate()
                     for a, p in zip(names, c.placements))

    cache_pl = map_with_path(kept, cache)
    local_p = tree_map(lambda p, pl: p.redistribute(mesh, pl).to_local(),
                       params, compute)
    local_c = tree_map(lambda c, pl: c.redistribute(mesh, pl).to_local(),
                       cache, cache_pl)
    rows = split_batch(batch, mesh, tuple(axes))
    with torch.no_grad():
        if kind == "prefill":
            logits, local_c = prefill_step(local_p, rows, local_c)
        else:
            logits, local_c = decode_step(local_p, rows["tokens"],
                                          rows["position"], local_c)
    new = tree_map(lambda c, l, pl: DTensor.from_local(
        l, mesh, pl, run_check=False).redistribute(mesh, c.placements),
        cache, local_c, cache_pl)
    return logits, new


def init_train_state(model: LM, opt_cfg: AdamWConfig,
                     gen: torch.Generator) -> tuple:
    params = model.init_params(gen)
    return params, adamw_init(opt_cfg, params)
