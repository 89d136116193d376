"""Sharding rules: logical model axes → mesh axes (MaxText-style, by path)
(counterpart of repro.distributed.sharding).

Meshes: single-pod ``("data", "model") = (16, 16)``; multi-pod adds a leading
``"pod"`` axis that joins the data-parallel group. Rules are
divisibility-aware: a dim that doesn't divide by the candidate axis size falls
back to the next candidate (or replication), so the same rules drive every
(arch × shape) cell, including awkward ones (e.g. 8 KV heads on a 16-way
model axis → the cache shards its sequence dim instead).

Three parameter modes:
  * tp        — weights TP-sharded over "model", replicated over data
  * fsdp      — additionally shard the largest replicated dim over "data"
                (ZeRO-3 for params; required for ≥ 17B assigned archs)
Optimizer state always gets the fsdp treatment (ZeRO-1 minimum).

A spec is the reference's ``PartitionSpec``, entry for entry: one entry per
tensor dim, each ``None``, an axis name or a tuple of names (``P`` below).
The rules read only the mesh's axis names and sizes, so they take a
``DeviceMesh`` or an ``{axis: size}`` mapping. ``to_shardings`` turns each
spec into DTensor placements, one per mesh dim: ``Shard(d)`` on every mesh
dim that names tensor dim ``d``, ``Replicate()`` elsewhere; a tuple of axes
shards the dim over each of them in mesh order (pod-major, as JAX orders
``P(("pod", "data"))``).

``torch.distributed.tensor`` is imported where it is used: the models call
``constrain`` and ``batch_mean``, and that import costs a second.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import sys
from collections.abc import Mapping
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

PyTree = Any


class P(tuple):
    """A partition spec: one entry per tensor dim (``None``, an axis name or
    a tuple of axis names), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P({', '.join(map(repr, self))})"


class _Unconstrained:
    def __repr__(self):
        return "UNCONSTRAINED"


UNCONSTRAINED = _Unconstrained()   # constrain: leave the dim as it is


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis: size} of a DeviceMesh, or the mapping itself."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh) -> tuple[str, ...]:
    names = mesh_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _fits(dim: int, mesh, axes) -> bool:
    return dim % axis_size(mesh, axes) == 0


def shard_dim(dim: int, mesh, candidates) -> Optional[Any]:
    """First candidate axis (or axis tuple) whose size divides ``dim``."""
    for c in candidates:
        if c is None:
            return None
        if _fits(dim, mesh, c):
            return c
    return None


# --------------------------------------------------------------------- params
# (regex on the param path, per-dim logical role). Roles: "model" candidates
# try TP; "fsdp" dims are where ZeRO sharding lands.
_PARAM_RULES: list[tuple[str, tuple[str, ...]]] = [
    (r"embed/table$", ("model", "fsdp")),          # (V, d): vocab-TP
    (r"unembed/table$", ("model", "fsdp")),
    (r"(attn|cross)/(q|k|v)/w$", ("fsdp", "model")),   # (d, H*hd): head-TP
    (r"(attn|cross)/(q|k|v)/b$", ("model",)),
    (r"(attn|cross)/o/w$", ("model", "fsdp")),         # (H*hd, d)
    (r"(attn|cross)/o/b$", (None,)),
    # --- MLA
    (r"attn/q_down/w$", ("fsdp", None)),
    (r"attn/q_up/w$", (None, "model")),
    (r"attn/kv_down/w$", ("fsdp", None)),
    (r"attn/(k_up|v_up)$", ("model", None, None)),     # (H, r, hd)
    # --- FFN / MoE
    (r"ffn/(gate|up)/w$", ("fsdp", "model")),
    (r"ffn/down/w$", ("model", "fsdp")),
    (r"ffn/(gate|up|down)/b$", (None,)),
    (r"ffn/router/w$", (None, None)),
    (r"ffn/(gate|up)$", ("model", "fsdp", None)),      # (E, d, ff): EP
    (r"ffn/down$", ("model", "fsdp", None)),           # (E, ff, d)
    # --- Mamba
    (r"mixer/in_proj/w$", ("fsdp", "model")),
    (r"mixer/conv_w$", (None, "model")),
    (r"mixer/conv_b$", ("model",)),
    (r"mixer/x_proj/w$", ("model", None)),
    (r"mixer/dt_proj/w$", (None, "model")),
    (r"mixer/dt_bias$", ("model",)),
    (r"mixer/A_log$", ("model", None)),
    (r"mixer/D$", ("model",)),
    (r"mixer/out_proj/w$", ("model", "fsdp")),
    # --- RWKV
    (r"mixer/(r|k|v|g)/w$", ("fsdp", "model")),
    (r"mixer/o/w$", ("model", "fsdp")),
    (r"mixer/(cm_k|cm_r)/w$", ("fsdp", "model")),
    (r"mixer/cm_v/w$", ("model", "fsdp")),
    (r"mixer/wA$", ("fsdp", None)),
    (r"mixer/wB$", (None, "model")),
    (r"mixer/(w0|u)$", ("model",)),
    (r"mixer/ln_scale$", ("model", None)),
    (r"mixer/(mu|cm_mu)$", (None, None)),
]


def map_with_path(fn: Callable, tree: PyTree, prefix: tuple = ()) -> PyTree:
    """``fn(path, leaf)`` over nested dicts/tuples/lists, the path being the
    dict keys and tuple indices joined by "/" (the reference's
    ``_path_str``)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        return type(tree)(map_with_path(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn("/".join(str(p) for p in prefix), tree)


def _spec_for(path: str, shape: tuple[int, ...], mesh, *,
              fsdp: bool, stacked: bool) -> P:
    roles: Optional[tuple] = None
    for pat, r in _PARAM_RULES:
        if re.search(pat, path):
            roles = r
            break
    ndim = len(shape)
    offset = 1 if stacked else 0         # leading n_periods axis
    spec: list = [None] * ndim
    if roles is not None:
        used_data = False
        for i, role in enumerate(roles):
            di = i + offset
            if di >= ndim or role is None:
                continue
            if role == "model":
                if _fits(shape[di], mesh, "model"):
                    spec[di] = "model"
            elif role == "fsdp" and fsdp and not used_data:
                dax = batch_axes(mesh)
                if dax and _fits(shape[di], mesh, dax):
                    spec[di] = dax if len(dax) > 1 else dax[0]
                    used_data = True
    return P(*spec)


def model_role_dim(path: str) -> Optional[int]:
    """The dim of the param at ``path`` that the rules try to shard over
    ``model`` (the stacked period axis counted, as ``param_pspecs`` counts
    it), or None where they name none."""
    for pat, roles in _PARAM_RULES:
        if re.search(pat, path):
            if "model" not in roles:
                return None
            return roles.index("model") + (1 if "blocks" in path else 0)
    return None


def param_pspecs(params: PyTree, mesh, *, fsdp: bool = False) -> PyTree:
    """Spec tree matching ``params`` (any leaves with a ``shape``: tensors,
    meta tensors, DTensors)."""

    def fn(ps, leaf):
        stacked = "blocks" in ps
        return _spec_for(ps, tuple(leaf.shape), mesh, fsdp=fsdp, stacked=stacked)

    return map_with_path(fn, params)


def zero_pspecs(params: PyTree, mesh) -> PyTree:
    """Optimizer-state sharding: params rules + forced fsdp (ZeRO)."""
    return param_pspecs(params, mesh, fsdp=True)


# --------------------------------------------------------------------- batch
def batch_entry(b: int, mesh):
    """The spec entry of a batch dim of ``b``: the batch axes, else the
    last of them, else None, whichever first divides it."""
    bax = batch_axes(mesh)
    ax = shard_dim(b, mesh, [bax, bax[-1:] if bax else None, None])
    if ax is not None and not isinstance(ax, str) and len(ax) == 1:
        ax = ax[0]
    return ax


def batch_pspecs(batch: PyTree, mesh) -> PyTree:
    def fn(_, leaf):
        if leaf.ndim == 0:
            return P()
        return P(batch_entry(leaf.shape[0], mesh), *([None] * (leaf.ndim - 1)))

    return map_with_path(fn, batch)


# --------------------------------------------------------------------- cache
def cache_pspecs(cache: PyTree, mesh) -> PyTree:
    """Decode-cache sharding: batch over data axes; heads over model when
    divisible, else the sequence (page) dim; SSM states shard their channel
    dim. Leaves have a leading n_periods stack axis."""

    def fn(ps, leaf):
        shape = tuple(leaf.shape)    # (n_periods, B, ...)
        spec: list = [None] * len(shape)
        spec[1] = batch_entry(shape[1], mesh)
        if re.search(r"(^|/)(k|v|xk|xv)$", ps):
            # (L, B, Hkv, S, hd)
            if _fits(shape[2], mesh, "model"):
                spec[2] = "model"
            elif _fits(shape[3], mesh, "model"):
                spec[3] = "model"
        elif re.search(r"/(c|kr)$", ps):           # MLA latent (L, B, S, r)
            if _fits(shape[2], mesh, "model"):
                spec[2] = "model"
        elif ps.endswith("/ssm"):                  # (L, B, di, ds)
            if _fits(shape[2], mesh, "model"):
                spec[2] = "model"
        elif ps.endswith("/conv"):                 # (L, B, K-1, di)
            if _fits(shape[3], mesh, "model"):
                spec[3] = "model"
        elif ps.endswith("/S"):                    # rwkv (L, B, H, N, N)
            if _fits(shape[2], mesh, "model"):
                spec[2] = "model"
        elif ps.endswith(("/tm_x", "/cm_x")):      # (L, B, d)
            if _fits(shape[2], mesh, "model"):
                spec[2] = "model"
        return P(*spec)

    return map_with_path(fn, cache)


# ------------------------------------------------------ specs as placements
def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None or entry is UNCONSTRAINED:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: the axes {axes} of dim {d} are not in "
                             f"mesh order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]!r} shards two dims")
            out[i] = Shard(d)
    return tuple(out)


def mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart)."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def distribute(self, t: torch.Tensor):
        """``t`` (the same on every rank of the mesh) as a DTensor of this
        layout on the mesh's device; every rank calls this."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t.detach().to(mesh_device(self.mesh)),
                                 self.mesh, self.placements)


def to_shardings(pspecs: PyTree, mesh) -> PyTree:
    return map_with_path(lambda _, s: NamedSharding(mesh, s), pspecs)


def distribute(tree: PyTree, shardings: PyTree) -> PyTree:
    """Every leaf of ``tree`` distributed by its ``NamedSharding``."""
    flat = {}
    map_with_path(lambda ps, sh: flat.__setitem__(ps, sh), shardings)
    return map_with_path(lambda ps, t: flat[ps].distribute(t), tree)


# ------------------------------------------------- activation constraints
# Without explicit constraints a compiler's sharding propagation may gather
# layer activations across the model axis. The launchers opt in via
# set_activation_mesh(mesh); model code calls constrain(x, "batch", None,
# "model") with logical roles that degrade to replication when a dim doesn't
# divide. The port's train step computes on local tensors, where constrain
# leaves every tensor as it is; on a DTensor it redistributes.
_ACT_MESH = None


def set_activation_mesh(mesh) -> None:
    global _ACT_MESH
    _ACT_MESH = mesh


MIN_CONSTRAIN_ELEMS = 1 << 22   # don't pin small (decode-sized) tensors


def constrain_spec(shape: tuple, roles: tuple, mesh) -> Optional[P]:
    """The spec ``constrain`` pins, or None where it leaves ``x`` alone.

    Roles: "batch" → ("pod","data"); "model" → "model"; None / non-divisible
    dims stay UNCONSTRAINED (never force replication — forcing P(None) on a
    non-divisible head dim was a measured regression in the reference).
    Tensors under ~4M elements are left alone (single-token decode paths
    must not be re-sharded per layer). None outside an activation mesh
    (tests, single-device runs)."""
    if mesh is None or len(shape) != len(roles) or \
            math.prod(shape) < MIN_CONSTRAIN_ELEMS:
        return None
    spec = []
    pinned = False
    for dim, role in zip(shape, roles):
        ax = UNCONSTRAINED
        if role == "batch":
            cand = [batch_axes(mesh), batch_axes(mesh)[-1:], None]
            got = shard_dim(dim, mesh, [c for c in cand if c])
            if got is not None:
                ax = got[0] if len(got) == 1 else got
                pinned = True
        elif role == "model" and _fits(dim, mesh, "model"):
            ax = "model"
            pinned = True
        spec.append(ax)
    return P(*spec) if pinned else None


def constrain(x, *roles):
    """A DTensor on the activation mesh redistributed to ``constrain_spec``
    (a mesh dim it does not name keeps its placement); anything else as it
    is."""
    mesh = _ACT_MESH
    spec = constrain_spec(tuple(x.shape), roles, mesh)
    dtensor = sys.modules.get("torch.distributed.tensor")
    if spec is None or dtensor is None or not isinstance(x, dtensor.DTensor) \
            or x.device_mesh != mesh:
        return x
    pins = placements(spec, mesh)
    new = [p if p != dtensor.Replicate() else old
           for p, old in zip(pins, x.placements)]
    return x.redistribute(mesh, new)


# ---------------------------------------------------- the split batch's stats
# A train step that splits the batch over data ranks computes each rank's
# share of the loss on local tensors. A statistic that the reference takes
# over the whole batch is taken over those ranks while ``batch_split`` is
# open: the MoE aux loss's per-expert means averaged (``batch_mean``), a
# ``loss_mask``'s count summed (``batch_sum``).
_BATCH_GROUP = None


@contextlib.contextmanager
def batch_split(group):
    """While open, ``batch_mean`` averages and ``batch_sum`` sums over
    ``group`` (None: not)."""
    global _BATCH_GROUP
    saved, _BATCH_GROUP = _BATCH_GROUP, group
    try:
        yield
    finally:
        _BATCH_GROUP = saved


class _AllReduceSum(torch.autograd.Function):
    """The sum over a group's ranks, differentiable: each rank's output is
    the same sum, so the gradient of each input is the sum of the outputs'
    gradients over the ranks (an all-reduce again)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks the batch is split across (a
    differentiable all-reduce, every rank of the group in the same order);
    ``x`` itself outside ``batch_split``."""
    group = _BATCH_GROUP
    if group is None:
        return x
    return _AllReduceSum.apply(x, group) / dist.get_world_size(group)


def batch_ranks() -> int:
    """The number of ranks the batch is split across (1 outside
    ``batch_split``)."""
    group = _BATCH_GROUP
    return 1 if group is None else dist.get_world_size(group)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks the batch is split across (an
    all-reduce with no gradient, every rank of the group in the same
    order); ``x`` itself outside ``batch_split``."""
    group = _BATCH_GROUP
    if group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out
