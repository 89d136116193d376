"""Tensor parallelism over the mesh's ``model`` axis: the port's
counterpart of what XLA's SPMD partitioner does for the reference's
products.

The reference shards each weight over ``model`` (``param_pspecs``) and XLA
partitions every product over those shards, so a rank computes its share of
each projection. Here the model code does it by hand on the rank's local
shards (Megatron-LM's scheme), reading the layouts the sharding rules gave
the params and the cache, never inventing its own:

* a column-parallel product (q, k, v, gate, up, the unembed) takes a
  replicated input through ``copy_to_model`` (identity forward, all-reduce
  backward) and yields this rank's columns; a row-parallel product (o,
  down) takes those columns and sums the ranks' partial outputs with
  ``reduce_from_model`` (all-reduce forward, identity backward), in f32,
  the bias added once after the sum;
* ``gather_columns`` (all-gather forward, reduce-scatter backward) gives a
  rank the k/v weight columns its q heads read where the rules split a kv
  head between ranks;
* the vocab-parallel embedding looks up the rows a rank holds and sums the
  ranks' rows; the loss's log-sum-exp and gold logit are taken over the
  ranks' vocab shards (``vocab_logsumexp``, ``vocab_gold``);
* an MoE layer's experts are sharded (expert parallelism): each rank runs
  its experts on the replicated tokens and the partial combines are summed;
* a decode step over a cache sharded over its sequence (a ring cache's
  slots too) attends each rank's slice, the decode kernel returning each
  row's log-sum-exp, and merges the partial softmaxes (``merge_partials``);
* MLA runs its heads (q_up, k_up, v_up column-parallel, o row-parallel;
  the latents whole on every rank, their sequence-sharded cache decoded
  over every head and merged); RWKV-6 its heads (r, k, v, g, the decay's
  wB, the wkv state and group norm; o and the channel mix's cm_v
  row-parallel, cm_v's sum reduce-scattered to meet cm_r's columns, the
  product gathered back, ``gather_from_model``); Mamba its channels (the
  conv, dt_proj, the scan and its state; x_proj and out_proj
  row-parallel), in_proj's column block of ``[x | z]`` routed to the
  rank's channels of both halves (``route_channels``).

* a GQA attention whose q heads do not split into whole GQA groups a rank
  (``head_parallel``), or whose rank's column block of k is not inside the
  kv heads its q heads read (``_blocks_contained``), runs on column blocks
  (``column_block``): q, k and v column-parallel on the rank's own block
  of the rules' shards, o row-parallel on its rows; the activations'
  blocks are gathered (``gather_blocks``: all-gather forward,
  reduce-scatter backward), each rank attends the q heads that overlap its
  block (``head_groups``: one flash launch, or one a kv head where they
  straddle GQA groups) and keeps its block of the result. Activations
  move, never weights.
* a step whose batch rows are split over data ranks (``RowsGroup``)
  shares an MoE layer's dispatch groups over them: the expert ids and
  outputs all-gathered (``gather_rows``: reduce-scatter backward), the
  capacity rows reduce-scattered (``reduce_scatter_rows``: all-gather
  backward).

A leaf the rules replicate over ``model`` is computed whole, as XLA would.
A mixer whose sharded leaves do not split on agreeing head or channel
boundaries gathers its leaves over ``model`` and computes whole; ``plan``
names every leaf it gathers and why. Every collective runs on the model
group, including a group of one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import LayerSpec
from repro_torch.distributed.sharding import map_with_path, model_role_dim

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """The ranks of one ``model`` row of the mesh: its process group, this
    rank's coordinate on the axis and the axis' size."""
    group: Any
    rank: int
    size: int

    @classmethod
    def of(cls, mesh) -> "ModelGroup":
        i = mesh.mesh_dim_names.index("model")
        return cls(mesh.get_group("model"), mesh.get_local_rank("model"),
                   mesh.shape[i])


@dataclasses.dataclass(frozen=True)
class RowsGroup:
    """The data ranks a step splits its batch rows over (a train step's
    ``sharded_step``, a serve step's ``serve_on_mesh``): their process
    group, this rank's block of the rows (its coordinate on the split axes,
    pod-major, as ``train/step.py: split_batch`` cuts the batch, which is
    its rank in the group) and the number of blocks. Only an MoE layer
    reads it (``models/moe.py``): its dispatch groups are the whole step's
    tokens, in the order of the blocks."""
    group: Any
    rank: int
    size: int


def _gather_rows(x: torch.Tensor, rows: RowsGroup) -> torch.Tensor:
    out = x.new_zeros((rows.size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=rows.group)
    return out


def _reduce_scatter_rows(x: torch.Tensor, rows: RowsGroup) -> torch.Tensor:
    out = x.new_empty((x.shape[0] // rows.size, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), group=rows.group)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows):
        ctx.rows = rows
        return _gather_rows(x, rows)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter_rows(grad, ctx.rows), None


class _ReduceScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows):
        ctx.rows = rows
        return _reduce_scatter_rows(x, rows)

    @staticmethod
    def backward(ctx, grad):
        return _gather_rows(grad, ctx.rows), None


def gather_rows(x: torch.Tensor, rows: RowsGroup) -> torch.Tensor:
    """The ranks' ``x`` stacked along dim 0 in the order of their blocks;
    where ``x`` needs a gradient, each rank's gradient is the sum over the
    ranks of its block of theirs (a reduce-scatter). The result starts as
    zeros: a group that moves no data (the dry-run's fake one) leaves valid
    indices in a gather of ids, which carries no gradient."""
    return _GatherRows.apply(x, rows)


def reduce_scatter_rows(x: torch.Tensor, rows: RowsGroup) -> torch.Tensor:
    """x: (size · m, ...) → the sum over the ranks of this rank's block of
    m along dim 0; its gradient all-gathered back to every rank."""
    return _ReduceScatterRows.apply(x, rows)


def _all_reduce(x: torch.Tensor, mg: ModelGroup, op=dist.ReduceOp.SUM):
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=mg.group)
    return out


def _all_gather(x: torch.Tensor, mg: ModelGroup, dim: int) -> torch.Tensor:
    """The ranks' ``x`` side by side along ``dim``, in rank order."""
    dim = dim % x.dim()
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((mg.size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=mg.group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, mg: ModelGroup, dim: int) -> torch.Tensor:
    """The sum over ranks of ``x``, this rank's block of it along ``dim``."""
    dim = dim % x.dim()
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // mg.size, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=mg.group)
    return out.movedim(0, dim)


# ------------------------------------------------- Megatron's two operators
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mg), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        return _all_reduce(x, mg)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ReduceScatterLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return _reduce_scatter(x, mg, -1)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.mg, -1), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg, ctx.n = mg, x.shape[-1]
        return _all_gather(x, mg, -1)

    @staticmethod
    def backward(ctx, grad):
        r, n = ctx.mg.rank, ctx.n
        return grad[..., r * n:(r + 1) * n].contiguous(), None


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg, dim):
        ctx.mg, ctx.dim = mg, dim
        return _all_gather(x, mg, dim)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.mg, ctx.dim), None, None


def copy_to_model(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """Before a column-parallel product: ``x`` itself; its gradient summed
    over the model ranks."""
    return _CopyToModel.apply(x, mg)


def reduce_from_model(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """After a row-parallel product: the ranks' partial ``x`` summed; the
    gradient passed through."""
    return _ReduceFromModel.apply(x, mg)


def reduce_scatter_from_model(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """After a row-parallel product whose output a rank reads only in its
    block of the last dim: the ranks' partial ``x`` summed, this rank's
    block of the sum (its gradient all-gathered back)."""
    return _ReduceScatterLast.apply(x, mg)


def gather_from_model(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """The ranks' blocks of an activation joined along the last dim, where
    what follows is replicated over the ranks: the gradient, the same on
    every rank, gives each rank its own block back."""
    return _GatherFromModel.apply(x, mg)


def gather_columns(w: torch.Tensor, mg: ModelGroup, dim: int = -1) -> torch.Tensor:
    """The ranks' column shards of a weight joined along ``dim``; the
    gradient of the whole reduce-scattered back to the shards."""
    return _GatherColumns.apply(w, mg, dim)


def gather_blocks(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """The ranks' column blocks of an activation joined along the last dim,
    where each rank goes on with a part of the whole of its own (a column
    block attention's heads): the ranks' partial gradients of the whole
    summed and reduce-scattered back to the blocks. Contiguous, so that
    its heads keep the layout the kernels' tensor-core variants read."""
    return gather_columns(x, mg).contiguous()


def col_input(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """A column-parallel product's input. Under autograd the input is
    widened to f32 first (the ref engine's product widens it anyway), so
    its gradient is summed over the ranks in f32 and rounds once, as one
    device rounds each product's input gradient."""
    if torch.is_grad_enabled() and x.requires_grad:
        return copy_to_model(x.float(), mg)
    return x


def gather_last(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """The ranks' shards joined along the last dim (serving: the vocab
    shards of the logits, the heads of one decode row); no gradient."""
    return _all_gather(x, mg, -1)


def gather_heads(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """The ranks' heads joined along dim 1, (B, H, ...) (serving: MLA's
    absorbed queries; no gradient)."""
    return _all_gather(x, mg, 1)


def all_to_all(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """``x[r]`` to rank r; → ``out[r]`` from rank r (serving; no
    gradient)."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=mg.group)
    return out


def _route_plan(r: int, m: int) -> tuple:
    """Rank r's column block of a ``[a | b]`` product whose two halves each
    split over m ranks: its two units (global units 2r, 2r + 1 of 2m) go
    to the ranks that own their channels (unit j < m: rank j's part of a;
    j >= m: rank j − m's part of b). → (r's units in the order it sends
    them, by destination; the units it sends to each rank; the units it
    receives from each rank, a's before b's)."""
    def dest(j):
        return j if j < m else j - m
    order = sorted((0, 1), key=lambda e: (dest(2 * r + e), e))
    send = [sum(dest(2 * r + e) == q for e in (0, 1)) for q in range(m)]
    recv = [sum(src == q for src in (r // 2, (m + r) // 2)) for q in range(m)]
    return order, send, recv


def _route(x: torch.Tensor, mg: ModelGroup, inverse: bool) -> torch.Tensor:
    c = x.shape[-1] // 2
    order, send, recv = _route_plan(mg.rank, mg.size)
    t = x.movedim(-1, 0)
    if inverse:
        send, recv = recv, send
    else:
        t = torch.cat([t[e * c:(e + 1) * c] for e in order])
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, [n * c for n in recv], [n * c for n in send],
                           group=mg.group)
    if inverse:
        back = [None, None]
        for i, e in enumerate(order):
            back[e] = out[i * c:(i + 1) * c]
        out = torch.cat(back)
    # contiguous, so that a routed weight keeps the layout the GEMM's
    # tensor-core variant reads
    return out.movedim(0, -1).contiguous()


class _RouteChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return _route(x, mg, inverse=False)

    @staticmethod
    def backward(ctx, grad):
        return _route(grad, ctx.mg, inverse=True), None


def route_channels(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """x's last dim is this rank's column block of ``[a | b]`` (both halves
    n wide, the 2n columns split over the ranks in blocks of 2n/m): →
    this rank's channels of both halves, ``[a_r | b_r]`` (each n/m, the
    channels [r·n/m, (r+1)·n/m)), by one all-to-all; the gradient routed
    back. Mamba's in_proj takes it on its product or on its weight
    columns (the same columns either way)."""
    return _RouteChannels.apply(x, mg)


# ------------------------------------------------------ vocab parallelism
def vocab_embed(table: torch.Tensor, tokens: torch.Tensor,
                mg: ModelGroup) -> torch.Tensor:
    """Rows of a table whose rows are sharded over the model ranks: each
    rank looks up the ids it holds, zeroes the rest, and the ranks' rows
    are summed (one rank holds each id)."""
    rows = table.shape[0]
    local = tokens.long() - mg.rank * rows
    inside = (local >= 0) & (local < rows)
    out = table[local.clamp(0, rows - 1)]
    out = torch.where(inside[..., None], out, torch.zeros_like(out))
    return reduce_from_model(out, mg)


class _VocabLogSumExp(torch.autograd.Function):
    """log Σ exp over the ranks' vocab shards of the last dim, in
    ``torch.logsumexp``'s arithmetic (max, shifted exp sum, log, max
    added back) and with its backward, ``grad · exp(x − lse)`` on the
    rank's own logits."""

    @staticmethod
    def forward(ctx, lg, mg):
        m = lg.amax(dim=-1, keepdim=True)
        m = _all_reduce(m, mg, dist.ReduceOp.MAX)
        m.masked_fill_(m.abs() == math.inf, 0)
        s = _all_reduce(torch.sum(torch.exp(lg - m), dim=-1), mg)
        lse = s.log_().add_(m[..., 0])
        ctx.save_for_backward(lg, lse)
        return lse

    @staticmethod
    def backward(ctx, grad):
        lg, lse = ctx.saved_tensors
        return grad[..., None] * (lg - lse[..., None]).exp(), None


def vocab_logsumexp(lg: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    return _VocabLogSumExp.apply(lg, mg)


def vocab_gold(lg: torch.Tensor, targets: torch.Tensor,
               mg: ModelGroup) -> torch.Tensor:
    """``lg[..., targets]`` where the last dim is this rank's vocab shard:
    the rank that holds a target gives its logit, the others 0, summed."""
    v = lg.shape[-1]
    local = targets.long() - mg.rank * v
    inside = (local >= 0) & (local < v)
    gold = torch.gather(lg, -1, local.clamp(0, v - 1)[..., None])[..., 0]
    gold = torch.where(inside, gold, torch.zeros_like(gold))
    return reduce_from_model(gold, mg)


# ------------------------------------ decode over a sequence-sharded cache
def partial_decode_attention(q, k, v, lo, hi, *, softcap=None, scale=None):
    """Decode attention of q (B, Hq, D) over the keys [lo, hi) (each (B,),
    local positions) of k, v (B, Hkv, S, D): (out (B, Hq, D) f32, lse (B,
    Hq) f32); a sequence with no key there has out 0 and lse −inf.
    Plain PyTorch."""
    b, hq, d = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, hkv, hq // hkv, d)
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    cols = torch.arange(s_len, device=q.device)[None, None, None, :]
    mask = (cols >= lo[:, None, None, None]) & (cols < hi[:, None, None, None])
    s = torch.where(mask, s, torch.full_like(s, -math.inf))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v.float()) / torch.clamp(l, min=1e-30)
    lse = (m_safe + torch.log(l))[..., 0]          # −inf where l is 0
    return out.reshape(b, hq, d), lse.reshape(b, hq)


def merge_partials(out: torch.Tensor, lse: torch.Tensor,
                   mg: ModelGroup) -> torch.Tensor:
    """The softmax over every rank's keys from the ranks' partial (out,
    lse): the largest lse (an all-reduce MAX), then the weighted outputs
    and their weights summed (one all-reduce SUM)."""
    m = _all_reduce(lse, mg, dist.ReduceOp.MAX)
    w = torch.exp(lse - m)                               # 0 for an empty rank
    both = torch.cat([out * w[..., None], w[..., None]], dim=-1)
    both = _all_reduce(both, mg)
    return both[..., :-1] / both[..., -1:]


# ------------------------------------------------------------------ plans
def head_parallel(n_heads: int, n_kv_heads: int, m: int) -> bool:
    """Whether a layer's attention splits by heads over ``m`` ranks: the q
    heads divide, and a rank's q heads cover whole GQA groups or sit inside
    one group."""
    if n_heads % m:
        return False
    per, group = n_heads // m, n_heads // n_kv_heads
    return per % group == 0 or group % per == 0


def head_ranges(n_heads: int, n_kv_heads: int, rank: int, m: int) -> tuple:
    """(q0, nq, k0, nk): a rank's q heads [q0, q0 + nq) and the kv heads
    [k0, k0 + nk) they read, under ``head_parallel``."""
    nq = n_heads // m
    group = n_heads // n_kv_heads
    q0 = rank * nq
    return q0, nq, q0 // group, max(1, nq // group)


def column_block(n_heads: int, n_kv_heads: int, hd: int, rank: int,
                 m: int) -> tuple:
    """(c0, c, q0, nq, k0, nk): rank r's column block [c0, c0 + c) of q's
    H·hd columns (c = H·hd/m, c0 = r·c), the q heads [q0, q0 + nq) that
    overlap it (⌊c0/hd⌋ … ⌈(c0 + c)/hd⌉ − 1) and the kv heads [k0, k0 + nk)
    those read."""
    c = n_heads * hd // m
    c0 = rank * c
    group = n_heads // n_kv_heads
    q0, q1 = c0 // hd, -(-(c0 + c) // hd)
    k0, k1 = q0 // group, (q1 - 1) // group + 1
    return c0, c, q0, q1 - q0, k0, k1 - k0


def head_groups(q0: int, nq: int, k0: int, nk: int, group: int) -> tuple:
    """The attention launches that cover q heads [q0, q0 + nq) over kv
    heads [k0, k0 + nk), GQA groups of ``group`` q heads: ((q0', nq', k0',
    nk'), ...). One where the kernel's map of local q head i to local kv
    head i // (nq / nk) holds: the heads are whole groups, or inside one;
    else one a kv head, over the q heads of its group in the range (the
    heads straddle groups)."""
    if nk == 1 or (q0 % group == 0 and nq % group == 0):
        return ((q0, nq, k0, nk),)
    out = []
    for k in range(k0, k0 + nk):
        lo, hi = max(q0, k * group), min(q0 + nq, (k + 1) * group)
        out.append((lo, hi - lo, k, 1))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class AttnTP:
    """How one attention (self or cross) of a layer runs: ``heads`` (this
    rank's q heads, o row-parallel), ``blocks`` (this rank's column block
    of q, k, v and rows of o, the activations' blocks gathered:
    ``column_block``) or whole (neither); ``kv``, where a rank's kv
    columns come from under ``heads``: its own shard (``local``) or the
    ranks' shards gathered (``gather``); ``cache``, the layout of its cache
    over ``model`` that it computes on while serving: ``heads``, ``seq``
    or ``whole``."""
    mg: ModelGroup
    heads: bool
    kv: str = "local"
    cache: str = "whole"
    blocks: bool = False


@dataclasses.dataclass(frozen=True)
class BlockTP:
    """One pattern position's plan: its attention or MLA and its
    cross-attention (None where the block has none), the dense FFN
    column/row-parallel, the MoE experts sharded, a Mamba or RWKV-6 mixer
    on the rank's channels or heads (``mixer``); an MoE block's ``rows``
    where a train or serve step splits its batch rows over more than one
    data rank (None elsewhere)."""
    mg: ModelGroup
    attn: Optional[AttnTP]
    cross: Optional[AttnTP]
    ffn: bool
    experts: bool
    mixer: bool = False
    rows: Optional[RowsGroup] = None


@dataclasses.dataclass(frozen=True)
class ModelTP:
    """The model's plan: the embedding's and the unembedding's tables
    vocab-parallel, a ``BlockTP`` per pattern position and one for the
    encoder's layers, the leaves gathered over ``model`` (path: why), and
    each layer's attention choice (path: "heads", "blocks" or why it is
    whole)."""
    mg: ModelGroup
    embed: bool
    unembed: bool
    blocks: tuple
    enc: Optional[BlockTP]
    gathered: dict
    choices: dict


# each mixer's params' key in its block, and what it splits over the ranks
MIXER_SPLIT = {"mla": ("attn", "heads"), "rwkv": ("mixer", "heads"),
               "mamba": ("mixer", "channels")}
# each mixer's state cache leaves, computed on the rank's shard where the
# mixer splits (MLA's latents follow its attention's cache layout)
MIXER_STATE = {"rwkv": ("S",), "mamba": ("ssm", "conv")}


def model_dims(tree: PyTree, mesh) -> dict:
    """path → the tensor dim a leaf's layout shards over ``model`` (None:
    replicated there), read from DTensor placements."""
    i = mesh.mesh_dim_names.index("model")
    out: dict = {}

    def fn(path, t):
        p = t.placements[i]
        out[path] = p.dim if p.is_shard() else None

    map_with_path(fn, tree)
    return out


def _attn_plan(mg, cfg, dims: dict, prefix: str, cache: Optional[str],
               cross: bool = False):
    """(AttnTP, its choice: "heads", "blocks" or why it is whole) of the
    attention under ``prefix`` over a cache laid out by ``cache`` over
    ``model`` (None: no cache, a train step). Head-parallel where
    ``head_parallel`` holds and the cache allows; on column blocks where
    the heads do not split so, or a sequence-sharded cache's slice could
    not be filled from the rank's kv heads (``_blocks_contained``). A
    layer on column blocks or whole keeps a self-attention's cache sharded
    by sequence; any other sharded cache is gathered for it."""
    seq = "seq" if cache == "seq" and not cross else "whole"
    if dims.get(f"{prefix}/q/w") is None or dims.get(f"{prefix}/k/w") is None:
        return AttnTP(mg, False, cache=seq), "whole: q or k replicated by the rules"
    blocks = AttnTP(mg, False, cache=seq, blocks=True), "blocks"
    if not head_parallel(cfg.n_heads, cfg.n_kv_heads, mg.size):
        return blocks
    hd = cfg.resolved_head_dim
    _, _, k0, nk = head_ranges(cfg.n_heads, cfg.n_kv_heads, mg.rank, mg.size)
    cols = cfg.n_kv_heads * hd // mg.size
    kv = "local" if (k0 * hd, nk * hd) == (mg.rank * cols, cols) else "gather"
    if cache is not None and cache not in (("heads",) if cross
                                           else ("heads", "seq")):
        return (AttnTP(mg, False, cache=seq),
                f"whole: its cache is laid out by {cache} over model")
    if cache == "seq" and not _blocks_contained(cfg, mg.size):
        return blocks
    return AttnTP(mg, True, kv, cache or "whole"), "heads"


def _blocks_contained(cfg, m: int) -> bool:
    """Whether every rank's column block of k lies inside the kv heads its
    q heads read (the prefill's all-to-all sends that block)."""
    hd = cfg.resolved_head_dim
    cols = cfg.n_kv_heads * hd // m
    for r in range(m):
        _, _, k0, nk = head_ranges(cfg.n_heads, cfg.n_kv_heads, r, m)
        if not (k0 * hd <= r * cols and (r + 1) * cols <= (k0 + nk) * hd):
            return False
    return True


def _mixer_units(cfg, kind: str) -> int:
    """The heads (MLA, RWKV-6) or channels (Mamba) a mixer splits."""
    if kind == "mla":
        return cfg.n_heads
    if kind == "rwkv":
        return cfg.d_model // cfg.rwkv.head_size
    return cfg.mamba.expand * cfg.d_model


def _mixer_plan(mg, cfg, kind: str, dims: dict, prefix: str,
                cache_dims: Optional[dict], j: Optional[int]):
    """Why the mixer under ``prefix`` computes whole, or None where it
    runs on the rank's heads or channels: they divide over the ranks, the
    rules shard every leaf of it on the dim they name for ``model``
    (``model_role_dim``), and while serving its state cache
    (``MIXER_STATE``) is sharded too."""
    units, split = _mixer_units(cfg, kind), MIXER_SPLIT[kind][1]
    why = []
    if units % mg.size:
        why.append(f"{units} {split} do not divide over {mg.size} ranks")
    off = [path[len(prefix) + 1:] for path, d in dims.items()
           if path.startswith(prefix + "/")
           and model_role_dim(path) not in (None, d)]
    if off:
        why.append(f"the rules replicate {', '.join(off)}")
    if not why and cache_dims is not None and j is not None:
        bad = [n for n in MIXER_STATE.get(kind, ())
               if cache_dims.get(f"{j}/{n}") is None]
        if bad:
            why.append(f"its cache {', '.join(bad)} is not sharded by its {split}")
    return "; ".join(why) or None


def cache_kept(tp: "ModelTP", path: str) -> bool:
    """Whether a serve step computes on the rank's ``model`` shard of the
    cache leaf at ``path`` ("j/name"): the k/v of a head-parallel layer or
    of one sharded by sequence, MLA's latents sharded by sequence, the
    cross k/v of a head-parallel cross-attention, the state of a Mamba
    (``ssm``, ``conv``: channels) or RWKV-6 (``S``: heads) mixer computing
    on its shards. Every other sharded leaf (RWKV-6's token-shift rows
    among them) is gathered for the step."""
    j, name = path.split("/")
    blk = tp.blocks[int(j)]
    if name in ("k", "v"):
        return blk.attn is not None and (blk.attn.heads or blk.attn.cache == "seq")
    if name in ("c", "kr"):
        return blk.attn is not None and blk.attn.cache == "seq"
    if name in ("xk", "xv"):
        return blk.cross is not None and blk.cross.heads
    if any(name in names for names in MIXER_STATE.values()):
        return blk.mixer
    return False


def plan(cfg, dims: dict, mg: ModelGroup, cache_dims: Optional[dict] = None,
         rows: Optional[RowsGroup] = None) -> ModelTP:
    """The model's plan on the layout ``dims`` (``model_dims`` of the
    params) and, while serving, ``cache_dims`` (of the cache). A layer's
    attention is head-parallel where ``head_parallel`` holds and its q and
    k are sharded, on column blocks where they are sharded but the heads
    do not split so (``_attn_plan``), else whole, its leaves sharded over
    ``model`` gathered. While serving, a cross-attention runs
    head-parallel only over a cache sharded by heads, and a
    self-attention over one sharded by heads or by sequence. An MLA, RWKV-6 or Mamba mixer runs on its heads or channels
    where ``_mixer_plan`` finds its leaves (and state cache) laid out so,
    else whole, its sharded leaves gathered; MLA keeps a latent cache
    sharded by sequence either way. ``rows``: the data ranks a train or
    serve step splits its batch rows over, handed to the MoE blocks."""
    gathered: dict = {}
    choices: dict = {}

    def gather_under(prefix: str, why: str):
        for path, d in dims.items():
            if path.startswith(prefix + "/") and d is not None:
                gathered[path] = why

    def cache_mode(j: int, name: str) -> Optional[str]:
        if cache_dims is None:
            return None
        d = cache_dims.get(f"{j}/{name}")
        if d is None:
            return "whole"
        # k, v (L, B, Hkv, S, hd); MLA's c (L, B, S, r)
        return ({2: "seq"} if name == "c" else {2: "heads", 3: "seq"})[d]

    def mixer(prefix: str, j: Optional[int], spec) -> tuple:
        key, split = MIXER_SPLIT[spec.kind]
        root = f"{prefix}/{key}"
        why = _mixer_plan(mg, cfg, spec.kind, dims, root, cache_dims, j)
        if why:
            gather_under(root, why)
        choices[root] = f"whole: {why}" if why else split
        if spec.kind != "mla":
            return None, why is None
        cm = cache_mode(j, "c") if j is not None else None
        return AttnTP(mg, why is None, cache="seq" if cm == "seq" else "whole"), False

    def attention(root: str, cm: Optional[str], cross: bool = False) -> AttnTP:
        tp, choice = _attn_plan(mg, cfg, dims, root, cm, cross)
        if choice.startswith("whole"):
            gather_under(root, choice[len("whole: "):])
        choices[root] = choice
        return tp

    def block(prefix: str, j: Optional[int], spec) -> BlockTP:
        attn = cross = None
        on_shards = False
        if spec.kind in MIXER_SPLIT:
            attn, on_shards = mixer(prefix, j, spec)
        else:
            cm = cache_mode(j, "k") if j is not None else None
            attn = attention(f"{prefix}/attn", cm)
            if f"{prefix}/cross/q/w" in dims:
                cm = cache_mode(j, "xk") if j is not None else None
                cross = attention(f"{prefix}/cross", cm, cross=True)
        ffn = dims.get(f"{prefix}/ffn/down/w") is not None
        experts = dims.get(f"{prefix}/ffn/gate") is not None
        return BlockTP(mg, attn, cross, ffn, experts, on_shards,
                       rows if spec.moe else None)

    blocks = tuple(block(f"blocks/{j}", j, spec)
                   for j, spec in enumerate(cfg.pattern))
    enc = block("enc_blocks/0", None, LayerSpec(kind="attn")) if cfg.enc_dec else None
    unembed = "unembed/table" if "unembed/table" in dims else "embed/table"
    return ModelTP(mg, dims.get("embed/table") is not None,
                   dims.get(unembed) is not None, blocks, enc, gathered, choices)


def compute_placements(tree: PyTree, mesh, gathered) -> PyTree:
    """Each DTensor leaf's placements for compute: replicated over the
    data axes, its ``model`` placement kept, or replicated there too where
    its path is in ``gathered``."""
    from torch.distributed.tensor import Replicate
    i = mesh.mesh_dim_names.index("model")

    def fn(path, t):
        out = [Replicate()] * len(t.placements)
        if path not in gathered:
            out[i] = t.placements[i]
        return tuple(out)

    return map_with_path(fn, tree)


