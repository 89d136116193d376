"""GQA attention: forward, prefill-with-cache, single-token decode
(counterpart of repro.models.attention).

Projections run through the engine's xmk0 dispatch; prefill attention goes
through the flash-attention kernel and decode through the cache-resident
decode kernel. Unlike the reference's pure functions, prefill and decode
write the new K/V rows into the cache tensors in place (they are views of
the model's stacked cache) and return them.

With an ``AttnTP`` (``tp``) of a head-parallel layer a rank computes its q
heads and the kv heads they read: q, k, v are column-parallel, o is
row-parallel (``distributed/tensor_parallel.py``). Its cache holds the
rank's kv heads, or, sharded by sequence, the rank's slice of every kv
head (of a ring cache, its slice of the ring's slots): a decode step then
attends each slice, the decode kernel returning each row's log-sum-exp,
and merges the ranks' partial softmaxes.

On column blocks (``tp.blocks``: the q heads do not split into whole GQA
groups a rank) q, k and v are column-parallel on the rank's block of the
rules' shards and o row-parallel on its rows, as above, but the blocks
need not be whole heads: the ranks' blocks of q, k and v are gathered
(``gather_blocks``; no weight moves), each rank attends the q heads that
overlap its block over the kv heads they read, one flash launch where
those heads are whole GQA groups or inside one and one a kv head where
they straddle groups (``tensor_parallel.head_groups``; the kernel maps
local q head i to kv head i // (nq / nk), which a straddling range
breaks), and keeps its block of the output (contiguous) for o. Its cache
is the rules' layout: every kv head, by sequence (each rank's slice
written from the gathered rows) or whole; a decode step attends every q
head (over a sequence slice, merged as above) and keeps its block.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import ArcaneEngine
from repro_torch.distributed.sharding import constrain
from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.models.layers import (apply_rope, dense, dense_col,
                                       dense_init, dense_row)


def attention_init(gen, cfg: ModelConfig, device) -> dict:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    dt = cfg.pdtype
    return {
        "q": dense_init(gen, d, cfg.n_heads * hd, dt, device, bias=cfg.qkv_bias),
        "k": dense_init(gen, d, cfg.n_kv_heads * hd, dt, device, bias=cfg.qkv_bias),
        "v": dense_init(gen, d, cfg.n_kv_heads * hd, dt, device, bias=cfg.qkv_bias),
        "o": dense_init(gen, cfg.n_heads * hd, d, dt, device),
    }


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    out = x.reshape(b, s, n, -1).transpose(1, 2)      # (B, H, S, D) view
    return constrain(out, "batch", "model", None, None)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _heads(tp) -> bool:
    return tp is not None and tp.heads


def _blocks(tp) -> bool:
    return tp is not None and tp.blocks


def _sharded(tp) -> bool:
    """Whether q, k, v run column-parallel and o row-parallel: by heads or
    on column blocks."""
    return _heads(tp) or _blocks(tp)


def _head_ranges(cfg, tp) -> tuple:
    """(q0, nq, k0, nk): the q heads this rank computes and the kv heads
    they read (all of them without a head-parallel ``tp``)."""
    if not _heads(tp):
        return 0, cfg.n_heads, 0, cfg.n_kv_heads
    return tpm.head_ranges(cfg.n_heads, cfg.n_kv_heads, tp.mg.rank, tp.mg.size)


def _column_block(cfg, tp) -> tuple:
    """(c0, c, q0, nq, k0, nk) of this rank on column blocks
    (``tensor_parallel.column_block``)."""
    return tpm.column_block(cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                            tp.mg.rank, tp.mg.size)


def _proj(engine, params, x, tp):
    """q, k or v: the rank's own columns (column-parallel) by heads or on
    column blocks, else whole."""
    if not _sharded(tp):
        return dense(engine, params, x)
    return dense_col(engine, params, x, tp.mg)


def _out(engine, params, x, tp):
    """o: row-parallel by heads or on column blocks, else whole."""
    if not _sharded(tp):
        return dense(engine, params, x)
    return dense_row(engine, params, x, tp.mg)


def _gathered(engine, params, x, tp, n: int) -> torch.Tensor:
    """On column blocks: every head of q, k or v, (B, n, S, hd), from the
    ranks' column blocks of the projection gathered."""
    return _split_heads(tpm.gather_blocks(dense_col(engine, params, x, tp.mg),
                                          tp.mg), n)


def _q(engine, params, cfg, x, tp, every: bool = False) -> torch.Tensor:
    """The q heads this rank attends, (B, nq, S, hd), unrotated: its own
    (head-parallel), on column blocks those that overlap its block (with
    ``every``, all of them), else all."""
    if _blocks(tp):
        q = _gathered(engine, params, x, tp, cfg.n_heads)
        if every:
            return q
        _, _, q0, nq, _, _ = _column_block(cfg, tp)
        return q[:, q0:q0 + nq]
    return _split_heads(_proj(engine, params, x, tp), _head_ranges(cfg, tp)[1])


def _own_columns(cfg, tp, out: torch.Tensor) -> torch.Tensor:
    """o's input from an attention output (B, ..., n·hd): on column blocks,
    of every q head, this rank's block of the columns, contiguous (the
    layout the GEMM's tensor-core variant reads); else as it is."""
    if not _blocks(tp):
        return out
    c0, c = _column_block(cfg, tp)[:2]
    return out[..., c0:c0 + c].contiguous()


def _block_attention(engine, cfg, tp, q, k, v, **kw) -> torch.Tensor:
    """On column blocks: the attention of the q heads that overlap this
    rank's block, q (B, nq, S, hd), over every kv head's k and v (B, Hkv,
    Skv, hd), one launch a ``head_groups`` entry (a kv head each where the
    heads straddle GQA groups) → the rank's block of the output (B, S, c)."""
    c0, c, q0, nq, k0, nk = _column_block(cfg, tp)
    group = cfg.n_heads // cfg.n_kv_heads
    outs = [engine.attention(q[:, a - q0:a - q0 + n], k[:, b:b + n_k],
                             v[:, b:b + n_k], **kw)
            for a, n, b, n_k in tpm.head_groups(q0, nq, k0, nk, group)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    off = c0 - q0 * cfg.resolved_head_dim      # the block from head q0's columns
    return _merge_heads(out)[..., off:off + c].contiguous()


def _kv_params(params, cfg, tp, k0: int, nk: int) -> dict:
    """The k or v weight (and bias) columns of kv heads [k0, k0 + nk): the
    rank's own shard (``local``) or a slice of the shards gathered over
    model (``gather``)."""
    if tp.kv == "local":
        return params
    hd = cfg.resolved_head_dim
    return {n: tpm.gather_columns(t, tp.mg)[..., k0 * hd:(k0 + nk) * hd].contiguous()
            for n, t in params.items()}


def _kv(engine, params, cfg, x, tp):
    """The k and v of the kv heads this rank reads, (B, nk, S, hd) each
    (on column blocks: of every kv head, gathered)."""
    if _blocks(tp):
        return tuple(_gathered(engine, params[n], x, tp, cfg.n_kv_heads)
                     for n in ("k", "v"))
    _, _, k0, nk = _head_ranges(cfg, tp)
    if not _heads(tp):
        return tuple(_split_heads(dense(engine, params[n], x), nk)
                     for n in ("k", "v"))
    return tuple(_split_heads(dense_col(engine, _kv_params(params[n], cfg, tp,
                                                           k0, nk), x, tp.mg), nk)
                 for n in ("k", "v"))


def _qkv(engine, params, cfg, x, positions, tp=None, every: bool = False):
    q = _q(engine, params["q"], cfg, x, tp, every)
    k, v = _kv(engine, params, cfg, x, tp)
    q = apply_rope(q, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
    k = apply_rope(k, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
    return q, k, v


def attention_forward(engine: ArcaneEngine, params: dict, cfg: ModelConfig,
                      x: torch.Tensor, positions: torch.Tensor, *,
                      window: Optional[int] = None,
                      kv_override: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
                      causal: bool = True, tp=None) -> torch.Tensor:
    """Training/prefill forward. x: (B, S, d). kv_override: the (B, Hkv,
    Skv, hd) K and V of a cross-attention (the encoder's, projected; the
    rank's kv heads under a head-parallel ``tp``); then only q is
    projected, and neither q nor k is rotated."""
    if kv_override is None:
        q, k, v = _qkv(engine, params, cfg, x, positions, tp)
    else:
        q = _q(engine, params["q"], cfg, x, tp)
        k, v = kv_override
    return _out(engine, params["o"], _attend(engine, cfg, tp, q, k, v,
                                             causal=causal, window=window), tp)


def _attend(engine, cfg, tp, q, k, v, **kw) -> torch.Tensor:
    """A prompt's attention of the q heads this rank attends → o's input,
    (B, S, its columns)."""
    if _blocks(tp):
        return _block_attention(engine, cfg, tp, q, k, v,
                                softcap=cfg.attn_softcap, **kw)
    return _merge_heads(engine.attention(q, k, v, softcap=cfg.attn_softcap, **kw))


def attention_prefill(engine: ArcaneEngine, params: dict, cfg: ModelConfig,
                      x: torch.Tensor, positions: torch.Tensor,
                      cache_k: torch.Tensor, cache_v: torch.Tensor, *,
                      window: Optional[int] = None, ring: bool = False,
                      tp=None):
    """Prefill: forward + write K/V into the cache at [0, S) in place.

    Ring mode (window-sized cache for local layers): only the last
    ``window`` rows are kept, at slot ``pos % window``. A cache sharded by
    sequence (``tp.cache == "seq"``) takes the rank's slice of the rows (of
    a ring, its slice of the slots).
    """
    s = x.shape[1]
    q, k, v = _qkv(engine, params, cfg, x, positions, tp)
    out = _attend(engine, cfg, tp, q, k, v, causal=True, window=window)
    if tp is not None and tp.cache == "seq":
        for c, t in ((cache_k, k), (cache_v, v)):
            _write_seq_slice(cfg, tp, c, t, ring)
    elif ring:
        w = cache_k.shape[2]
        keep = min(w, s)
        slots = torch.arange(s - keep, s, device=x.device) % w
        cache_k[:, :, slots] = k[:, :, s - keep:].to(cache_k.dtype)
        cache_v[:, :, slots] = v[:, :, s - keep:].to(cache_v.dtype)
    else:
        cache_k[:, :, :s] = k.to(cache_k.dtype)
        cache_v[:, :, :s] = v.to(cache_v.dtype)
    return _out(engine, params["o"], out, tp), cache_k, cache_v


def slot_positions(s: int, n_slots: int, ring: bool, device) -> torch.Tensor:
    """The prompt position that lands in each slot of a cache of
    ``n_slots`` after a prompt of ``s`` tokens: slot g holds position g,
    or in a ring the last position p < s with p % n_slots == g; the slots
    from s on hold none (their entries clamped into [0, s))."""
    g = torch.arange(n_slots, device=device)
    pos = g + n_slots * torch.div(s - 1 - g, n_slots, rounding_mode="floor") \
        if ring else g
    return pos.clamp(0, s - 1)


def _write_seq_slice(cfg, tp, cache: torch.Tensor, t: torch.Tensor,
                     ring: bool = False) -> None:
    """Prompt rows of every kv head into the rank's sequence slice of the
    cache (B, Hkv, S_l, hd), from ``t``: every kv head (a whole layer, or
    one on column blocks) or the rank's heads (head-parallel), whose
    rank-own column block goes to each rank's slice by an all-to-all
    (heads to sequence). The slices are of the ring's slots for a ring
    cache (``slot_positions``)."""
    mg, (b, _, s, hd) = tp.mg, t.shape
    s_l = cache.shape[2]
    pos = slot_positions(s, mg.size * s_l, ring, t.device).reshape(mg.size, s_l)
    n = min(max(s - mg.rank * s_l, 0), s_l)      # the slice's filled slots
    if not tp.heads:
        rows = t[:, :, pos[mg.rank]]
    else:
        _, _, k0, _ = _head_ranges(cfg, tp)
        cols = cfg.n_kv_heads * hd // mg.size
        c0 = mg.rank * cols - k0 * hd       # the rank's block in t's columns
        own = _merge_heads(t)[..., c0:c0 + cols]            # (B, s, cols)
        # the rank's columns of every rank's slice
        ins = own[:, pos].transpose(0, 1).contiguous()      # (m, B, S_l, cols)
        outs = tpm.all_to_all(ins, mg)          # (m, B, S_l, cols): by rank
        rows = outs.permute(1, 2, 0, 3).reshape(b, s_l, cfg.n_kv_heads, hd)
        rows = rows.transpose(1, 2)
    cache[:, :, :n] = rows[:, :, :n].to(cache.dtype)


def attention_decode(engine: ArcaneEngine, params: dict, cfg: ModelConfig,
                     x: torch.Tensor, position: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, *,
                     window: Optional[int] = None, ring: bool = False, tp=None):
    """One-token decode. x: (B, d); position: (B,) current index, on the
    device. The new K/V row is scattered into the cache (one row per
    sequence, in place), then the decode kernel sweeps the cache. Over a
    cache sharded by sequence (``tp.cache == "seq"``) see ``_decode_seq``."""
    if tp is not None and tp.cache == "seq":
        return _decode_seq(engine, params, cfg, x, position, cache_k, cache_v,
                           window=window, ring=ring, tp=tp)
    b = x.shape[0]
    q, k, v = _qkv(engine, params, cfg, x[:, None, :], position[:, None], tp,
                   every=True)
    w = cache_k.shape[2]
    slot = position % w if ring else position
    rows = torch.arange(b, device=x.device)
    cache_k[rows, :, slot] = k[:, :, 0].to(cache_k.dtype)
    cache_v[rows, :, slot] = v[:, :, 0].to(cache_v.dtype)
    lengths = torch.clamp(position + 1, max=w) if ring else position + 1
    out = engine.decode_attention(q[:, :, 0], cache_k, cache_v,
                                  lengths.to(torch.int32),
                                  softcap=cfg.attn_softcap,
                                  window=None if ring else window)  # (B,Hq,hd)
    out = _out(engine, params["o"], _own_columns(cfg, tp, out.reshape(b, -1)), tp)
    return out, cache_k, cache_v


def _row_all_heads(engine, params, cfg, x, tp) -> torch.Tensor:
    """The new row's k or v of every kv head, (B, 1, Hkv * hd): whole, or
    the ranks' column blocks of it gathered (a row: no weight moves)."""
    if not _sharded(tp):
        return dense(engine, params, x)
    return tpm.gather_last(dense(engine, params, x), tp.mg)


def seq_lengths(position: torch.Tensor, s_l: int, mg, ring: bool) -> tuple:
    """A decode step over a cache sharded by sequence, rank ``mg.rank``
    holding slots [r·S_l, (r+1)·S_l): (the new row's slot in the rank's
    slice, in range only on its owner; the decode kernel's length over the
    slice, unclamped: at most 0 for a slice with no valid key, above S_l
    for a full one). A ring's new row goes to slot ``position % (m·S_l)``
    and its filled slots are the first min(position + 1, m·S_l)."""
    start = mg.rank * s_l
    if ring:
        w = mg.size * s_l
        return position % w - start, torch.clamp(position + 1, max=w) - start
    return position - start, position + 1 - start


def _decode_seq(engine, params, cfg, x, position, cache_k, cache_v, *,
                window, ring, tp):
    """One-token decode over a cache sharded by sequence: each rank holds
    the rows [r·S_l, (r+1)·S_l) of every kv head (of a ring, those slots).
    The rank that holds the new row's slot writes it; each rank attends
    every q head over its rows (the decode kernel over its slice with the
    rank-local lengths, returning each row's log-sum-exp; a ring with no
    window: it holds the window), the ranks merge (``merge_partials``)
    and a head-parallel rank keeps its q heads for o, one on column
    blocks its block of the columns."""
    b, hd, mg = x.shape[0], cfg.resolved_head_dim, tp.mg
    q0, nq, _, _ = _head_ranges(cfg, tp)
    x1, pos1 = x[:, None, :], position[:, None]
    rope = dict(theta=cfg.rope_theta, fraction=cfg.rope_fraction)
    q = _proj(engine, params["q"], x1, tp)
    if _sharded(tp):
        q = tpm.gather_last(q, mg)
    q = apply_rope(_split_heads(q, cfg.n_heads), pos1, **rope)[:, :, 0]
    k = apply_rope(_split_heads(_row_all_heads(engine, params["k"], cfg, x1, tp),
                                cfg.n_kv_heads), pos1, **rope)[:, :, 0]
    v = _split_heads(_row_all_heads(engine, params["v"], cfg, x1, tp),
                     cfg.n_kv_heads)[:, :, 0]
    s_l = cache_k.shape[2]
    slot, lengths = seq_lengths(position, s_l, mg, ring)
    own = ((slot >= 0) & (slot < s_l))[:, None, None]
    slot = slot.clamp(0, s_l - 1)
    rows = torch.arange(b, device=x.device)
    for c, new in ((cache_k, k), (cache_v, v)):
        c[rows, :, slot] = torch.where(own, new.to(c.dtype), c[rows, :, slot])
    out, lse = engine.decode_attention(q, cache_k, cache_v,
                                       lengths.to(torch.int32),
                                       softcap=cfg.attn_softcap,
                                       window=None if ring else window,
                                       return_lse=True)
    out = tpm.merge_partials(out, lse, mg).to(q.dtype)[:, q0:q0 + nq]
    out = _own_columns(cfg, tp, out.reshape(b, nq * hd))
    return _out(engine, params["o"], out, tp), cache_k, cache_v
