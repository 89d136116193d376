"""Layer blocks: norm/residual wiring around the sequence mixers + FFN/MoE
(counterpart of repro.models.blocks, for the kinds ``attn``, ``attn_local``,
``mla`` and ``mamba``, each with a dense or an MoE FFN, and ``rwkv``, which
carries its own channel mix). An encoder-decoder's decoder blocks also
carry a cross-attention over the encoder's output (``cross``).

A block is one position in the config's repeating layer pattern, with three
entry points: forward, prefill (cache write) and decode (one token). The
cache of a block is a dict of tensors updated in place: ``k``, ``v``
(B, Hkv, S, hd) for attention, ``c`` (B, S, r) and ``kr`` (B, S, rope) for
MLA's latent stream, ``conv`` (B, d_conv-1, d_inner) and ``ssm`` (B,
d_inner, d_state) f32 for Mamba, ``S`` (B, H, N, N) f32 and ``tm_x``,
``cm_x`` (B, d) for RWKV, and for a cross-attention ``xk``, ``xv`` (B,
Hkv, cross_len, hd): the projected encoder output. Where the reference
rebinds a cache entry to a new state, this module copies the state into
the entry: the serving engine prefills a slot through views of the batched
cache. So the cross cache is a buffer of a fixed ``cross_len``, and a
prefill whose encoder output has another length raises ``ValueError``
(the reference rebinds ``xk`` and ``xv`` to an output of any length).

Under tensor parallelism each entry point takes the pattern position's
``BlockTP`` (``tp``): its attention, MLA and cross-attention head-parallel,
on column blocks or whole, a Mamba or RWKV-6 mixer on the rank's channels or heads or
whole, its dense FFN column/row-parallel, its MoE experts sharded; the
norms compute whole.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.engine import ArcaneEngine
from repro_torch.distributed.sharding import constrain
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import mla as mla_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.layers import make_norm
from repro_torch.models.mlp import mlp, mlp_init
from repro_torch.models.moe import moe, moe_init

KINDS = ("attn", "attn_local", "mla", "mamba", "rwkv")


def _check_kind(cfg: ModelConfig, spec: LayerSpec) -> None:
    if spec.kind not in KINDS:
        raise ValueError(f"{cfg.name}: unknown layer kind {spec.kind!r}")


def check_prompt_length(cfg: ModelConfig, s: int) -> None:
    """Raise ``ValueError`` for a prompt of ``s`` tokens that the
    reference's prefill refuses: a recurrent scan's length contract (longer
    than the chunk and not a multiple of it), and for Mamba a prompt
    shorter than its conv state (d_conv - 1 tokens), whose state the
    reference would build short."""
    kinds = {spec.kind for spec in cfg.pattern}
    if "rwkv" in kinds:
        rwkv_mod.check_length(cfg, s)
    if "mamba" in kinds:
        mam.check_prompt(cfg, s)


def _window(cfg: ModelConfig, spec: LayerSpec):
    return cfg.local_window if spec.kind == "attn_local" else None


def _ring(cfg: ModelConfig, spec: LayerSpec, cache: dict, tp=None) -> bool:
    """Whether the layer's cache is a ring of ``window`` slots (sharded by
    sequence: its slices of them)."""
    window = _window(cfg, spec)
    attn_tp = _part(tp, "attn")
    slices = attn_tp.mg.size if attn_tp is not None and attn_tp.cache == "seq" else 1
    return (window is not None and cfg.ring_local_cache
            and cache["k"].shape[2] * slices == window)


def block_init(gen, cfg: ModelConfig, spec: LayerSpec, device, *,
               cross: bool = False) -> dict:
    _check_kind(cfg, spec)
    ninit, _ = make_norm(cfg.norm)
    d, dt = cfg.d_model, cfg.pdtype
    p: dict[str, Any] = {"ln1": ninit(d, dt, device)}
    if spec.kind == "mla":
        p["attn"] = mla_mod.mla_init(gen, cfg, device)
    elif spec.kind == "mamba":
        p["mixer"] = mam.mamba_init(gen, cfg, device)
    elif spec.kind == "rwkv":
        p["mixer"] = rwkv_mod.rwkv_init(gen, cfg, device)
        p["ln2"] = ninit(d, dt, device)
        return p          # rwkv carries its own channel-mix FFN
    else:
        p["attn"] = attn.attention_init(gen, cfg, device)
    if cross:
        p["cross_ln"] = ninit(d, dt, device)
        p["cross"] = attn.attention_init(gen, cfg, device)
    p["ln2"] = ninit(d, dt, device)
    p["ffn"] = (moe_init if spec.moe else mlp_init)(gen, cfg, device)
    return p


def _part(tp, name: str):
    return None if tp is None else getattr(tp, name)


def _mixer_mg(tp):
    """The model group a Mamba or RWKV-6 mixer computes its shards over,
    or None (whole)."""
    return tp.mg if tp is not None and tp.mixer else None


def _cross_kv(engine, params, cfg, enc_out, tp=None):
    """The cross-attention's K and V: the encoder output projected, as
    (B, Hkv, S_enc, hd) views of the projections (the rank's kv heads
    under a head-parallel cross-attention; every kv head, the ranks'
    blocks gathered, on column blocks)."""
    return attn._kv(engine, params["cross"], cfg, enc_out, _part(tp, "cross"))


def _cross(engine, params, cfg, x, positions, kv, tp=None):
    """x plus the cross-attention of x over ``kv`` (non-causal)."""
    _, napply = make_norm(cfg.norm)
    hc = napply(params["cross_ln"], x)
    return x + attn.attention_forward(engine, params["cross"], cfg, hc,
                                      positions, causal=False, kv_override=kv,
                                      tp=_part(tp, "cross"))


def _ffn_apply(engine, params, cfg, spec, x, tp=None):
    """The FFN of the block: (h, MoE aux loss; 0.0 for a dense FFN, a
    Python float, so that the decode step launches nothing for it)."""
    if spec.moe:
        return moe(engine, params["ffn"], cfg, x,
                   mg=tp.mg if tp is not None and tp.experts else None,
                   rows=None if tp is None else tp.rows)
    return mlp(engine, params["ffn"], cfg, x,
               mg=tp.mg if tp is not None and tp.ffn else None), 0.0


def block_forward(engine: ArcaneEngine, params: dict, cfg: ModelConfig,
                  spec: LayerSpec, x: torch.Tensor, positions: torch.Tensor, *,
                  causal: bool = True, enc_out: Optional[torch.Tensor] = None,
                  tp=None) -> tuple[torch.Tensor, torch.Tensor | float]:
    """Returns (x, moe_aux_loss): an f32 scalar tensor, or 0.0 for a dense
    FFN. ``causal=False``: bidirectional attention (the encoder's);
    ``enc_out``: the encoder output a decoder block's cross-attention
    reads."""
    _check_kind(cfg, spec)
    _, napply = make_norm(cfg.norm)
    x = constrain(x, "batch", None, None)
    h = napply(params["ln1"], x)
    mg = _mixer_mg(tp)
    if spec.kind == "mla":
        h = mla_mod.mla_forward(engine, params["attn"], cfg, h, positions,
                                tp=_part(tp, "attn"))
    elif spec.kind == "mamba":
        h, _ = mam.mamba_forward(engine, params["mixer"], cfg, h, mg=mg)
    elif spec.kind == "rwkv":
        h, _, _ = rwkv_mod.rwkv_time_mix(engine, params["mixer"], cfg, h, mg=mg)
        x = x + h
        cm, _ = rwkv_mod.rwkv_channel_mix(engine, params["mixer"], cfg,
                                          napply(params["ln2"], x), mg=mg)
        return x + cm, 0.0
    else:
        h = attn.attention_forward(engine, params["attn"], cfg, h, positions,
                                   window=_window(cfg, spec), causal=causal,
                                   tp=_part(tp, "attn"))
    x = x + h
    if enc_out is not None and "cross" in params:
        x = _cross(engine, params, cfg, x, positions,
                   _cross_kv(engine, params, cfg, enc_out, tp), tp)
    h, aux = _ffn_apply(engine, params, cfg, spec, napply(params["ln2"], x), tp)
    return x + h, aux


def init_block_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype, device, *, cross_len: int = 0) -> dict:
    _check_kind(cfg, spec)
    f32 = dict(dtype=torch.float32, device=device)
    if spec.kind == "mamba":
        di = mam.d_inner(cfg)
        return {"conv": torch.zeros((batch, cfg.mamba.d_conv - 1, di), **f32),
                "ssm": torch.zeros((batch, di, cfg.mamba.d_state), **f32)}
    if spec.kind == "rwkv":
        n = cfg.rwkv.head_size
        h = cfg.d_model // n
        return {"S": torch.zeros((batch, h, n, n), **f32),
                "tm_x": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                    device=device),
                "cm_x": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                    device=device)}
    if spec.kind == "mla":
        m = cfg.mla
        return {"c": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                                 device=device),
                "kr": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}
    s_len = max_len
    if (spec.kind == "attn_local" and cfg.ring_local_cache
            and cfg.local_window and cfg.local_window < max_len):
        s_len = cfg.local_window          # ring buffer
    def zeros(rows):
        return torch.zeros((batch, cfg.n_kv_heads, rows, cfg.resolved_head_dim),
                           dtype=dtype, device=device)

    c = {"k": zeros(s_len), "v": zeros(s_len)}
    if cross_len:
        c["xk"], c["xv"] = zeros(cross_len), zeros(cross_len)
    return c


def block_prefill(engine, params, cfg, spec, x, positions, cache, *,
                  enc_out=None, tp=None):
    """Prefill from position 0; returns (x, cache). With ``enc_out`` a
    decoder block also projects the encoder output once and copies it into
    its cross cache (``ValueError`` where the lengths differ)."""
    _check_kind(cfg, spec)
    _, napply = make_norm(cfg.norm)
    h = napply(params["ln1"], x)
    mg = _mixer_mg(tp)
    if spec.kind == "mla":
        h, cache["c"], cache["kr"] = mla_mod.mla_prefill(
            engine, params["attn"], cfg, h, positions, cache["c"], cache["kr"],
            tp=_part(tp, "attn"))
    elif spec.kind == "mamba":
        k1 = cfg.mamba.d_conv - 1
        mam.check_prompt(cfg, x.shape[1])
        h, last = mam.mamba_forward(engine, params["mixer"], cfg, h, mg=mg)
        cache["ssm"].copy_(last)
        # conv state: the last K-1 pre-conv activations, recomputed (ln1
        # and in_proj of the last K-1 tokens again, as the reference does)
        tail = napply(params["ln1"], x[:, -k1:])
        cache["conv"].copy_(mam.in_proj(engine, params["mixer"], tail, mg)[0])
    elif spec.kind == "rwkv":
        h, S, tm_x = rwkv_mod.rwkv_time_mix(engine, params["mixer"], cfg, h,
                                            mg=mg)
        cache["S"].copy_(S)
        cache["tm_x"].copy_(tm_x)
        x = x + h
        cm, cm_x = rwkv_mod.rwkv_channel_mix(engine, params["mixer"], cfg,
                                             napply(params["ln2"], x), mg=mg)
        cache["cm_x"].copy_(cm_x)
        return x + cm, cache
    else:
        h, cache["k"], cache["v"] = attn.attention_prefill(
            engine, params["attn"], cfg, h, positions, cache["k"], cache["v"],
            window=_window(cfg, spec), ring=_ring(cfg, spec, cache, tp),
            tp=_part(tp, "attn"))
    x = x + h
    if enc_out is not None and "cross" in params:
        kx, vx = _cross_kv(engine, params, cfg, enc_out, tp)
        if cache["xk"].shape[2] != kx.shape[2]:
            raise ValueError(f"{cfg.name}: an encoder output of "
                             f"{kx.shape[2]} frames for a cross cache of "
                             f"{cache['xk'].shape[2]}")
        cache["xk"].copy_(kx)
        cache["xv"].copy_(vx)
        x = _cross(engine, params, cfg, x, positions, (kx, vx), tp)
    h, _ = _ffn_apply(engine, params, cfg, spec, napply(params["ln2"], x), tp)
    return x + h, cache


def block_decode(engine, params, cfg, spec, x, position, cache, *,
                 enc_len: Optional[int] = None, tp=None):
    """One-token step. x: (B, d); returns (x, cache). A decoder block with
    a cross cache attends over its first ``enc_len`` rows in every
    sequence."""
    _check_kind(cfg, spec)
    _, napply = make_norm(cfg.norm)
    h = napply(params["ln1"], x)
    mg = _mixer_mg(tp)
    if spec.kind == "mla":
        h, cache["c"], cache["kr"] = mla_mod.mla_decode(
            engine, params["attn"], cfg, h, position, cache["c"], cache["kr"],
            tp=_part(tp, "attn"))
    elif spec.kind == "mamba":
        h, conv, ssm = mam.mamba_decode(engine, params["mixer"], cfg, h,
                                        cache["conv"], cache["ssm"], mg=mg)
        cache["conv"].copy_(conv)
        cache["ssm"].copy_(ssm)
    elif spec.kind == "rwkv":
        h, S, tm_x = rwkv_mod.rwkv_time_mix_decode(
            engine, params["mixer"], cfg, h, cache["S"], cache["tm_x"], mg=mg)
        cache["S"].copy_(S)
        cache["tm_x"].copy_(tm_x)
        x = x + h
        cm, cm_x = rwkv_mod.rwkv_channel_mix(
            engine, params["mixer"], cfg, napply(params["ln2"], x)[:, None, :],
            cache["cm_x"], mg=mg)
        cache["cm_x"].copy_(cm_x)
        return x + cm[:, 0], cache
    else:
        h, cache["k"], cache["v"] = attn.attention_decode(
            engine, params["attn"], cfg, h, position, cache["k"], cache["v"],
            window=_window(cfg, spec), ring=_ring(cfg, spec, cache, tp),
            tp=_part(tp, "attn"))
    x = x + h
    if "cross" in params and "xk" in cache:
        x = x + _cross_decode(engine, params["cross"], cfg,
                              napply(params["cross_ln"], x), cache, enc_len,
                              _part(tp, "cross"))
    h, _ = _ffn_apply(engine, params, cfg, spec,
                      napply(params["ln2"], x)[:, None, :], tp)
    return x + h[:, 0], cache


def _cross_decode(engine, params, cfg, h, cache, enc_len, tp=None):
    """One query a sequence over the cross cache: q and o projections
    around decode attention with every length ``enc_len`` (the rank's q
    heads over its kv heads under a head-parallel ``tp``; on column blocks
    every q head over the whole cache, the rank keeping its block)."""
    b, s = h.shape[0], cache["xk"].shape[2]
    if enc_len is None or not 0 < enc_len <= s:
        raise ValueError(f"{cfg.name}: enc_len={enc_len} for a cross cache "
                         f"of {s} frames")
    q = attn._q(engine, params["q"], cfg, h[:, None, :], tp,
                every=True)[:, :, 0]                            # (B, Hq, hd)
    lengths = torch.full((b,), enc_len, dtype=torch.int32, device=h.device)
    o = engine.decode_attention(q, cache["xk"], cache["xv"], lengths,
                                softcap=cfg.attn_softcap)
    return attn._out(engine, params["o"],
                     attn._own_columns(cfg, tp, o.reshape(b, -1)), tp)
