"""Mamba (S6 selective state space) block, Jamba's sequence mixer
(counterpart of repro.models.mamba).

The state (d_inner × d_state per sequence) is updated by every token:
h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t, y_t = h_t C_t + D x_t. Every
projection goes through the engine (xmk0); the depthwise causal conv and
the scan are plain PyTorch, as the reference computes them outside any
kernel. The scan runs over chunks in sequence; inside a chunk, the pairs
(decay, contrib) are combined by ``_chunk_scan``, a log-depth
(Hillis-Steele) inclusive scan under the reference's combine
(a, b) ∘ (a', b') = (a a', a' b + b'), and the chunk's states are
``a_acc h + b_acc`` from the state the previous chunk left. It agrees with
the reference's ``associative_scan`` and with a step-by-step recurrence to
1e-4 in f32 (tests/test_torch_ssm.py).

The reference refuses a sequence longer than the chunk whose length is not
a multiple of it; so does this module, with ``ValueError``.

With a model group (``mg``) a rank computes its channels [r·di/m,
(r+1)·di/m) of both x and z: the conv, dt_proj's columns, dt_bias, A,
D, the scan and the ``conv``/``ssm`` states are the rank's; x_proj and
out_proj are row-parallel (x_proj's partial dt, B and C summed in f32 and
replicated, then entering the rank's channels through ``col_input``).
The rules shard in_proj by columns over the concatenated ``[x | z]``, so
a rank's column block is x-channels on the first half of the ranks and
z-channels on the second: ``in_proj`` routes them to the rank's channels
of both halves with one all-to-all (``tensor_parallel.route_channels``),
of the product where it has fewer rows than the weight (a decode step, a
short prompt), else of the weight's columns (a train step).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import ArcaneEngine
from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.models.layers import (dense, dense_col, dense_init, dense_row,
                                       truncated_normal_init)


def _dt_rank(cfg: ModelConfig) -> int:
    return cfg.mamba.dt_rank or -(-cfg.d_model // 16)


def d_inner(cfg: ModelConfig) -> int:
    return cfg.mamba.expand * cfg.d_model


def mamba_init(gen, cfg: ModelConfig, device) -> dict:
    mb, d, dt = cfg.mamba, cfg.d_model, cfg.pdtype
    di, dtr = d_inner(cfg), _dt_rank(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    # S4D-real initialisation for A; dt bias init for softplus ∈ [1e-3, 0.1]
    a = torch.arange(1, mb.d_state + 1, **f32).expand(di, mb.d_state)
    dt_init = torch.exp(torch.rand((di,), generator=gen, **f32)
                        * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))  # inverse softplus
    return {
        "in_proj": dense_init(gen, d, 2 * di, dt, device),
        "conv_w": truncated_normal_init(gen, (mb.d_conv, di), dt, 0.5, device),
        "conv_b": torch.zeros((di,), dtype=dt, device=device),
        "x_proj": dense_init(gen, di, dtr + 2 * mb.d_state, dt, device),
        "dt_proj": dense_init(gen, dtr, di, dt, device, scale=dtr ** -0.5),
        "dt_bias": dt_bias,
        "A_log": torch.log(a),
        "D": torch.ones((di,), **f32),
        "out_proj": dense_init(gen, di, d, dt, device),
    }


def check_length(cfg: ModelConfig, s: int) -> None:
    """The reference's contract (``assert s % chunk == 0`` with ``chunk =
    min(cfg.mamba.chunk, s)``), as ``ValueError``."""
    chunk = min(cfg.mamba.chunk, s)
    if s < 1 or s % chunk:
        raise ValueError(
            f"{cfg.name}: the Mamba scan takes {s} tokens only if they fit "
            f"one chunk of {cfg.mamba.chunk} or are a multiple of it")


def check_prompt(cfg: ModelConfig, s: int) -> None:
    """``check_length``, and a prompt at least as long as the conv state
    (d_conv - 1 tokens): the reference's prefill builds a shorter state
    from a shorter prompt, which its cache cannot hold."""
    check_length(cfg, s)
    if s < cfg.mamba.d_conv - 1:
        raise ValueError(
            f"{cfg.name}: a prompt of {s} tokens is shorter than the Mamba "
            f"conv state ({cfg.mamba.d_conv - 1} tokens)")


def in_proj(engine, params, x, mg=None) -> tuple:
    """x: (B, L, d) → the pre-conv x and the gate z (B, L, di) each; with
    ``mg`` the rank's channels of both (di / m each): its column block of
    in_proj routed to them (``route_channels``), on the product or on the
    weight, whichever has fewer rows."""
    if mg is None:
        xz = dense(engine, params["in_proj"], x)
    elif x.numel() // x.shape[-1] < x.shape[-1]:
        xz = tpm.route_channels(dense_col(engine, params["in_proj"], x, mg), mg)
    else:
        w = tpm.route_channels(params["in_proj"]["w"], mg)
        xz = dense_col(engine, {"w": w}, x, mg)
    return xz.chunk(2, dim=-1)


def _selective_terms(engine, params, cfg, x_conv, mg=None):
    """x_conv: (B, L, di) → decay a, input contribution b (f32, (B, L, di,
    ds)) and the readout C (f32, (B, L, ds)). dt_proj reads the first
    dt_rank columns of x_proj's output in place (a strided view). With
    ``mg``, x_conv and the terms are the rank's channels."""
    ds, dtr = cfg.mamba.d_state, _dt_rank(cfg)
    if mg is None:
        proj = dense(engine, params["x_proj"], x_conv)
    else:
        proj = dense_row(engine, params["x_proj"], x_conv, mg)
    dt_lat, bmat, cmat = torch.split(proj, [dtr, ds, ds], dim=-1)
    if mg is None:
        dt = dense(engine, params["dt_proj"], dt_lat)
    else:       # B and C, replicated, read by the rank's channels
        bmat, cmat = tpm.col_input(bmat, mg), tpm.col_input(cmat, mg)
        dt = dense_col(engine, params["dt_proj"], dt_lat, mg)
    dt = F.softplus(dt.float() + params["dt_bias"])             # (B,L,di)
    a_cont = -torch.exp(params["A_log"])                        # (di, ds)
    decay = torch.exp(dt[..., None] * a_cont)                   # (B,L,di,ds)
    contrib = (dt * x_conv.float())[..., None] \
        * bmat.float()[..., None, :]                            # (B,L,di,ds)
    return decay, contrib, cmat.float()


def _causal_conv(params, x, conv_state=None):
    """Depthwise causal conv along L in f32. x: (B, L, di) → (out, the
    last K-1 inputs: the next call's conv_state)."""
    w = params["conv_w"].float()                                # (K, di)
    kk = w.shape[0]
    xf = x.float()
    if conv_state is not None:
        xf = torch.cat([conv_state, xf], dim=1)
    else:
        xf = F.pad(xf, (0, 0, kk - 1, 0))
    out = sum(w[i] * xf[:, i:i + x.shape[1]] for i in range(kk))
    return out + params["conv_b"].float(), xf[:, -(kk - 1):]


def _chunk_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along axis 1 of the pairs (a, b) under (a, b) ∘
    (a', b') = (a a', a' b + b'), in ceil(log2 L) steps: after the step of
    offset o, position t holds the composition of positions t - 2o + 1..t."""
    off, n = 1, a.shape[1]
    while off < n:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], 1)
        off *= 2
    return a, b


def _out(engine, params, y, mg):
    if mg is None:
        return dense(engine, params["out_proj"], y)
    return dense_row(engine, params["out_proj"], y, mg)


def mamba_forward(engine: ArcaneEngine, params: dict, cfg: ModelConfig,
                  x: torch.Tensor, h0=None, mg=None):
    """Forward/prefill; x: (B, S, d) → (out, final state (B, di, ds) f32;
    the rank's channels with ``mg``)."""
    b, s, _ = x.shape
    check_length(cfg, s)
    chunk = min(cfg.mamba.chunk, s)
    xi, z = in_proj(engine, params, x, mg)
    x_conv, _ = _causal_conv(params, xi)
    x_conv = F.silu(x_conv).to(x.dtype)
    decay, contrib, cmat = _selective_terms(engine, params, cfg, x_conv, mg)
    h = h0 if h0 is not None else torch.zeros(
        (b, decay.shape[2], cfg.mamba.d_state), dtype=torch.float32,
        device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        a_acc, b_acc = _chunk_scan(decay[:, sl], contrib[:, sl])
        hs = a_acc * h[:, None] + b_acc                         # (B,L,di,ds)
        ys.append(torch.einsum("blds,bls->bld", hs, cmat[:, sl]))
        h = hs[:, -1].contiguous()
        del a_acc, b_acc, hs
    y = torch.cat(ys, dim=1)
    y = y + params["D"] * x_conv.float()
    y = y.to(x.dtype) * F.silu(z)
    return _out(engine, params, y, mg), h


def mamba_decode(engine: ArcaneEngine, params: dict, cfg: ModelConfig,
                 x: torch.Tensor, conv_state: torch.Tensor,
                 ssm_state: torch.Tensor, mg=None):
    """One-token step. x: (B, d); conv_state: (B, K-1, di); ssm_state:
    (B, di, ds) (the rank's channels with ``mg``) → (out (B, d),
    conv_state', ssm_state')."""
    xi, z = in_proj(engine, params, x[:, None, :], mg)
    x_conv, conv_state = _causal_conv(params, xi, conv_state)
    x_conv = F.silu(x_conv).to(x.dtype)                         # (B,1,di)
    decay, contrib, cmat = _selective_terms(engine, params, cfg, x_conv, mg)
    h = decay[:, 0] * ssm_state + contrib[:, 0]                 # (B,di,ds)
    y = torch.einsum("bds,bs->bd", h, cmat[:, 0])
    y = y + params["D"] * x_conv[:, 0].float()
    y = y.to(x.dtype) * F.silu(z[:, 0])
    return _out(engine, params, y, mg), conv_state, h
