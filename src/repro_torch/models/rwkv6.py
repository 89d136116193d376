"""RWKV-6 ("Finch") block: attention-free time mixing with data-dependent
decay (counterpart of repro.models.rwkv6).

Per head (size N): state S ∈ R^{N×N} evolves as

    S_t[j, :] = w_t[j] · S_{t-1}[j, :] + k_t[j] · v_t[:]
    y_t[:]    = Σ_j r_t[j] · (S_{t-1}[j, :] + u[j] · k_t[j] · v_t[:])

with the decay w_t data-dependent through a low-rank MLP (w0 + tanh(x_w A)
B). Token-shift mixing uses static lerp coefficients, as the reference's.

Every projection goes through the engine (xmk0); the recurrence is plain
PyTorch, as the reference computes it with ``lax.scan`` outside any kernel:
a Python loop over the chunks and, inside each, over its tokens. The
reference refuses a sequence longer than the chunk whose length is not a
multiple of it; so does this module, with ``ValueError``.

With a model group (``mg``) a rank computes its heads: r, k, v, g and the
decay LoRA's wB are column-parallel (``wA`` is replicated, so the LoRA's
hidden layer is computed whole and enters wB through ``col_input``), the
wkv state, ``u``, ``w0`` and the group norm are the rank's heads, o is
row-parallel. In the channel mix cm_k is column-parallel and cm_v
row-parallel; cm_r's columns are the rank's d-slice, so the sum of cm_v's
partials is reduce-scattered to that slice, gated there and gathered
back. The token-shift rows are whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import ArcaneEngine
from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.models.layers import (dense, dense_col, dense_init, dense_row,
                                       truncated_normal_init)

GROUPNORM_EPS = 64e-5


def rwkv_init(gen, cfg: ModelConfig, device) -> dict:
    d, r, dt = cfg.d_model, cfg.rwkv, cfg.pdtype
    n_heads = d // r.head_size
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # time-mix lerp coefficients for r, k, v, g, w
        "mu": torch.full((5, d), 0.5, **f32),
        "r": dense_init(gen, d, d, dt, device),
        "k": dense_init(gen, d, d, dt, device),
        "v": dense_init(gen, d, d, dt, device),
        "g": dense_init(gen, d, d, dt, device),
        "o": dense_init(gen, d, d, dt, device),
        # data-dependent decay lora: w = w0 + tanh(x_w @ A) @ B
        "w0": torch.full((d,), -6.0, **f32),
        "wA": truncated_normal_init(gen, (d, r.decay_lora), dt, 0.02, device),
        "wB": truncated_normal_init(gen, (r.decay_lora, d), dt, 0.02, device),
        "u": truncated_normal_init(gen, (d,), torch.float32, 0.5, device),
        "ln_scale": torch.ones((n_heads, r.head_size), **f32),
        # channel mixing
        "cm_mu": torch.full((2, d), 0.5, **f32),
        "cm_k": dense_init(gen, d, cfg.d_ff, dt, device),
        "cm_v": dense_init(gen, cfg.d_ff, d, dt, device),
        "cm_r": dense_init(gen, d, d, dt, device),
    }


def check_length(cfg: ModelConfig, s: int) -> None:
    """The reference's contract (``assert s % chunk == 0`` with ``chunk =
    min(cfg.rwkv.chunk, s)``), as ``ValueError``."""
    chunk = min(cfg.rwkv.chunk, s)
    if s < 1 or s % chunk:
        raise ValueError(
            f"{cfg.name}: the RWKV scan takes {s} tokens only if they fit one "
            f"chunk of {cfg.rwkv.chunk} or are a multiple of it")


def _shift(x: torch.Tensor, last: torch.Tensor | None = None) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros / carried ``last`` for t = 0)."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([first, x[:, :-1]], dim=1)


def _mix(x, prev, mu):
    """Static lerp, in x's dtype."""
    return x + (prev - x) * mu.to(x.dtype)


def _col(engine, params, x, mg):
    """A product of the time or channel mix: whole, or column-parallel."""
    return dense(engine, params, x) if mg is None else dense_col(engine, params, x, mg)


def _row(engine, params, x, mg):
    """o or cm_v: whole, or row-parallel (partials summed in f32)."""
    return dense(engine, params, x) if mg is None else dense_row(engine, params, x, mg)


def _wkv_terms(engine, params, cfg, x, prev, mg=None):
    """Projections for the wkv recurrence. x, prev: (B, L, d) →
    r, k, v (f32, (B, L, H, N)), the gate g (x's dtype, (B, L, d)) and the
    decay (f32, (B, L, H, N), in (0, 1)); with ``mg`` of the rank's heads
    (d / m columns)."""
    n = cfg.rwkv.head_size
    b, s, _ = x.shape
    mu = params["mu"]
    xr, xk = _mix(x, prev, mu[0]), _mix(x, prev, mu[1])
    xv, xg = _mix(x, prev, mu[2]), _mix(x, prev, mu[3])
    xw = _mix(x, prev, mu[4])
    rr = _col(engine, params["r"], xr, mg)
    h = rr.shape[-1] // n
    rr = rr.reshape(b, s, h, n)
    kk = _col(engine, params["k"], xk, mg).reshape(b, s, h, n)
    vv = _col(engine, params["v"], xv, mg).reshape(b, s, h, n)
    gg = F.silu(_col(engine, params["g"], xg, mg))
    # the decay LoRA through the engine directly: tanh in x's dtype, the
    # second product widened to f32 before exp(-exp(w))
    w_lat = torch.tanh(engine.gemm(xw, params["wA"]))
    if mg is None:
        w_lo = engine.gemm(w_lat, params["wB"])
    else:       # the whole hidden layer into the rank's wB columns
        w_lo = engine.gemm(tpm.col_input(w_lat, mg), params["wB"],
                           out_dtype=w_lat.dtype)
    w = params["w0"] + w_lo.float()
    decay = torch.exp(-torch.exp(w)).reshape(b, s, h, n)
    return rr.float(), kk.float(), vv.float(), gg, decay


def _groupnorm(params, y: torch.Tensor) -> torch.Tensor:
    """Per-head layer norm of the wkv output. y: (B, L, H, N) f32."""
    mu = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, unbiased=False, keepdim=True)
    return (y - mu) * torch.rsqrt(var + GROUPNORM_EPS) * params["ln_scale"]


def _wkv_step(S, rt, kt, vt, wt, u):
    """One token: (B, H, N) each, S (B, H, N, N) → (S', y_t (B, H, N))."""
    kv = kt[..., :, None] * vt[..., None, :]
    yt = torch.einsum("bhj,bhjn->bhn", rt, S + u[..., None] * kv)
    return wt[..., None] * S + kv, yt


def _wkv_scan(S, rr, kk, vv, decay, u, chunk: int):
    """The recurrence over (B, L, H, N) terms from the state S, a chunk at
    a time (the reference's scan over chunks) and a token at a time inside
    each chunk → (final S, y (B, L, H, N))."""
    ys = []
    for c0 in range(0, rr.shape[1], chunk):
        for t in range(c0, c0 + chunk):
            S, yt = _wkv_step(S, rr[:, t], kk[:, t], vv[:, t], decay[:, t], u)
            ys.append(yt)
    return S, torch.stack(ys, dim=1)


def rwkv_time_mix(engine: ArcaneEngine, params: dict, cfg: ModelConfig,
                  x: torch.Tensor, state=None, last_x=None, mg=None):
    """x: (B, S, d) → (out, final state (B, H, N, N) f32, final x (B, d));
    with ``mg`` the state holds the rank's heads."""
    n = cfg.rwkv.head_size
    b, s, _ = x.shape
    check_length(cfg, s)
    chunk = min(cfg.rwkv.chunk, s)
    prev = _shift(x, last_x)
    rr, kk, vv, gg, decay = _wkv_terms(engine, params, cfg, x, prev, mg)
    h = rr.shape[2]
    u = params["u"].reshape(h, n)
    S = state if state is not None else torch.zeros(
        (b, h, n, n), dtype=torch.float32, device=x.device)
    S, y = _wkv_scan(S, rr, kk, vv, decay, u, chunk)
    y = _groupnorm(params, y).reshape(b, s, h * n).to(x.dtype) * gg
    return _row(engine, params["o"], y, mg), S, x[:, -1]


def rwkv_channel_mix(engine: ArcaneEngine, params: dict, cfg: ModelConfig,
                     x: torch.Tensor, last_x=None, mg=None):
    """x: (B, S, d) → (out, final x (B, d))."""
    prev = _shift(x, last_x)
    mu = params["cm_mu"]
    xk, xr = _mix(x, prev, mu[0]), _mix(x, prev, mu[1])
    k = torch.square(F.relu(_col(engine, params["cm_k"], xk, mg)))
    if mg is None:
        kv = dense(engine, params["cm_v"], k)
        return torch.sigmoid(dense(engine, params["cm_r"], xr)) * kv, x[:, -1]
    # cm_v's partials summed in f32 to the rank's d-slice, where cm_r's
    # columns gate it; the gated slices joined
    kv = tpm.reduce_scatter_from_model(
        engine.gemm(k, params["cm_v"]["w"], out_dtype=torch.float32), mg)
    gate = torch.sigmoid(dense_col(engine, params["cm_r"], xr, mg))
    return tpm.gather_from_model(gate * kv.to(k.dtype), mg), x[:, -1]


def rwkv_time_mix_decode(engine: ArcaneEngine, params: dict, cfg: ModelConfig,
                         x: torch.Tensor, state: torch.Tensor,
                         last_x: torch.Tensor, mg=None):
    """One-token time mix. x: (B, d); state: (B, H, N, N) (the rank's
    heads with ``mg``); last_x: (B, d) → (out (B, d), state', x)."""
    n = cfg.rwkv.head_size
    b = x.shape[0]
    rr, kk, vv, gg, decay = _wkv_terms(engine, params, cfg, x[:, None, :],
                                       last_x[:, None, :], mg)
    h = rr.shape[2]
    u = params["u"].reshape(h, n)
    state, yt = _wkv_step(state, rr[:, 0], kk[:, 0], vv[:, 0], decay[:, 0], u)
    y = _groupnorm(params, yt[:, None]).reshape(b, 1, h * n).to(x.dtype) * gg
    return _row(engine, params["o"], y, mg)[:, 0], state, x
