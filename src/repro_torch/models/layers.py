"""Foundational layers: norms, embeddings, rotary embeddings, dense dispatch
(counterpart of repro.models.layers).

Params are plain dicts of tensors in the reference's layout. All matrix
multiplies go through the ArcaneEngine (xmk0 dispatch).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.engine import ArcaneEngine
from repro_torch.distributed import tensor_parallel as tpm


def truncated_normal_init(gen: torch.Generator, shape, dtype, scale: float,
                          device) -> torch.Tensor:
    """scale * N(0, 1) truncated to [-2, 2], drawn on ``device`` in f32."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale).to(dtype)


# ----------------------------------------------------------------- norms
def rmsnorm_init(d: int, dtype, device) -> dict:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    # gemma-style (1 + scale) parameterisation: zeros-init == identity
    return (normed * (1.0 + params["scale"].float())).to(x.dtype)


def layernorm_init(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params: dict, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    normed = (xf - mu) * torch.rsqrt(var + eps)
    return (normed * params["scale"].float()
            + params["bias"].float()).to(x.dtype)


def make_norm(kind: str):
    if kind == "rmsnorm":
        return rmsnorm_init, rmsnorm
    if kind == "layernorm":
        return layernorm_init, layernorm
    raise ValueError(kind)


# ----------------------------------------------------------------- dense
def dense_init(gen, d_in: int, d_out: int, dtype, device, *,
               bias: bool = False, scale: Optional[float] = None) -> dict:
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    p = {"w": truncated_normal_init(gen, (d_in, d_out), dtype, scale, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(engine: ArcaneEngine, params: dict, x: torch.Tensor,
          out_dtype=None) -> torch.Tensor:
    """xmk0 dispatch: out = x @ W (+ b, fused as the beta*C epilogue; the
    bias is a broadcast view, read by the kernel through a zero stride), in
    ``out_dtype`` (default ``x``'s)."""
    b = params.get("b")
    if b is None:
        return engine.gemm(x, params["w"], out_dtype=out_dtype)
    c = b.expand(*x.shape[:-1], b.shape[-1])
    return engine.gemm(x, params["w"], c, alpha=1.0, beta=1.0,
                       out_dtype=out_dtype)


def dense_col(engine: ArcaneEngine, params: dict, x: torch.Tensor,
              mg: tpm.ModelGroup) -> torch.Tensor:
    """A column-parallel product: this rank's columns of ``x @ W (+ b)``
    from its column shard of ``W`` (and of ``b``), the input passed through
    ``col_input`` (its gradient summed over the model ranks). The output
    keeps ``x``'s dtype."""
    return dense(engine, params, tpm.col_input(x, mg), x.dtype)


def dense_row(engine: ArcaneEngine, params: dict, x: torch.Tensor,
              mg: tpm.ModelGroup) -> torch.Tensor:
    """A row-parallel product: this rank's rows of ``W`` against its
    columns of ``x``, the ranks' partial products summed in f32
    (``reduce_from_model``), then the bias, once, and one rounding to
    ``x``'s dtype, as one device's product rounds its f32 sum."""
    out = engine.gemm(x, params["w"], out_dtype=torch.float32)
    out = tpm.reduce_from_model(out, mg)
    if "b" in params:
        out = out + params["b"].float()
    return out.to(x.dtype)


# ------------------------------------------------------------- embeddings
def embedding_init(gen, vocab: int, d: int, dtype, device) -> dict:
    return {"table": truncated_normal_init(gen, (vocab, d), dtype, 0.02, device)}


def embed(params: dict, tokens: torch.Tensor, *, scale: bool = False,
          mg: Optional[tpm.ModelGroup] = None) -> torch.Tensor:
    """Rows of the table; with ``mg``, of a table whose rows (the vocab)
    are sharded over the model ranks (``vocab_embed``)."""
    if mg is None:
        out = params["table"][tokens]
    else:
        out = tpm.vocab_embed(params["table"], tokens, mg)
    if scale:
        out = out * math.sqrt(out.shape[-1])      # in the table's dtype
    return out


def unembed(engine: ArcaneEngine, params: dict, x: torch.Tensor,
            *, softcap: Optional[float] = None,
            mg: Optional[tpm.ModelGroup] = None) -> torch.Tensor:
    """f32 logits; with ``mg``, this rank's vocab shard of them (the
    table's rows sharded over the model ranks; the softcap is elementwise)."""
    if mg is not None:
        x = tpm.col_input(x, mg)
    # table.T is a view: the kernel reads the table in place through strides
    logits = engine.gemm(x, params["table"].T, out_dtype=torch.float32)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


# ------------------------------------------------------------------- rope
def rope_frequencies(head_dim: int, *, theta: float = 10000.0,
                     fraction: float = 1.0, device=None) -> torch.Tensor:
    rot_dim = int(head_dim * fraction) // 2 * 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0, fraction: float = 1.0) -> torch.Tensor:
    """x: (B, H, S, D); positions: (B, S) or (S,). Rotates interleaved pairs
    x[..., 0::2], x[..., 1::2] of the first ``fraction`` of D."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta=theta, fraction=fraction, device=x.device)
    rot = 2 * freqs.shape[0]
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[:, None, :, None].float() * freqs      # B,1,S,rot/2
    sin, cos = torch.sin(angles), torch.cos(angles)
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(*o1.shape[:-1], rot)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass.to(out.dtype)], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------ sinusoidal positions
def sinusoidal_positions(max_len: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal position embeddings: (max_len, d) f32."""
    return sinusoidal_at(torch.arange(max_len, device=device), d)


def sinusoidal_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embedding rows for any positions: (*positions.shape, d)
    f32, on the positions' device. The frequencies are
    exp(-log(10000) * i / (half - 1)), computed in f32 in the reference's
    order."""
    half = d // 2
    i = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * i / (half - 1))
    args = positions[..., None].float() * freqs
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def activation(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu
            "relu": F.relu}[name]
