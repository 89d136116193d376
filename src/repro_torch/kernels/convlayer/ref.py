"""Plain PyTorch version of the xmk4 fused conv layer (mirrors repro's
conv_layer_ref)."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import acc_dtype, is_integer
from repro_torch.kernels.maxpool.ref import takes


def check_kinds(x_dtype: torch.dtype, out_dtype: torch.dtype) -> None:
    """An integer layer writes an integer type, a float layer a float type.
    Across kinds the reference's kernel and oracle round differently (the
    kernel by the accumulator's kind, the oracle by the output's), so the
    port takes neither."""
    if is_integer(x_dtype) != is_integer(out_dtype):
        raise ValueError(f"conv_layer: out_dtype {out_dtype} is not of the "
                         f"kind of the input {x_dtype}")


def pool2x2(acc: torch.Tensor) -> torch.Tensor:
    """Max over the 2x2/2 windows of the conv maps acc (F, H', W') (the
    ragged tail dropped), as jnp's max picks: NaN propagates, +0 wins over
    -0 in either order (``torch.amax`` would keep the first of the two)."""
    nf, h, w = acc.shape
    ph, pw = h // 2, w // 2
    win = acc[:, :ph * 2, :pw * 2].reshape(nf, ph, 2, pw, 2)
    pooled = win[:, :, 0, :, 0]
    for i, j in ((0, 1), (1, 0), (1, 1)):
        v = win[:, :, i, :, j]
        pooled = torch.where(takes(v, pooled), v, pooled)
    return pooled


def conv_layer_ref(x: torch.Tensor, f: torch.Tensor, *,
                   negative_slope: float = 0.0, out_dtype=None) -> torch.Tensor:
    """conv(valid) → maxpool 2×2/2 → LeakyReLU; x (C,H,W), f (F,C,KH,KW)."""
    cch, h, w = x.shape
    nf, cf, kh, kw = f.shape
    if cch != cf:
        raise ValueError(f"conv_layer: x {tuple(x.shape)} vs f {tuple(f.shape)}")
    out_dtype = out_dtype or x.dtype
    check_kinds(x.dtype, out_dtype)
    acc = acc_dtype(x.dtype)
    conv_h, conv_w = h - kh + 1, w - kw + 1
    out = torch.zeros((nf, conv_h, conv_w), dtype=acc, device=x.device)
    xl = x.to(acc)
    fl = f.to(acc)
    for di in range(kh):
        for dj in range(kw):
            window = xl[:, di:di + conv_h, dj:dj + conv_w]
            # (1, C, H', W') * (F, C, 1, 1) summed over C; int32 wraps
            out = out + (window[None] * fl[:, :, di, dj, None, None]).sum(1, dtype=acc)
    pooled = pool2x2(out)
    neg = negative_slope * pooled.float()
    if is_integer(out_dtype):
        # two's-complement wrap on the narrowing cast, through int32
        act = torch.where(pooled >= 0, pooled, torch.round(neg).to(acc))
        return act.to(torch.int32).to(out_dtype)
    act = torch.where(pooled >= 0, pooled.float(), neg)
    return act.to(out_dtype)
