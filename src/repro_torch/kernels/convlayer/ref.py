"""Plain PyTorch version of the xmk4 fused conv layer (mirrors repro's
conv_layer_ref)."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import acc_dtype, is_integer


def check_kinds(x_dtype: torch.dtype, out_dtype: torch.dtype) -> None:
    """An integer layer writes an integer type, a float layer a float type.
    Across kinds the reference's kernel and oracle round differently (the
    kernel by the accumulator's kind, the oracle by the output's), so the
    port takes neither."""
    if is_integer(x_dtype) != is_integer(out_dtype):
        raise ValueError(f"conv_layer: out_dtype {out_dtype} is not of the "
                         f"kind of the input {x_dtype}")


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
    ph, pw = conv_h // 2, conv_w // 2
    pooled = out[:, :ph * 2, :pw * 2].reshape(nf, ph, 2, pw, 2).amax(dim=(2, 4))
    neg = negative_slope * pooled.float()
    if is_integer(out_dtype):
        # two's-complement wrap on the narrowing cast, through int32
        act = torch.where(pooled >= 0, pooled, torch.round(neg).to(acc))
        return act.to(torch.int32).to(out_dtype)
    act = torch.where(pooled >= 0, pooled.float(), neg)
    return act.to(out_dtype)
