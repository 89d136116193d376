"""Plain PyTorch version of the xmk2 MaxPool kernel (mirrors repro's
maxpool_ref)."""
from __future__ import annotations

from typing import Optional

import torch


def takes(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Where v replaces the running max m, as ``jnp.maximum(m, v)`` picks:
    larger, or NaN (the later of two NaNs), or +0 over -0 (which
    ``torch.maximum`` would leave as it found them)."""
    if not v.is_floating_point():
        return v > m
    return (v > m) | v.isnan() | ((v == m) & m.signbit() & ~v.signbit())


def maxpool_ref(x: torch.Tensor, *, win: int = 2,
                stride: Optional[int] = None) -> torch.Tensor:
    """Max over win x win windows of x (H, W) at ``stride`` (default
    ``win``), the windows walked in row-major order; the ragged tail is
    dropped and NaN propagates."""
    stride = stride or win
    h, w = x.shape
    out_h = (h - win) // stride + 1
    out_w = (w - win) // stride + 1
    acc = None
    for di in range(win):
        for dj in range(win):
            sl = x[di:di + (out_h - 1) * stride + 1:stride,
                   dj:dj + (out_w - 1) * stride + 1:stride]
            acc = sl if acc is None else torch.where(takes(sl, acc), sl, acc)
    return acc
