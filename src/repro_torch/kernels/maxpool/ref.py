"""Plain PyTorch version of the xmk2 MaxPool kernel (mirrors repro's
maxpool_ref)."""
from __future__ import annotations

from typing import Optional

import torch


def maxpool_ref(x: torch.Tensor, *, win: int = 2,
                stride: Optional[int] = None) -> torch.Tensor:
    """Max over win x win windows of x (H, W) at ``stride`` (default
    ``win``); the ragged tail is dropped and NaN propagates."""
    stride = stride or win
    h, w = x.shape
    out_h = (h - win) // stride + 1
    out_w = (w - win) // stride + 1
    acc = None
    for di in range(win):
        for dj in range(win):
            sl = x[di:di + (out_h - 1) * stride + 1:stride,
                   dj:dj + (out_w - 1) * stride + 1:stride]
            acc = sl if acc is None else torch.maximum(acc, sl)
    return acc
