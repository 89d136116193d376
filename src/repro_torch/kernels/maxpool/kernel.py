"""ctypes wrapper of the xmk2 MaxPool CUDA kernel (``csrc/maxpool.cu``).

Replaces ``repro/kernels/maxpool/kernel.py: maxpool_pallas``. Takes a
contiguous (H, W) tensor in int8, int16, int32, f32 or bf16; the kernel
covers exactly the outputs, with no padding. ``maxpool_cuda.launches``
counts the kernel's launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (ELEM_CODES, check_cuda, check_dtype,
                                        stream_ptr)

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("maxpool").maxpool_launch
        I = _build.I32
        fn.argtypes = [_build.VP, _build.VP, I, I, I, I, I, _build.VP]
        fn.restype = I
        _FN = fn
    return _FN


def maxpool_cuda(x: torch.Tensor, *, win: int = 2,
                 stride: Optional[int] = None) -> torch.Tensor:
    """Max over win x win windows of x (H, W) at ``stride`` (default
    ``win``) on the card; NaN propagates."""
    check_cuda("maxpool", x)
    check_dtype("maxpool", x, ELEM_CODES)
    stride = stride or win
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"maxpool: the kernel takes a contiguous (H, W) "
                         f"tensor, got shape {tuple(x.shape)} strides {x.stride()}")
    h, w = x.shape
    if not 1 <= win <= min(h, w) or stride < 1 or max(h, w) >= 2**31:
        raise ValueError(f"maxpool: win={win} stride={stride} on {(h, w)}")
    out = torch.empty(((h - win) // stride + 1, (w - win) // stride + 1),
                      dtype=x.dtype, device=x.device)
    err = _fn()(x.data_ptr(), out.data_ptr(), h, w, win, stride,
                ELEM_CODES[x.dtype], stream_ptr(x))
    maxpool_cuda.launches += 1
    _build.check(err, "maxpool")
    return out


maxpool_cuda.launches = 0
