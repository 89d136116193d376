"""ctypes wrapper of the xmk4 fused conv-layer CUDA kernel
(``csrc/convlayer.cu``).

Replaces ``repro/kernels/convlayer/kernel.py: conv_layer_pallas``. Takes
contiguous x (C, H, W) and f (F, C, KH, KW) of one dtype (int8, int16,
int32, f32 or bf16) and writes out_dtype, of the input's kind. The TPU
knobs ``block_rows`` and ``interpret`` have no counterpart.
``conv_layer_cuda.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (ELEM_CODES, check_cuda, check_dtype,
                                        stream_ptr)
from repro_torch.kernels.convlayer.ref import check_kinds

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("convlayer").conv_layer_launch
        I = _build.I32
        fn.argtypes = [_build.VP, _build.VP, _build.VP, I, I, I, I, I, I, I,
                       I, _build.F32, _build.VP]
        fn.restype = I
        _FN = fn
    return _FN


def conv_layer_cuda(x: torch.Tensor, f: torch.Tensor, *,
                    negative_slope: float = 0.0,
                    out_dtype=None) -> torch.Tensor:
    """Fused conv(valid) + maxpool(2×2/2) + LeakyReLU on the card.

    x: (C, H, W); f: (F, C, KH, KW) → (F, (H-KH+1)//2, (W-KW+1)//2).
    """
    check_cuda("conv_layer", x, f)
    check_dtype("conv_layer", x, ELEM_CODES)
    if f.dtype != x.dtype:
        raise ValueError(f"conv_layer: x is {x.dtype} but f is {f.dtype}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in ELEM_CODES:
        raise ValueError(f"conv_layer: out_dtype {out_dtype} not supported")
    check_kinds(x.dtype, out_dtype)
    if x.dim() != 3 or f.dim() != 4 or f.shape[1] != x.shape[0] \
            or not x.is_contiguous() or not f.is_contiguous():
        raise ValueError(f"conv_layer: the kernel takes contiguous x (C, H, W) "
                         f"and f (F, C, KH, KW), got {tuple(x.shape)} and "
                         f"{tuple(f.shape)}")
    cch, h, w = x.shape
    nf, _, kh, kw = f.shape
    out_h, out_w = (h - kh + 1) // 2, (w - kw + 1) // 2
    if out_h < 1 or out_w < 1 or x.numel() >= 2**31:
        raise ValueError(f"conv_layer: x {tuple(x.shape)} with a {kh}x{kw} "
                         f"filter has no pooled output")
    out = torch.empty((nf, out_h, out_w), dtype=out_dtype, device=x.device)
    err = _fn()(x.data_ptr(), f.data_ptr(), out.data_ptr(), cch, h, w, nf,
                kh, kw, ELEM_CODES[x.dtype], ELEM_CODES[out_dtype],
                float(negative_slope), stream_ptr(x))
    conv_layer_cuda.launches += 1
    _build.check(err, "conv_layer")
    return out


conv_layer_cuda.launches = 0
