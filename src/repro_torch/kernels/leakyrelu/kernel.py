"""ctypes wrapper of the xmk1 LeakyReLU CUDA kernel (``csrc/leakyrelu.cu``).

Replaces ``repro/kernels/leakyrelu/kernel.py: leakyrelu_pallas``. Takes a
contiguous tensor of any shape in int8, int16, int32, f32 or bf16 and reads
it flat, with no padding; the grid is sized by the card's SM count.
``leakyrelu_cuda.launches`` counts the kernel's
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (ELEM_CODES, check_cuda, check_dtype,
                                        sm_count, stream_ptr)

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("leakyrelu").leakyrelu_launch
        fn.argtypes = [_build.VP, _build.VP, _build.I64, _build.I32,
                       _build.F32, _build.I32, _build.VP]
        fn.restype = _build.I32
        _FN = fn
    return _FN


def leakyrelu_cuda(x: torch.Tensor, *,
                   negative_slope: float = 0.01) -> torch.Tensor:
    """x >= 0 ? x : cast(slope * f32(x)) on the card, the product rounded
    half to even for integer dtypes."""
    check_cuda("leakyrelu", x)
    check_dtype("leakyrelu", x, ELEM_CODES)
    if not x.is_contiguous():
        raise ValueError(f"leakyrelu: the kernel takes a contiguous tensor, "
                         f"got strides {x.stride()}")
    out = torch.empty_like(x)
    err = _fn()(x.data_ptr(), out.data_ptr(), x.numel(), ELEM_CODES[x.dtype],
                float(negative_slope), sm_count(x.device), stream_ptr(x))
    leakyrelu_cuda.launches += 1
    _build.check(err, "leakyrelu")
    return out


leakyrelu_cuda.launches = 0
