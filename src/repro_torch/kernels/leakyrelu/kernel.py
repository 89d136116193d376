"""ctypes wrapper of the xmk1 LeakyReLU CUDA kernel (``csrc/leakyrelu.cu``).

Replaces ``repro/kernels/leakyrelu/kernel.py: leakyrelu_pallas``. Takes a
contiguous tensor of any shape in int8, int16, int32, f32 or bf16 and reads
it flat, with no padding; the grid is sized by the card's SM count.
``leakyrelu_cuda.launches`` counts the kernel's
launches. The dtype check and the launch's parameters of a (size, dtype,
slope, device) are worked out once, so a call passes four arguments to one
ctypes call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (ELEM_CODES, LaunchCache, check_cuda,
                                        check_dtype, sm_count, stream_ptr)


class Params(ctypes.Structure):
    """The launch's parameters (``csrc/leakyrelu.cu``: Params)."""
    _fields_ = [("n", ctypes.c_int64), ("code", ctypes.c_int),
                ("slope", ctypes.c_float), ("sms", ctypes.c_int)]


_FN = None
_LAUNCHES = LaunchCache()     # (numel, dtype, slope, device) -> (Params, address)


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("leakyrelu").leakyrelu_launch
        fn.argtypes = [_build.VP] * 4
        fn.restype = _build.I32
        _FN = fn
    return _FN


def _launch_for(x: torch.Tensor, negative_slope: float):
    check_dtype("leakyrelu", x, ELEM_CODES)
    p = Params(x.numel(), ELEM_CODES[x.dtype], float(negative_slope),
               sm_count(x.device))
    return p, ctypes.addressof(p)


def leakyrelu_cuda(x: torch.Tensor, *,
                   negative_slope: float = 0.01) -> torch.Tensor:
    """x >= 0 ? x : cast(slope * f32(x)) on the card, the product rounded
    half to even for integer dtypes."""
    check_cuda("leakyrelu", x)
    key = (x.numel(), x.dtype, negative_slope, x.get_device())
    launch = _LAUNCHES.get(key) or _LAUNCHES.make(key, _launch_for, x, negative_slope)
    if not x.is_contiguous():
        raise ValueError(f"leakyrelu: the kernel takes a contiguous tensor, "
                         f"got strides {x.stride()}")
    out = torch.empty_like(x)
    err = _fn()(x.data_ptr(), out.data_ptr(), launch[1], stream_ptr(x))
    leakyrelu_cuda.launches += 1
    _build.check(err, "leakyrelu")
    return out


leakyrelu_cuda.launches = 0
