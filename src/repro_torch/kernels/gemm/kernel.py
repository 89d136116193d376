"""ctypes wrapper of the xmk0 GeMM CUDA kernel (``csrc/gemm.cu``).

Replaces ``repro/kernels/gemm/kernel.py: gemm_pallas``. The kernel reads A,
B and C through their strides: a transposed view (the unembed's
``table.T``) and a broadcast bias (M stride 0) are taken as they are, with
no copy. ``gemm_cuda.launches`` counts the kernel's launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (acc_dtype, check_cuda, check_dtype,
                                        stream_ptr)

CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.int32: 3}
IN_DTYPES = (torch.float32, torch.bfloat16, torch.int8)

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("gemm").gemm_launch
        V, L, I, F = _build.VP, _build.I64, _build.I32, _build.F32
        fn.argtypes = [V, L, L, V, L, L, V, L, L, I, V, I, I, I, I, I, F, F, V]
        fn.restype = I
        _FN = fn
    return _FN


def gemm_cuda(a: torch.Tensor, b: torch.Tensor,
              c: Optional[torch.Tensor] = None, *, alpha: float = 1.0,
              beta: float = 0.0,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """D = alpha * (A @ B) + beta * C on the card; A (M, K), B (K, N),
    C (M, N) of any strides. Raises on what the kernel does not take."""
    check_cuda("gemm", a, b, *(() if c is None else (c,)))
    check_dtype("gemm a", a, IN_DTYPES)
    if b.dtype != a.dtype:
        raise ValueError(f"gemm: a is {a.dtype} but b is {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm: shapes {tuple(a.shape)} x {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if max(m, n, k) >= 2**31:
        raise ValueError("gemm: a dimension exceeds the int32 range")
    if c is not None:
        check_dtype("gemm c", c, CODES)
        if tuple(c.shape) != (m, n):
            raise ValueError(f"gemm: c has shape {tuple(c.shape)}, not {(m, n)}")
    if out_dtype is None:
        acc = acc_dtype(a.dtype)
        out_dtype = acc if acc == torch.int32 else a.dtype
    if out_dtype not in CODES:
        raise ValueError(f"gemm: out_dtype {out_dtype} not supported")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    err = _fn()(a.data_ptr(), a.stride(0), a.stride(1),
                b.data_ptr(), b.stride(0), b.stride(1),
                None if c is None else c.data_ptr(),
                0 if c is None else c.stride(0),
                0 if c is None else c.stride(1),
                CODES[c.dtype] if c is not None else 0,
                out.data_ptr(), CODES[out_dtype], m, n, k, CODES[a.dtype],
                float(alpha), float(beta), stream_ptr(a))
    gemm_cuda.launches += 1
    _build.check(err, "gemm")
    return out


gemm_cuda.launches = 0
