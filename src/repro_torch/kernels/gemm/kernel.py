"""ctypes wrapper of the xmk0 GeMM CUDA kernel (``csrc/gemm.cu``).

Replaces ``repro/kernels/gemm/kernel.py: gemm_pallas``. The kernel reads A,
B and C through their strides: a transposed view (the unembed's
``table.T``) and a broadcast bias (M stride 0) are taken as they are, with
no copy. ``gemm_variant`` picks the kernel from the operands: ``gemv`` for
M <= 8, ``wgmma`` (TMA + wgmma on tensor cores) for bf16 with A
K-contiguous and B N-contiguous, ``wmma`` for other bf16 layouts, ``fma``
(CUDA cores) for f32 and int8. ``gemm_cuda.launches`` counts the kernel's
launches and ``gemm_cuda.variants`` the launches of each variant.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (acc_dtype, aligned16, check_cuda,
                                        check_dtype, stream_ptr)

CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.int32: 3}
IN_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
VARIANTS = {"gemv": 0, "wgmma": 1, "wmma": 2, "fma": 3}

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("gemm").gemm_launch
        V, L, I, F = _build.VP, _build.I64, _build.I32, _build.F32
        fn.argtypes = [V, L, L, V, L, L, V, L, L, I, V, I, I, I, I, I, F, F,
                       I, V]
        fn.restype = I
        _FN = fn
    return _FN


def _tma_ok(t: torch.Tensor, inner: int) -> bool:
    """A 2-D operand that TMA can tile: inner stride 1, rows of at least
    ``inner`` elements and a multiple of 16 bytes apart, base 16-byte
    aligned."""
    rows, cols = t.stride()
    return cols == 1 and rows % 8 == 0 and rows >= inner and aligned16(t)


def gemm_variant(a: torch.Tensor, b: torch.Tensor) -> str:
    """The kernel that takes A (M, K) @ B (K, N) (``wgmma_ok`` in the
    source checks the same)."""
    m, k = a.shape
    if m <= 8:
        return "gemv"
    if a.dtype != torch.bfloat16:
        return "fma"
    if _tma_ok(a, k) and _tma_ok(b, b.shape[1]):
        return "wgmma"
    return "wmma"


def gemm_cuda(a: torch.Tensor, b: torch.Tensor,
              c: Optional[torch.Tensor] = None, *, alpha: float = 1.0,
              beta: float = 0.0,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """D = alpha * (A @ B) + beta * C on the card; A (M, K), B (K, N),
    C (M, N) of any strides. Raises on what the kernel does not take."""
    return _gemm(a, b, c, alpha, beta, out_dtype, None)


def _gemm(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor],
          alpha: float, beta: float, out_dtype: Optional[torch.dtype],
          variant: Optional[str]) -> torch.Tensor:
    """``gemm_cuda`` with the variant named: None takes ``gemm_variant``'s
    choice, ``wmma`` runs the WMMA kernel on operands that would take
    wgmma (so that ``chip_smoke.py`` holds that kernel to the plain version
    at prefill shapes too)."""
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
    best = gemm_variant(a, b)
    variant = variant or best
    if variant != best and not (variant == "wmma" and best == "wgmma"):
        raise ValueError(f"gemm: variant {variant!r} does not take these "
                         "operands")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    err = _fn()(a.data_ptr(), a.stride(0), a.stride(1),
                b.data_ptr(), b.stride(0), b.stride(1),
                None if c is None else c.data_ptr(),
                0 if c is None else c.stride(0),
                0 if c is None else c.stride(1),
                CODES[c.dtype] if c is not None else 0,
                out.data_ptr(), CODES[out_dtype], m, n, k, CODES[a.dtype],
                float(alpha), float(beta), VARIANTS[variant], stream_ptr(a))
    gemm_cuda.launches += 1
    gemm_cuda.variants[variant] += 1
    _build.check(err, "gemm")
    return out


gemm_cuda.launches = 0
gemm_cuda.variants = dict.fromkeys(VARIANTS, 0)
