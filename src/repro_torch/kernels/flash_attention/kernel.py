"""ctypes wrapper of the flash-attention CUDA kernel
(``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention/kernel.py: flash_attention_pallas``.
q, k and v are read through their strides, so the transposed head views of
the model need no copy. ``flash_attention_cuda.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_cuda, check_dtype, stream_ptr

CODES = {torch.float32: 0, torch.bfloat16: 1}

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("flash_attention").flash_attention_launch
        V, L, I, F = _build.VP, _build.I64, _build.I32, _build.F32
        fn.argtypes = [V, L, L, L, L, V, L, L, L, L, V, L, L, L, L, V,
                       I, I, I, I, I, I, I, I, I, F, F, I, V]
        fn.restype = I
        _FN = fn
    return _FN


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None,
                         kv_len: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D), any strides → (B, Hq, Sq, D)."""
    check_cuda("flash_attention", q, k, v)
    check_dtype("flash_attention q", q, CODES)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k and v must share a dtype")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)}")
    if d % 4 or d > 256:
        raise ValueError(f"flash_attention: D={d} (a multiple of 4 up to "
                         "256) is what the kernel takes")
    if kv_len is None:
        kv_len = skv
    if not 0 <= kv_len <= skv:
        raise ValueError(f"flash_attention: kv_len={kv_len} outside [0, {skv}]")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window={window}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    err = _fn()(q.data_ptr(), *q.stride(), k.data_ptr(), *k.stride(),
                v.data_ptr(), *v.stride(), out.data_ptr(), b, hq, hkv, sq,
                skv, d, kv_len, int(causal), int(window or 0),
                float(softcap or 0.0), float(scale), CODES[q.dtype],
                stream_ptr(q))
    flash_attention_cuda.launches += 1
    _build.check(err, "flash_attention")
    return out


flash_attention_cuda.launches = 0
