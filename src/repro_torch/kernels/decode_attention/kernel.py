"""ctypes wrapper of the decode-attention CUDA kernel
(``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention/kernel.py:
decode_attention_pallas``. The lengths stay on the device: the kernel reads
them, and nothing is copied to the host. ``decode_attention_cuda.launches``
counts the kernel's launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_cuda, check_dtype, stream_ptr

CODES = {torch.float32: 0, torch.bfloat16: 1}

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("decode_attention").decode_attention_launch
        V, L, I, F = _build.VP, _build.I64, _build.I32, _build.F32
        fn.argtypes = [V, L, L, L, L, V, L, L, L, V, L, L, L, V, V,
                       I, I, I, I, I, I, F, F, I, V]
        fn.restype = I
        _FN = fn
    return _FN


def _check_cache(name: str, t: torch.Tensor) -> None:
    align = 4 * t.element_size()
    if t.stride(3) != 1 or t.stride(2) % 4 or t.data_ptr() % align \
            or t.stride(0) % 4 or t.stride(1) % 4:
        raise ValueError(f"decode_attention: {name} needs a unit D stride, "
                         f"other strides a multiple of 4 and {align}-byte "
                         f"alignment, got strides {t.stride()}")


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, *,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None,
                          window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hkv, G, D) any strides; k, v: (B, Hkv, S, D); lengths: (B,)
    int32 on the card → (B, Hkv, G, D)."""
    check_cuda("decode_attention", q, k, v, lengths)
    check_dtype("decode_attention q", q, CODES)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("decode_attention: q, k and v must share a dtype")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hkv, g, d = q.shape
    if tuple(k.shape[:2]) != (b, hkv) or k.shape[3] != d:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"match the cache {tuple(k.shape)}")
    if d % 16 or d > 256 or g > 8:
        raise ValueError(f"decode_attention: D={d} (a multiple of 16 up to "
                         f"256) and G={g} (up to 8) are what the kernel takes")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,) \
            or lengths.stride(0) != 1:
        raise ValueError("decode_attention: lengths must be a contiguous "
                         "(B,) int32 tensor")
    _check_cache("k", k)
    _check_cache("v", v)
    if window is not None and window <= 0:
        raise ValueError(f"decode_attention: window={window}")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    out = torch.empty((b, hkv, g, d), dtype=q.dtype, device=q.device)
    err = _fn()(q.data_ptr(), *q.stride(), k.data_ptr(), *k.stride()[:3],
                v.data_ptr(), *v.stride()[:3], lengths.data_ptr(),
                out.data_ptr(), b, hkv, g, k.shape[2], d, CODES[q.dtype],
                float(scale), float(softcap or 0.0), int(window or 0),
                stream_ptr(q))
    decode_attention_cuda.launches += 1
    _build.check(err, "decode_attention")
    return out


decode_attention_cuda.launches = 0
