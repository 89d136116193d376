"""ctypes wrapper of the flash-attention CUDA kernel
(``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention/kernel.py: flash_attention_pallas``.
q, k and v are read through their strides, so the transposed head views of
the model need no copy. Three variants, picked by ``flash_variant`` from the
operands: ``mma`` (bf16 on tensor cores), ``sflash`` (true f32 on the CUDA
cores: 64-row query tiles, K and V tiles refilled by cp.async as soon as
read, register-tiled products) and ``simt`` (CUDA cores in f32, any strides: the operands the
other two refuse, and their earlier design). ``flash_attention_cuda.launches``
counts the kernel's launches and ``flash_attention_cuda.variants`` the
launches of each variant.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (aligned16, check_cuda, check_dtype,
                                        stream_ptr, strides_of)

CODES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {"simt": 0, "mma": 1, "sflash": 2}
# the earlier kernel of each redesigned variant, which ``_flash`` runs on
# the same operands when asked (chip_smoke.py times the two side by side)
EARLIER = {"mma": "simt", "sflash": "simt"}

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("flash_attention").flash_attention_launch
        V, L, I, F = _build.VP, _build.I64, _build.I32, _build.F32
        fn.argtypes = [V, L, L, L, L, V, L, L, L, L, V, L, L, L, L, V,
                       I, I, I, I, I, I, I, I, I, F, F, I, I, V]
        fn.restype = I
        _FN = fn
    return _FN


def flash_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``mma`` when the tensor-core kernel takes the operands: bf16, D a
    multiple of 16 up to 256, D stride 1, every other stride a multiple of
    16 bytes, each base 16-byte aligned (``mma_ok`` in the source checks the
    same); ``sflash`` for f32 with D a multiple of 4 up to 256 and the same
    layout (``sflash_ok``). Else ``simt``."""
    d = q.shape[-1]
    if q.dtype == torch.bfloat16:
        best, elems = "mma", 8
        if d % 16 or d > 256:
            return "simt"
    else:
        best, elems = "sflash", 4
        if d % 4 or d > 256:
            return "simt"
    for t in (q, k, v):
        st = strides_of(t)
        if st[3] != 1 or any(s % elems for s in st[:3]) or not aligned16(t):
            return "simt"
    return best


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None,
                         kv_len: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D), any strides → (B, Hq, Sq, D)."""
    return _flash(q, k, v, causal, window, softcap, scale, kv_len, None)


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: Optional[int], softcap: Optional[float],
           scale: Optional[float], kv_len: Optional[int],
           variant: Optional[str]) -> torch.Tensor:
    """``flash_attention_cuda`` with the variant named: None takes
    ``flash_variant``'s choice; ``simt``, the earlier kernel of both
    redesigned variants (``EARLIER``), runs on any operands (so that
    ``chip_smoke.py`` holds it to the plain version at the model's shapes
    and times it beside the newer one)."""
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
    best = flash_variant(q, k, v)
    variant = variant or best
    if variant not in (best, EARLIER.get(best, best)):
        raise ValueError(f"flash_attention: variant {variant!r} does not take "
                         "these operands")
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    err = _fn()(q.data_ptr(), *strides_of(q), k.data_ptr(), *strides_of(k),
                v.data_ptr(), *strides_of(v), out.data_ptr(), b, hq, hkv, sq,
                skv, d, kv_len, int(causal), int(window or 0),
                float(softcap or 0.0), float(scale), CODES[q.dtype],
                VARIANTS[variant], stream_ptr(q))
    flash_attention_cuda.launches += 1
    flash_attention_cuda.variants[variant] += 1
    _build.check(err, "flash_attention")
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.variants = dict.fromkeys(VARIANTS, 0)
