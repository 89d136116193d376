"""ctypes wrapper of the decode-attention CUDA kernel
(``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention/kernel.py:
decode_attention_pallas``. The cache's S axis is split across blocks
(``decode_splits``); the splits' partial states go to an f32 workspace and a
second kernel of the same call merges them in split order. The lengths stay
on the device: the kernel reads them, and nothing is copied to the host.
Two variants of the split kernel: ``narrow`` (G <= 8, D <= 256: each
thread holds every head's accumulators) and ``wide`` (any shape the
kernel takes, up to MLA's absorbed decode at G = 40, D = 288), picked by
``decode_variant``. ``decode_attention_cuda.launches`` counts the wrapper's
launches (one per call, the merge included) and
``decode_attention_cuda.variants`` the launches of each variant. With
``return_lse`` the merge also writes each row's f32 log-sum-exp (−inf for a
row with no valid key, whose output is 0), in the same launch, and the
output in f32, unrounded (rounded, it is the output without lse): a cache
sharded by sequence merges its ranks' slices with them and rounds once.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (ceil_div, check_cuda, check_dtype,
                                        sm_count, stream_ptr)
from repro_torch.kernels.decode_attention.ref import check_shape

CODES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {"narrow": 0, "wide": 1}
NARROW_GMAX, NARROW_DMAX = 8, 256   # what the narrow variant takes
ALIGN = 32           # a split's keys are a multiple of this (ALIGN there)
MAX_SPLITS = 256     # the most splits the merge takes (MAX_SPLITS there)

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("decode_attention").decode_attention_launch
        V, L, I, F = _build.VP, _build.I64, _build.I32, _build.F32
        fn.argtypes = [V, L, L, L, L, V, L, L, L, V, L, L, L, V, V, V, V,
                       I, I, I, I, I, I, I, I, F, F, I, V]
        fn.restype = I
        _FN = fn
    return _FN


def split_chunk(s: int, splits: int) -> int:
    """Keys of one split: ceil(S / splits) rounded up to ``ALIGN``."""
    return ceil_div(ceil_div(s, splits), ALIGN) * ALIGN


def decode_splits(b: int, hkv: int, s: int, sms: int) -> int:
    """Splits of the cache's S axis: about two (batch, KV head, split)
    blocks for each of the ``sms`` SMs (rounded down, so that they run in
    one round where two fit on an SM), at least one wave, at least
    ``ALIGN`` keys a split, no split without a key of [0, S), and at most
    ``MAX_SPLITS``. A function of the cache's capacity, not of the lengths,
    so no length is read on the host. The C side refuses a value that
    leaves a split empty."""
    pairs = max(b * hkv, 1)
    want = min(MAX_SPLITS, max(1, 2 * sms // pairs, ceil_div(sms, pairs)))
    chunk = max(ALIGN, split_chunk(s, want))
    return max(1, ceil_div(s, chunk))


def decode_variant(g: int, d: int) -> str:
    """``narrow`` where it takes the shape (G <= 8, D <= 256), else
    ``wide`` (the C side checks the pick again)."""
    return "narrow" if g <= NARROW_GMAX and d <= NARROW_DMAX else "wide"


def _check_cache(name: str, t: torch.Tensor) -> None:
    esz = t.element_size()
    if t.stride(3) != 1 or t.data_ptr() % 16 \
            or any(x * esz % 16 for x in t.stride()[:3]):
        raise ValueError(f"decode_attention: {name} needs a unit D stride, "
                         f"other strides a multiple of 16 bytes and 16-byte "
                         f"alignment, got strides {t.stride()}")


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, *,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None,
                          window: Optional[int] = None,
                          return_lse: bool = False):
    """q: (B, Hkv, G, D) any strides; k, v: (B, Hkv, S, D); lengths: (B,)
    int32 on the card → (B, Hkv, G, D) in q's dtype; with ``return_lse``
    (that output in f32, unrounded, and the rows' log-sum-exp (B, Hkv, G)
    f32). A length may be at most 0 (no valid key) or above S (the row ends
    at S; a window starts from the length)."""
    return _decode(q, k, v, lengths, softcap, scale, window, None, return_lse)


def _decode(q, k, v, lengths, softcap, scale, window, variant, return_lse=False):
    """``decode_attention_cuda`` with the variant named: None takes
    ``decode_variant``'s pick; ``wide`` runs on any shape the kernel takes
    (so that the card tests and ``chip_smoke.py`` hold it to the plain
    version at the narrow shapes too)."""
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
    check_shape(g, d, q.element_size())
    best = decode_variant(g, d)
    variant = variant or best
    if variant not in ("wide", best):
        raise ValueError(f"decode_attention: variant {variant!r} does not take "
                         f"G={g}, D={d}")
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
    s = k.shape[2]
    splits = decode_splits(b, hkv, s, sm_count(q.device))
    out = torch.empty((b, hkv, g, d), device=q.device,
                      dtype=torch.float32 if return_lse else q.dtype)
    ws = torch.empty(b * hkv * splits * g * (d + 2), dtype=torch.float32,
                     device=q.device)
    lse = (torch.empty((b, hkv, g), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = _fn()(q.data_ptr(), *q.stride(), k.data_ptr(), *k.stride()[:3],
                v.data_ptr(), *v.stride()[:3], lengths.data_ptr(),
                out.data_ptr(), ws.data_ptr(),
                None if lse is None else lse.data_ptr(), b, hkv, g, s, d, splits,
                CODES[q.dtype], VARIANTS[variant],
                float(scale), float(softcap or 0.0), int(window or 0),
                stream_ptr(q))
    decode_attention_cuda.launches += 1
    decode_attention_cuda.variants[variant] += 1
    _build.check(err, "decode_attention")
    return out if lse is None else (out, lse)


decode_attention_cuda.launches = 0
decode_attention_cuda.variants = dict.fromkeys(VARIANTS, 0)
