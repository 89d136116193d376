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
``decode_variant``. MLA's absorbed decode has an entry of its own,
``mla_decode_attention_cuda``: q against the latent cache ``c`` and its
rope part ``kr`` as the model holds them, the output the r latent columns.
bf16 operands that the ``mla`` variant takes (``mla_takes``) run it, on
the tensor cores, V read from the key rows and no copy of the cache made;
any other operands take the earlier route (``EARLIER``): the cache's keys
``cat(c, kr)`` and values ``pad(c)`` copied, then ``decode_variant``'s
pick. ``decode_attention_cuda.launches`` counts the launches of both
entries (one per call, the merge included) and
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
from repro_torch.kernels.common import (aligned16, ceil_div, check_cuda,
                                        check_dtype, sm_count, stream_ptr,
                                        strides_of)
from repro_torch.kernels.decode_attention.ref import (check_shape, mla_columns,
                                                      mla_keys_values)

CODES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {"narrow": 0, "wide": 1, "mla": 2}
# the earlier design of a redesigned variant: ``_mla(..., "wide")`` runs the
# route MLA's absorbed decode took before the mla variant (cat, pad, wide)
EARLIER = {"mla": "wide"}
NARROW_GMAX, NARROW_DMAX = 8, 256   # what the narrow variant takes
ALIGN = 32           # a split's keys are a multiple of this (ALIGN there)
MAX_SPLITS = 256     # the most splits the merge takes (MAX_SPLITS there)
MLA_TILE = 64        # keys a tile of the mla variant (MTK there)
MLA_MIN_TILES = 4    # tiles a split of the mla variant holds, where S allows
MLA_GMAX, MLA_RMAX, MLA_DMAX = 40, 256, 288   # mla_ok there

_FN = None
_MLA_FN = None


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


def _mla_fn():
    global _MLA_FN
    if _MLA_FN is None:
        fn = _build.load("decode_attention").mla_decode_launch
        V, L, I, F32 = _build.VP, _build.I64, _build.I32, _build.F32
        fn.argtypes = [V, L, L, V, L, L, V, L, L, V, V, V, V,
                       I, I, I, I, I, I, I, F32, V]
        fn.restype = I
        _MLA_FN = fn
    return _MLA_FN


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


# ------------------------------------------- MLA's absorbed decode (mla)
def mla_chunk(s: int, splits: int) -> int:
    """Keys of one split of the mla variant: ceil(S / splits) rounded up
    to ``MLA_TILE``."""
    return ceil_div(ceil_div(s, splits), MLA_TILE) * MLA_TILE


def mla_splits(b: int, s: int, sms: int) -> int:
    """Splits of the latent cache's S axis for the mla variant: about one
    block (of one (batch, split)) for each of the ``sms`` SMs (one fits an
    SM), each split at least ``MLA_MIN_TILES`` tiles of ``MLA_TILE`` keys
    where S allows, so that a split's G x r partials stay few beside the
    rows it reads; no split without a key of [0, S), at most
    ``MAX_SPLITS``. A function of the cache's capacity, never of the
    lengths. The C side refuses a value that leaves a split empty."""
    s = max(s, 1)
    tiles = ceil_div(s, MLA_TILE)
    want = max(1, min(ceil_div(sms, max(b, 1)), ceil_div(tiles, MLA_MIN_TILES),
                      MAX_SPLITS))
    return ceil_div(s, mla_chunk(s, want))


def mla_takes(q: torch.Tensor, c: torch.Tensor, kr: torch.Tensor) -> bool:
    """Whether the mla variant takes q (B, G, r + rope), c (B, S, r) and kr
    (B, S, rope) (``mla_ok`` and the checks of ``mla_decode_launch`` in the
    source take the same): bf16 all three, 1 <= G <= 40, r a multiple of 64
    up to 256, rope a multiple of 16 and at least 16, r + rope <= 288; a
    unit column stride, every other stride a multiple of 16 bytes (and not
    0 where its dimension is stepped: TMA takes no broadcast) and
    16-byte-aligned bases."""
    if q.dim() != 3 or c.dim() != 3 or kr.dim() != 3:
        return False
    r, rope = c.shape[2], kr.shape[2]
    if any(t.dtype != torch.bfloat16 for t in (q, c, kr)) \
            or not 1 <= q.shape[1] <= MLA_GMAX or r % 64 or not 64 <= r <= MLA_RMAX \
            or rope % 16 or rope < 16 or r + rope > MLA_DMAX:
        return False
    return all(t.stride(2) == 1 and aligned16(t)
               and all(x % 8 == 0 and (x > 0 or n == 1)
                       for x, n in zip(strides_of(t)[:2], t.shape[:2]))
               for t in (q, c, kr))


def mla_variant(q: torch.Tensor, c: torch.Tensor, kr: torch.Tensor) -> str:
    """``mla`` where it takes the operands (``mla_takes``), else the pick of
    the earlier route (``decode_variant`` at G heads over r + rope)."""
    if mla_takes(q, c, kr):
        return "mla"
    return decode_variant(q.shape[1], c.shape[2] + kr.shape[2])


def _check_mla(q, c, kr, lengths) -> None:
    if q.dim() != 3 or c.dim() != 3 or kr.dim() != 3 \
            or c.shape[:2] != kr.shape[:2] or q.shape[0] != c.shape[0] \
            or q.shape[2] != c.shape[2] + kr.shape[2]:
        raise ValueError(f"mla_decode_attention: shapes q {tuple(q.shape)}, "
                         f"c {tuple(c.shape)}, kr {tuple(kr.shape)}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (q.shape[0],) \
            or lengths.stride(0) != 1:
        raise ValueError("mla_decode_attention: lengths must be a contiguous "
                         "(B,) int32 tensor")


def mla_decode_attention_cuda(q: torch.Tensor, c: torch.Tensor, kr: torch.Tensor,
                              lengths: torch.Tensor, *, scale: float,
                              return_lse: bool = False):
    """MLA's absorbed decode over the latent cache: q (B, G, r + rope); c
    (B, S, r); kr (B, S, rope); lengths (B,) int32 on the card → (B, G, r)
    in q's dtype; with ``return_lse`` (that output in f32, unrounded, and
    the rows' log-sum-exp (B, G) f32). The same function as
    ``decode_attention_cuda`` of q over the keys cat(c, kr) and the values
    pad(c), its first r columns. The route is picked from the operands
    (``mla_variant``) before any launch."""
    return _mla(q, c, kr, lengths, scale, return_lse, None)


def _mla(q, c, kr, lengths, scale, return_lse=False, variant=None):
    """``mla_decode_attention_cuda`` with the route named: None takes
    ``mla_variant``'s pick; ``wide``, the earlier route (``EARLIER``), runs
    on any operands the kernel takes: the cat and pad copies, then the
    wide variant (so that ``chip_smoke.py`` holds it to the plain version
    at the mla variant's shapes and times it beside it)."""
    check_cuda("mla_decode_attention", q, c, kr, lengths)
    _check_mla(q, c, kr, lengths)
    best = mla_variant(q, c, kr)
    variant = variant or best
    if variant not in (best, EARLIER.get(best)):
        raise ValueError(f"mla_decode_attention: variant {variant!r} does not "
                         "take these operands")
    b, g, d = q.shape
    r = c.shape[2]
    if variant != "mla":
        out = _decode(q[:, None], *mla_keys_values(c, kr, q.dtype), lengths, None,
                      scale, None, variant, return_lse)
        return mla_columns(out, r, return_lse)
    s = c.shape[1]
    splits = mla_splits(b, s, sm_count(q.device))
    out = torch.empty((b, g, r), device=q.device,
                      dtype=torch.float32 if return_lse else q.dtype)
    ws = torch.empty(b * splits * g * (r + 2), dtype=torch.float32, device=q.device)
    lse = (torch.empty((b, g), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = _mla_fn()(q.data_ptr(), *strides_of(q)[:2], c.data_ptr(),
                    *strides_of(c)[:2], kr.data_ptr(), *strides_of(kr)[:2],
                    lengths.data_ptr(), out.data_ptr(), ws.data_ptr(),
                    None if lse is None else lse.data_ptr(), b, g, s, r,
                    kr.shape[2], splits, CODES[q.dtype], float(scale),
                    stream_ptr(q))
    decode_attention_cuda.launches += 1
    decode_attention_cuda.variants["mla"] += 1
    _build.check(err, "mla_decode_attention")
    return out if lse is None else (out, lse)
