"""ctypes wrapper of the xmk4 fused conv-layer CUDA kernel
(``csrc/convlayer.cu``).

Replaces ``repro/kernels/convlayer/kernel.py: conv_layer_pallas``. Takes
contiguous x (C, H, W) and f (F, C, KH, KW) of one dtype (int8, int16,
int32, f32 or bf16) and writes out_dtype, of the input's kind. The TPU
knobs ``block_rows`` and ``interpret`` have no counterpart.
``conv_variant`` picks the kernel from the operands: ``mma`` (implicit GEMM
on mma.sync tensor cores) for bf16 from 16 filters and int8 from 4
(``MMA_MIN_FILTERS``), ``simt`` (CUDA cores) otherwise: int16, int32, f32
(true f32, never TF32) and fewer filters. ``mma_rows`` is the order in
which an ``mma`` block lays its conv outputs along M.
``conv_layer_cuda.launches`` counts the kernel's launches and
``conv_layer_cuda.variants`` the launches of each variant. The checks and
the launch's parameters of a (shapes, dtypes, slope, variant, device) are
worked out once, so a call passes five arguments to one ctypes call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (ELEM_CODES, LaunchCache, check_cuda,
                                        check_dtype, stream_ptr)
from repro_torch.kernels.convlayer.ref import check_kinds

VARIANTS = {"mma": 0, "simt": 1}
# the filter count from which mma is the faster, by dtype (chip_smoke's
# 3x226x226 k=3 rows at 1 to 64 filters, both variants timed, on the H100):
# bf16 takes simt up to 8 filters and mma from 16, int8 ties at 2 and takes
# mma from 4
MMA_MIN_FILTERS = {torch.bfloat16: 16, torch.int8: 4}
# an mma block (csrc/convlayer.cu, namespace mma): PY x PX pooled outputs
# (M = 4 * PY * PX conv outputs), 4 warps of 8 pooled outputs, NT filters
MMA_PY, MMA_PX, MMA_WARPS, MMA_NT = 2, 16, 4, 64


class Params(ctypes.Structure):
    """The launch's parameters (``csrc/convlayer.cu``: LayerParams)."""
    _fields_ = [(n, ctypes.c_int) for n in ("c", "h", "w", "f", "kh", "kw",
                                             "in_code", "out_code")] + \
        [("slope", ctypes.c_float), ("variant", ctypes.c_int)]


_FN = None
# (x shape, f shape, dtypes, out_dtype, slope, variant, device) ->
# (out shape, out dtype, variant, Params, its address)
_LAUNCHES = LaunchCache()


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("convlayer").conv_layer_launch
        fn.argtypes = [_build.VP] * 5
        fn.restype = _build.I32
        _FN = fn
    return _FN


def conv_variant(x: torch.Tensor, f: torch.Tensor) -> str:
    """The kernel that takes x (C, H, W) and f (F, C, KH, KW): ``mma`` for
    bf16 and int8 with at least ``MMA_MIN_FILTERS[dtype]`` filters,
    ``simt`` otherwise."""
    least = MMA_MIN_FILTERS.get(x.dtype)
    return "mma" if least is not None and f.shape[0] >= least else "simt"


def mma_rows() -> dict:
    """(warp, m-tile, row) -> (conv row, conv col) within an mma block's
    tile of 2 * MMA_PY x 2 * MMA_PX conv outputs. Lane 4 g + t holds rows g
    and g + 8 of both of its warp's m-tiles: m-tile 0 the top-left (row g)
    and top-right (g + 8) conv outputs of pooled output 8 w + g, m-tile 1
    the bottom-left and bottom-right."""
    rows = {}
    for w in range(MMA_WARPS):
        for g in range(8):
            py, px = divmod(8 * w + g, MMA_PX)
            for mt in (0, 1):
                for right in (0, 1):
                    rows[(w, mt, g + 8 * right)] = (2 * py + mt, 2 * px + right)
    return rows


def conv_layer_cuda(x: torch.Tensor, f: torch.Tensor, *,
                    negative_slope: float = 0.0, out_dtype=None,
                    variant: str | None = None) -> torch.Tensor:
    """Fused conv(valid) + maxpool(2×2/2) + LeakyReLU on the card.

    x: (C, H, W); f: (F, C, KH, KW) → (F, (H-KH+1)//2, (W-KW+1)//2).
    ``variant`` (for tests and timing) names the kernel: None takes
    ``conv_variant``'s choice; ``simt`` takes any operands, ``mma`` bf16
    and int8 at any filter count.
    """
    check_cuda("conv_layer", x, f)
    key = (x.shape, f.shape, x.dtype, f.dtype, out_dtype, negative_slope,
           variant, x.get_device())
    launch = _LAUNCHES.get(key) or \
        _LAUNCHES.make(key, _launch_for, x, f, negative_slope, out_dtype, variant)
    if not x.is_contiguous() or not f.is_contiguous():
        raise ValueError(f"conv_layer: the kernel takes contiguous x (C, H, W) "
                         f"and f (F, C, KH, KW), got {tuple(x.shape)} and "
                         f"{tuple(f.shape)}")
    shape, out_dtype, variant, _, params = launch
    out = x.new_empty(shape, dtype=out_dtype)
    err = _fn()(x.data_ptr(), f.data_ptr(), out.data_ptr(), params, stream_ptr(x))
    conv_layer_cuda.launches += 1
    conv_layer_cuda.variants[variant] += 1
    _build.check(err, "conv_layer")
    return out


def _launch_for(x: torch.Tensor, f: torch.Tensor, negative_slope: float,
                out_dtype, variant: str | None):
    """(out shape, out dtype, variant, Params, its address) for the key of
    (x, f, ...), after the checks that the key decides."""
    check_dtype("conv_layer", x, ELEM_CODES)
    if f.dtype != x.dtype:
        raise ValueError(f"conv_layer: x is {x.dtype} but f is {f.dtype}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in ELEM_CODES:
        raise ValueError(f"conv_layer: out_dtype {out_dtype} not supported")
    check_kinds(x.dtype, out_dtype)
    if x.dim() != 3 or f.dim() != 4 or f.shape[1] != x.shape[0]:
        raise ValueError(f"conv_layer: the kernel takes contiguous x (C, H, W) "
                         f"and f (F, C, KH, KW), got {tuple(x.shape)} and "
                         f"{tuple(f.shape)}")
    cch, h, w = x.shape
    nf, _, kh, kw = f.shape
    out_h, out_w = (h - kh + 1) // 2, (w - kw + 1) // 2
    if out_h < 1 or out_w < 1 or x.numel() >= 2**31:
        raise ValueError(f"conv_layer: x {tuple(x.shape)} with a {kh}x{kw} "
                         f"filter has no pooled output")
    variant = variant or conv_variant(x, f)
    if variant not in VARIANTS or (variant == "mma" and x.dtype not in MMA_MIN_FILTERS):
        raise ValueError(f"conv_layer: variant {variant!r} does not take "
                         f"{x.dtype}")
    p = Params(cch, h, w, nf, kh, kw, ELEM_CODES[x.dtype], ELEM_CODES[out_dtype],
               float(negative_slope), VARIANTS[variant])
    return (nf, out_h, out_w), out_dtype, variant, p, ctypes.addressof(p)


conv_layer_cuda.launches = 0
conv_layer_cuda.variants = dict.fromkeys(VARIANTS, 0)
