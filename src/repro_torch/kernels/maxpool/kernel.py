"""ctypes wrapper of the xmk2 MaxPool CUDA kernel (``csrc/maxpool.cu``).

Replaces ``repro/kernels/maxpool/kernel.py: maxpool_pallas``. Takes a
contiguous (H, W) tensor in int8, int16, int32, f32 or bf16; the kernel
covers exactly the outputs, with no padding. ``maxpool_plan`` picks the
variant from the shapes and x's alignment alone (the C side checks it
again): ``vector`` (2 x 2 windows at stride 2 over rows of a multiple of
16 bytes, x on 16 bytes: 16-byte loads, several outputs a thread),
``band`` (overlapping windows on a map past one wave of threads: row
bands staged in shared memory by 16-byte cp.async, the windows read from
there) or ``scalar`` (any window; one output a thread on a map of at most
one wave of threads, more on a larger one). ``maxpool_cuda.launches``
counts the kernel's launches and ``maxpool_cuda.variants`` the launches
of each variant.

The checks and the plan of a (shape, dtype, window, stride, alignment,
device) are worked out once and kept with the launch's parameters, so a
call repeats only what the key does not fix (device, contiguity) and one
ctypes call of four arguments.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (ELEM_CODES, LaunchCache, ceil_div,
                                        check_cuda, check_dtype, sm_count,
                                        stream_ptr)

VARIANTS = {"vector": 0, "scalar": 1, "band": 2}
THREADS = 128              # a block: outputs of one row
MAX_GRID_Y = 65535         # output rows past it: a block steps over them
WAVE_THREADS = 2048        # threads an SM holds
BAND_THREADS = 256         # a band block
BAND_ROWS = 16             # input rows a band tile stages, about
BAND_TILE_BYTES = 16384    # input bytes a band tile stages, about
BAND_SMEM_MAX = 48 * 1024  # a band block's shared memory, at most (no opt-in)


class Params(ctypes.Structure):
    """The launch's parameters (``csrc/maxpool.cu``: Params)."""
    _fields_ = [(n, ctypes.c_int) for n in ("h", "w", "win", "stride", "code",
                                             "variant", "per_thread", "tile_rows",
                                             "tile_cols", "pitch", "smem")]


class MaxpoolPlan(NamedTuple):
    variant: str
    per_thread: int   # outputs a thread (vector, scalar)
    grid: tuple       # blocks along (OW, OH)
    tile: tuple = (0, 0)   # band: output rows and columns of a tile
    pitch: int = 0    # band: bytes of a staged row
    smem: int = 0     # band: shared memory of a block, bytes


def out_shape(h: int, w: int, win: int, stride: int) -> tuple[int, int]:
    return (h - win) // stride + 1, (w - win) // stride + 1


def takes_vector(w: int, win: int, stride: int, itemsize: int) -> bool:
    """2 x 2 windows at stride 2 over rows of a multiple of 16 bytes (the
    vector variant also needs x on 16 bytes)."""
    return win == stride == 2 and w * itemsize % 16 == 0


def band_tile(h: int, w: int, win: int, stride: int, itemsize: int):
    """(tile rows, tile columns, pitch, shared bytes) of a band block: about
    BAND_ROWS staged rows (at least one output row; a thread walks a tile
    column down them), and as many output columns as fit BAND_TILE_BYTES
    over those rows (at least one; past BAND_THREADS, a multiple of it, so
    every thread walks as many columns), the tiles of a row of one width; a
    staged row takes its elements and up to 15 bytes of alignment, rounded
    up to 16."""
    oh, ow = out_shape(h, w, win, stride)
    tr = max(1, min(oh, (max(win, BAND_ROWS) - win) // stride + 1))
    ir = (tr - 1) * stride + win
    fit = max(1, ((BAND_TILE_BYTES // ir - 16) // itemsize - win) // stride + 1)
    if fit > BAND_THREADS:
        fit -= fit % BAND_THREADS
    tc = ceil_div(ow, ceil_div(ow, fit))
    pitch = ceil_div(((tc - 1) * stride + win) * itemsize + 15, 16) * 16
    return tr, tc, pitch, ir * pitch


def maxpool_plan(h: int, w: int, win: int, stride: int, itemsize: int,
                 sms: int, variant: Optional[str] = None,
                 aligned: bool = True) -> MaxpoolPlan:
    """``band`` (``band_tile``) for overlapping windows (stride < win <= 4)
    on a map of more outputs than one wave of ``sms`` SMs' threads; else
    ``vector`` where the shape takes it and x lies on 16 bytes
    (``aligned``), 8 bytes of outputs a thread; else ``scalar``: one
    output a thread where the outputs fit one wave (the map costs one round
    trip), else 4 outputs a thread for 1-byte types and 2 for the others,
    the most the card's measurements favour. ``variant`` names one:
    ``band`` takes windows of 2 to 4 at stride <= win, ``vector`` what it
    would be picked for, ``scalar`` any (ValueError otherwise)."""
    oh, ow = out_shape(h, w, win, stride)
    vector = takes_vector(w, win, stride, itemsize) and aligned
    if variant == "vector" and not vector:
        raise ValueError(f"maxpool: vector does not take win={win} stride={stride} "
                         f"on {(h, w)} of {itemsize}-byte elements")
    small = oh * ow <= sms * WAVE_THREADS
    band = 2 <= win <= 4 and stride <= win
    if variant == "band" and not band:
        raise ValueError(f"maxpool: band does not take win={win} stride={stride}")
    if variant == "band" or (variant is None and not small and band and stride < win):
        tr, tc, pitch, smem = band_tile(h, w, win, stride, itemsize)
        return MaxpoolPlan("band", 0, (ceil_div(ow, tc), min(ceil_div(oh, tr), MAX_GRID_Y)),
                           (tr, tc), pitch, smem)
    if vector and variant != "scalar":
        per = 8 // itemsize
        return MaxpoolPlan("vector", per,
                           (ceil_div(ow // per, THREADS), min(oh, MAX_GRID_Y)))
    per = 1 if small else (4 if itemsize == 1 else 2)
    return MaxpoolPlan("scalar", per,
                       (ceil_div(ow, THREADS * per), min(oh, MAX_GRID_Y)))


_FN = None
# (shape, dtype, win, stride, variant, x on 16 bytes, device) -> launch
_LAUNCHES = LaunchCache()


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("maxpool").maxpool_launch
        fn.argtypes = [_build.VP] * 4
        fn.restype = _build.I32
        _FN = fn
    return _FN


def _launch_for(x: torch.Tensor, win: int, stride: int,
                variant: Optional[str], aligned: bool):
    """(out shape, variant, Params, its address) for x's key, after the
    checks that the key decides; ``aligned``: x on 16 bytes."""
    check_dtype("maxpool", x, ELEM_CODES)
    if x.dim() != 2:
        raise ValueError(f"maxpool: the kernel takes a contiguous (H, W) "
                         f"tensor, got shape {tuple(x.shape)} strides {x.stride()}")
    h, w = x.shape
    if not 1 <= win <= min(h, w) or stride < 1 or max(h, w) >= 2**31 \
            or variant not in (None, *VARIANTS):
        raise ValueError(f"maxpool: win={win} stride={stride} variant={variant} "
                         f"on {(h, w)}")
    plan = maxpool_plan(h, w, win, stride, x.element_size(), sm_count(x.device),
                        variant, aligned)
    p = Params(h, w, win, stride, ELEM_CODES[x.dtype], VARIANTS[plan.variant],
               plan.per_thread, *plan.tile, plan.pitch, plan.smem)
    return out_shape(h, w, win, stride), plan.variant, p, ctypes.addressof(p)


def maxpool_cuda(x: torch.Tensor, *, win: int = 2,
                 stride: Optional[int] = None,
                 variant: Optional[str] = None) -> torch.Tensor:
    """Max over win x win windows of x (H, W) at ``stride`` (default
    ``win``) on the card; NaN propagates. ``variant`` (for tests and
    timing) names the kernel, as ``maxpool_plan`` takes it (None: the
    plan's pick)."""
    check_cuda("maxpool", x)
    stride = stride or win
    ptr = x.data_ptr()
    key = (x.shape, x.dtype, win, stride, variant, ptr % 16 == 0, x.get_device())
    launch = _LAUNCHES.get(key) or \
        _LAUNCHES.make(key, _launch_for, x, win, stride, variant, key[5])
    if not x.is_contiguous():
        raise ValueError(f"maxpool: the kernel takes a contiguous (H, W) "
                         f"tensor, got shape {tuple(x.shape)} strides {x.stride()}")
    shape, variant, _, params = launch
    out = x.new_empty(shape)
    err = _fn()(ptr, out.data_ptr(), params, stream_ptr(x))
    maxpool_cuda.launches += 1
    maxpool_cuda.variants[variant] += 1
    _build.check(err, "maxpool")
    return out


maxpool_cuda.launches = 0
maxpool_cuda.variants = dict.fromkeys(VARIANTS, 0)
