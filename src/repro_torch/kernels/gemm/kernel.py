"""ctypes wrapper of the xmk0 GeMM CUDA kernel (``csrc/gemm.cu``).

Replaces ``repro/kernels/gemm/kernel.py: gemm_pallas``. The kernel reads A,
B and C through their strides: a transposed view (the unembed's
``table.T``) and a broadcast bias (M stride 0) are taken as they are, with
no copy. ``gemm_variant`` picks the kernel from the operands: ``gemv`` for
M <= 8; at M > 8 with A K-contiguous and B N- or K-contiguous (a weight, or
the unembed's ``table.T``), rows 16-byte aligned, ``wgmma`` (TMA + wgmma on
tensor cores) for bf16, ``imma`` (mma.sync on the integer tensor cores)
for int8 and ``sgemm`` (true f32 on the CUDA cores: a cp.async ring and
8x8 register tiles) for f32; ``wmma`` for other bf16 operands, ``fma``
(CUDA cores, the earlier design) for other f32 and int8 operands. At
M <= 8 the GEMV kernels split K across
blocks by ``gemv_plan``; the splits' partial sums go to a workspace and
are added in split order on the card. ``gemm_cuda.launches`` counts the
kernel's launches and ``gemm_cuda.variants`` the launches of each variant.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (acc_dtype, aligned16, ceil_div,
                                        check_cuda, check_dtype, sm_count,
                                        stream_ptr)

CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.int32: 3}
IN_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
VARIANTS = {"gemv": 0, "wgmma": 1, "wmma": 2, "fma": 3, "imma": 4, "sgemm": 5}
# the earlier kernel of each redesigned variant, which ``_gemm`` runs on
# the same operands when asked (chip_smoke.py times the two side by side)
EARLIER = {"wgmma": "wmma", "imma": "fma", "sgemm": "fma"}
GEMV_KC = 1024          # most rows of K a GEMV block takes, B read along N (KC there)
GEMV_NCOLS = 128        # columns of a GEMV strip, B read along N
GEMV_TCOLS = 32         # the same, B read along K
GEMV_NSTEP = 64         # rows a GEMV block steps by, B read along N

_FN = None
_TICKETS: dict = {}     # (device index, stream) -> zeroed int32 counters


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("gemm").gemm_launch
        V, L, I, F = _build.VP, _build.I64, _build.I32, _build.F32
        fn.argtypes = [V, L, L, V, L, L, V, L, L, I, V, I, I, I, I, I, F, F,
                       I, I, I, V, V, V]
        fn.restype = I
        _FN = fn
    return _FN


def _rows16(t: torch.Tensor, inner: int) -> bool:
    """A 2-D operand whose rows TMA or 16-byte copies can tile: inner
    stride 1, rows of at least ``inner`` elements and a multiple of 16
    bytes apart, base 16-byte aligned (``rows16`` in the source)."""
    rows, cols = t.stride()
    return (cols == 1 and rows * t.element_size() % 16 == 0 and rows >= inner
            and aligned16(t))


def gemm_variant(a: torch.Tensor, b: torch.Tensor) -> str:
    """The kernel that takes A (M, K) @ B (K, N) (``mma_layout`` in the
    source checks the same): B may be N-contiguous (a weight) or
    K-contiguous (a transposed view)."""
    m, k = a.shape
    if m <= 8:
        return "gemv"
    tiled = _rows16(a, k) and (_rows16(b, b.shape[1]) or _rows16(b.T, k))
    if a.dtype == torch.bfloat16:
        return "wgmma" if tiled else "wmma"
    if a.dtype == torch.float32:
        return "sgemm" if tiled else "fma"
    return "imma" if tiled else "fma"


def b_layout(b: torch.Tensor) -> str:
    """``t`` where B is read along K (K stride 1: the unembed's ``table.T``),
    ``n`` otherwise (``t_layout`` in the source)."""
    return "t" if b.stride(0) == 1 and b.stride(1) != 1 else "n"


def gemv_plan(n: int, k: int, layout: str, sms: int) -> tuple[int, int]:
    """(splits, chunk) of the GEMV's K axis: at least two waves of ``sms``
    SMs over (column strips x splits), ``chunk`` a multiple of the rows a
    block steps by along N (``GEMV_NSTEP``) and of 32 along K, and no split
    without rows; with B read along N also at most ``GEMV_KC`` rows a split
    (the slice of A a block stages), while along K a block reads A as it
    goes and takes any number of rows; ``plan_ok`` in the source checks the
    same. Strips are ``GEMV_NCOLS`` columns with B read along N,
    ``GEMV_TCOLS`` along K. M and the dtype change the work per byte, not
    the bytes, and do not enter."""
    if layout == "t":
        strips, step, most = ceil_div(n, GEMV_TCOLS), 32, 1
    else:
        strips, step = ceil_div(n, GEMV_NCOLS), GEMV_NSTEP
        most = ceil_div(k, GEMV_KC)
    want = max(ceil_div(2 * sms, max(strips, 1)), most, 1)
    # rounded down, so that the splits reach `want`
    chunk = max(step, ceil_div(k, want) // step * step)
    return max(1, ceil_div(k, chunk)), chunk


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """Zeroed counters, one for each 32 columns of N: each GEMV leaves the
    ones it used at 0 again, so they are made once per device and stream
    (and grown). GEMVs on one stream run one after another and may share
    them; GEMVs on two streams may overlap, so each stream has its own.
    A stream being captured into a CUDA graph must have them already
    (``reserve_tickets``): made in the capture, they would come from the
    graph's pool, and a later growth would free memory the graph uses."""
    key = (device.index, stream)
    t = _TICKETS.get(key)
    need = ceil_div(n, 32)
    if t is None or t.numel() < need:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"gemm: the stream being captured has split-K "
                               f"counters for {0 if t is None else t.numel()} "
                               f"of the {need} 32-column strips this GEMV needs: "
                               "make them before the capture (reserve_tickets)")
        t = _TICKETS[key] = torch.zeros(max(need, 8192), dtype=torch.int32,
                                        device=device)
    return t


def reserve_tickets(device: torch.device, stream: int, like: int):
    """Make ``stream``'s split-K counters before a capture on it, as many as
    stream ``like`` holds: the stream whose eager run of the same step grew
    them to its largest plan's need (``gemv_plan`` depends on the shapes
    only, so the captured step needs no more). Returns them (None where
    ``like`` has none: the step splits no GEMV)."""
    src = _TICKETS.get((device.index, like))
    if src is None:
        return None
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < src.numel():
        t = _TICKETS[key] = torch.zeros_like(src)
    return t


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
    choice; the earlier kernel of a redesigned variant (``EARLIER``: wmma
    for wgmma, fma for imma and sgemm) runs on operands that would take
    the newer one, so that ``chip_smoke.py`` holds it to the plain version
    at the same shapes and times it."""
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
    if variant != best and variant != EARLIER.get(best):
        raise ValueError(f"gemm: variant {variant!r} does not take these "
                         "operands")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    stream = stream_ptr(a)
    splits, chunk, ws, tickets = 1, 0, None, None
    if variant == "gemv":
        splits, chunk = gemv_plan(n, k, b_layout(b), sm_count(a.device))
        if splits > 1:
            ws = torch.empty(splits * m * n, dtype=acc_dtype(a.dtype),
                             device=a.device)
            tickets = _tickets(a.device, stream, n)
    err = _fn()(a.data_ptr(), a.stride(0), a.stride(1),
                b.data_ptr(), b.stride(0), b.stride(1),
                None if c is None else c.data_ptr(),
                0 if c is None else c.stride(0),
                0 if c is None else c.stride(1),
                CODES[c.dtype] if c is not None else 0,
                out.data_ptr(), CODES[out_dtype], m, n, k, CODES[a.dtype],
                float(alpha), float(beta), VARIANTS[variant], splits, chunk,
                None if ws is None else ws.data_ptr(),
                None if tickets is None else tickets.data_ptr(), stream)
    gemm_cuda.launches += 1
    gemm_cuda.variants[variant] += 1
    _build.check(err, "gemm")
    return out


gemm_cuda.launches = 0
gemm_cuda.variants = dict.fromkeys(VARIANTS, 0)
