"""The software-defined `xmnmc` matrix ISA — kernel library (paper §IV).

Counterpart of repro.core.isa: the same registry, preambles, costs and
dataflow descriptors, with the kernel bodies on tensors.

Only two instruction *types* exist: ``xmr`` (matrix reserve) and ``xmkN``
(matrix kernel, N ∈ [0, 30], selected by ``func5``). What each ``xmkN`` *does*
is software: the Kernel Decoder looks the func5 up in this registry (O(1)) and
runs the registered micro-program. Users extend the ISA by registering new
kernels with :meth:`KernelLibrary.register`.

Each kernel definition carries:
  * ``preamble``  — shape/param validation, destination shape inference
                    (runs in the decoder's interrupt context);
  * ``body``      — the vector micro-program on tensors of the VPU's device;
  * ``cost``      — op counts for the cycle/roofline models.

Built-ins follow Table I:
  xmk0 GeMM (α, β) · xmk1 LeakyReLU (α) · xmk2 MaxPool (stride, win)
  xmk3 2D Conv · xmk4 3-channel 2D Conv Layer (conv+maxpool+ReLU, fused)

Integer semantics: element arithmetic wraps at the operand width (hardware
registers); α/β are signed Q8.8 fixed-point scalars. The bodies are bit for
bit the reference's numpy bodies: products and sums in int64 (wrapping as
numpy's int64 does; no integer matmul runs on CUDA, so GEMM is a broadcast
multiply summed over K in chunks, never through floats), the α/β scaling in
float64 as numpy promotes it, ``torch.round`` (half to even, as
``np.round``), and the write to the operand width as a two's-complement
wrap through int64.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core.dataflow import (ELEMENTWISE, FULL, OperandFlow, TILED,
                                       windowed)
from repro_torch.core.encoding import NUM_XMK, ElemWidth
from repro_torch.core.encoding import fx_decode as _fx
from repro_torch.core.encoding import fx_encode as _fx_encode
from repro_torch.core.matrix import torch_dtype


class KernelError(ValueError):
    """Preamble rejected the operation — bridge answers 'kill'."""


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """Op counts for the cycle model (simulator) and roofline (benchmarks)."""

    macs: int = 0          # multiply-accumulate ops (2 OPs each, as in §V-C)
    elementwise: int = 0   # compare/select/add/shift style ops
    in_bytes: int = 0
    out_bytes: int = 0

    @property
    def ops(self) -> int:
        return 2 * self.macs + self.elementwise


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Decoded, validated kernel instance ready for scheduling."""

    func5: int
    name: str
    width: ElemWidth
    src_shapes: tuple[tuple[int, int], ...]
    dst_shape: tuple[int, int]
    params: dict
    cost: KernelCost
    # Per-source-operand DMA→compute gating policy, resolved at decode time
    # (FULL for every operand when the kernel registers no descriptor).
    dataflow: tuple[OperandFlow, ...] = ()


@dataclasses.dataclass(frozen=True)
class KernelDef:
    func5: int
    name: str
    n_sources: int
    # preamble(src_shapes, params, width) -> (dst_shape, cost); raises KernelError.
    preamble: Callable[[Sequence[tuple[int, int]], dict, ElemWidth], tuple[tuple[int, int], KernelCost]]
    # body(sources, params, width) -> destination tensor (on the sources'
    # device).
    body: Callable[[Sequence[torch.Tensor], dict, ElemWidth], torch.Tensor]
    doc: str = ""
    # dataflow(src_shapes, params, width) -> one OperandFlow per source: how
    # DMA chunks of each operand gate compute pieces in the pipelined
    # scheduler (see repro_torch.core.dataflow). None -> FULL on every operand.
    dataflow: Optional[Callable[[Sequence[tuple[int, int]], dict, ElemWidth],
                                Sequence[OperandFlow]]] = None


class KernelLibrary:
    """func5 → KernelDef registry. O(1) decode; user-extensible (§IV-A2)."""

    def __init__(self):
        self._defs: list[Optional[KernelDef]] = [None] * NUM_XMK

    def register(self, kdef: KernelDef, *, allow_override: bool = False) -> None:
        if not 0 <= kdef.func5 < NUM_XMK:
            raise ValueError(f"func5 {kdef.func5} outside xmk space [0, {NUM_XMK})")
        if self._defs[kdef.func5] is not None and not allow_override:
            raise ValueError(f"xmk{kdef.func5} already bound to "
                             f"{self._defs[kdef.func5].name}")
        self._defs[kdef.func5] = kdef

    def lookup(self, func5: int) -> KernelDef:
        if not 0 <= func5 < NUM_XMK or self._defs[func5] is None:
            raise KernelError(f"xmk{func5}: no kernel registered")
        return self._defs[func5]

    def names(self) -> dict[int, str]:
        return {i: d.name for i, d in enumerate(self._defs) if d is not None}


def register_kernel(
    library: "KernelLibrary", func5: int, name: str, n_sources: int, doc: str = ""
):
    """Decorator pair: ``@register_kernel(lib, 5, "mykernel", 2)`` on the body,
    with ``preamble=`` supplied via the returned registrar."""

    def wrap(body, preamble):
        library.register(KernelDef(func5=func5, name=name, n_sources=n_sources,
                                   preamble=preamble, body=body, doc=doc))
        return body

    return wrap


# ---------------------------------------------------------------------------
# Fixed-point helpers (α/β are signed Q8.8 in the integer datapath).

def fx_encode(x: float) -> int:
    """Encode a float scalar into the 16-bit Q8.8 operand half."""
    try:
        return _fx_encode(x)
    except ValueError as e:
        raise KernelError(str(e)) from None


def _wrap(x: torch.Tensor, width: ElemWidth) -> torch.Tensor:
    """Wrap accumulator results back to the operand width (two's complement
    truncation, i.e. what the hardware register write does): float64 or
    int64 → int64 → the width's type."""
    return x.to(torch.int64).to(torch_dtype(width))


#: Elements of the int64 product block a GEMM sums at once (32 MiB).
_GEMM_BLOCK_ELEMS = 1 << 22


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in int64, exact and wrapping as numpy's int64 matmul: a
    broadcast multiply summed over K in chunks (integer sums wrap the same
    in any order)."""
    a, b = a.to(torch.int64), b.to(torch.int64)
    m, k = a.shape
    n = b.shape[1]
    step = max(1, _GEMM_BLOCK_ELEMS // (m * n))
    acc = torch.zeros((m, n), dtype=torch.int64, device=a.device)
    for k0 in range(0, k, step):
        acc += (a[:, k0:k0 + step, None] * b[None, k0:k0 + step, :]).sum(dim=1)
    return acc


# ---------------------------------------------------------------------------
# Built-in kernels (Table I).

def _gemm_preamble(shapes, params, width):
    (m, k), (k2, n) = shapes[0], shapes[1]
    if k != k2:
        raise KernelError(f"GeMM inner dims mismatch: {shapes[0]} x {shapes[1]}")
    if len(shapes) > 2 and shapes[2] != (m, n):
        raise KernelError(f"GeMM accumulator shape {shapes[2]} != {(m, n)}")
    eb = width.nbytes
    cost = KernelCost(
        macs=m * k * n,
        elementwise=2 * m * n,  # alpha scale + beta*C add
        in_bytes=(m * k + k * n + (m * n if len(shapes) > 2 else 0)) * eb,
        out_bytes=m * n * eb,
    )
    return (m, n), cost


def _gemm_body(sources, params, width):
    a, b = sources[0], sources[1]
    acc = _int_matmul(a, b)
    alpha = _fx(params.get("alpha", fx_encode(1.0)))
    beta = _fx(params.get("beta", fx_encode(0.0)))
    out = acc.to(torch.float64) * alpha
    if len(sources) > 2 and beta != 0.0:
        out = out + sources[2].to(torch.float64) * beta
    return _wrap(torch.round(out), width)

def _leakyrelu_preamble(shapes, params, width):
    (m, n) = shapes[0]
    eb = width.nbytes
    return (m, n), KernelCost(elementwise=2 * m * n, in_bytes=m * n * eb,
                              out_bytes=m * n * eb)


def _leakyrelu_body(sources, params, width):
    x = sources[0].to(torch.int64)
    alpha = _fx(params.get("alpha", fx_encode(0.0)))
    xf = x.to(torch.float64)
    return _wrap(torch.where(x >= 0, xf, torch.round(xf * alpha)), width)

def _maxpool_preamble(shapes, params, width):
    (m, n) = shapes[0]
    win = params.get("win_size", 2)
    stride = params.get("stride", win)
    if win <= 0 or stride <= 0:
        raise KernelError("maxpool window/stride must be positive")
    if m < win or n < win:
        raise KernelError(f"maxpool window {win} larger than input {shapes[0]}")
    om = (m - win) // stride + 1
    on = (n - win) // stride + 1
    eb = width.nbytes
    return (om, on), KernelCost(elementwise=om * on * win * win,
                                in_bytes=m * n * eb, out_bytes=om * on * eb)


def _maxpool_body(sources, params, width):
    x = sources[0]
    win = params.get("win_size", 2)
    stride = params.get("stride", win)
    # (om, on, win, win) windows of x, each reduced to its max
    return x.unfold(0, win, stride).unfold(1, win, stride).amax(dim=(2, 3))


def _conv2d_valid(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Valid 2D cross-correlation in int64 (what CNN stacks call conv) of
    the maps x (..., M, N) with the filters f (..., KM, KN), summed over the
    leading (channel) dims."""
    km, kn = f.shape[-2:]
    windows = x.to(torch.int64).unfold(-2, km, 1).unfold(-2, kn, 1)
    prod = windows * f.to(torch.int64)[..., None, None, :, :]
    dims = tuple(range(prod.dim() - 4)) + (-2, -1)
    return prod.sum(dim=dims)

def _conv2d_preamble(shapes, params, width):
    (m, n), (km, kn) = shapes[0], shapes[1]
    if km > m or kn > n:
        raise KernelError(f"filter {shapes[1]} larger than input {shapes[0]}")
    om, on = m - km + 1, n - kn + 1
    eb = width.nbytes
    return (om, on), KernelCost(macs=om * on * km * kn,
                                in_bytes=(m * n + km * kn) * eb,
                                out_bytes=om * on * eb)


def _conv2d_body(sources, params, width):
    return _wrap(_conv2d_valid(sources[0], sources[1]), width)

def _convlayer_preamble(shapes, params, width):
    """3-channel conv layer (xmk4): input (3·H, W) channel-stacked, filter
    (3·k, k) channel-stacked; fused conv → 2×2 maxpool → ReLU (§IV-A)."""
    (m3, n), (km3, kn) = shapes[0], shapes[1]
    if m3 % 3 or km3 % 3:
        raise KernelError("xmk4 expects 3 channel-stacked rows (rows % 3 == 0)")
    m, km = m3 // 3, km3 // 3
    if km > m or kn > n:
        raise KernelError("filter larger than input")
    cm, cn = m - km + 1, n - kn + 1
    if cm < 2 or cn < 2:
        raise KernelError("conv output smaller than 2x2 pool window")
    om, on = cm // 2, cn // 2
    eb = width.nbytes
    cost = KernelCost(
        macs=3 * cm * cn * km * kn,
        elementwise=om * on * 4 + om * on,  # pool compares + relu
        in_bytes=(m3 * n + km3 * kn) * eb,
        out_bytes=om * on * eb,
    )
    return (om, on), cost


def _convlayer_body(sources, params, width):
    x3, f3 = sources[0], sources[1]
    m = x3.shape[0] // 3
    km = f3.shape[0] // 3
    acc = _conv2d_valid(x3.reshape(3, m, x3.shape[1]),
                        f3.reshape(3, km, f3.shape[1]))
    # maxpool 2x2 stride 2 on the accumulator, then ReLU, then width wrap.
    cm, cn = acc.shape
    om, on = cm // 2, cn // 2
    pooled = acc[: om * 2, : on * 2].reshape(om, 2, on, 2).amax(dim=(1, 3))
    return _wrap(pooled.clamp_min(0), width)


# ---------------------------------------------------------------------------
# Per-operand dataflow descriptors (pipelined-scheduler gating; §IV-B timing).
# Each flow carries a row-axis and a column-axis policy (TILED); the column
# axis only becomes visible when the scheduler runs with 2D tiling enabled —
# with a single column tile per operand the column policy is vacuous and the
# gating reduces exactly to the 1D row-train model.

def _gemm_dataflow(shapes, params, width):
    # Output tile (i, j) = A-band i @ B-column-tile j (+ beta*C tile (i, j)):
    # A streams row-for-row and is read across all its columns (the inner
    # dimension); B needs every row but only the output tile's column tile;
    # the accumulator streams tile-for-tile.
    return (ELEMENTWISE, TILED(FULL, ELEMENTWISE)) \
        + (TILED(ELEMENTWISE, ELEMENTWISE),) * (len(shapes) - 2)


def _leakyrelu_dataflow(shapes, params, width):
    return (TILED(ELEMENTWISE, ELEMENTWISE),)


def _maxpool_dataflow(shapes, params, width):
    # Output element (i, j) reads the input window at (i*stride, j*stride):
    # the overhang beyond the proportional share is at most `win` on each
    # axis.
    win = params.get("win_size", 2)
    return (TILED(windowed(win), windowed(win)),)


def _conv2d_dataflow(shapes, params, width):
    # Valid conv: output tile (i, j) reads input rows i .. i+km-1 and cols
    # j .. j+kn-1; the filter is read in full by every output element.
    km, kn = shapes[1]
    return (TILED(windowed(km), windowed(kn)), FULL)


def _convlayer_dataflow(shapes, params, width):
    # 3-channel-stacked input (3H rows = three H-row planes): every output
    # row reads a k-row window from EACH plane, so the planes stream as three
    # round-robin-interleaved DMA trains; the 2x2 pool consumes two conv
    # rows/cols per output element, hence the +2 lookahead on top of the
    # filter window on both axes.
    km = shapes[1][0] // 3
    kn = shapes[1][1]
    return (TILED(windowed(km + 2, blocks=3), windowed(kn + 2)), FULL)


def default_library() -> KernelLibrary:
    lib = KernelLibrary()
    lib.register(KernelDef(0, "gemm", 3, _gemm_preamble, _gemm_body,
                           "D = alpha * ms1 @ ms2 + beta * ms3 (Q8.8 scalars)",
                           dataflow=_gemm_dataflow))
    lib.register(KernelDef(1, "leakyrelu", 1, _leakyrelu_preamble, _leakyrelu_body,
                           "D = x >= 0 ? x : alpha * x (alpha Q8.8)",
                           dataflow=_leakyrelu_dataflow))
    lib.register(KernelDef(2, "maxpool", 1, _maxpool_preamble, _maxpool_body,
                           "D = maxpool(ms1, win_size, stride)",
                           dataflow=_maxpool_dataflow))
    lib.register(KernelDef(3, "conv2d", 2, _conv2d_preamble, _conv2d_body,
                           "D = conv2d_valid(ms1, ms2)",
                           dataflow=_conv2d_dataflow))
    lib.register(KernelDef(4, "conv_layer", 2, _convlayer_preamble, _convlayer_body,
                           "D = relu(maxpool2x2(conv3ch(ms1, ms2))) — fused",
                           dataflow=_convlayer_dataflow))
    return lib
