"""Per-operand dataflow descriptors — kernel-aware DMA→compute gating.

Own copy of repro.core.dataflow (the descriptors; the pipelined scheduler
that consumes them is not ported yet).

The pipelined C-RT scheduler models NM-Carus-style intra-instruction
pipelining: each source operand streams into the VPU as a
tile-indexed DMA activity train, and the kernel's compute is split into pieces
that start as tiles land. *Which* tiles a compute piece actually needs is a
property of the kernel's dataflow, not of the DMA stream order: output row *i*
of a GEMM needs row *i* of A but **all** of B, whereas an elementwise kernel
needs only row *i* of each operand (Neural Cache's operand-blocked dataflow;
NM-Carus pipelines per operand at sub-instruction granularity).

Each kernel in the library therefore declares one :class:`OperandFlow` per
source operand. A flow carries **two axis policies** — one per matrix
dimension — each drawn from:

* :data:`ELEMENTWISE` — compute piece *i* (of *P*) needs the operand's
  rows/cols up to the proportional share ``ceil((i+1)·extent/P)``.
* :data:`FULL` — the whole axis must land before the first piece (GEMM's B
  along rows, conv weights along both axes).
* :func:`windowed(w)` — proportional share **plus** ``w`` lookahead (conv /
  maxpool windows).

The 1D constants/constructors keep their one-axis meaning (column axis FULL);
:func:`TILED` combines a row-axis policy with a column-axis policy so the
scheduler's 2D tile trains (``pipeline: {tiling: ...}``) can gate an output
tile ``(i, j)`` on exactly the operand tiles it reads — GEMM output tile
``(i, j)`` needs A-band *i* and B-column-tile *j*, not all of B.

``blocks=B`` marks a row-stacked operand (e.g. the 3-channel conv-layer input,
three H-row channel planes stacked into one 3H-row matrix): every output row
reads a window from *each* plane, so the C-RT programs ``B`` interleaved 2D
DMA descriptors, streaming the planes round-robin — after a fraction *f* of
the transfer, a fraction *f* of every plane has landed, and windowed gating
applies per plane instead of degenerating to FULL on the stacked layout.

Kernels that register no descriptor get :data:`FULL` on every operand — the
conservative (sound) default; only declared dataflow earns overlap.

Descriptors change **timing only**. Functional DMA and compute still execute
atomically in dependency order, so serial and pipelined outputs remain
bit-identical regardless of the gating policy.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, Optional, Sequence


class FlowKind(enum.Enum):
    ELEMENTWISE = "elementwise"
    FULL = "full"
    WINDOWED = "windowed"


def _share(kind: FlowKind, window: int, piece: int, n_pieces: int,
           extent: int) -> int:
    """Units of one axis that must have landed before ``piece`` starts."""
    if kind is FlowKind.FULL:
        return extent
    need = math.ceil((piece + 1) * extent / max(n_pieces, 1))
    if kind is FlowKind.WINDOWED:
        need += window
    return min(extent, need)


@dataclasses.dataclass(frozen=True)
class OperandFlow:
    """How one source operand's DMA tiles gate compute pieces.

    ``kind``/``window_rows`` describe the row axis (the one-axis policy);
    ``col_kind``/``window_cols`` describe the column axis and default to FULL
    — a 1D flow is exactly a 2D flow whose column policy is FULL.
    """

    kind: FlowKind
    window_rows: int = 0      # WINDOWED lookahead beyond the proportional share
    blocks: int = 1           # row-stacked planes streamed round-robin
    col_kind: FlowKind = FlowKind.FULL
    window_cols: int = 0

    def __post_init__(self):
        if self.window_rows < 0:
            raise ValueError(f"window_rows must be >= 0, got {self.window_rows}")
        if self.window_cols < 0:
            raise ValueError(f"window_cols must be >= 0, got {self.window_cols}")
        if self.blocks < 1:
            raise ValueError(f"blocks must be >= 1, got {self.blocks}")
        if self.kind is not FlowKind.WINDOWED and self.window_rows:
            raise ValueError(f"window_rows only applies to WINDOWED, "
                             f"got {self.kind}")
        if self.col_kind is not FlowKind.WINDOWED and self.window_cols:
            raise ValueError(f"window_cols only applies to WINDOWED, "
                             f"got {self.col_kind}")

    def rows_required(self, piece: int, n_pieces: int, block_rows: int) -> int:
        """Rows of each block that must have landed before ``piece`` starts."""
        return _share(self.kind, self.window_rows, piece, n_pieces, block_rows)

    def cols_required(self, piece: int, n_pieces: int, cols: int) -> int:
        """Columns that must have landed before column piece ``piece``."""
        return _share(self.col_kind, self.window_cols, piece, n_pieces, cols)


#: Piece *i* needs chunk *i* of the operand (row-for-row streaming).
ELEMENTWISE = OperandFlow(FlowKind.ELEMENTWISE)
#: Every chunk before any piece — the sound default for undeclared kernels.
FULL = OperandFlow(FlowKind.FULL)


def windowed(window_rows: int, *, blocks: int = 1) -> OperandFlow:
    """Piece *i* needs its proportional rows plus ``window_rows`` lookahead."""
    return OperandFlow(FlowKind.WINDOWED, window_rows=window_rows,
                       blocks=blocks)


def TILED(rows: OperandFlow, cols: OperandFlow) -> OperandFlow:
    """Combine a row-axis policy with a column-axis policy into one 2D flow.

    ``rows`` contributes its kind/window/blocks as the row-axis behaviour;
    ``cols`` is reinterpreted along the column axis (its ``window_rows``
    becomes the column lookahead). E.g. GEMM's B is ``TILED(FULL,
    ELEMENTWISE)`` — every row of B before any piece, but only the column
    tiles the output tile's columns project onto.
    """
    if cols.blocks != 1 or cols.col_kind is not FlowKind.FULL:
        raise ValueError("TILED cols policy must be a plain 1-axis flow")
    return OperandFlow(rows.kind, window_rows=rows.window_rows,
                       blocks=rows.blocks, col_kind=cols.kind,
                       window_cols=cols.window_rows)


#: Signature of a kernel's dataflow hook: (src_shapes, params, width) ->
#: one OperandFlow per source operand.
DataflowFn = Callable[..., Sequence[OperandFlow]]


def resolve(dataflow: Optional[DataflowFn],
            src_shapes: Sequence[tuple[int, int]], params: dict,
            width) -> tuple[OperandFlow, ...]:
    """Resolve a kernel's per-operand descriptor at decode time.

    ``None`` (kernel registered without a descriptor) yields FULL for every
    operand — never optimistic. A descriptor returning the wrong arity is a
    kernel-registration bug and raises ``ValueError``.
    """
    if dataflow is None:
        return (FULL,) * len(src_shapes)
    flows = tuple(dataflow(src_shapes, params, width))
    if len(flows) != len(src_shapes):
        raise ValueError(
            f"dataflow descriptor returned {len(flows)} operand flows for "
            f"{len(src_shapes)} source operands")
    for f in flows:
        if not isinstance(f, OperandFlow):
            raise ValueError(f"dataflow descriptor must return OperandFlow "
                             f"instances, got {type(f).__name__}")
    return flows
