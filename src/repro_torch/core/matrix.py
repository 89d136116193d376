"""Logical matrix registers and deferred (xmr) operand bindings.

Own copy of repro.core.matrix; the width maps to a ``torch.dtype``.

``xmr`` binds an address + shape to a logical matrix register *without moving
data* (paper §IV-A1). Allocation into VPU-local layout is deferred until a kernel
consumes the operand, which lets the Matrix Allocator pick a kernel-dependent
layout. The binding therefore is pure metadata.

Physical bindings are versioned: the hazard checker renames a logical register to
a fresh physical binding when an ``xmr`` would overwrite a reservation still in
use by a pending kernel (paper §IV-B1), which removes WAR/WAW hazards exactly the
way register renaming does in an OoO core.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Optional

import torch

from repro_torch.core.encoding import ElemWidth, NUM_MATRIX_REGS
from repro_torch.core.regions import StridedRegion

_WIDTH_TO_DTYPE = {
    ElemWidth.W: torch.int32,
    ElemWidth.H: torch.int16,
    ElemWidth.B: torch.int8,
}


def torch_dtype(width: ElemWidth) -> torch.dtype:
    """The integer element type of a width suffix."""
    return _WIDTH_TO_DTYPE[width]


@dataclasses.dataclass(frozen=True)
class MatrixBinding:
    """One versioned physical binding of a logical matrix register."""

    phys_id: int            # unique physical tag (renaming target)
    logical: int            # logical register the program named (m0..m31)
    addr: int               # base byte address in main memory
    rows: int
    cols: int
    stride: int             # row stride in *elements* (>= cols)
    width: ElemWidth

    def __post_init__(self):
        if not 0 <= self.logical < NUM_MATRIX_REGS:
            raise ValueError(f"logical register m{self.logical} out of range")
        if self.rows <= 0 or self.cols <= 0:
            raise ValueError("matrix dimensions must be positive")
        if self.stride < self.cols:
            raise ValueError(f"stride {self.stride} < cols {self.cols}")

    @property
    def elem_bytes(self) -> int:
        return self.width.nbytes

    @property
    def row_bytes(self) -> int:
        return self.cols * self.elem_bytes

    @property
    def stride_bytes(self) -> int:
        return self.stride * self.elem_bytes

    @property
    def nbytes(self) -> int:
        """Bytes of *useful* data (effective dims — what the allocator moves)."""
        return self.rows * self.cols * self.elem_bytes

    @property
    def start(self) -> int:
        return self.addr

    @property
    def end(self) -> int:
        """One past the last byte touched in the strided memory footprint."""
        return self.addr + (self.rows - 1) * self.stride_bytes + self.row_bytes

    @property
    def shape(self) -> tuple[int, int]:
        return (self.rows, self.cols)

    @functools.cached_property
    def region(self) -> StridedRegion:
        """Exact 2D byte footprint of this binding in main memory.

        Cached: bindings are frozen, and ``overlaps`` sits in the admission
        and dispatch sweeps (``cached_property`` writes the instance dict
        directly, which frozen dataclasses permit)."""
        return StridedRegion(addr=self.addr, rows=self.rows,
                             row_bytes=self.row_bytes,
                             stride_bytes=self.stride_bytes)

    def overlaps(self, other: "MatrixBinding") -> bool:
        """Exact: True iff the two strided 2D footprints share a byte.

        Interval intersection is necessary but not sufficient: column strips
        of the same row-major array interleave in the flat address space
        without aliasing — the case the strip-mined conv tiling emits.
        Treating those as overlapping would serialize every strip through
        false WAW edges, so the decision is delegated to the exact
        region algebra (:mod:`repro_torch.core.regions`), which also handles
        unequal strides and bands that wrap the stride period.
        """
        return self.region.overlaps(other.region)

    def overlaps_range(self, start: int, end: int) -> bool:
        """Exact: True iff the footprint touches flat interval [start, end)."""
        return self.region.overlaps_interval(start, end)


class MatrixMap:
    """Logical→physical matrix register map with renaming (the C-RT 'matrix map').

    Statically sized (paper §IV-B: static allocation philosophy): the number of
    logical registers is fixed at construction; physical ids grow monotonically
    because a *binding* is metadata only — there is no physical storage to
    exhaust until a kernel allocates cache lines.
    """

    def __init__(self, num_regs: int = NUM_MATRIX_REGS):
        self.num_regs = num_regs
        self._map: list[Optional[MatrixBinding]] = [None] * num_regs
        self._phys_counter = itertools.count()

    def reserve(
        self,
        logical: int,
        addr: int,
        rows: int,
        cols: int,
        stride: int,
        width: ElemWidth,
    ) -> MatrixBinding:
        """Execute an ``xmr``: bind (rename) ``logical`` to a fresh physical tag."""
        if not 0 <= logical < self.num_regs:
            raise ValueError(f"logical register m{logical} out of range")
        binding = MatrixBinding(
            phys_id=next(self._phys_counter),
            logical=logical,
            addr=addr,
            rows=rows,
            cols=cols,
            stride=stride,
            width=width,
        )
        self._map[logical] = binding
        return binding

    def lookup(self, logical: int) -> MatrixBinding:
        b = self._map[logical]
        if b is None:
            raise KeyError(f"m{logical} has no live reservation (missing xmr)")
        return b

    def live_bindings(self) -> list[MatrixBinding]:
        return [b for b in self._map if b is not None]
