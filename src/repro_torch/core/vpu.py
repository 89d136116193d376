"""Near-memory Vector Processing Unit model (NM-Carus instances, paper §III).

Counterpart of repro.core.vpu. Each VPU owns a slice of the LLC data array
as its vector register file and executes the vector micro-programs the
kernel bodies expand into. The simulator executes the micro-program
semantics with tensor ops on the data array's device (a register file's
bytes are reinterpreted with ``Tensor.view(dtype)``); the *cycle model*
captures the datapath geometry the paper synthesizes:

  * ``lanes`` 32-bit lanes per VPU (2 / 4 / 8 in Table II);
  * packed-SIMD within a lane: a lane retires ``4 / elem_bytes`` element ops
    per cycle (int8 runs 4× faster than int32 — the source of the paper's
    8-bit advantage);
  * MACs count as one datapath op (the MXU analogue on the TPU target);
  * DMA moves ``dma_bytes_per_cycle`` between memory and the register file.

The same geometry drives the Fig. 3 / Fig. 4 reproduction benchmarks.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.cache import ArcaneCache, as_bytes
from repro_torch.core.encoding import ElemWidth
from repro_torch.core.isa import KernelCost, KernelSpec, KernelLibrary
from repro_torch.core.matrix import torch_dtype


@dataclasses.dataclass(frozen=True)
class VPUGeometry:
    lanes: int = 4
    dma_bytes_per_cycle: int = 4     # 32-bit bus, one beat per cycle
    decode_cycles: int = 350         # SW decode + preamble in the eCPU ISR
    schedule_cycles: int = 120       # queue push/pop + VPU selection
    issue_cycles_per_vins: int = 4   # eCPU cost to issue one vector instruction
    vlen_bytes: int = 1024           # vector length == LLC line length, bytes

    def compute_cycles(self, cost: KernelCost, width: ElemWidth) -> int:
        simd = 4 // width.nbytes                 # packed elems per 32-bit lane
        per_cycle = max(1, self.lanes * simd)
        datapath_ops = cost.macs + cost.elementwise
        # issue overhead: one vector instruction per ~vl elements chunk
        vl_elems = self.vlen_bytes // width.nbytes
        n_vins = max(1, math.ceil(datapath_ops / max(vl_elems, 1)))
        return math.ceil(datapath_ops / per_cycle) + n_vins * self.issue_cycles_per_vins

    def dma_cycles(self, nbytes: int, rows: int = 1) -> int:
        # per-row address-generation overhead of the 2D auto-increment DMA
        return math.ceil(nbytes / self.dma_bytes_per_cycle) + 4 * rows


@dataclasses.dataclass
class ResidentMatrix:
    """A matrix currently materialised in a VPU's register file."""

    phys_id: int
    vpu: int
    line_idxs: list[int]
    rows: int
    cols: int
    width: ElemWidth
    dirty: bool = False      # result not written back yet


class VPU:
    """One near-memory vector unit bound to its LLC line slice."""

    def __init__(self, index: int, cache: ArcaneCache, geometry: VPUGeometry,
                 library: KernelLibrary):
        self.index = index
        self.cache = cache
        self.geometry = geometry
        self.library = library

    # ------------------------------------------------------------- data path
    def lines_needed(self, rows: int, cols: int, width: ElemWidth) -> int:
        nbytes = rows * cols * width.nbytes
        return max(1, math.ceil(nbytes / self.cache.vlen_bytes))

    def load_matrix(self, resident: ResidentMatrix, buf: torch.Tensor) -> None:
        self.cache._scatter_to_lines(resident.line_idxs, as_bytes(buf))

    def read_matrix(self, resident: ResidentMatrix) -> torch.Tensor:
        dt = torch_dtype(resident.width)
        n = resident.rows * resident.cols * dt.itemsize
        raw = self.cache._gather_from_lines(resident.line_idxs, n)
        return raw.view(dt).reshape(resident.rows, resident.cols)

    # ------------------------------------------------------------- execution
    def execute(self, spec: KernelSpec, sources: list[ResidentMatrix],
                dest: ResidentMatrix) -> int:
        """Run the micro-program on register-file-resident operands.

        Returns modeled compute cycles. Raises if an operand is not resident
        on *this* VPU — the scheduler must have allocated it here first.
        """
        for r in (*sources, dest):
            if r.vpu != self.index:
                raise RuntimeError(
                    f"operand phys{r.phys_id} resident on VPU{r.vpu}, "
                    f"kernel dispatched to VPU{self.index}"
                )
        kdef = self.library.lookup(spec.func5)
        src_arrays = [self.read_matrix(r) for r in sources]
        out = kdef.body(src_arrays, spec.params, spec.width)
        if tuple(out.shape) != spec.dst_shape:
            raise RuntimeError(
                f"{spec.name}: body produced {tuple(out.shape)}, preamble "
                f"promised {spec.dst_shape}"
            )
        self.load_matrix(dest, out.to(torch_dtype(spec.width)))
        dest.dirty = True
        return self.geometry.compute_cycles(spec.cost, spec.width)
