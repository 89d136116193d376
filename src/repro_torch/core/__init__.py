"""ARCANE core — the paper's contribution (counterpart of repro.core).

Simulator stack (paper-faithful): encoding → bridge → runtime (C-RT) →
cache/VPUs, its memory and cache lines as tensors on one device. Production
stack: ``repro_torch.core.engine`` (dispatch-time decode) → the hand-written
CUDA kernels of ``repro_torch.kernels``.
"""
from repro_torch.core.encoding import (
    ElemWidth, InstrWord, Offload, Operands, encode_xmk, encode_xmr,
    IllegalInstruction, OPCODE_CUSTOM2, XMR_FUNC5, NUM_XMK, NUM_MATRIX_REGS)
from repro_torch.core.isa import (KernelCost, KernelDef, KernelError,
                                  KernelLibrary, KernelSpec, default_library,
                                  fx_encode)
from repro_torch.core.matrix import MatrixBinding, MatrixMap, torch_dtype
from repro_torch.core.regions import StridedRegion, footprints_overlap
from repro_torch.core.cache import (ArcaneCache, CacheLocked, LineBusy,
                                    MainMemory, ResourceStall)
from repro_torch.core.address_table import (AddressTable, RegionKind,
                                            RegionStatus)
from repro_torch.core.hazards import DependencyTracker, KernelDeps
from repro_torch.core.runtime import CacheRuntime, PhaseStats
from repro_torch.core.vpu import VPU, VPUGeometry, ResidentMatrix
from repro_torch.core.bridge import ArcaneCoprocessor, Bridge, XifResult
from repro_torch.core.program import (
    Buffer, KernelOp, KernelProgram, ProgramBuilder, ProgramError, ProgramRun,
    View, PROGRAM_VERSION, issue_program, place_program, reference_images,
    run_program)
from repro_torch.core.session import IssueHandle, RuntimeSession

__all__ = [
    "ElemWidth", "InstrWord", "Offload", "Operands", "encode_xmk", "encode_xmr",
    "IllegalInstruction", "OPCODE_CUSTOM2", "XMR_FUNC5", "NUM_XMK",
    "NUM_MATRIX_REGS", "KernelCost", "KernelDef", "KernelError",
    "KernelLibrary", "KernelSpec", "default_library", "fx_encode",
    "MatrixBinding", "MatrixMap", "torch_dtype", "StridedRegion",
    "footprints_overlap", "ArcaneCache", "CacheLocked",
    "LineBusy", "MainMemory", "ResourceStall", "AddressTable", "RegionKind",
    "RegionStatus", "DependencyTracker", "KernelDeps", "CacheRuntime",
    "PhaseStats", "VPU", "VPUGeometry", "ResidentMatrix", "ArcaneCoprocessor",
    "Bridge", "XifResult", "Buffer", "KernelOp", "KernelProgram",
    "ProgramBuilder", "ProgramError", "ProgramRun", "View", "PROGRAM_VERSION",
    "issue_program", "place_program", "reference_images", "run_program",
    "IssueHandle", "RuntimeSession",
]
