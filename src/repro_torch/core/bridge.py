"""CV-X-IF bridge + host-side programming API (paper §III-B, Listing 1).

The bridge samples the offloaded instruction's opcode/func5 and the three
operand registers, raises the eCPU "interrupt" (a decode call here), and
relays the accept/reject outcome back over the CV-X-IF. The host then commits
or kills; committed operations complete out-of-order while the host continues.

`ArcaneCoprocessor` is the application-facing wrapper providing the intrinsics
used in the paper's Listing 1 (`_xmr_w`, `_gemm_w`, `_conv_layer_w`, ...) plus
typed helpers for examples/benchmarks. Matrix data lives in simulated main
memory; loads/stores go through the cache with full hazard checking.

Counterpart of repro.core.bridge. Matrices cross the host interface as
tensors: ``place``/``store`` take a tensor (or an array) and write its
elements in the width's integer type; ``gather`` returns a tensor on the
runtime's device.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.encoding import (ElemWidth, Offload, encode_xmk,
                                       encode_xmr)
from repro_torch.core.isa import KernelError, fx_encode
from repro_torch.core.matrix import torch_dtype
from repro_torch.core.runtime import CacheRuntime


class XifResult(enum.Enum):
    ACCEPT = "accept"
    REJECT = "reject"


@dataclasses.dataclass
class OffloadRecord:
    offload: Offload
    result: XifResult
    committed: bool = False
    killed: bool = False


class Bridge:
    """Models the offload/accept/commit/kill handshake."""

    def __init__(self, runtime: CacheRuntime):
        self.runtime = runtime
        self.log: list[OffloadRecord] = []

    def offload(self, off: Offload) -> OffloadRecord:
        try:
            off.instr  # decode raises on malformed words
            rec = OffloadRecord(offload=off, result=XifResult.ACCEPT)
        except Exception:
            rec = OffloadRecord(offload=off, result=XifResult.REJECT)
            self.log.append(rec)
            return rec
        self.log.append(rec)
        return rec

    def commit(self, rec: OffloadRecord) -> None:
        """Host commits: the eCPU decodes and queues; execution is OoO."""
        if rec.result is not XifResult.ACCEPT:
            raise RuntimeError("cannot commit a rejected offload")
        try:
            self.runtime.decode(rec.offload)
            rec.committed = True
        except KernelError:
            rec.killed = True
            raise

    def kill(self, rec: OffloadRecord) -> None:
        rec.killed = True  # bridge idles on kill acknowledgment


class ArcaneCoprocessor:
    """Host-CPU view of the ARCANE LLC (the Listing-1 programming model)."""

    def __init__(self, runtime: Optional[CacheRuntime] = None, *,
                 device=None, **rt_kwargs):
        if runtime is not None and device is not None and \
                resolve_device(device) != runtime.device:
            raise ValueError(f"device {device} is not the runtime's "
                             f"{runtime.device}")
        self.rt = runtime or CacheRuntime(device=device, **rt_kwargs)
        self.bridge = Bridge(self.rt)
        self._heap = 64  # bump allocator over simulated main memory

    # ---------------------------------------------------------------- memory
    def malloc(self, nbytes: int, align: int = 64) -> int:
        self._heap = (self._heap + align - 1) // align * align
        addr = self._heap
        self._heap += nbytes
        if self._heap > self.rt.memory.size:
            raise MemoryError("simulated main memory exhausted")
        return addr

    def place(self, arr, width: ElemWidth) -> int:
        """Host-store a matrix into fresh main memory; returns its address.

        Goes through the cache (host write path) — a direct backdoor write to
        ``MainMemory`` would be incoherent with lines already caching the
        surrounding block (line-granule aliasing).
        """
        t = self._elements(arr, width)
        addr = self.malloc(t.numel() * width.nbytes)
        self.rt.host_store(addr, t)
        return addr

    def gather(self, addr: int, rows: int, cols: int,
               width: ElemWidth) -> torch.Tensor:
        """Host load of a matrix (hazard-checked, through the cache)."""
        raw = self.rt.host_load(addr, rows * cols * width.nbytes)
        return raw.view(torch_dtype(width)).reshape(rows, cols)

    def store(self, addr: int, arr, width: ElemWidth) -> None:
        self.rt.host_store(addr, self._elements(arr, width))

    def _elements(self, arr, width: ElemWidth) -> torch.Tensor:
        """``arr`` (a tensor or an array) in the width's integer type on the
        runtime's device; a wider integer wraps, as numpy's cast does."""
        if isinstance(arr, np.ndarray):
            arr = np.ascontiguousarray(arr)
        return torch.as_tensor(arr).to(torch_dtype(width)).to(self.rt.device)

    # -------------------------------------------------------------- offloads
    def _issue(self, off: Offload) -> None:
        rec = self.bridge.offload(off)
        if rec.result is XifResult.REJECT:
            raise RuntimeError(f"CV-X-IF rejected {off.word:#010x}")
        self.bridge.commit(rec)

    def xmr(self, width: ElemWidth, md: int, addr: int, rows: int, cols: int,
            stride: int = 0) -> None:
        self._issue(encode_xmr(width, addr, stride, md, cols, rows))

    def xmk(self, n: int, width: ElemWidth, md: int, ms1: int = 0, ms2: int = 0,
            ms3: int = 0, alpha: int = 0, beta: int = 0) -> None:
        self._issue(encode_xmk(n, width, md, ms1, ms2, ms3, alpha, beta))

    def barrier(self) -> None:
        self.rt.barrier()

    # --------------------------------------------- Listing-1 style intrinsics
    def _xmr(self, width, md, addr, stride, rows, cols):
        self.xmr(width, md, addr, rows, cols, stride)

    def _xmr_w(self, md, addr, stride, rows, cols):
        self._xmr(ElemWidth.W, md, addr, stride, rows, cols)

    def _xmr_h(self, md, addr, stride, rows, cols):
        self._xmr(ElemWidth.H, md, addr, stride, rows, cols)

    def _xmr_b(self, md, addr, stride, rows, cols):
        self._xmr(ElemWidth.B, md, addr, stride, rows, cols)

    def _gemm(self, width, md, ms1, ms2, ms3, alpha=1.0, beta=0.0):
        self.xmk(0, width, md, ms1=ms1, ms2=ms2, ms3=ms3,
                 alpha=fx_encode(alpha), beta=fx_encode(beta))

    def _gemm_w(self, md, ms1, ms2, ms3, alpha=1.0, beta=0.0):
        self._gemm(ElemWidth.W, md, ms1, ms2, ms3, alpha, beta)

    def _leakyrelu(self, width, md, ms1, alpha=0.0):
        self.xmk(1, width, md, ms1=ms1, alpha=fx_encode(alpha))

    def _maxpool(self, width, md, ms1, stride, win_size):
        # Table I: stride/win_size travel in rs1's halves.
        self.xmk(2, width, md, ms1=ms1, alpha=stride, beta=win_size)

    def _conv2d(self, width, md, ms1, ms2):
        self.xmk(3, width, md, ms1=ms1, ms2=ms2)

    def _conv_layer(self, width, md, ms1, ms2):
        self.xmk(4, width, md, ms1=ms1, ms2=ms2)

    def _conv_layer_w(self, md, ms1, ms2):
        self._conv_layer(ElemWidth.W, md, ms1, ms2)

    def _conv_layer_h(self, md, ms1, ms2):
        self._conv_layer(ElemWidth.H, md, ms1, ms2)

    def _conv_layer_b(self, md, ms1, ms2):
        self._conv_layer(ElemWidth.B, md, ms1, ms2)
