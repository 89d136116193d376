"""Functional model of the ARCANE LLC (paper §III-A).

Fully-associative cache whose data array doubles as the VPUs' vector register
files: ``n_lines = n_vpus * vregs_per_vpu`` and the line length equals the
maximum vector length (1 KiB in the paper's synthesized configs). Hits resolve
in one cycle; misses/write-backs go through a DMA to main memory; replacement is
a counter-based approximate LRU; the write policy is write-back +
fetch-on-write. A lock register arbitrates host-CPU vs eCPU access; lines
claimed by an in-flight kernel are marked *busy-computing* and are neither
evictable nor host-accessible.

Counterpart of repro.core.cache. Main memory and the data array are
``torch.uint8`` tensors on one explicit device; the line states, tags and
counters that every scheduling decision reads are host metadata, so the
controller never reads the device to decide anything (no ``.item()``, no
boolean indexing): a transfer is one or a few tensor copies enqueued on the
device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch import resolve_device


class CacheLocked(Exception):
    """Host access attempted while the eCPU holds the cache lock (stall)."""


class LineBusy(Exception):
    """Access or eviction attempted on a busy-computing line (stall)."""


class ResourceStall(Exception):
    """No allocatable line available (all candidates busy-computing)."""


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """The bytes of a tensor as a flat ``uint8`` tensor (a view where ``t``
    is contiguous)."""
    t = t.contiguous()
    if t.dim() == 0:
        t = t.reshape(1)
    return t.view(torch.uint8).reshape(-1)


class MainMemory:
    """Flat byte-addressable main (off-chip) memory: ``size`` bytes on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, size: int, device=None):
        self.size = size
        self.data = torch.zeros(size, dtype=torch.uint8,
                                device=resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.data.device

    def read(self, addr: int, n: int) -> torch.Tensor:
        if addr < 0 or addr + n > self.size:
            raise IndexError(f"memory read [{addr}, {addr + n}) out of bounds")
        return self.data[addr : addr + n].clone()

    def write(self, addr: int, buf: torch.Tensor) -> None:
        buf = as_bytes(buf)
        if addr < 0 or addr + buf.numel() > self.size:
            raise IndexError(
                f"memory write [{addr}, {addr + buf.numel()}) out of bounds")
        self.data[addr : addr + buf.numel()] = buf

    # Typed convenience accessors used by examples/tests.
    def write_array(self, addr: int, arr: torch.Tensor) -> None:
        self.write(addr, arr)

    def read_array(self, addr: int, shape: tuple[int, ...],
                   dtype: torch.dtype) -> torch.Tensor:
        n = math.prod(shape) * dtype.itemsize
        return self.read(addr, n).view(dtype).reshape(shape)


@dataclasses.dataclass
class CacheLineState:
    valid: bool = False
    dirty: bool = False
    tag: int = -1              # line-aligned base address of the cached block
    lru: int = 0               # counter-based approximate LRU timestamp
    busy_computing: bool = False
    is_src: bool = False       # CT fast-path flags (§III-A3): line holds a kernel
    is_dst: bool = False       # source / destination operand


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    writebacks: int = 0
    fills: int = 0
    host_stalls: int = 0

    def reset(self) -> None:
        self.hits = self.misses = self.writebacks = self.fills = self.host_stalls = 0


class ArcaneCache:
    """The LLC: cache controller + data array shared with the VPUs."""

    def __init__(
        self,
        memory: MainMemory,
        n_vpus: int = 4,
        vregs_per_vpu: int = 32,
        vlen_bytes: int = 1024,
    ):
        self.memory = memory
        self.n_vpus = n_vpus
        self.vregs_per_vpu = vregs_per_vpu
        self.vlen_bytes = vlen_bytes
        self.n_lines = n_vpus * vregs_per_vpu
        self.lines = [CacheLineState() for _ in range(self.n_lines)]
        # The data array: one row per line; VPU v's vector register r is row
        # v * vregs_per_vpu + r — the memory *is* the register file.
        self.data = torch.zeros((self.n_lines, vlen_bytes), dtype=torch.uint8,
                                device=memory.device)
        # tag -> line for O(1) lookup; at most one valid line per tag (fills
        # only happen on misses, so duplicates cannot arise).
        self._tag_to_line: dict[int, int] = {}
        # Per-VPU busy/dirty line counters: scheduler policy inputs
        # (fewest-dirty-lines, capacity checks) read these every dispatch —
        # maintained incrementally instead of rescanning the line slice.
        self._busy_per_vpu = [0] * n_vpus
        self._dirty_per_vpu = [0] * n_vpus
        self._lru_counter = 0
        self.locked_by_ecpu = False
        self.stats = CacheStats()

    # ------------------------------------------------------------------ util
    def line_of_vreg(self, vpu: int, vreg: int) -> int:
        if not (0 <= vpu < self.n_vpus and 0 <= vreg < self.vregs_per_vpu):
            raise IndexError("vpu/vreg out of range")
        return vpu * self.vregs_per_vpu + vreg

    def vpu_lines(self, vpu: int) -> range:
        return range(vpu * self.vregs_per_vpu, (vpu + 1) * self.vregs_per_vpu)

    def _align(self, addr: int) -> int:
        return addr - (addr % self.vlen_bytes)

    def _touch(self, idx: int) -> None:
        self._lru_counter += 1
        self.lines[idx].lru = self._lru_counter

    def lookup(self, addr: int) -> Optional[int]:
        return self._tag_to_line.get(self._align(addr))

    def _invalidate_tag(self, idx: int) -> None:
        ln = self.lines[idx]
        if ln.valid and self._tag_to_line.get(ln.tag) == idx:
            del self._tag_to_line[ln.tag]

    def dirty_line_count(self, vpu: int) -> int:
        """Scheduler policy input: prefer the VPU with fewest dirty lines."""
        return self._dirty_per_vpu[vpu]

    def free_line_count(self, vpu: int) -> int:
        """Lines of ``vpu`` not claimed by an in-flight kernel."""
        return self.vregs_per_vpu - self._busy_per_vpu[vpu]

    def _set_dirty(self, idx: int, val: bool) -> None:
        ln = self.lines[idx]
        if ln.dirty != val:
            ln.dirty = val
            self._dirty_per_vpu[idx // self.vregs_per_vpu] += 1 if val else -1

    # ------------------------------------------------------------------ lock
    def acquire_lock(self) -> bool:
        """eCPU lock request; not granted during ongoing host ops (modeled as
        always-grantable here because host ops are atomic in the simulator)."""
        if self.locked_by_ecpu:
            return False
        self.locked_by_ecpu = True
        return True

    def release_lock(self) -> None:
        self.locked_by_ecpu = False

    # ------------------------------------------------------------- fill/evict
    def _set_busy(self, idx: int, val: bool) -> None:
        ln = self.lines[idx]
        if ln.busy_computing != val:
            ln.busy_computing = val
            self._busy_per_vpu[idx // self.vregs_per_vpu] += 1 if val else -1

    def _writeback(self, idx: int) -> None:
        ln = self.lines[idx]
        if ln.valid and ln.dirty:
            end = min(ln.tag + self.vlen_bytes, self.memory.size)
            self.memory.write(ln.tag, self.data[idx, : end - ln.tag])
            self.stats.writebacks += 1
        self._set_dirty(idx, False)

    def _victim(self) -> int:
        best, best_lru = -1, None
        for i, ln in enumerate(self.lines):
            if ln.busy_computing:
                continue
            if not ln.valid:
                return i
            if best_lru is None or ln.lru < best_lru:
                best, best_lru = i, ln.lru
        if best < 0:
            raise ResourceStall("all cache lines are busy-computing")
        return best

    def _fill(self, addr: int) -> int:
        """Miss path: pick a victim, write back if dirty, DMA the block in."""
        tag = self._align(addr)
        idx = self._victim()
        self._writeback(idx)
        self._invalidate_tag(idx)
        ln = self.lines[idx]
        end = min(tag + self.vlen_bytes, self.memory.size)
        self.data[idx, : end - tag] = self.memory.read(tag, end - tag)
        if end - tag < self.vlen_bytes:
            self.data[idx, end - tag :] = 0
        ln.valid, ln.tag = True, tag       # dirty already cleared by _writeback
        self._tag_to_line[tag] = idx
        self._set_busy(idx, False)
        ln.is_src = ln.is_dst = False
        self.stats.fills += 1
        self._touch(idx)
        return idx

    # ------------------------------------------------------------- host path
    def _host_access_line(self, addr: int, *, for_write: bool) -> int:
        if self.locked_by_ecpu:
            self.stats.host_stalls += 1
            raise CacheLocked("cache is locked by the eCPU")
        idx = self.lookup(addr)
        if idx is not None:
            if self.lines[idx].busy_computing:
                self.stats.host_stalls += 1
                raise LineBusy(f"line for addr {addr:#x} is busy-computing")
            self.stats.hits += 1
            self._touch(idx)
            return idx
        self.stats.misses += 1
        return self._fill(addr)  # fetch-on-write: misses fill even for stores

    def host_read(self, addr: int, n: int) -> torch.Tensor:
        out = torch.empty(n, dtype=torch.uint8, device=self.data.device)
        pos = 0
        while pos < n:
            a = addr + pos
            idx = self._host_access_line(a, for_write=False)
            off = a - self.lines[idx].tag
            take = min(self.vlen_bytes - off, n - pos)
            out[pos : pos + take] = self.data[idx, off : off + take]
            pos += take
        return out

    def host_write(self, addr: int, buf: torch.Tensor) -> None:
        buf = as_bytes(buf).to(self.data.device)
        pos = 0
        while pos < buf.numel():
            a = addr + pos
            idx = self._host_access_line(a, for_write=True)
            off = a - self.lines[idx].tag
            take = min(self.vlen_bytes - off, buf.numel() - pos)
            self.data[idx, off : off + take] = buf[pos : pos + take]
            self._set_dirty(idx, True)
            pos += take

    # ----------------------------------------------------------- kernel path
    def claim_vregs(self, vpu: int, n: int) -> list[int]:
        """Claim ``n`` vector registers (cache lines) of ``vpu`` for a kernel.

        Lines are freed (written back if dirty) and marked busy-computing.
        """
        avail = [i for i in self.vpu_lines(vpu) if not self.lines[i].busy_computing]
        if len(avail) < n:
            raise ResourceStall(
                f"VPU{vpu}: need {n} vregs, only {len(avail)} not busy"
            )
        # Prefer invalid lines, then LRU order — the fewest-writebacks choice.
        avail.sort(key=lambda i: (self.lines[i].valid, self.lines[i].lru))
        chosen = avail[:n]
        for i in chosen:
            self._writeback(i)
            self._invalidate_tag(i)
            ln = self.lines[i]
            ln.valid, ln.tag = False, -1
            self._set_busy(i, True)
            ln.is_src = ln.is_dst = False
            self._touch(i)
        return chosen

    def release_vregs(self, line_idxs: list[int]) -> None:
        for i in line_idxs:
            self._invalidate_tag(i)
            self._set_busy(i, False)
            self._set_dirty(i, False)
            ln = self.lines[i]
            ln.is_src = ln.is_dst = False
            ln.valid, ln.tag = False, -1

    # ------------------------------------------------------------- DMA (2D)
    def dma_in_2d(
        self, vpu: int, line_idxs: list[int], addr: int, rows: int,
        row_bytes: int, stride_bytes: int,
    ) -> int:
        """2D DMA main-memory→VPU lines: pack ``rows`` of ``row_bytes`` (strided
        by ``stride_bytes`` in memory) contiguously into the claimed lines.

        Rows the host still holds dirty in *other* cache lines are snooped so
        the DMA always observes the latest data (the controller routes DMA
        requests and serves hits from the cache, §III-A4). Returns bytes moved.
        """
        total = rows * row_bytes
        end = addr + (rows - 1) * stride_bytes + row_bytes
        if rows > 1 and stride_bytes >= row_bytes:
            # Bulk path: one strided copy straight from main memory, then
            # re-read (snoop) only the rows a *dirty* non-busy cache line
            # covers — a clean valid line holds exactly the memory bytes
            # (lines become clean only by copying from/to memory), so
            # serving it from memory is bit-identical.
            if addr < 0 or end > self.memory.size:
                raise IndexError(
                    f"memory read [{addr}, {end}) out of bounds")
            buf2d = self.memory.data.as_strided(
                (rows, row_bytes), (stride_bytes, 1), addr).clone()
            snoop = self._snoop_rows(addr, rows, row_bytes, stride_bytes,
                                     end, dirty_only=True)
            if snoop:
                self._snoop_read_rows(addr, snoop, row_bytes, stride_bytes,
                                      buf2d)
            buf = buf2d.reshape(-1)
        else:
            buf = torch.empty(total, dtype=torch.uint8,
                              device=self.data.device)
            for r in range(rows):
                a = addr + r * stride_bytes
                buf[r * row_bytes : (r + 1) * row_bytes] = \
                    self._snooped_read(a, row_bytes)
        self._scatter_to_lines(line_idxs, buf)
        return total

    def dma_out_2d(
        self, vpu: int, line_idxs: list[int], addr: int, rows: int,
        row_bytes: int, stride_bytes: int,
    ) -> int:
        """2D DMA VPU lines→main memory (kernel write-back consolidation).

        Follows fetch-on-write: if a destination row is resident in a normal
        cache line, that line is updated and marked dirty instead of bypassing
        to memory, so pending host reads see the newest data immediately.
        """
        total = rows * row_bytes
        buf = self._gather_from_lines(line_idxs, total)
        end = addr + (rows - 1) * stride_bytes + row_bytes
        if rows > 1 and stride_bytes >= row_bytes:
            # Bulk path (see dma_in_2d): one strided scatter to memory, then
            # route the rows a valid cache line covers through the snoop
            # path so those lines hold the newest data (the bulk write left
            # the same bytes in memory, which the dirty line shadows — the
            # write-back later lands identical data, so no observer can tell
            # this apart from the pure row-by-row path).
            if addr < 0 or end > self.memory.size:
                raise IndexError(
                    f"memory write [{addr}, {end}) out of bounds")
            buf2d = buf.reshape(rows, row_bytes)
            self.memory.data.as_strided(
                (rows, row_bytes), (stride_bytes, 1), addr).copy_(buf2d)
            snoop = self._snoop_rows(addr, rows, row_bytes, stride_bytes,
                                     end, dirty_only=False)
            if snoop:
                self._snoop_write_rows(addr, snoop, row_bytes, stride_bytes,
                                       buf2d)
        else:
            for r in range(rows):
                a = addr + r * stride_bytes
                self._snooped_write(a, buf[r * row_bytes:(r + 1) * row_bytes])
        return total

    def _snoop_rows(self, addr: int, rows: int, row_bytes: int,
                    stride_bytes: int, end: int,
                    dirty_only: bool) -> list[int]:
        """Ascending rows of the 2D transfer that touch a valid, non-busy
        cache line (those must route through the snoop path; the rest may
        move in bulk). Reads pass ``dirty_only=True``: a clean line mirrors
        memory, so only dirty lines can serve different bytes. One dict
        probe per aligned block of the bounding span, then pure arithmetic
        to map blocks back to row ranges."""
        get = self._tag_to_line.get
        lines = self.lines
        vlen = self.vlen_bytes
        out: list[int] = []
        last = -1              # tags ascend, so row ranges ascend: merge by
        for tag in range(addr - addr % vlen, end, vlen):   # tracking the max
            idx = get(tag)
            if idx is None or lines[idx].busy_computing \
                    or (dirty_only and not lines[idx].dirty):
                continue
            # Rows r with [addr + r*stride, +row_bytes) ∩ [tag, tag+vlen) ≠ ∅
            r0 = max(last + 1,
                     -(-(tag - addr - row_bytes + 1) // stride_bytes))
            r1 = min(rows - 1, (tag + vlen - 1 - addr) // stride_bytes)
            if r1 >= r0:
                out.extend(range(r0, r1 + 1))
                last = r1
        return out

    def _classify_snoop_rows(self, addr: int, snoop: list[int],
                             row_bytes: int, stride_bytes: int):
        """Split snoop rows into rows inside one valid, non-busy line, as
        ``(row, line, offset)``, and a slow remainder (line-crossing / partly
        uncached rows, served piece by piece)."""
        get = self._tag_to_line.get
        lines = self.lines
        vlen = self.vlen_bytes
        inline, slow = [], []
        for r in snoop:
            a = addr + r * stride_bytes
            off = a % vlen
            if off + row_bytes <= vlen:
                idx = get(a - off)
                if idx is not None and not lines[idx].busy_computing:
                    inline.append((r, idx, off))
                    continue
            slow.append(r)
        return inline, slow

    def _snoop_read_rows(self, addr: int, snoop: list[int], row_bytes: int,
                         stride_bytes: int, buf2d: torch.Tensor) -> None:
        """Overwrite ``buf2d``'s snoop rows with the cached bytes."""
        inline, slow = self._classify_snoop_rows(
            addr, snoop, row_bytes, stride_bytes)
        for r, idx, off in inline:
            buf2d[r] = self.data[idx, off : off + row_bytes]
        for r in slow:
            buf2d[r] = self._snooped_read(addr + r * stride_bytes, row_bytes)

    def _snoop_write_rows(self, addr: int, snoop: list[int], row_bytes: int,
                          stride_bytes: int, buf2d: torch.Tensor) -> None:
        """Write ``buf2d``'s snoop rows into the covering cache lines."""
        inline, slow = self._classify_snoop_rows(
            addr, snoop, row_bytes, stride_bytes)
        for r, idx, off in inline:
            self.data[idx, off : off + row_bytes] = buf2d[r]
        for idx in {idx for _, idx, _ in inline}:
            self._set_dirty(idx, True)
        for r in slow:
            self._snooped_write(addr + r * stride_bytes, buf2d[r])

    def _snooped_read(self, addr: int, n: int) -> torch.Tensor:
        out = torch.empty(n, dtype=torch.uint8, device=self.data.device)
        pos = 0
        while pos < n:
            a = addr + pos
            idx = self.lookup(a)
            off = a % self.vlen_bytes
            take = min(self.vlen_bytes - off, n - pos)
            if idx is not None and not self.lines[idx].busy_computing:
                out[pos : pos + take] = self.data[idx, off : off + take]
            else:
                out[pos : pos + take] = self.memory.read(a, take)
            pos += take
        return out

    def _snooped_write(self, addr: int, buf: torch.Tensor) -> None:
        pos = 0
        n = buf.numel()
        while pos < n:
            a = addr + pos
            idx = self.lookup(a)
            off = a % self.vlen_bytes
            take = min(self.vlen_bytes - off, n - pos)
            if idx is not None and not self.lines[idx].busy_computing:
                self.data[idx, off : off + take] = buf[pos : pos + take]
                self._set_dirty(idx, True)
            else:
                self.memory.write(a, buf[pos : pos + take])
            pos += take

    @staticmethod
    def _runs(line_idxs: list[int]):
        """``(first line, count)`` of each run of consecutive line indices:
        a run's lines are one contiguous span of the data array."""
        i = 0
        while i < len(line_idxs):
            j = i + 1
            while j < len(line_idxs) and line_idxs[j] == line_idxs[j - 1] + 1:
                j += 1
            yield line_idxs[i], j - i
            i = j

    def _scatter_to_lines(self, line_idxs: list[int],
                          buf: torch.Tensor) -> None:
        """Pack ``buf`` into the lines in order (the last one partly; its
        tail keeps its bytes), one copy per run of consecutive lines."""
        n = buf.numel()
        if n > len(line_idxs) * self.vlen_bytes:
            raise ValueError("operand larger than claimed vector registers")
        pos = 0
        for first, count in self._runs(line_idxs):
            take = min(count * self.vlen_bytes, n - pos)
            if take <= 0:
                break
            self.data[first : first + count].view(-1)[:take] = \
                buf[pos : pos + take]
            pos += take

    def _gather_from_lines(self, line_idxs: list[int], n: int) -> torch.Tensor:
        out = torch.empty(n, dtype=torch.uint8, device=self.data.device)
        pos = 0
        for first, count in self._runs(line_idxs):
            take = min(count * self.vlen_bytes, n - pos)
            if take <= 0:
                break
            out[pos : pos + take] = \
                self.data[first : first + count].view(-1)[:take]
            pos += take
        return out

    # ---------------------------------------------------------------- debug
    def flush_all(self) -> None:
        for i, ln in enumerate(self.lines):
            if ln.busy_computing:
                raise LineBusy("cannot flush while kernels are in flight")
            self._writeback(i)
            self._invalidate_tag(i)
            ln.valid, ln.tag = False, -1
