"""Address Table (AT) — kernel operand state tracking (paper §III-A3).

Own copy of repro.core.address_table (pure Python: the port imports nothing of
``repro``).

Each entry holds the *exact 2D footprint* of a kernel operand (a
:class:`~repro_torch.core.regions.StridedRegion`), a validity flag and a status
flag, plus whether the region is a kernel *source* or *destination*. The
Kernel Decoder registers regions when an operation is queued; the cache
controller consults the AT on critical accesses and stalls only the requests
that would corrupt an in-flight kernel:

- host STORE into a live *source* region  → WAR hazard → stall until the
  operand has been allocated (copied) into VPU lines;
- host LOAD  from a live *destination*    → RAW hazard → stall until kernel
  write-back completes;
- host STORE into a live *destination*    → WAW hazard → stall likewise.

Because entries carry the strided footprint rather than its bounding byte
interval, a host access that lands in the *gap* between two strided rows of
an operand (e.g. the untouched columns beside a conv strip) does not stall —
the check is exact, not conservative.

Entries are reference-counted per physical binding so that renamed matrices
(same logical register, different physical tags) track independently. Live
entries are mirrored into an :class:`~repro_torch.core.alias_index.AliasIndex`
keyed by slot, so the host-access checks and registration bookkeeping cost
O(hits) rather than a scan of the whole (statically sized) table.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
from typing import Iterator, Optional

from repro_torch.core.alias_index import AliasIndex
from repro_torch.core.isa import KernelError
from repro_torch.core.regions import StridedRegion


class RegionKind(enum.Enum):
    SRC = "src"
    DST = "dst"


class RegionStatus(enum.Enum):
    BUSY = "busy"          # operand still needed by a pending/running kernel
    ALLOCATED = "alloc"    # source copied into VPU lines → host stores OK again
    FREE = "free"


@dataclasses.dataclass
class ATEntry:
    region: StridedRegion
    kind: RegionKind
    status: RegionStatus = RegionStatus.BUSY
    valid: bool = True
    phys_id: int = -1             # owning physical matrix binding
    refcount: int = 1             # pending kernels still referencing the region

    @property
    def start(self) -> int:
        return self.region.start

    @property
    def end(self) -> int:         # one past last byte of the bounding interval
        return self.region.end

    def overlaps(self, start: int, end: int) -> bool:
        """Exact strided-footprint check against flat interval [start, end)."""
        return self.valid and self.region.overlaps_interval(start, end)


class AddressTable:
    """Statically sized AT (static allocation philosophy, §IV-B)."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self._entries: list[Optional[ATEntry]] = [None] * capacity
        # Live-entry lookup structures: (phys_id, kind) -> slot for the O(1)
        # up-ref/release/mark paths, a min-heap of reusable slots (the lowest
        # free slot wins, matching the original first-free scan), and the
        # footprint index answering the host-access hazard checks by slot.
        self._by_key: dict[tuple[int, RegionKind], int] = {}
        self._free_heap: list[int] = list(range(capacity))
        self._alias_index = AliasIndex()

    def __iter__(self) -> Iterator[ATEntry]:
        return (e for e in self._entries if e is not None and e.valid)

    def free_slots(self) -> int:
        """Slots available for new registrations (empty or invalidated)."""
        return self.capacity - len(self._by_key)

    def slots_needed(self, regions: list[tuple[int, "RegionKind"]]) -> int:
        """Fresh slots a batch of registrations would consume: repeated
        operands and regions already registered live just up-ref the
        existing ``(phys_id, kind)`` entry."""
        return len(set(regions) - self._by_key.keys())

    def _free_slot(self) -> int:
        while self._free_heap:
            i = heapq.heappop(self._free_heap)
            e = self._entries[i]
            if e is None or not e.valid:
                return i
        # Preamble-level rejection (bridge answers 'kill'), not a crash: the
        # runtime drains deferred write-backs on capacity pressure before
        # registering, so reaching here means the table is truly over
        # capacity for the live working set.
        raise KernelError(
            f"Address Table full ({self.capacity} entries live) — raise "
            f"queue_capacity in the config or barrier() to drain deferred "
            f"write-backs")

    def register(self, region: StridedRegion, kind: RegionKind,
                 phys_id: int) -> ATEntry:
        """Register (or up-ref) an operand region for a queued kernel."""
        slot = self._by_key.get((phys_id, kind))
        if slot is not None:
            e = self._entries[slot]
            e.refcount += 1
            e.status = RegionStatus.BUSY
            return e
        entry = ATEntry(region=region, kind=kind, phys_id=phys_id)
        slot = self._free_slot()
        self._entries[slot] = entry
        self._by_key[(phys_id, kind)] = slot
        self._alias_index.insert(slot, region)
        return entry

    def mark_allocated(self, phys_id: int) -> None:
        """Source operand copied into VPU lines — WAR window closed."""
        slot = self._by_key.get((phys_id, RegionKind.SRC))
        if slot is not None:
            self._entries[slot].status = RegionStatus.ALLOCATED

    def release(self, phys_id: int, kind: RegionKind) -> None:
        """Kernel finished with the region: down-ref; free at zero (permissions
        restored for the host, §IV-B3)."""
        slot = self._by_key.get((phys_id, kind))
        if slot is None:
            return
        e = self._entries[slot]
        e.refcount -= 1
        if e.refcount <= 0:
            e.valid = False
            e.status = RegionStatus.FREE
            del self._by_key[(phys_id, kind)]
            self._alias_index.remove(slot)
            heapq.heappush(self._free_heap, slot)

    # ---------------------------------------------------------------- checks
    def blocks_store(self, start: int, end: int) -> Optional[ATEntry]:
        """Would a host store into [start, end) corrupt an in-flight kernel?"""
        for slot in self._alias_index.query_interval(start, end):
            e = self._entries[slot]
            if e.kind == RegionKind.SRC and e.status == RegionStatus.BUSY:
                return e  # WAR: operand not yet copied into the VPU
            if e.kind == RegionKind.DST:
                return e  # WAW: result would be overwritten by the kernel
        return None

    def blocks_load(self, start: int, end: int) -> Optional[ATEntry]:
        """Would a host load from [start, end) observe a stale result?"""
        for slot in self._alias_index.query_interval(start, end):
            e = self._entries[slot]
            if e.kind == RegionKind.DST:
                return e  # RAW: kernel result not written back yet
        return None

    def live_count(self) -> int:
        return len(self._by_key)
