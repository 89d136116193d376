"""C-RT — the Cache Runtime executed by the eCPU (paper §IV-B).

Three cooperating modules around a statically-allocated kernel queue
(producer–consumer, single-threaded preemptive in hardware; cooperative here):

  * **Kernel Decoder** — runs in the "interrupt handler" when the bridge
    latches an offload: O(1) kernel-library lookup by func5, preamble
    (validation + destination shape inference), hazard check with
    logical-matrix renaming, AT registration, queue push.
  * **Kernel Scheduler** — pops ready kernels (dependency DAG), selects the
    VPU with the fewest dirty cache lines, drives the Matrix Allocator, runs
    the kernel, and decides whether to defer the destination write-back
    (kept resident if a queued kernel will read it).
  * **Matrix Allocator** — acquires the cache lock, claims vector registers,
    programs 2D DMA transfers (memory→VPU with kernel-chosen layout;
    VPU→memory consolidation on write-back), releases lock and AT regions.

Phase cycle/time accounting (preamble / allocation / compute / writeback)
feeds the Fig. 3 reproduction benchmark directly.

Counterpart of repro.core.runtime (the serial scheduler). Main memory and
the LLC's data array are tensors on the runtime's device (``device=``, the
card unless the caller asks for the CPU); every decision reads host
metadata only. The ``*_s`` fields of :class:`PhaseStats` are host wall
time; on the card they time the enqueue of asynchronous work.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from collections import deque
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.address_table import AddressTable, RegionKind
from repro_torch.core.alias_index import AliasIndex
from repro_torch.core.cache import ArcaneCache, MainMemory, as_bytes
from repro_torch.core.dataflow import resolve as resolve_dataflow
from repro_torch.core.encoding import Offload, NUM_MATRIX_REGS
from repro_torch.core.hazards import DependencyTracker, KernelDeps
from repro_torch.core.isa import (KernelError, KernelLibrary, KernelSpec,
                                  default_library)
from repro_torch.core.matrix import MatrixBinding, MatrixMap
from repro_torch.core.regions import StridedRegion
from repro_torch.core.vpu import VPU, VPUGeometry, ResidentMatrix


@dataclasses.dataclass
class PhaseStats:
    """Modeled cycles and wall-clock per C-RT phase (Fig. 3 axes)."""

    preamble_cycles: int = 0
    allocation_cycles: int = 0
    compute_cycles: int = 0
    writeback_cycles: int = 0
    preamble_s: float = 0.0
    allocation_s: float = 0.0
    compute_s: float = 0.0
    writeback_s: float = 0.0
    kernels_run: int = 0
    # Cross-instruction operand reuse (pipelined scheduler only): DMA-in
    # trains skipped because a containing region was already modeled resident
    # and clean in the dispatch VPU's data array, and the transfer cycles
    # those skips avoided (excluded from allocation_cycles/total_cycles).
    reuse_hits: int = 0
    reused_dma_cycles: int = 0
    # Fault-recovery overhead (ECC scrubs, replay backoff + re-execution):
    # part of total_cycles — recovery really costs modeled time — but kept
    # out of the four phase buckets so Fig. 3 shares stay comparable.
    fault_cycles: int = 0

    @property
    def total_cycles(self) -> int:
        return (self.preamble_cycles + self.allocation_cycles
                + self.compute_cycles + self.writeback_cycles
                + self.fault_cycles)

    def shares(self) -> dict[str, float]:
        t = max(self.total_cycles, 1)
        return {
            "preamble": self.preamble_cycles / t,
            "allocation": self.allocation_cycles / t,
            "compute": self.compute_cycles / t,
            "writeback": self.writeback_cycles / t,
        }

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, type(getattr(self, f.name))())


@dataclasses.dataclass
class QueuedKernel:
    deps: KernelDeps
    spec: KernelSpec
    src_bindings: tuple[MatrixBinding, ...]
    dst_binding: MatrixBinding


@dataclasses.dataclass
class Allocation:
    """Result of the Matrix Allocator step for one kernel.

    ``dma_segments`` records each memory→VPU source transfer as
    ``(src_idx, rows, dma_cycles)`` — the pipelined scheduler chunks these
    into per-operand row-granular activity trains (``src_idx`` identifies
    which operand's dataflow policy gates the chunks; operands already
    resident, including repeated ones, produce no segment); the serial
    scheduler only uses the totals.
    """

    src_res: list[ResidentMatrix]
    dst_res: ResidentMatrix
    dma_cycles: int
    wb_cycles: int
    dma_segments: list[tuple[int, int, int]]  # (src_idx, rows, cycles) per DMA-in
    wb_segments: list[tuple[int, int]]       # (vpu, cycles) per consolidation


class CacheRuntime:
    """The C-RT instance owning one ARCANE LLC."""

    def __init__(
        self,
        memory: Optional[MainMemory] = None,
        *,
        n_vpus: int = 4,
        vregs_per_vpu: int = 32,
        vlen_bytes: int = 1024,
        lanes: int = 4,
        queue_capacity: int = 16,
        library: Optional[KernelLibrary] = None,
        num_matrix_regs: int = NUM_MATRIX_REGS,
        geometry: Optional[VPUGeometry] = None,
        metrics: bool = True,
        faults=None,
        device=None,
    ):
        # Function-level import, as the reference's: repro_torch.sim's
        # package import reaches this module through sim.pipeline, so a
        # module-level import would cycle while this module initialises.
        from repro_torch.sim.metrics import SchedulerMetrics
        from repro_torch.sim.faults import as_fault_plan
        if memory is not None and device is not None and \
                resolve_device(device) != memory.device:
            raise ValueError(f"device {device} is not the memory's "
                             f"{memory.device}")
        self.device = memory.device if memory is not None \
            else resolve_device(device)
        self.memory = memory or MainMemory(16 << 20, device=self.device)
        self.cache = ArcaneCache(self.memory, n_vpus=n_vpus,
                                 vregs_per_vpu=vregs_per_vpu,
                                 vlen_bytes=vlen_bytes)
        self.geometry = geometry or VPUGeometry(lanes=lanes,
                                                vlen_bytes=vlen_bytes)
        self.library = library or default_library()
        self.vpus = [VPU(i, self.cache, self.geometry, self.library)
                     for i in range(n_vpus)]
        self.matrix_map = MatrixMap(num_matrix_regs)
        self.at = AddressTable(capacity=4 * queue_capacity)
        self.tracker = DependencyTracker()
        self.queue_capacity = queue_capacity
        self.queue: deque[QueuedKernel] = deque()
        self.resident: dict[int, ResidentMatrix] = {}   # phys_id -> residency
        # Footprints of resident matrices, keyed by phys_id, plus a claim
        # sequence number per residency: the dirty-alias flush sweeps query
        # the index for overlap candidates (O(hits), not O(residents)) and
        # replay them in claim order — the same order the plain dict scan
        # used, so flush-ordering behaviour is unchanged.
        self._resident_index = AliasIndex()
        self._resident_seq: dict[int, int] = {}
        self._claim_counter = itertools.count()
        self.stats = PhaseStats()
        # Unified metrics layer (purely observational — never consulted by
        # any scheduling decision, so metrics on/off cannot change schedules).
        self.metrics = SchedulerMetrics(enabled=metrics)
        # Fault-injection plan (None = faults off, the default). The plan is
        # keyed by kernel id only, so both schedulers draw identical faults
        # for the same program. ``offline`` holds hard-faulted VPU indices:
        # they accept no new work, and their residents are evacuated.
        self.faults = as_fault_plan(faults)
        self.offline: set[int] = set()
        if self.faults is not None and self.faults.cfg.hard_at and \
                not 0 <= self.faults.cfg.hard_vpu < n_vpus:
            raise ValueError(
                f"faults.hard_vpu {self.faults.cfg.hard_vpu} out of range "
                f"for {n_vpus} VPUs")
        # When set (by a scheduler wanting per-port timing), every
        # consolidation DMA appends (vpu, cycles) here — the transfer runs on
        # the port of the VPU *holding* the resident, not the dispatch VPU.
        self._wb_segments: Optional[list[tuple[int, int]]] = None
        # ---- re-entrant session protocol (see repro_torch.core.session) ----
        # The serial clock is modeled-cycles-so-far plus injected idle (the
        # gaps between a drain finishing and the next posted arrival).
        self._session_idle = 0
        self._session_posts: list[tuple[int, int, Callable]] = []
        self._post_seq = itertools.count()
        # Re-entrancy guards: completion callbacks may issue new kernels from
        # *inside* a drain. ``_running`` stops the serial fixpoint loop from
        # nesting; ``_in_loop`` is the pipelined scheduler's event-loop flag
        # (defined here so shared helpers can consult it either way).
        self._running = False
        self._in_loop = False
        self._session_open = False
        # Issue capture + completion watchers: a session wraps issue_program
        # with a capture hook so it learns the kernel ids a program decoded
        # into, and registers per-kernel callbacks fired exactly once when
        # the kernel retires (serial _run_one or pipelined compute_done).
        self._issue_capture: Optional[Callable[[int], None]] = None
        self._retire_watchers: dict[int, list[Callable[[int], None]]] = {}

    # ================================================================ decoder
    def decode(self, off: Offload) -> None:
        """Kernel Decoder: software-decode one offloaded instruction."""
        t0 = time.perf_counter()
        instr = off.instr
        ops = off.operands
        if instr.is_xmr:
            # xmr: pure metadata — bind (rename) the logical register.
            self.matrix_map.reserve(
                logical=ops.xmr_md,
                addr=ops.xmr_addr,
                rows=ops.xmr_rows,
                cols=ops.xmr_cols,
                stride=self._xmr_stride(ops),
                width=instr.width,
            )
            self.stats.preamble_cycles += self.geometry.decode_cycles // 4
            self.stats.preamble_s += time.perf_counter() - t0
            return

        if len(self.queue) >= self.queue_capacity:
            # Static queue full: drain before accepting (backpressure).
            self.run_pending()

        kdef = self.library.lookup(instr.func5)
        srcs = [self.matrix_map.lookup(m)
                for m in (ops.ms1, ops.ms2, ops.ms3)[: kdef.n_sources]]
        params = {"alpha": ops.alpha, "beta": ops.beta}
        if instr.func5 == 2:  # maxpool packs stride/win in rs1 (Table I)
            params = {"stride": ops.hi1, "win_size": ops.lo1}
        dst_shape, cost = kdef.preamble([s.shape for s in srcs], params, instr.width)

        dst_prev = self.matrix_map.lookup(ops.md)
        # Destination keeps its reservation's memory footprint but gets shape
        # from the preamble (effective dims allocation, §IV-B3).
        if dst_shape[0] * dst_shape[1] * instr.width.nbytes > \
           dst_prev.rows * dst_prev.cols * dst_prev.elem_bytes:
            raise KernelError(
                f"{kdef.name}: result {dst_shape} exceeds m{ops.md} reservation")
        dst = self.matrix_map.reserve(
            logical=ops.md, addr=dst_prev.addr, rows=dst_shape[0],
            cols=dst_shape[1], stride=max(dst_prev.stride, dst_shape[1]),
            width=instr.width,
        )

        spec = KernelSpec(func5=instr.func5, name=kdef.name, width=instr.width,
                          src_shapes=tuple(s.shape for s in srcs),
                          dst_shape=dst_shape, params=params, cost=cost,
                          dataflow=resolve_dataflow(
                              kdef.dataflow, tuple(s.shape for s in srcs),
                              params, instr.width))
        # Capacity pressure: make room in the Address Table *before* admitting
        # (a failed registration mid-admission would leak tracker state).
        # Repeated operands and regions already registered only up-ref, so
        # count the genuinely fresh slots. The drain first retires the queue,
        # then lands deferred write-backs — each release frees an AT entry —
        # and only a table that stays full after that raises.
        at_regions = ([(s.phys_id, RegionKind.SRC) for s in srcs]
                      + [(dst.phys_id, RegionKind.DST)])
        if self.at.free_slots() < len(at_regions):
            # Only compute the exact fresh-slot count (set algebra) when the
            # free count could actually be short of the worst case.
            self._relieve_at_pressure(self.at.slots_needed(at_regions))
        deps = self.tracker.admit(srcs, dst)
        for s in srcs:
            self.at.register(s.region, RegionKind.SRC, s.phys_id)
        self.at.register(dst.region, RegionKind.DST, dst.phys_id)
        self.queue.append(QueuedKernel(deps=deps, spec=spec,
                                       src_bindings=tuple(srcs), dst_binding=dst))
        self.stats.preamble_cycles += self.geometry.decode_cycles
        self.stats.preamble_s += time.perf_counter() - t0
        self.metrics.inc("kernels.decoded")
        if self._issue_capture is not None:
            # Capture at decode time (not after issue_program returns):
            # queue backpressure can retire early kernels of a long program
            # mid-issue, and their completion watchers must already exist.
            self._issue_capture(deps.kernel_id)

    @staticmethod
    def _xmr_stride(ops) -> int:
        # Table I: A.stride is in elements; 0 means dense (stride = cols).
        # A nonzero stride below cols would make rows overlap in memory —
        # reject it instead of silently clamping to dense (the clamp changed
        # which bytes the program addressed without telling anyone).
        if ops.xmr_stride == 0:
            return ops.xmr_cols
        if ops.xmr_stride < ops.xmr_cols:
            raise KernelError(
                f"xmr: stride {ops.xmr_stride} < cols {ops.xmr_cols} "
                f"(Table I: stride is in elements; 0 means dense)")
        return ops.xmr_stride

    # ============================================================== scheduler
    def _select_vpu(self, needed_lines: int) -> int:
        """Fewest-dirty-lines policy (§IV-B2) among VPUs with capacity.

        Offlined (hard-faulted) VPUs are never candidates — graceful
        degradation redistributes work across the survivors."""
        best, best_key = -1, None
        for v in range(self.cache.n_vpus):
            if v in self.offline:
                continue
            free = self.cache.free_line_count(v)
            if free < needed_lines:
                continue
            key = (self.cache.dirty_line_count(v), -free)
            if best_key is None or key < best_key:
                best, best_key = v, key
        if best < 0:
            raise RuntimeError("no VPU has capacity for the kernel operands")
        return best

    def run_pending(self) -> None:
        """Drain the kernel queue respecting the dependency DAG.

        Re-entrant calls (a completion watcher issuing new kernels from
        inside ``_run_one``) return immediately: the outer fixpoint loop
        re-checks the queue every pass, so nested work is picked up without
        recursing."""
        if self._running:
            return
        self._running = True
        try:
            progress = True
            while self.queue and progress:
                progress = False
                for _ in range(len(self.queue)):
                    qk = self.queue.popleft()
                    if self.tracker.ready(qk.deps.kernel_id):
                        self._run_one(qk)
                        progress = True
                    else:
                        self.queue.append(qk)
        finally:
            self._running = False

    def _run_one(self, qk: QueuedKernel) -> None:
        t0 = time.perf_counter()
        kid = qk.deps.kernel_id
        # A scheduled hard fault due at (or before) the current clock fires
        # before this kernel is placed, so placement sees the survivor set.
        self._maybe_hard_fault(self.session_now())
        kf = self.faults.kernel_faults(kid) if self.faults is not None \
            else None
        vpu = self.vpus[self._choose_vpu(qk)]

        # -------------------------------------------------- allocation phase
        alloc = self._allocation_step(qk, vpu)
        self.stats.allocation_cycles += (self.geometry.schedule_cycles
                                         + alloc.dma_cycles)
        self.stats.writeback_cycles += alloc.wb_cycles
        self.stats.allocation_s += time.perf_counter() - t0

        # ------------------------------------------- ECC tier (fault model)
        fault_cycles = 0
        if kf is not None and kf.ecc_bits:
            fault_cycles += self._fault_scrub(qk, alloc, kf)

        # ----------------------------------------------------- compute phase
        t1 = time.perf_counter()
        cycles = self._compute_step(qk, vpu, alloc.src_res, alloc.dst_res)
        self.stats.compute_cycles += cycles
        self.stats.compute_s += time.perf_counter() - t1

        # ---------------------------------------- replay tier (fault model)
        if kf is not None and kf.replays:
            for attempt in range(kf.replays):
                self._fault_corrupt_dst(qk, alloc, attempt)
                rc = self._compute_step(qk, vpu, alloc.src_res, alloc.dst_res)
                fault_cycles += self.faults.backoff(attempt) + rc
                self.metrics.inc("faults.injected")
                self.metrics.inc("faults.replayed")
                self.metrics.observe("fault.replay_latency_cycles",
                                     self.faults.backoff(attempt) + rc)
        self.stats.fault_cycles += fault_cycles

        # --------------------------------------------------- writeback phase
        t2 = time.perf_counter()
        retire_wb = self._retire_step(qk, alloc.src_res, alloc.dst_res)
        self.stats.writeback_cycles += retire_wb
        self.stats.writeback_s += time.perf_counter() - t2
        self.stats.kernels_run += 1
        # Serial stall synthesis: phases run back-to-back, so the window is
        # exactly the phase totals (conserved by construction).
        self.metrics.kernel_serial(
            kid, qk.spec.name, busy=cycles,
            bins={"cache_lock": self.geometry.schedule_cycles,
                  "dma_wait": alloc.dma_cycles,
                  "drain": alloc.wb_cycles + retire_wb,
                  "fault_replay": fault_cycles})
        self._notify_retired(kid, self.session_now())
        # Retry exhaustion: the kernel completed on scrubbed state, but the
        # datapath is deemed faulty — fence it after the retire.
        if kf is not None and kf.exhausted:
            self._offline_vpu(vpu.index, self.session_now())

    # ------------------------------------------------- shared scheduler steps
    # The serial scheduler above and repro_torch.sim.pipeline.PipelinedRuntime
    # both drive exactly these four steps; only *when* each step runs
    # differs, so the numerical results are identical by construction.
    def _choose_vpu(self, qk: QueuedKernel) -> int:
        """VPU selection: resident-operand affinity, else fewest-dirty-lines.

        Affinity never points at an offlined VPU: its surviving residents
        (if any) are consolidated through memory by the cross-VPU path in
        ``_allocate_source`` when a healthy VPU picks the kernel up."""
        for s in qk.src_bindings:
            r = self.resident.get(s.phys_id)
            if r is not None and r.vpu not in self.offline:
                return r.vpu
        return self._select_vpu(self._lines_for(qk))

    def _lines_for(self, qk: QueuedKernel) -> int:
        return sum(
            self.vpus[0].lines_needed(*s.shape, s.width) for s in qk.src_bindings
        ) + self.vpus[0].lines_needed(*qk.dst_binding.shape, qk.dst_binding.width)

    def _allocation_step(self, qk: QueuedKernel, vpu: VPU) -> Allocation:
        """Matrix Allocator: lock, claim vregs, 2D-DMA the operands in.

        Returns an :class:`Allocation`; the caller attributes the cycles
        (allocation vs writeback phase) and may re-chunk ``dma_segments``
        into row-granular timing activities.
        """
        if not self.cache.acquire_lock():
            raise RuntimeError("cache lock already held")
        dma_cycles = wb_cycles = 0
        segments: list[tuple[int, int, int]] = []
        self._wb_segments = wb_segments = []
        try:
            src_res = []
            for si, s in enumerate(qk.src_bindings):
                res, dma_c, wb_c = self._allocate_source(vpu, s)
                src_res.append(res)
                dma_cycles += dma_c
                wb_cycles += wb_c
                if dma_c:
                    segments.append((si, s.rows, dma_c))
                self.at.mark_allocated(s.phys_id)
            dst_res = self._allocate_destination(vpu, qk.dst_binding)
        finally:
            self.cache.release_lock()
            self._wb_segments = None
        return Allocation(src_res=src_res, dst_res=dst_res,
                          dma_cycles=dma_cycles, wb_cycles=wb_cycles,
                          dma_segments=segments, wb_segments=wb_segments)

    def _compute_step(self, qk: QueuedKernel, vpu: VPU,
                      src_res: list[ResidentMatrix],
                      dst_res: ResidentMatrix) -> int:
        return vpu.execute(qk.spec, src_res, dst_res)

    def _retire_step(self, qk: QueuedKernel, src_res: list[ResidentMatrix],
                     dst_res: ResidentMatrix) -> int:
        """Complete the kernel: release sources, defer or write back the
        destination. Returns destination write-back DMA cycles (0 if deferred).
        """
        dst = qk.dst_binding
        self.tracker.complete(qk.deps.kernel_id)
        for s, r in zip(qk.src_bindings, src_res):
            self.at.release(s.phys_id, RegionKind.SRC)
            if not r.dirty and not self._needed_later(s.phys_id):
                self._evict_resident(s.phys_id)
        if self._needed_later(dst.phys_id):
            # Deferred write-back: destination stays resident for the consumer.
            self.resident[dst.phys_id] = dst_res
            return 0
        wb_cycles = (self._flush_older_aliases(dst)
                     + self._writeback_resident(dst, dst_res))
        self.at.release(dst.phys_id, RegionKind.DST)
        return wb_cycles

    def _needed_later(self, phys_id: int) -> bool:
        return any(phys_id in qk.deps.sources for qk in self.queue)

    # ============================================================ fault model
    # Injection and recovery are *functionally exact*: injection really flips
    # bits in the modeled SRAM array and recovery really re-fetches or
    # recomputes, always inline at dispatch time — while the kernel's
    # operands are guaranteed resident and valid — so a run whose faults are
    # all recoverable flushes a memory image bit-identical to the fault-free
    # run. The pipelined scheduler reuses these helpers for the functional
    # side and layers its own event-timeline cost model on top.
    def _maybe_hard_fault(self, t: int, eq=None) -> None:
        """Fire the scheduled hard fault once the clock reaches ``hard_at``.

        Checked lazily at scheduler steps (never via a posted event) so a
        run that finishes before ``hard_at`` keeps its fault-free makespan.
        """
        f = self.faults
        if f is None or not f.cfg.hard_at:
            return
        v = f.cfg.hard_vpu
        if v in self.offline or t < f.cfg.hard_at:
            return
        self._offline_vpu(v, t, eq)

    def _offline_vpu(self, v: int, t: int, eq=None) -> None:
        """Hard-fault VPU ``v``: evacuate its residents (dirty ones land in
        admission order, clean ones drop) and remove it from every placement
        policy. Raises :class:`FaultError` when no healthy VPU remains."""
        if v in self.offline:
            return
        self.offline.add(v)
        self.metrics.inc("faults.offlined")
        self._evacuate_vpu(v)
        if len(self.offline) >= self.cache.n_vpus:
            from repro_torch.sim.faults import FaultError
            raise FaultError(
                f"hard fault offlined vpu{v}: no healthy VPU remains "
                f"({len(self.offline)}/{self.cache.n_vpus} offline)")

    def _evacuate_vpu(self, v: int) -> None:
        """Consolidate every resident on ``v`` back to memory (the cache
        controller can still drain a fenced VPU's data array). Mirrors
        ``_drain_deferred_residents``: pending readers re-fetch the landed
        bytes from a healthy VPU afterwards."""
        for phys_id in list(self.resident):
            res = self.resident.get(phys_id)
            if res is None or res.vpu != v:
                continue
            if res.dirty:
                b = self._binding_of(phys_id)
                self.stats.writeback_cycles += (
                    self._flush_older_aliases(b)
                    + self._writeback_resident(b, res))
                self.at.release(phys_id, RegionKind.DST)
            else:
                self._evict_resident(phys_id)
                self.at.release(phys_id, RegionKind.DST)

    def _fault_scrub(self, qk: QueuedKernel, alloc: Allocation,
                     kf) -> int:
        """ECC tier: flip bit(s) in the first freshly-fetched source line,
        then recover — correct in place (single-bit, SECDED syndrome) or
        replay the transfer from memory's clean architectural copy
        (double-bit). Returns the recovery cycle charge (0 when the kernel
        fetched nothing, i.e. every operand was already resident)."""
        if not alloc.dma_segments:
            return 0
        kid = qk.deps.kernel_id
        si = alloc.dma_segments[0][0]
        res = alloc.src_res[si]
        b = qk.src_bindings[si]
        line = int(res.line_idxs[0])
        span = min(b.row_bytes, self.cache.vlen_bytes)
        byte, bit = self.faults.flip_position(kid, 0, span)
        self.metrics.inc("faults.injected")
        self._flip(line, byte, bit)
        if kf.ecc_bits == 1:
            # The syndrome pinpoints the bit: correct in place.
            self._flip(line, byte, bit)
            self.metrics.inc("faults.corrected")
            return self.faults.cfg.ecc_penalty
        # Double-bit: detected but uncorrectable — make the line genuinely
        # bad with a second flip, then re-fetch the whole source region.
        byte2, bit2 = self.faults.flip_position(kid, 1, span)
        self._flip(line, byte2, bit2)
        nbytes = self.cache.dma_in_2d(res.vpu, res.line_idxs, b.addr, b.rows,
                                      b.row_bytes, b.stride_bytes)
        self.metrics.inc("faults.replayed")
        return (self.faults.cfg.ecc_penalty + self.faults.backoff(0)
                + self.geometry.dma_cycles(nbytes, b.rows))

    def _fault_corrupt_dst(self, qk: QueuedKernel, alloc: Allocation,
                           attempt: int) -> None:
        """Replay tier injection: flip one bit in the destination's first
        line — the detected compute corruption the replay overwrites when
        the kernel re-executes from its still-clean sources."""
        kid = qk.deps.kernel_id
        b = qk.dst_binding
        span = min(b.row_bytes, self.cache.vlen_bytes)
        byte, bit = self.faults.flip_position(kid, 16 + attempt, span)
        self._flip(int(alloc.dst_res.line_idxs[0]), byte, bit)

    def _flip(self, line: int, byte: int, bit: int) -> None:
        """Flip one bit of the modeled SRAM array (on its device)."""
        self.cache.data[line, byte].bitwise_xor_(1 << bit)

    # ============================================================== allocator
    def _claim(self, vpu: VPU, b: MatrixBinding) -> ResidentMatrix:
        n = vpu.lines_needed(b.rows, b.cols, b.width)
        idxs = self.cache.claim_vregs(vpu.index, n)
        res = ResidentMatrix(phys_id=b.phys_id, vpu=vpu.index, line_idxs=idxs,
                             rows=b.rows, cols=b.cols, width=b.width)
        self.resident[b.phys_id] = res
        self._resident_index.insert(b.phys_id, b.region)
        self._resident_seq[b.phys_id] = next(self._claim_counter)
        # Residency pins the tracker's binding + write-order stamp: deferred
        # results need both after their writer completes (bounded-state prune).
        self.tracker.pin(b.phys_id)
        return res

    def _allocate_source(
        self, vpu: VPU, b: MatrixBinding
    ) -> tuple[ResidentMatrix, int, int]:
        """Materialise a source on ``vpu``; returns (res, dma_cycles, wb_cycles)."""
        wb_cycles = 0
        res = self.resident.get(b.phys_id)
        if res is not None:
            # A deferred result from a *newer* aliasing writer supersedes
            # this copy's bytes: land it first (the landing invalidates the
            # stale copy, and we fall through to a fresh fetch).
            wb_cycles += self._land_newer_aliases(b)
            res = self.resident.get(b.phys_id)
        if res is not None:
            if res.vpu != vpu.index:
                # Deferred result lives on another VPU: consolidate through
                # memory, then load here (cross-VPU move). The consolidation
                # is the deferred write-back landing, so the DST region it
                # guarded is released here (host RAW window closes).
                was_dirty = res.dirty
                wb_cycles += (self._flush_older_aliases(b)
                              + self._writeback_resident(b, res))
                if was_dirty:
                    self.at.release(b.phys_id, RegionKind.DST)
                res = None
            else:
                return res, 0, wb_cycles
        # The DMA below reads main memory: any *dirty* deferred resident
        # whose footprint overlaps this source must land first, or the read
        # observes pre-kernel bytes (the reader's RAW edge only orders it
        # after the writer *completed* — not after its deferred write-back).
        wb_cycles += self._flush_aliased_dirty(b)
        res = self._claim(vpu, b)
        nbytes = self.cache.dma_in_2d(
            vpu.index, res.line_idxs, b.addr, b.rows, b.row_bytes, b.stride_bytes)
        return res, self.geometry.dma_cycles(nbytes, b.rows), wb_cycles

    def _allocate_destination(self, vpu: VPU, b: MatrixBinding) -> ResidentMatrix:
        res = self.resident.get(b.phys_id)
        if res is not None and res.vpu == vpu.index and \
           (res.rows, res.cols) == (b.rows, b.cols):
            return res
        if res is not None:
            self._evict_resident(b.phys_id)
        # Destinations are allocated with effective dims; no memory fetch is
        # needed (the kernel overwrites every element — fetch-on-write applies
        # only to the write-back path’s partial lines, handled by dma_out_2d).
        return self._claim(vpu, b)

    def _consolidate_resident(self, b: MatrixBinding,
                              res: ResidentMatrix) -> int:
        """Write a dirty resident's data to memory *without* evicting it
        (the residency stays for future readers); returns DMA cycles.

        Landing invalidates stale copies: any *other* clean resident whose
        footprint overlaps the bytes just written holds pre-landing data —
        it is evicted so the next reader re-fetches the fresh union."""
        if not res.dirty:
            return 0
        nbytes = self.cache.dma_out_2d(
            res.vpu, res.line_idxs, b.addr, b.rows, b.row_bytes, b.stride_bytes)
        res.dirty = False
        for pid in self._resident_index.query(b.region):
            r = self.resident.get(pid)
            if r is None or r.dirty or pid == b.phys_id:
                continue
            self._evict_resident(pid)
        cycles = self.geometry.dma_cycles(nbytes, b.rows)
        if self._wb_segments is not None:
            self._wb_segments.append((res.vpu, cycles))
        self._note_memory_write(b.region)
        return cycles

    def _note_memory_write(self, region) -> None:
        """Hook: ``region``'s bytes in main memory just changed (consolidation
        landing). The pipelined scheduler invalidates modeled reuse copies
        here; the serial scheduler models no reuse."""

    def _writeback_resident(self, b: MatrixBinding, res: ResidentMatrix) -> int:
        """Consolidate a resident matrix back to memory; returns DMA cycles."""
        cycles = self._consolidate_resident(b, res)
        self._evict_resident(b.phys_id)
        return cycles

    def _aliased_dirty(self, b: MatrixBinding,
                       newer_than: Optional[int] = None
                       ) -> list[tuple[int, int, MatrixBinding]]:
        """Dirty residents (≠ ``b``) overlapping ``b``, as sorted
        ``(writer_id, phys_id, binding)`` — admission (writer) order."""
        out = []
        for phys_id in self._resident_index.query(b.region):
            res = self.resident[phys_id]
            if phys_id == b.phys_id or not res.dirty:
                continue
            w = self.tracker.writer_of(phys_id)
            w = w if w is not None else -1
            if newer_than is not None and w <= newer_than:
                continue
            out.append((w, phys_id, self._binding_of(phys_id)))
        return sorted(out)

    def _land_aliased(self, items) -> int:
        """Land the given dirty residents in admission order, each preceded
        by its own older overlapping aliases (write-order discipline).
        Residents stay in place, clean, for their own pending readers; DST
        regions are released (the data is in memory now). Returns DMA
        cycles."""
        cycles = 0
        for _, phys_id, other in items:
            res = self.resident.get(phys_id)
            if res is None or not res.dirty:
                continue                         # landed by an earlier flush
            cycles += (self._flush_older_aliases(other)
                       + self._consolidate_resident(other, res))
            self.at.release(phys_id, RegionKind.DST)
        return cycles

    def _flush_aliased_dirty(self, b: MatrixBinding) -> int:
        """Land every dirty resident overlapping ``b`` before ``b``'s bytes
        are *read* from memory, so the read observes all deferred results."""
        return self._land_aliased(self._aliased_dirty(b))

    def _land_newer_aliases(self, b: MatrixBinding) -> int:
        """``b`` has a resident copy; deferred results from writers admitted
        *after* ``b``'s supersede its bytes — land them (the landing evicts
        the now-stale copy) so the reader re-fetches the fresh union."""
        my_w = self.tracker.writer_of(b.phys_id)
        return self._land_aliased(
            self._aliased_dirty(b, newer_than=my_w if my_w is not None else -1))

    def _flush_older_aliases(self, b: MatrixBinding) -> int:
        """Enforce admission-order memory write-backs: before ``b``'s data
        lands in memory, consolidate every dirty resident written by an
        *earlier-admitted* kernel whose footprint overlaps ``b`` — a deferred
        older result flushed later would clobber the newer bytes (and with a
        partial overlap, discarding it would lose the non-overlapped bytes).
        The flushed resident stays in place, clean, for its pending readers;
        its DST region is released (host RAW window closes with the data in
        memory). Returns DMA cycles."""
        my_writer = self.tracker.writer_of(b.phys_id)
        if my_writer is None:
            return 0
        cycles = 0
        # Snapshot the overlap candidates up-front (consolidations below
        # mutate the index) and replay them in residency claim order — the
        # iteration order of the pre-index dict scan.
        hits = [pid for pid in self._resident_index.query(b.region)
                if pid != b.phys_id]
        hits.sort(key=self._resident_seq.__getitem__)
        for phys_id in hits:
            res = self.resident.get(phys_id)
            if res is None or not res.dirty:
                continue
            w = self.tracker.writer_of(phys_id)
            if w is None or w >= my_writer:
                continue
            cycles += self._consolidate_resident(self._binding_of(phys_id),
                                                 res)
            self.at.release(phys_id, RegionKind.DST)
        return cycles

    def _evict_resident(self, phys_id: int) -> None:
        res = self.resident.pop(phys_id, None)
        if res is not None:
            self._resident_index.discard(phys_id)
            self._resident_seq.pop(phys_id, None)
            self.cache.release_vregs(res.line_idxs)
            self.tracker.unpin(phys_id)

    # ================================================================= barrier
    def _drain_deferred_residents(self, need_slots: Optional[int] = None) -> None:
        """Write back deferred dirty results and drop clean residents,
        releasing their AT destination regions — all of them (``barrier``),
        or just enough to free ``need_slots`` AT slots (capacity-pressure
        relief: residency affinity of the rest survives). Pending readers of
        a drained resident re-fetch from memory afterwards — the
        consolidation lands the bytes first, so draining under a non-empty
        queue is a pure timing cost, not a correctness hazard."""
        for phys_id in list(self.resident):
            if need_slots is not None and self.at.free_slots() >= need_slots:
                return
            res = self.resident.get(phys_id)
            if res is None:              # invalidated by an earlier landing
                continue
            if res.dirty:
                b = self._binding_of(phys_id)
                self.stats.writeback_cycles += (
                    self._flush_older_aliases(b)
                    + self._writeback_resident(b, res))
                self.at.release(phys_id, RegionKind.DST)
            else:
                # Clean residents (including ones consolidated early by
                # _flush_older_aliases) just drop; release the DST region so
                # host loads don't stall on a stale registration.
                self._evict_resident(phys_id)
                self.at.release(phys_id, RegionKind.DST)

    def _relieve_at_pressure(self, need: int) -> None:
        """Ensure ``need`` free Address Table slots before a registration.

        Static tables fill up when deferred write-backs pin DST entries
        (capacity pressure, §IV-B static allocation): first drain the kernel
        queue (retires release SRC entries), then force the deferred
        write-backs to land (each release frees its DST entry). A table that
        is still full afterwards is genuinely over capacity — raise a clear
        :class:`KernelError` instead of corrupting a half-registered kernel.
        """
        if need <= 0 or self.at.free_slots() >= need:
            return
        self.run_pending()
        # ``self._running``: a completion watcher is decoding new kernels
        # from inside a drain (the run_pending above was a guarded no-op, so
        # the queue may be non-empty) — the kernel that fired the watcher has
        # fully retired, so draining deferred residents is sound (see
        # _drain_deferred_residents: readers re-fetch landed bytes).
        if self.at.free_slots() < need and (not self.queue or self._running):
            self._drain_deferred_residents(need_slots=need)
        if self.at.free_slots() < need:
            raise KernelError(
                f"Address Table full ({self.at.capacity} entries, "
                f"{self.at.free_slots()} free, {need} needed) even after a "
                f"deferred write-back drain — raise queue_capacity (the AT "
                f"holds 4 entries per queue slot) in the config")

    def barrier(self) -> None:
        """Drain all queued kernels and write back all deferred results."""
        self.run_pending()
        if self.queue:
            raise RuntimeError("kernel queue not drained — dependency deadlock?")
        self._drain_deferred_residents()

    # ============================================================== sessions
    # The re-entrant session protocol (repro_torch.core.session.RuntimeSession is
    # the user-facing wrapper). The serial runtime has no event timeline, so
    # its clock is "modeled cycles so far plus injected idle": issuing at a
    # future time first drains queued work (work-conserving — the hardware
    # would not sit on runnable kernels), then pads the clock with idle.
    def session_now(self) -> int:
        """Current sim time of this runtime's session clock."""
        return self._session_idle + self.stats.total_cycles

    def session_post(self, t: int, fn: Callable[[int], None]) -> None:
        """Inject an external event (e.g. a request arrival): ``fn(now)`` is
        called when the session clock reaches ``t`` (clamped to now) during
        a later :meth:`session_advance`/:meth:`session_drain`."""
        if not callable(fn):
            raise TypeError(f"session_post payload must be callable, got "
                            f"{type(fn).__name__}")
        heapq.heappush(self._session_posts,
                       (max(int(t), self.session_now()),
                        next(self._post_seq), fn))

    def _session_pad(self, t: int) -> None:
        """Advance the clock to ``t``: run queued work first (its cycles are
        busy time, not idle), then pad the remainder with idle."""
        self.run_pending()
        now = self.session_now()
        if t > now:
            self._session_idle += t - now

    def _service_posts(self, until: Optional[int]) -> None:
        while self._session_posts and (until is None
                                       or self._session_posts[0][0] <= until):
            t, _, fn = heapq.heappop(self._session_posts)
            self._session_pad(t)
            fn(self.session_now())
            self.run_pending()

    def session_advance(self, until: int) -> None:
        """Service every posted event due by ``until`` (in time order, each
        followed by a drain of the work it issued), then pad to ``until``."""
        self._service_posts(until)
        self._session_pad(until)

    def session_drain(self) -> None:
        """Run the session to completion: service all remaining posts (and
        any they chain), then barrier."""
        self._service_posts(None)
        self.barrier()

    def _notify_retired(self, kid: int, t: int) -> None:
        """Fire the completion watchers registered for kernel ``kid`` —
        exactly once per kernel, at its retire point on either scheduler."""
        for cb in self._retire_watchers.pop(kid, ()):
            cb(t)

    def alias_queries_served(self) -> int:
        """AliasIndex queries answered across the scheduler stack (profiling:
        the ``--profile`` benchmark flag and PipelineReport surface this)."""
        return (self.at._alias_index.queries
                + self.tracker._alias_index.queries
                + self._resident_index.queries)

    def metrics_report(self) -> dict:
        """The unified metrics report (see :mod:`repro_torch.sim.metrics`). The
        serial scheduler books no event timeline, so the report carries the
        typed instruments and per-kernel stall synthesis but no critical
        path."""
        return self.metrics.report(
            makespan=self.stats.total_cycles,
            extra={"kernels_run": self.stats.kernels_run,
                   "alias_queries": self.alias_queries_served()})

    def _binding_of(self, phys_id: int) -> MatrixBinding:
        for b in self.matrix_map.live_bindings():
            if b.phys_id == phys_id:
                return b
        # Renamed away by a later xmr: the tracker retains the binding the
        # kernel was admitted with, so a deferred result whose logical
        # register was rebound can still be written back to its own region.
        b = self.tracker.binding(phys_id)
        if b is not None:
            return b
        raise KeyError(f"physical binding {phys_id} not live")

    # ============================================================== host path
    def host_load(self, addr: int, n: int) -> torch.Tensor:
        """Host CPU load with AT hazard check (RAW on kernel destinations):
        ``n`` bytes as a ``uint8`` tensor on the runtime's device."""
        if self.at.blocks_load(addr, addr + n):
            self.barrier()          # stall-until-writeback, then serve
        return self.cache.host_read(addr, n)

    def host_store(self, addr: int, buf: torch.Tensor) -> None:
        """Host CPU store of a tensor's bytes with AT hazard check (WAR on
        sources, WAW on dsts)."""
        buf = as_bytes(buf)
        n = buf.numel()
        if self.at.blocks_store(addr, addr + n):
            self.barrier()
        self.cache.host_write(addr, buf)
        if n:
            self._note_memory_write(StridedRegion(
                addr=addr, rows=1, row_bytes=n, stride_bytes=n))
