"""Event-driven pipelined C-RT scheduler (paper §IV-B, multi-VPU overlap).

:class:`PipelinedRuntime` schedules the *same* ``QueuedKernel`` DAG as the
serial :class:`~repro_torch.core.runtime.CacheRuntime` it subclasses, but overlaps
the C-RT phases across resources the way the hardware does:

  * the eCPU decodes kernel *k+1* while kernel *k* is in flight;
  * DMA-in for the next ready kernel runs on one VPU's DMA port while another
    VPU's datapath computes;
  * deferred write-backs drain opportunistically on idle DMA ports.

**Bit-identical numerics by construction.** All functional state mutation
(operand DMA-in, kernel execution, write-back) is performed *inline* at
event-handling time, in dependency order — the event queue only decides
*when* each already-correct step is modeled to happen. A kernel is dispatched
only after every DAG predecessor has retired (``DependencyTracker.ready``)
and no earlier-queued pending kernel still reads a memory region it writes
(the in-order WAR-aliasing guarantee the serial loop provides implicitly), so
the data each kernel observes is exactly what the serial schedule produces.

Modeled resources (see :mod:`repro_torch.sim.events`): ``ecpu``, ``cache.lock``,
and per VPU ``vpu{i}.datapath`` + ``vpu{i}.dma``. Every booked activity is
mirrored into a :class:`~repro_torch.sim.trace.Tracer` for Chrome trace export.

Own copy of repro.sim.pipeline: the scheduling code is the reference's;
the data plane is the serial runtime's shared steps, whose memory and
cache lines are tensors on the runtime's device (``device=``, passed on to
:class:`~repro_torch.core.runtime.CacheRuntime`: the card unless the caller
asks for the CPU). Every scheduling decision reads host metadata only.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from typing import Optional

from repro_torch.core.address_table import RegionKind
from repro_torch.core.alias_index import AliasIndex
from repro_torch.core.dataflow import FULL, FlowKind
from repro_torch.core.regions import StridedRegion, contains_cached
from repro_torch.core.runtime import CacheRuntime, QueuedKernel
from repro_torch.sim.events import (EventQueue, Resource, TileTrain,
                                    Timeline, row_chunks, split_proportional,
                                    tile_entries)
from repro_torch.sim.faults import FaultError
from repro_torch.sim.trace import Tracer


class DeadlockError(RuntimeError):
    """The open-loop session drain stopped making progress with work still
    pending — a genuine dependency deadlock (e.g. a kernel whose RAW edge
    can never be satisfied), not a capacity stall.

    Structured diagnostics ride along for the operator:

    * ``pending`` — ``{kernel_id: {"kernel": name, "blocked_on": reason,
      "unmet_deps": [ids]}}`` for every stuck kernel, with the last blocked
      reason the stall tracker observed (None when metrics are disabled);
    * ``resources`` — ``{resource_name: free_at}`` for every modeled
      resource at the moment the drain wedged.
    """

    def __init__(self, message: str, pending: dict, resources: dict):
        super().__init__(message)
        self.pending = pending
        self.resources = resources


@dataclasses.dataclass(frozen=True)
class PipelineReport:
    """Summary of one pipelined run: makespan vs the serial sum-of-phases.

    ``sim_seconds`` / ``events_processed`` / ``alias_queries`` profile the
    *simulator itself* (wall-clock spent inside the event loops, events
    popped, AliasIndex queries served) — the axes ``bench_scheduler.py``
    tracks and the ``--profile`` benchmark flag surfaces."""

    makespan: int                   # modeled end-to-end cycles (overlapped)
    serial_cycles: int              # sum of per-phase cycles (no overlap)
    kernels_run: int
    resource_busy: dict[str, int]   # resource name -> busy cycles
    utilization: dict[str, float]   # resource name -> busy / makespan
    reuse_hits: int = 0             # operand DMA trains skipped by reuse
    sim_seconds: float = 0.0        # wall-clock inside the scheduler loops
    events_processed: int = 0       # events popped off the EventQueue
    alias_queries: int = 0          # AliasIndex queries served (whole stack)

    @property
    def concurrency_speedup(self) -> float:
        return self.serial_cycles / self.makespan if self.makespan else 1.0


@dataclasses.dataclass
class ReuseEntry:
    """One modeled clean operand copy in a VPU's data array.

    ``region`` is the main-memory footprint the copy mirrors; ``ready_at`` the
    cycle its DMA train completed (a reuse hit gates compute no earlier)."""

    region: StridedRegion
    ready_at: int


class PipelinedRuntime(CacheRuntime):
    """C-RT with an event-driven, resource-accurate pipelined scheduler.

    ``row_chunk`` sets the intra-instruction pipelining granularity
    (NM-Carus-style): each source DMA-in is modeled as chunks of at most
    ``row_chunk`` rows, and the kernel's compute is split into matching
    pieces, each starting only after the chunks it needs have landed — so the
    datapath starts as soon as the first rows arrive instead of waiting for
    the whole operand. ``row_chunk=0`` disables chunking (whole-transfer
    granularity).

    ``dataflow`` selects the gating model. ``True`` (default): each operand
    streams as its *own* tile train and compute piece *i* waits for the
    per-operand tile set the kernel's dataflow descriptor demands
    (:mod:`repro_torch.core.dataflow` — e.g. all of GEMM's B before the first
    piece). ``False``: the legacy concatenated-stream model (piece *i* gated
    on chunk *i* of the sources concatenated in operand order) — optimistic
    for GEMM-like kernels, kept as an A/B reference. Functional state
    mutation is unchanged either way — only the timing model differs, so
    outputs stay bit-identical to the serial scheduler.

    ``tiling=(rows, cols)`` generalizes the 1D row trains to 2D tile trains:
    each operand DMA splits into row bands of at most ``rows`` rows (0 falls
    back to ``row_chunk``) × column tiles of at most ``cols`` columns (0
    keeps whole rows), compute splits into the matching output-tile grid, and
    piece ``(i, j)`` waits only for the operand tiles its dataflow policy
    projects onto it — GEMM output tile ``(i, j)`` needs A-band ``i`` and
    B-column-tile ``j``, not all of B. Operands whose column policy is FULL
    keep single-tile rows (column-splitting them buys no earlier gate).

    ``reuse`` enables cross-instruction operand reuse (NM-Carus keeps
    operands resident in the cache data arrays): the scheduler remembers the
    memory regions whose clean copies it modeled streaming into each VPU, and
    an operand whose region is *contained* in a remembered copy
    (:meth:`repro_torch.core.regions.StridedRegion.contains`) skips its DMA-in
    train entirely — strip-mined GEMM/conv sequences stop paying repeated
    B/weight fetches. Copies are invalidated whenever main memory changes
    under them (consolidations, host stores) and bounded by the VPU register
    file capacity (oldest copies fall out first). Reuse is a *timing* model:
    functional DMA still executes, so outputs stay bit-identical.

    Both ``tiling`` and ``reuse`` require ``dataflow`` gating (the legacy
    concatenated-stream model has no per-operand structure to tile or skip).

    ``wakeup`` selects the dispatch engine. ``True`` (default): wakeup-driven
    — each blocked kernel registers what it waits on (unmet dependencies, the
    earlier-queued WAR readers aliasing its destination, VPU capacity) and is
    re-examined only when a completion/dispatch wakes it. ``False``: the
    legacy full-pending-list rescan after every event. Both engines examine
    kernels in the same queue order under the same pass discipline, so the
    schedule — makespans, traces, memory images — is bit-identical; only the
    simulator's own wall-clock differs (``bench_scheduler.py`` measures the
    gap, and the differential tests assert the equality).
    """

    def __init__(self, *args, tracer: Optional[Tracer] = None,
                 row_chunk: int = 8, dataflow: bool = True,
                 tiling: Optional[tuple[int, int]] = None,
                 reuse: bool = False, wakeup: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        if row_chunk < 0:
            raise ValueError(f"row_chunk must be >= 0, got {row_chunk}")
        self.row_chunk = row_chunk
        self.dataflow = bool(dataflow)
        if tiling is not None:
            tr, tc = tiling
            if tr < 0 or tc < 0:
                raise ValueError(f"tiling dims must be >= 0, got {tiling}")
            # (0, 0) disables both axes — same normalization as SimConfig.
            tiling = (int(tr), int(tc)) if (tr or tc) else None
        self.tiling = tiling
        self.reuse = bool(reuse)
        if (self.tiling or self.reuse) and not self.dataflow:
            raise ValueError(
                "tiling/reuse require dataflow gating (dataflow=True); the "
                "legacy concatenated-stream model has no per-operand trains")
        self.wakeup = bool(wakeup)
        self.tracer = tracer or Tracer()
        self.sim_time = 0
        self.res_ecpu = Resource("ecpu")
        self.res_lock = Resource("cache.lock")
        self.res_dp = [Resource(f"vpu{v}.datapath")
                       for v in range(self.cache.n_vpus)]
        self.res_dma = [Resource(f"vpu{v}.dma")
                        for v in range(self.cache.n_vpus)]
        self._ready_at: dict[int, int] = {}     # kernel_id -> decode done time
        # Dispatch state: pending kernels by id (ascending == queue order),
        # per-phys pending-reader counts (the _needed_later question), the
        # pending-source footprint index (the WAR dispatch guard), and the
        # wakeup bookkeeping — which kernels to (re)examine, who waits on
        # which completion/dispatch, who waits on VPU capacity.
        self._pending_map: dict[int, QueuedKernel] = {}
        self._pending_src_count: dict[int, int] = {}
        self._war_index = AliasIndex()
        self._wake: set[int] = set()
        self._dep_waiters: dict[int, set[int]] = {}
        self._war_waiters: dict[int, set[int]] = {}
        self._cap_blocked: set[int] = set()
        # Open-ended timeline (persistent across drains): the event queue
        # lives for the whole session so externally posted events (request
        # arrivals) and kernels issued from completion callbacks interleave
        # with in-flight work. ``_inflight`` maps dispatched-but-unretired
        # kernels to their functional state.
        self._timeline = Timeline()
        self._inflight: dict[int, tuple] = {}
        # Simulator self-profiling (PipelineReport / --profile).
        self.events_processed = 0
        self._wall_seconds = 0.0
        # Cross-instruction reuse: per-VPU FIFO of modeled clean copies
        # (insertion-ordered dicts keyed by a global sequence number), bounded
        # by the register-file capacity (oldest copies reclaimed first — the
        # model's stand-in for line reclamation). The footprint index keyed by
        # (vpu, seq) answers both the containment lookups and the
        # invalidation sweeps in O(hits).
        self._reuse_entries: list[dict[int, ReuseEntry]] = [
            {} for _ in range(self.cache.n_vpus)]
        self._reuse_bytes = [0] * self.cache.n_vpus
        self._reuse_index = AliasIndex()
        self._reuse_seq = itertools.count()
        self._reuse_cap = self.cache.vregs_per_vpu * self.cache.vlen_bytes

    # ----------------------------------------------------------- public api
    def _all_resources(self) -> list[Resource]:
        return [self.res_ecpu, self.res_lock, *self.res_dp, *self.res_dma]

    def report(self) -> PipelineReport:
        busy = {r.name: r.busy_cycles for r in self._all_resources()}
        return PipelineReport(
            makespan=self.sim_time,
            serial_cycles=self.stats.total_cycles,
            kernels_run=self.stats.kernels_run,
            resource_busy=busy,
            utilization={n: (b / self.sim_time if self.sim_time else 0.0)
                         for n, b in busy.items()},
            reuse_hits=self.stats.reuse_hits,
            sim_seconds=self._wall_seconds,
            events_processed=self.events_processed,
            alias_queries=self.alias_queries_served(),
        )

    def alias_queries_served(self) -> int:
        return (super().alias_queries_served()
                + self._war_index.queries + self._reuse_index.queries)

    def metrics_report(self) -> dict:
        """Unified metrics report over the pipelined event timeline: typed
        instruments, per-kernel stall attribution, and the critical-path
        breakdown of the makespan (see :mod:`repro_torch.sim.metrics`)."""
        return self.metrics.report(
            makespan=self.sim_time,
            extra={"kernels_run": self.stats.kernels_run,
                   "events_processed": self.events_processed,
                   "alias_queries": self.alias_queries_served(),
                   "reuse_hits": self.stats.reuse_hits,
                   "serial_cycles": self.stats.total_cycles,
                   "sim_seconds": self._wall_seconds})

    def _emit_counters(self, t: int) -> None:
        """Sample the Chrome counter tracks (per-VPU line occupancy, AT free
        slots, reuse-FIFO bytes) at cycle ``t`` — dispatches, completions and
        drains are the points where any of them can change."""
        if not self.tracer.enabled:
            return
        self.tracer.counter("at.free_slots", t, free=self.at.free_slots())
        for v in range(self.cache.n_vpus):
            self.tracer.counter(
                f"vpu{v}.lines", t,
                used=self.cache.vregs_per_vpu - self.cache.free_line_count(v))
        if self.reuse:
            for v in range(self.cache.n_vpus):
                self.tracer.counter(f"vpu{v}.reuse_bytes", t,
                                    bytes=self._reuse_bytes[v])

    # ----------------------------------------------------- operand reuse set
    def _reuse_lookup(self, v: int, region: StridedRegion) -> Optional[int]:
        """Cycle at which a containing clean copy on VPU ``v`` is fully
        landed, or None when the operand must stream."""
        if not self.reuse:
            return None
        # Index keys sort by (vpu, seq): the first containment hit for VPU v
        # is the oldest (FIFO-first) entry — the copy the pre-index deque
        # scan would have returned.
        for vv, seq in self._reuse_index.query(region):
            if vv != v:
                continue
            e = self._reuse_entries[v][seq]
            if contains_cached(e.region, region):
                return e.ready_at
        return None

    def _reuse_drop(self, v: int, seq: int) -> None:
        e = self._reuse_entries[v].pop(seq)
        self._reuse_index.remove((v, seq))
        self._reuse_bytes[v] -= e.region.nbytes

    def _reuse_note(self, v: int, region: StridedRegion, ready_at: int) -> None:
        """Record a freshly-streamed clean copy on VPU ``v``."""
        if not self.reuse:
            return
        for vv, seq in self._reuse_index.query(region):
            if vv == v and self._reuse_entries[v][seq].region == region:
                self._reuse_drop(v, seq)
        seq = next(self._reuse_seq)
        self._reuse_entries[v][seq] = ReuseEntry(region=region,
                                                 ready_at=ready_at)
        self._reuse_index.insert((v, seq), region)
        self._reuse_bytes[v] += region.nbytes
        while self._reuse_bytes[v] > self._reuse_cap:
            self._reuse_drop(v, next(iter(self._reuse_entries[v])))

    def _note_memory_write(self, region: StridedRegion) -> None:
        """Main memory changed under ``region`` (consolidation landing or a
        host store): every modeled copy overlapping it is stale. The index
        query pins down exactly the overlapped entries — nothing else is
        evicted, and no FIFO is scanned."""
        for vv, seq in self._reuse_index.query(region):
            self._reuse_drop(vv, seq)

    # ------------------------------------------------------------ scheduler
    def run_pending(self) -> None:
        """Drain every admitted kernel with the event-driven schedule.

        Re-entrant calls — a completion callback issuing new kernels from
        inside the event loop, or any issue under an *open* session (see
        :mod:`repro_torch.core.session`) — only admit the queue into the pending
        set; the owning event loop (or the session's ``advance``/``drain``)
        processes the events. A top-level call in closed (batch) mode is the
        legacy behaviour: admit, run the timeline dry, settle."""
        if self._in_loop or self._session_open:
            self._admit_queue()
            return
        if not (self.queue or self._pending_map or self._timeline):
            return
        wall0 = time.perf_counter()
        self._admit_queue()
        self._wake.update(self._pending_map)
        t = self._run_events()
        self._settle(t)
        self._wall_seconds += time.perf_counter() - wall0

    def _relieve_at_pressure(self, need: int) -> None:
        """Address-Table pressure with the event loop live (re-entrant issue
        from a callback, or any issue under an open session): model a
        *frontend stall*. The decoder blocks mid-issue and the machine keeps
        executing — internal lifecycle events run until enough earlier
        kernels retire to free ``need`` slots — while posted arrivals stay
        queued (a stalled decoder cannot service them; they fire at the
        unblock time). Closed-batch calls fall through to the base eager
        drain, which this path never perturbs."""
        if need > 0 and self.at.free_slots() < need \
                and (self._in_loop or self._session_open):
            self._admit_queue()
            self._wake.update(self._pending_map)
            self._run_events(at_need=need)
        super()._relieve_at_pressure(need)

    def _admit_queue(self, at: Optional[int] = None) -> None:
        """Move queued kernels into the pending set and book their decodes
        starting at ``at`` (default: the timeline clock).

        Decode timeline: the eCPU ISR serialises preambles, but kernel k may
        dispatch right after its own decode — later decodes overlap with
        earlier kernels' allocation/compute. Each decode-completion event
        wakes exactly its own kernel."""
        if not self.queue:
            return
        pending = list(self.queue)
        self.queue.clear()
        for qk in pending:
            kid = qk.deps.kernel_id
            self._pending_map[kid] = qk
            for si, s in enumerate(qk.src_bindings):
                self._pending_src_count[s.phys_id] = \
                    self._pending_src_count.get(s.phys_id, 0) + 1
                self._war_index.insert((kid, si), s.region)
        t0 = self._timeline.now if at is None else at
        for qk in pending:
            kid = qk.deps.kernel_id
            iv = self.res_ecpu.acquire(t0, self.geometry.decode_cycles,
                                       label=f"decode k{kid}")
            self._ready_at[kid] = iv.end
            self.tracer.emit(f"{qk.spec.name} k{kid} decode", "preamble",
                             "ecpu", iv.start, iv.duration, kernel=kid)
            self.metrics.kernel_decoded(kid, iv.end, qk.spec.name)
            self.metrics.activity(f"{qk.spec.name} k{kid} decode", "preamble",
                                  "ecpu", iv.start, iv.end, kernel=kid)
            self._timeline.push(iv.end, "dispatch", kid)

    def _run_events(self, until: Optional[int] = None,
                    at_need: Optional[int] = None,
                    internal_only: bool = False) -> int:
        """Process timeline events in order until the timeline empties or
        the next event lies beyond ``until``; returns the clock. External
        events (posted arrivals) invoke their callback — which may issue new
        kernels re-entrantly — then admit whatever the callback queued.

        ``at_need`` is the frontend-stall mode (see
        :meth:`_relieve_at_pressure`): run only *internal* lifecycle events
        until that many Address-Table slots are free. External events are
        deferred back onto the timeline — the stalled decoder cannot service
        arrivals, so their callbacks fire at the unblock time (their posted
        sim time is preserved; only the service time moves, exactly a
        stalled issue queue's behaviour). ``internal_only`` (implied by
        ``at_need``) defers externals without an AT target — the settle uses
        it to run residual in-flight work dry."""
        internal_only = internal_only or at_need is not None
        eq = self._timeline
        t = eq.now
        was_in_loop, self._in_loop = self._in_loop, True
        deferred = []
        try:
            while True:
                if at_need is not None and self.at.free_slots() >= at_need:
                    break
                self._dispatch_sweep(t, self._inflight, eq)
                while internal_only and eq \
                        and eq.peek().kind == Timeline.EXTERNAL:
                    deferred.append(eq.pop())
                if not eq:
                    break
                if until is not None and eq.peek().time > until:
                    break
                ev = eq.pop()
                t = eq.advance_clock(ev.time)
                self.events_processed += 1
                # Lazy hard-fault check: fires at the first event at or
                # after ``hard_at`` (never via a posted event, so runs that
                # finish earlier keep their fault-free makespan).
                self._maybe_hard_fault(t, eq)
                if ev.kind == "dispatch":
                    # Decode finished: this kernel becomes examinable.
                    self._wake.add(ev.payload)
                elif ev.kind == "compute_done":
                    self._handle_compute_done(ev.payload, t, self._inflight,
                                              eq)
                elif ev.kind == "wb_done":
                    # A port that just finished a write-back immediately
                    # takes the next least-booked-port drain instead of
                    # leaving it for the final barrier flush. Drains evict
                    # residents, so capacity-blocked kernels get another
                    # look.
                    self._drain_idle_dma(t, self._inflight, eq)
                    self._emit_counters(t)
                    self._wake_capacity_blocked()
                elif ev.kind == Timeline.EXTERNAL:
                    ev.payload(t)
                    self._admit_queue()
        finally:
            self._in_loop = was_in_loop
            for ev in deferred:
                eq.push(ev.time, ev.kind, ev.payload)
        return t

    def _settle(self, t: int) -> None:
        """Close a batch drain: align the makespan with the latest booking,
        run capacity-starved leftovers through the serial fallback, and
        reset the wakeup bookkeeping.

        Capacity-starved leftovers fall back to the serial step so the
        failure mode (ResourceStall) is identical to CacheRuntime's. Their
        phase cycles (everything but the already-timelined decode) append
        serially to the makespan — nothing overlaps a starved schedule.
        Kernels admitted *during* the fallback (completion callbacks may
        issue new work) are not part of this settle: they stay pending, with
        their decode events on the timeline, for the next drain."""
        end = max([t, self.sim_time]
                  + [r.free_at for r in self._all_resources()])
        still = []
        fallback_before = self.stats.total_cycles
        snapshot = list(self._pending_map.values())
        ran: set[int] = set()
        was_in_loop, self._in_loop = self._in_loop, True   # nested issues admit
        try:
            for qk in snapshot:
                kid = qk.deps.kernel_id
                if kid not in self._pending_map:
                    # A retire callback's backpressure stall ran the event
                    # loop mid-pass and dispatched (and cleaned up) this
                    # kernel — nothing left to do here.
                    continue
                if self.tracker.ready(kid):
                    self.metrics.inc("kernels.fallback")
                    # Hide the kernel from re-entrant dispatch sweeps before
                    # running it, but keep its source counts until the pass
                    # ends: _needed_later must see the whole snapshot.
                    self._pending_map.pop(kid)
                    ran.add(kid)
                    self._run_one(qk)
                else:
                    still.append(qk)
        finally:
            self._in_loop = was_in_loop
        # A backpressure stall during the fallback may have dispatched
        # kernels event-driven; run their remaining lifecycle dry (externals
        # stay deferred) so nothing is left in flight across the settle
        # clock jump — the stall attribution could not account for that
        # gap. Closed-batch settles enter with an empty timeline and no
        # in-flight work, so this is a no-op there.
        if self._inflight or self._timeline:
            t2 = self._run_events(internal_only=True)
            end = max([end, t2] + [r.free_at for r in self._all_resources()])
        # Pending-state removal happens after the fallback pass (not per
        # kernel): _needed_later must see the whole snapshot's source counts
        # while fallback kernels retire, exactly as the batch scheduler did.
        for qk in snapshot:
            kid = qk.deps.kernel_id
            if kid in self._pending_map:
                self._remove_pending(kid)
            elif kid in ran:
                self._strip_pending_residue(kid, qk)
        # Kernels admitted *during* the fallback (retire callbacks issuing
        # new programs) get the same treatment as capacity-starved
        # leftovers: back to the queue for a fresh decode next drain. A
        # settle always ends with the pending set empty, so the serial
        # fallback cycles it appends to the makespan never open an
        # unattributed ready→dispatch gap in the stall accounting.
        for kid in list(self._pending_map):
            still.append(self._remove_pending(kid))
        end += self.stats.total_cycles - fallback_before
        self.sim_time = end
        self._timeline.advance_clock(end)
        self._wake.clear()
        self._dep_waiters.clear()
        self._war_waiters.clear()
        self._cap_blocked.clear()
        self.queue.extend(still)

    def _remove_pending(self, kid: int) -> QueuedKernel:
        """Drop one kernel from the pending bookkeeping (dispatched, run by
        the fallback, or re-queued as undispatchable)."""
        qk = self._pending_map.pop(kid)
        self._strip_pending_residue(kid, qk)
        return qk

    def _strip_pending_residue(self, kid: int, qk: QueuedKernel) -> None:
        """The non-map half of :meth:`_remove_pending`: release the decode
        booking, the source refcounts, and the WAR-index entries."""
        self._ready_at.pop(kid, None)
        for si, s in enumerate(qk.src_bindings):
            n = self._pending_src_count[s.phys_id] - 1
            if n:
                self._pending_src_count[s.phys_id] = n
            else:
                del self._pending_src_count[s.phys_id]
            self._war_index.remove((kid, si))

    def _dispatch_sweep(self, t: int, inflight: dict, eq: EventQueue) -> None:
        """Dispatch every kernel that can go at time ``t``.

        Kernels are examined in queue (ascending-id) order under the same
        pass discipline as the legacy full rescan: a pass walks ids upward
        (a heap, so mid-pass wakes ahead of the cursor join the same pass in
        order), kernels woken *behind* the cursor defer to the next pass,
        and passes repeat until one dispatches nothing. With ``wakeup`` the
        examined set is only the woken kernels — blocked kernels re-enter
        via their registered waker — which is schedule-equivalent because a
        kernel none of whose wake conditions fired would fail its checks
        with exactly the same answers as last time. With ``wakeup=False``
        every pass (re)examines the whole pending set, reproducing the
        legacy rescan-to-fixpoint engine."""
        while True:
            if not self.wakeup:
                self._wake.update(self._pending_map)
            if not self._wake:
                return
            progress = False
            cursor = -1
            deferred: set[int] = set()
            heap = sorted(self._wake)
            self._wake.clear()
            while heap:
                cand = heapq.heappop(heap)
                if cand <= cursor:
                    continue                   # duplicate wake this pass
                cursor = cand
                qk = self._pending_map.get(cand)
                if qk is None:
                    continue                   # already dispatched
                if self._try_dispatch(cand, qk, t, inflight, eq):
                    progress = True
                    if self._wake:             # wakes from this dispatch
                        for k in self._wake:
                            if k > cursor:
                                heapq.heappush(heap, k)
                            else:
                                deferred.add(k)
                        self._wake.clear()
            self._wake |= deferred
            if not progress:
                return

    def _try_dispatch(self, kid: int, qk: QueuedKernel, t: int,
                      inflight: dict, eq: EventQueue) -> bool:
        """Examine one pending kernel; dispatch it or register its waker."""
        if self._ready_at[kid] > t:
            return False         # its own decode event wakes it
        unmet = self.tracker.unmet_deps(kid)
        if unmet:
            self.metrics.kernel_blocked(kid, t, "raw_dep")
            if self.wakeup:
                for d in unmet:
                    self._dep_waiters.setdefault(d, set()).add(kid)
            return False
        blockers = self._war_blockers(qk, kid)
        if blockers:
            self.metrics.kernel_blocked(kid, t, "war_guard")
            if self.wakeup:
                for b in blockers:
                    self._war_waiters.setdefault(b, set()).add(kid)
            return False
        v = self._choose_vpu_pipelined(qk, t)
        if v is None:
            self.metrics.kernel_blocked(kid, t, "capacity")
            if self.wakeup:
                self._cap_blocked.add(kid)
            return False
        self._remove_pending(kid)
        self._dispatch(qk, v, t, inflight, eq)
        # This dispatch unblocks: later kernels WAR-gated on this reader, and
        # (because allocation can consolidate/evict residents on any VPU)
        # possibly every capacity-blocked kernel.
        waiters = self._war_waiters.pop(kid, None)
        if waiters:
            self._wake |= waiters
        self._wake_capacity_blocked()
        return True

    def _war_blockers(self, qk: QueuedKernel, kid: int) -> set[int]:
        """In-order WAR-aliasing guard: ``qk`` must not overwrite a memory
        region an earlier-queued, still-pending kernel reads (that kernel
        copies its sources in at dispatch; program order then guarantees it
        observes the pre-``qk`` data, exactly like the serial loop). Returns
        the blocking kernel ids (empty = free to go); the pending-source
        footprint index makes this O(hits), not O(pending × operands)."""
        return {k for k, _si in
                self._war_index.query(qk.dst_binding.region) if k < kid}

    def _wake_capacity_blocked(self) -> None:
        if self._cap_blocked:
            self._wake |= self._cap_blocked
            self._cap_blocked.clear()

    # -------------------------------------------------------- VPU selection
    def _free_lines(self, v: int) -> int:
        return self.cache.free_line_count(v)

    def _capacity_ok(self, qk: QueuedKernel, v: int) -> bool:
        need = 0
        seen: set[int] = set()
        for s in qk.src_bindings:
            if s.phys_id in seen:       # repeated operand (e.g. gemm(A, A))
                continue                # is claimed once by _allocation_step
            seen.add(s.phys_id)
            r = self.resident.get(s.phys_id)
            if r is not None and r.vpu == v:
                continue
            need += self.vpus[v].lines_needed(*s.shape, s.width)
        d = qk.dst_binding
        r = self.resident.get(d.phys_id)
        if not (r is not None and r.vpu == v
                and (r.rows, r.cols) == (d.rows, d.cols)):
            need += self.vpus[v].lines_needed(*d.shape, d.width)
        return self._free_lines(v) >= need

    def _choose_vpu_pipelined(self, qk: QueuedKernel, t: int) -> Optional[int]:
        """Same policy family as the serial scheduler — resident-operand
        affinity first — extended with earliest-free-datapath preference so
        independent kernels spread across VPUs. Returns None to wait.

        Offlined VPUs never attract work: affinity to a resident stranded on
        a fenced VPU falls through to the healthy candidates (the cross-VPU
        path in ``_allocate_source`` consolidates the resident through
        memory when the kernel lands elsewhere)."""
        for s in qk.src_bindings:
            r = self.resident.get(s.phys_id)
            if r is None or r.vpu in self.offline:
                continue
            return r.vpu if self._capacity_ok(qk, r.vpu) else None
        cands = [v for v in range(self.cache.n_vpus)
                 if v not in self.offline and self._capacity_ok(qk, v)]
        if not cands:
            return None
        return min(cands, key=lambda v: (max(self.res_dp[v].free_at, t),
                                         self.cache.dirty_line_count(v),
                                         -self._free_lines(v), v))

    # ------------------------------------------------------------ activities
    def _dispatch(self, qk: QueuedKernel, v: int, t: int, inflight: dict,
                  eq: EventQueue) -> None:
        kid = qk.deps.kernel_id
        vpu = self.vpus[v]
        kf = self.faults.kernel_faults(kid) if self.faults is not None \
            else None
        # Functional allocation happens NOW, in dependency order; the events
        # below only model when the hardware would finish each piece. (The
        # allocation's aliased-dirty flushes consolidate through
        # _consolidate_resident, which invalidates any reuse copies the
        # landing made stale — so the reuse lookups below see post-flush
        # memory state.)
        alloc = self._allocation_step(qk, vpu)
        lock_iv = self.res_lock.acquire(t, self.geometry.schedule_cycles,
                                        label=f"k{kid} claim")
        flows = (qk.spec.dataflow
                 if self.dataflow and qk.spec.dataflow else None)
        # Cross-instruction reuse: an operand whose region is contained in a
        # clean copy already modeled on this VPU skips its DMA-in train — the
        # skipped transfer cycles never enter the allocation phase (they are
        # tallied separately in PhaseStats.reused_dma_cycles).
        segs = alloc.dma_segments
        reuse_gates: list[int] = []
        skip_cycles = 0
        if self.reuse and flows is not None:
            kept = []
            for si, rows, cycles in segs:
                hit = self._reuse_lookup(v, qk.src_bindings[si].region)
                if hit is None:
                    kept.append((si, rows, cycles))
                    continue
                reuse_gates.append(hit)
                skip_cycles += cycles
                self.stats.reuse_hits += 1
                self.stats.reused_dma_cycles += cycles
                self.tracer.emit(f"{qk.spec.name} k{kid} reuse[op{si}]",
                                 "allocation", f"vpu{v}.dma",
                                 max(lock_iv.end, hit), 0, lane=f"op{si}",
                                 instant=True, kernel=kid, vpu=v, operand=si)
            segs = kept
        self.stats.allocation_cycles += (self.geometry.schedule_cycles
                                         + alloc.dma_cycles - skip_cycles)
        self.stats.writeback_cycles += alloc.wb_cycles
        self.tracer.emit(f"{qk.spec.name} k{kid} claim", "allocation",
                         "cache.lock", lock_iv.start, lock_iv.duration,
                         kernel=kid, vpu=v)
        self.metrics.activity(f"{qk.spec.name} k{kid} claim", "allocation",
                              "cache.lock", lock_iv.start, lock_iv.end,
                              kernel=kid, vpu=v)
        # Consolidation write-backs of older deferred results happen before
        # this kernel's operands stream in, each on the DMA port of the VPU
        # *holding* the resident (not necessarily the dispatch VPU); they are
        # *writeback*-phase cycles, booked separately so the trace's phase
        # totals agree with PhaseStats. The DMA-in below reads the bytes
        # these consolidations land, so it is gated on their completion.
        dma_start = lock_iv.end
        for wv, cyc in alloc.wb_segments:
            wb_iv = self.res_dma[wv].acquire(lock_iv.end, cyc,
                                             label=f"k{kid} consolidate")
            dma_start = max(dma_start, wb_iv.end)
            self.tracer.emit(f"{qk.spec.name} k{kid} consolidate", "writeback",
                             f"vpu{wv}.dma", wb_iv.start, wb_iv.duration,
                             kernel=kid, vpu=wv)
            self.metrics.activity(f"{qk.spec.name} k{kid} consolidate",
                                  "writeback", f"vpu{wv}.dma", wb_iv.start,
                                  wb_iv.end, kernel=kid, vpu=wv)
            self.metrics.inc("wb.consolidations")

        # ECC tier (fault model): the injection + recovery is functional —
        # bits really flip in the data array and the scrub really corrects
        # or re-fetches (see CacheRuntime._fault_scrub) — and the recovery
        # cycles book as a window on this VPU's DMA port ahead of the
        # operand tile trains (FIFO order pushes the trains behind it). The
        # window's end feeds the stall table so the delay bins as
        # ``fault_replay``, keeping per-kernel conservation exact.
        fault_end = 0
        if kf is not None and kf.ecc_bits:
            scrub_cycles = self._fault_scrub(qk, alloc, kf)
            if scrub_cycles:
                f_iv = self.res_dma[v].acquire(dma_start, scrub_cycles,
                                               label=f"k{kid} ecc-scrub")
                fault_end = f_iv.end
                self.stats.fault_cycles += scrub_cycles
                kind = "correct" if kf.ecc_bits == 1 else "refetch"
                self.tracer.emit(f"{qk.spec.name} k{kid} ecc-{kind}",
                                 "allocation", f"vpu{v}.dma", f_iv.start,
                                 f_iv.duration, kernel=kid, vpu=v)
                self.metrics.activity(f"{qk.spec.name} k{kid} ecc-{kind}",
                                      "allocation", f"vpu{v}.dma", f_iv.start,
                                      f_iv.end, kernel=kid, vpu=v)

        # Tile-train DMA-in (intra-instruction pipelining): each source
        # operand streams as its OWN train of (row-band × column-tile)
        # activities on the VPU's DMA port. With dataflow gating on, operands
        # that gate FULL on *both* axes (conv weights; GEMM's B when column
        # tiling is off) stream first so the streamable operands can feed the
        # datapath while still in flight. A row-FULL operand whose column
        # axis streams (GEMM's B under `tiling`) instead keeps its program
        # position: it transfers column-tile-major *after* the row-paced
        # operands, so output tile (*, 0) unblocks at B's first column tile
        # and compute overlaps the remaining tiles' DMA — the Neural-Cache
        # strip pipeline. Trains are keyed by physical binding, so a repeated
        # operand (gemm(A, A)) gates every occurrence on the one train that
        # was actually scheduled. Without a `tiling` config every operand has
        # a single column tile and the model reduces to the 1D row trains.
        band_limit = ((self.tiling[0] or self.row_chunk) if self.tiling
                      else self.row_chunk)
        col_limit = self.tiling[1] if self.tiling else 0
        if flows is not None:
            def fully_gated(flow) -> bool:
                return (flow.kind is FlowKind.FULL
                        and not (col_limit
                                 and flow.col_kind is not FlowKind.FULL))
            order = sorted(range(len(segs)),
                           key=lambda i: (not fully_gated(flows[segs[i][0]]),
                                          i))
            segs = [segs[i] for i in order]
        trains: dict[int, TileTrain] = {}
        streamed: list[tuple[StridedRegion, int]] = []
        eff_flows = list(flows) if flows is not None else None
        dma_ivs = []
        chunk_rows: list[int] = []
        # Trace rows + spans of the booked DMA tiles, for flow-arrow emission
        # (phys_id -> (block, band, tile) -> (row, start, end)); the parallel
        # flat list serves the legacy chunk-indexed gating model.
        tile_slices: dict[int, dict[tuple[int, int, int],
                                    tuple[str, int, int]]] = {}
        flat_slices: list[tuple[str, int, int]] = []
        ci = 0
        for si, rows, cycles in segs:
            flow = flows[si] if flows is not None else None
            binding = qk.src_bindings[si]
            blocks = 1
            if flow is not None and flow.blocks > 1:
                if rows % flow.blocks == 0:
                    blocks = flow.blocks
                else:
                    # Rows don't split into the declared blocks: stream as one
                    # train and gate FULL — a per-row window over a layout we
                    # can't decompose would be optimistic, not conservative.
                    eff_flows[si] = FULL
            flow_eff = eff_flows[si] if flows is not None else None
            band_parts = row_chunks(rows // blocks, band_limit)
            # Column tiles only pay off when the operand's column policy can
            # gate on partial columns; a column-FULL operand streams whole
            # rows (one tile) — splitting it buys no earlier compute start.
            if (flow_eff is not None and col_limit
                    and flow_eff.col_kind is not FlowKind.FULL):
                col_parts = row_chunks(binding.cols, col_limit)
            else:
                col_parts = [binding.cols]
            # Row-FULL / column-streamed operands (GEMM's B) transfer
            # column-tile-major so output tile (*, 0) unblocks as early as
            # possible; everything else goes band-major.
            col_major = (flow_eff is not None and len(col_parts) > 1
                         and flow_eff.kind is FlowKind.FULL)
            entries = tile_entries([band_parts] * blocks, col_parts,
                                   col_major)
            cyc_parts = split_proportional(
                cycles, [band_parts[bi] * col_parts[ti]
                         for _, bi, ti in entries])
            nb, nt = len(band_parts), len(col_parts)
            ends = [[[0] * nt for _ in range(nb)] for _ in range(blocks)]
            op_slices = tile_slices.setdefault(binding.phys_id, {})
            for (blk, bi, ti), cyc in zip(entries, cyc_parts):
                iv = self.res_dma[v].acquire(
                    dma_start, cyc, label=f"k{kid} dma-in[op{si}.{ci}]")
                dma_ivs.append(iv)
                if flows is None:       # legacy concatenated-gating weights
                    chunk_rows.append(band_parts[bi])
                ends[blk][bi][ti] = iv.end
                lane = f"op{si}" if nt == 1 else f"op{si}.c{ti}"
                self.tracer.emit(f"{qk.spec.name} k{kid} dma-in[op{si}.{ci}]",
                                 "allocation", f"vpu{v}.dma", iv.start,
                                 iv.duration, lane=lane, kernel=kid,
                                 vpu=v, chunk=ci, operand=si, band=bi,
                                 tile=ti)
                self.metrics.activity(
                    f"{qk.spec.name} k{kid} dma-in[op{si}.{ci}]",
                    "allocation", f"vpu{v}.dma", iv.start, iv.end,
                    kernel=kid, vpu=v)
                self.metrics.inc("dma.tiles")
                op_slices[(blk, bi, ti)] = (f"vpu{v}.dma/{lane}",
                                            iv.start, iv.end)
                flat_slices.append((f"vpu{v}.dma/{lane}", iv.start, iv.end))
                ci += 1
            cum_r = []
            acc = 0
            for r in band_parts:
                acc += r
                cum_r.append(acc)
            cum_c = []
            acc = 0
            for c in col_parts:
                acc += c
                cum_c.append(acc)
            trains[binding.phys_id] = TileTrain(
                [list(cum_r) for _ in range(blocks)], cum_c, ends)
            if self.reuse:
                streamed.append((binding.region,
                                 max(iv.end
                                     for iv in dma_ivs[-len(entries):])))

        compute_cycles = self._compute_step(qk, vpu, alloc.src_res,
                                            alloc.dst_res)
        self.stats.compute_cycles += compute_cycles
        # Replay tier (fault model), functional half: each corrupted attempt
        # flips a destination bit and re-executes from the still-resident,
        # still-clean sources — inline, while they are guaranteed valid (a
        # later kernel's consolidation sweep may evict them mid-flight).
        # The *timing* of each replay attempt books at compute_done.
        if kf is not None and kf.replays:
            for attempt in range(kf.replays):
                self._fault_corrupt_dst(qk, alloc, attempt)
                self._compute_step(qk, vpu, alloc.src_res, alloc.dst_res)
        # Matching compute pieces. Dataflow gating: the output-tile grid is
        # paced row-wise by the longest row-streaming train and column-wise
        # by the widest column-streaming train, and tile (i, j) waits for the
        # tile set every operand's policy demands (operands without a train
        # are already resident or reuse-skipped — residents impose no gate,
        # reuse copies gate at their modeled landing time). Legacy (dataflow
        # off): piece i is gated on chunk i of the concatenated stream. With
        # no DMA at all, compute is one piece.
        piece_spans: list[tuple[int, int, int]] = []   # (gate, start, end)
        if flows is not None and (dma_ivs or reuse_gates):
            constraints = [(trains[s.phys_id], eff_flows[si], s.phys_id)
                           for si, s in enumerate(qk.src_bindings)
                           if s.phys_id in trains]
            pacing = [tr for tr, fl, _ in constraints
                      if fl.kind is not FlowKind.FULL]
            n_pieces = max((tr.pace for tr in pacing), default=1)
            weights = next((tr.piece_weights() for tr in pacing
                            if tr.pace == n_pieces), [1] * n_pieces)
            col_pacing = [tr for tr, fl, _ in constraints
                          if fl.col_kind is not FlowKind.FULL
                          and tr.col_pace > 1]
            n_cols = max((tr.col_pace for tr in col_pacing), default=1)
            col_weights = next((tr.col_weights() for tr in col_pacing
                                if tr.col_pace == n_cols), [1] * n_cols)
            band_cycles = split_proportional(compute_cycles, weights)
            base_gate = max([lock_iv.end] + reuse_gates)
            dp_iv = None
            for pi, bc in enumerate(band_cycles):
                for pj, cyc in enumerate(split_proportional(bc, col_weights)):
                    ready = max([base_gate]
                                + [tr.gate(fl, pi, n_pieces, pj, n_cols)
                                   for tr, fl, _ in constraints])
                    tag = f"{pi},{pj}" if n_cols > 1 else f"{pi}"
                    dp_iv = self.res_dp[v].acquire(
                        ready, cyc, label=f"k{kid} {qk.spec.name}[{tag}]")
                    self.tracer.emit(f"{qk.spec.name} k{kid}[{tag}]",
                                     "compute", f"vpu{v}.datapath",
                                     dp_iv.start, dp_iv.duration, kernel=kid,
                                     vpu=v, chunk=pi * n_cols + pj, band=pi,
                                     tile=pj)
                    self.metrics.activity(f"{qk.spec.name} k{kid}[{tag}]",
                                          "compute", f"vpu{v}.datapath",
                                          dp_iv.start, dp_iv.end,
                                          kernel=kid, vpu=v)
                    piece_spans.append((ready, dp_iv.start, dp_iv.end))
                    if self.tracer.enabled and ready > base_gate:
                        self._emit_gate_flow(qk, kid, v, constraints,
                                             tile_slices, pi, n_pieces, pj,
                                             n_cols, tag, dp_iv, base_gate)
        elif dma_ivs:
            pieces = split_proportional(compute_cycles, chunk_rows)
            dp_iv = None
            for pi, (dma_iv, cyc) in enumerate(zip(dma_ivs, pieces)):
                dp_iv = self.res_dp[v].acquire(dma_iv.end, cyc,
                                               label=f"k{kid} {qk.spec.name}"
                                                     f"[{pi}]")
                self.tracer.emit(f"{qk.spec.name} k{kid}[{pi}]", "compute",
                                 f"vpu{v}.datapath", dp_iv.start,
                                 dp_iv.duration, kernel=kid, vpu=v, chunk=pi)
                self.metrics.activity(f"{qk.spec.name} k{kid}[{pi}]",
                                      "compute", f"vpu{v}.datapath",
                                      dp_iv.start, dp_iv.end,
                                      kernel=kid, vpu=v)
                piece_spans.append((dma_iv.end, dp_iv.start, dp_iv.end))
                if self.tracer.enabled:
                    row, s0, e0 = flat_slices[pi]
                    self.tracer.flow(f"{qk.spec.name} k{kid} gate[{pi}]",
                                     "compute", row, max(s0, e0 - 1),
                                     f"vpu{v}.datapath", dp_iv.start)
        else:
            dp_iv = self.res_dp[v].acquire(lock_iv.end, compute_cycles,
                                           label=f"k{kid} {qk.spec.name}")
            self.tracer.emit(f"{qk.spec.name} k{kid}", "compute",
                             f"vpu{v}.datapath", dp_iv.start, dp_iv.duration,
                             kernel=kid, vpu=v)
            self.metrics.activity(f"{qk.spec.name} k{kid}", "compute",
                                  f"vpu{v}.datapath", dp_iv.start, dp_iv.end,
                                  kernel=kid, vpu=v)
            piece_spans.append((lock_iv.end, dp_iv.start, dp_iv.end))

        self.metrics.kernel_dispatched(kid, t, v, lock_iv.end, dma_start,
                                       piece_spans, fault_end=fault_end)
        if self.reuse:
            for region, landed in streamed:
                self._reuse_note(v, region, landed)
        # attempt counts the replay bookings already modeled (0 = the first
        # compute_done is the initial execution); compute_cycles is carried
        # so each replay re-books the same datapath occupancy.
        inflight[kid] = (qk, v, alloc.src_res, alloc.dst_res,
                        kf, 0, compute_cycles)
        self._emit_counters(t)
        eq.push(dp_iv.end, "compute_done", kid)

    def _emit_gate_flow(self, qk, kid: int, v: int, constraints, tile_slices,
                        pi: int, n_pieces: int, pj: int, n_cols: int,
                        tag: str, dp_iv, base_gate: int) -> None:
        """Flow arrow from the DMA tile that binds compute piece ``(pi, pj)``
        to the piece's datapath slice. Observability only — ``gate_source``
        re-derives the argmax of the gate rectangle; timing is untouched."""
        best_gate, best_slice = base_gate, None
        for tr, fl, pid in constraints:
            g, src = tr.gate_source(fl, pi, n_pieces, pj, n_cols)
            if g > best_gate and src is not None:
                sl = tile_slices.get(pid, {}).get(src)
                if sl is not None:
                    best_gate, best_slice = g, sl
        if best_slice is not None:
            row, s0, e0 = best_slice
            self.tracer.flow(f"{qk.spec.name} k{kid} gate[{tag}]", "compute",
                             row, max(s0, e0 - 1),
                             f"vpu{v}.datapath", dp_iv.start)

    def _book_writebacks(self, segments: list, fallback: tuple[int, int],
                         t: int, label: str, eq: Optional[EventQueue],
                         **args) -> None:
        """Book write-back DMA activities per owning-VPU port. ``fallback``
        is ``(vpu, cycles)`` for the rare case cycles were accrued without
        segment attribution. ``eq=None`` when no event loop is running
        (barrier): completion then surfaces via the resources' free_at."""
        if not segments and fallback[1]:
            segments = [fallback]
        for wv, cyc in segments:
            iv = self.res_dma[wv].acquire(t, cyc, label=label)
            self.tracer.emit(label, "writeback", f"vpu{wv}.dma",
                             iv.start, iv.duration, vpu=wv, **args)
            self.metrics.activity(label, "writeback", f"vpu{wv}.dma",
                                  iv.start, iv.end,
                                  kernel=args.get("kernel"), vpu=wv)
            self.metrics.inc("wb.bookings")
            if eq is not None:
                eq.push(iv.end, "wb_done")

    def _retire_timed(self, qk, src_res, dst_res) -> tuple[int, list]:
        """Run the shared retire step, capturing (vpu, cycles) per
        consolidation so each lands on the right DMA port."""
        self._wb_segments = segs = []
        try:
            wb = self._retire_step(qk, src_res, dst_res)
        finally:
            self._wb_segments = None
        return wb, segs

    def _handle_compute_done(self, kid: int, t: int, inflight: dict,
                             eq: EventQueue) -> None:
        qk, v, src_res, dst_res, kf, attempt, compute_cycles = inflight[kid]
        # Replay tier, timing half: each attempt re-books the datapath after
        # its backoff and re-fires compute_done — timing only; the replayed
        # execution already ran inline at dispatch, so the functional result
        # is correct no matter how many attempts the timing models. A VPU
        # offlined mid-flight skips the bookings (its datapath is fenced;
        # the hard-fault path owns the rest of the story).
        if kf is not None and attempt < kf.replays and v not in self.offline:
            backoff = self.faults.backoff(attempt)
            dp_iv = self.res_dp[v].acquire(t + backoff, compute_cycles,
                                           label=f"k{kid} replay{attempt}")
            self.tracer.emit(f"{qk.spec.name} k{kid} replay[{attempt}]",
                             "compute", f"vpu{v}.datapath", dp_iv.start,
                             dp_iv.duration, kernel=kid, vpu=v)
            self.metrics.activity(f"{qk.spec.name} k{kid} replay[{attempt}]",
                                  "compute", f"vpu{v}.datapath", dp_iv.start,
                                  dp_iv.end, kernel=kid, vpu=v)
            self.metrics.inc("faults.injected")
            self.metrics.kernel_replayed(kid, t, dp_iv.start, dp_iv.end)
            self.stats.fault_cycles += dp_iv.end - t
            inflight[kid] = (qk, v, src_res, dst_res,
                             kf, attempt + 1, compute_cycles)
            eq.push(dp_iv.end, "compute_done", kid)
            return
        inflight.pop(kid)
        self.metrics.kernel_retired(kid, t)
        wb, segs = self._retire_timed(qk, src_res, dst_res)
        self.stats.writeback_cycles += wb
        self.stats.kernels_run += 1
        if wb:
            self._book_writebacks(segs, (v, wb), t,
                                  f"{qk.spec.name} k{kid} writeback", eq,
                                  kernel=kid)
        if v in self.offline:
            # The VPU died while this kernel was in flight: its (now retired)
            # destination must not stay deferred-resident on a fenced VPU.
            self._evacuate_vpu_timed(v, t, eq)
        elif kf is not None and kf.exhausted:
            # Retry exhaustion: the final attempt completed on scrubbed
            # state, but the datapath is deemed faulty — fence it now.
            self._offline_vpu(v, t, eq)
        self._drain_idle_dma(t, inflight, eq)
        self._emit_counters(t)
        # This completion satisfies dependency edges out of ``kid``, and the
        # retire/drain may have evicted residents (capacity changed).
        waiters = self._dep_waiters.pop(kid, None)
        if waiters:
            self._wake |= waiters
        self._wake_capacity_blocked()
        # Completion watchers last, with scheduler state consistent: a
        # watcher may re-entrantly issue the request's next kernels (the
        # continuous-batching step chain).
        self._notify_retired(kid, t)

    def _drain_idle_dma(self, t: int, inflight: dict, eq: EventQueue) -> None:
        """Opportunistically write back deferred results whose consumers are
        all done, using DMA ports that would otherwise sit idle.

        Eligible residents are served least-booked-port first — ascending
        DMA-port ``free_at`` on the event timelines, not resident scan order
        — so on wide configs the drains land on the ports with the most
        headroom; each port takes one drain per sweep, and the ``wb_done``
        event triggers the next sweep."""
        busy_phys: set[int] = set()
        for qk, *_ in inflight.values():
            busy_phys.update(s.phys_id for s in qk.src_bindings)
            busy_phys.add(qk.dst_binding.phys_id)
        eligible = []
        for phys_id, res in self.resident.items():
            if (phys_id in busy_phys or self._needed_later(phys_id)
                    or not res.dirty):
                continue
            port = self.res_dma[res.vpu]
            eligible.append((port.free_at, port.busy_cycles, phys_id))
        eligible.sort()
        for _, _, phys_id in eligible:
            res = self.resident.get(phys_id)
            # Re-check: an earlier drain's alias flush may have landed this
            # resident, and a port that took a drain this sweep is no longer
            # idle — its next drain waits for the wb_done sweep.
            if (res is None or not res.dirty
                    or not self.res_dma[res.vpu].idle_at(t)):
                continue
            b = self._binding_of(phys_id)
            v = res.vpu
            self._wb_segments = segs = []
            try:
                wb = (self._flush_older_aliases(b)
                      + self._writeback_resident(b, res))
            finally:
                self._wb_segments = None
            self.at.release(phys_id, RegionKind.DST)
            self.stats.writeback_cycles += wb
            self._book_writebacks(segs, (v, wb), t, f"drain phys{phys_id}",
                                  eq, phys=phys_id)

    # ---------------------------------------------------------- fault model
    def _offline_vpu(self, v: int, t: int, eq=None) -> None:
        """Hard-fault VPU ``v`` under the event timeline: fence its datapath
        (any further booking raises), evacuate its residents with timed
        write-backs, and mark it offline for every placement policy.
        Kernels already in flight on ``v`` run to completion — their
        functional work happened at dispatch — and their leftovers are
        evacuated at their retire. Raises :class:`FaultError` when the last
        healthy VPU dies."""
        if v in self.offline:
            return
        self.offline.add(v)
        self.res_dp[v].fence(t)
        self.metrics.inc("faults.offlined")
        self.tracer.emit(f"vpu{v} offline (hard fault)", "writeback",
                         f"vpu{v}.datapath", t, 0, instant=True, vpu=v)
        self._evacuate_vpu_timed(v, t, eq)
        if len(self.offline) >= self.cache.n_vpus:
            raise FaultError(
                f"hard fault offlined vpu{v}: no healthy VPU remains "
                f"({len(self.offline)}/{self.cache.n_vpus} offline)")
        # Survivors may now be the only capacity left — re-examine blocked
        # kernels so pending work redistributes immediately.
        self._wake_capacity_blocked()
        self._wake.update(self._pending_map)

    def _evacuate_vpu_timed(self, v: int, t: int, eq=None) -> None:
        """Timed counterpart of ``_evacuate_vpu``: consolidations book on
        the owning VPU's DMA port (the cache controller still drains a
        fenced VPU's data array — only the datapath is dead). Residents of
        in-flight kernels are skipped; the retire path re-runs the sweep."""
        busy_phys: set[int] = set()
        for qk, *_ in self._inflight.values():
            busy_phys.update(s.phys_id for s in qk.src_bindings)
            busy_phys.add(qk.dst_binding.phys_id)
        for phys_id in list(self.resident):
            res = self.resident.get(phys_id)
            if res is None or res.vpu != v or phys_id in busy_phys:
                continue
            if res.dirty:
                b = self._binding_of(phys_id)
                self._wb_segments = segs = []
                try:
                    wb = (self._flush_older_aliases(b)
                          + self._writeback_resident(b, res))
                finally:
                    self._wb_segments = None
                self.stats.writeback_cycles += wb
                self.at.release(phys_id, RegionKind.DST)
                self._book_writebacks(segs, (v, wb), t,
                                      f"evacuate phys{phys_id}", eq,
                                      phys=phys_id)
            else:
                self._evict_resident(phys_id)
                self.at.release(phys_id, RegionKind.DST)

    # -------------------------------------------------------------- pending
    def _needed_later(self, phys_id: int) -> bool:
        if self._pending_src_count.get(phys_id, 0) > 0:
            return True
        return super()._needed_later(phys_id)

    # -------------------------------------------------------------- barrier
    def _drain_deferred_residents(self, need_slots: Optional[int] = None) -> None:
        """Timed flush of deferred results (all for barrier, just enough AT
        slots for capacity-pressure relief): each consolidation books on the
        owning VPU's DMA port, so the flushes overlap across ports.

        Skips residents touched by in-flight kernels: mid-loop (AT pressure
        from a re-entrant issue) a dispatched kernel's functional state is
        already claimed, and evicting its destination would let the retire
        step re-insert a dead residency over released lines."""
        wall0 = time.perf_counter()
        t = self._timeline.now
        busy_phys: set[int] = set()
        for qk, *_ in self._inflight.values():
            busy_phys.update(s.phys_id for s in qk.src_bindings)
            busy_phys.add(qk.dst_binding.phys_id)
        for phys_id in list(self.resident):
            if need_slots is not None and self.at.free_slots() >= need_slots:
                break
            if phys_id in busy_phys:
                continue
            res = self.resident.get(phys_id)
            if res is None:              # invalidated by an earlier landing
                continue
            if res.dirty:
                b = self._binding_of(phys_id)
                v = res.vpu
                self._wb_segments = segs = []
                try:
                    wb = (self._flush_older_aliases(b)
                          + self._writeback_resident(b, res))
                finally:
                    self._wb_segments = None
                self.stats.writeback_cycles += wb
                self.at.release(phys_id, RegionKind.DST)
                self._book_writebacks(segs, (v, wb), t,
                                      f"flush phys{phys_id}", None,
                                      phys=phys_id)
            else:
                self._evict_resident(phys_id)
                self.at.release(phys_id, RegionKind.DST)
        if not (self._in_loop or self._session_open):
            # Batch mode: the flush extends the makespan and the next drain's
            # decodes start where it left off. Mid-session the clock belongs
            # to the event loop — flush bookings surface via free_at.
            self.sim_time = max([self.sim_time]
                                + [r.free_at for r in self._all_resources()])
            self._timeline.advance_clock(self.sim_time)
        self._wall_seconds += time.perf_counter() - wall0

    def barrier(self) -> None:
        """Drain the queue, then flush deferred results with timed DMA."""
        self.run_pending()
        if self.queue:
            raise RuntimeError("kernel queue not drained — dependency deadlock?")
        self._drain_deferred_residents()

    # -------------------------------------------------------------- sessions
    # The pipelined runtime's session clock IS the open timeline: issues book
    # decodes at the current clock, posted arrivals are timeline events, and
    # ``advance`` runs the event loop up to a bound with work left in flight.
    def session_now(self) -> int:
        return self._timeline.now

    def session_post(self, t: int, fn) -> None:
        self._timeline.post(t, fn)

    def session_advance(self, until: int) -> None:
        """Process every event due by ``until`` — dispatches, completions,
        posted arrivals — then move the clock there, leaving later events
        (and undispatched kernels) in flight."""
        wall0 = time.perf_counter()
        self._admit_queue()
        self._wake.update(self._pending_map)
        self._run_events(until)
        self._timeline.advance_clock(until)
        self._wall_seconds += time.perf_counter() - wall0

    def _deadlock_error(self) -> DeadlockError:
        """Assemble the structured diagnostics for a wedged drain: every
        stuck kernel with its last blocked reason and unmet dependency ids,
        plus each resource's ``free_at`` — enough to tell a dependency
        deadlock from a mis-modeled resource without re-running under a
        debugger."""
        pending: dict[int, dict] = {}
        stalls = getattr(self.metrics, "stalls", None)
        for qk in [*self._pending_map.values(), *self.queue]:
            kid = qk.deps.kernel_id
            rec = stalls.records.get(kid) if stalls is not None else None
            pending[kid] = {
                "kernel": qk.spec.name,
                "blocked_on": rec._reason if rec is not None else None,
                "unmet_deps": sorted(self.tracker.unmet_deps(kid)),
            }
        resources = {r.name: r.free_at for r in self._all_resources()}
        ids = ", ".join(f"k{kid}" for kid in sorted(pending))
        return DeadlockError(
            f"session drain made no progress with {len(pending)} kernel(s) "
            f"still pending ({ids}) — dependency deadlock; see "
            f"err.pending / err.resources for per-kernel blocked reasons "
            f"and resource horizons", pending, resources)

    def session_drain(self) -> None:
        """Run the timeline dry (arrivals included), settle, and flush —
        the open-session counterpart of :meth:`barrier`.

        Unlike a closed-batch barrier, one drain pass is not enough: the
        settle fallback fires retire callbacks, and those may issue fresh
        programs (a continuous-batching driver chaining its next step), so
        the pass repeats until a full pass makes no progress. A stuck
        remainder raises :class:`DeadlockError` with the pending kernels,
        their last blocked reasons, and resource horizons — instead of
        wedging silently or falling through to the generic barrier check."""
        was, self._session_open = self._session_open, False
        try:
            while self.queue or self._pending_map or self._timeline:
                before = (self.stats.kernels_run, self.events_processed,
                          self.stats.total_cycles)
                self.run_pending()
                after = (self.stats.kernels_run, self.events_processed,
                         self.stats.total_cycles)
                if after == before:
                    # A full pass moved nothing at all: if work remains it
                    # can never complete (event re-bookings would at least
                    # bump events_processed).
                    if self.queue or self._pending_map or self._inflight:
                        raise self._deadlock_error()
                    break
                if (after[0] == before[0]
                        and (self.queue or self._pending_map)
                        and not self._timeline and not self._inflight):
                    # Events ticked but no kernel retired, nothing is in
                    # flight, and the timeline is dry — the remaining
                    # kernels are re-examined each pass without ever
                    # becoming ready. Progress in the counters is an
                    # artifact of re-booked decode events, not real work.
                    raise self._deadlock_error()
            self.barrier()
        finally:
            self._session_open = was
