"""Unified metrics layer for the scheduler stack (observability).

Own copy of repro.sim.metrics (pure Python: the port imports nothing of
``repro``).

Three cooperating pieces, all **purely observational** — collection never
touches scheduler state, books no resources, and draws no randomness, so a
metrics-on run produces a bit-identical schedule to a metrics-off run (the
differential fuzzer asserts exactly that):

  * :class:`MetricsRegistry` — a typed registry of named :class:`Counter` /
    :class:`Gauge` / :class:`Histogram` instruments, threaded through
    :class:`~repro_torch.core.runtime.CacheRuntime` and
    :class:`~repro_torch.sim.pipeline.PipelinedRuntime`.
  * :class:`StallTable` — per-kernel **stall attribution**: every cycle
    between a kernel becoming dispatchable (decode complete) and its retire
    (compute done) that the datapath is *not* computing the kernel is binned
    into exactly one wait cause (:data:`STALL_BINS`), with the conservation
    invariant ``busy + Σ stall_bins == retire - ready`` checked per kernel.
  * :class:`ActivityLog` — the completed event graph (every booked resource
    interval), from which :meth:`ActivityLog.critical_path` extracts the
    longest dependent chain: starting from the activity that ends at the
    makespan, repeatedly step to the activity whose completion *bound* the
    current one's start (booking start times always equal either a gate's
    completion or the resource's previous free_at — both activity ends), down
    to cycle 0. The chain is contiguous in time, so its per-resource /
    per-phase breakdown sums exactly to the makespan.

The per-kernel window is ``[ready, retired]`` where ``ready`` is the
decode-completion cycle (the kernel enters the dispatchable set) and
``retired`` the compute-done cycle; destination write-back happens after
retire (deferred or booked asynchronously) and is tracked by counters, not by
the conservation window.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Optional

#: Exclusive per-kernel wait causes (see StallTable.attribute_dispatch):
#:   raw_dep       — blocked pre-dispatch on an unmet dependency (RAW edge)
#:   war_guard     — blocked pre-dispatch by the in-order WAR-aliasing guard
#:   capacity      — blocked pre-dispatch: no VPU (or AT slot) has capacity
#:   cache_lock    — waiting for + holding the cache lock (allocator claim)
#:   drain         — consolidation write-backs of deferred results gating DMA
#:   dma_wait      — compute piece waiting for operand tiles (DMA port busy)
#:   datapath_busy — operand tiles landed but the datapath still runs another
#:                   kernel's piece
#:   fault_replay  — fault-recovery overhead: ECC scrub penalties on a
#:                   corrupted operand fetch plus bounded instruction-replay
#:                   attempts (backoff + requeue) after detected corruption
STALL_BINS = ("raw_dep", "war_guard", "capacity", "cache_lock", "drain",
              "dma_wait", "datapath_busy", "fault_replay")

#: Version stamp of the metrics-report dict layout (and of the shared BENCH
#: envelope in benchmarks/common.py, which embeds these reports).
METRICS_SCHEMA_VERSION = 1


class MetricsError(RuntimeError):
    """A metrics-layer invariant (e.g. stall-cycle conservation) failed."""


# ============================================================ typed registry
class Counter:
    """Monotonically-increasing integer instrument."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        self.value += n

    def to_dict(self) -> dict:
        return {"value": self.value}


class Gauge:
    """Instrument holding the latest sampled value."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    def inc(self, n=1) -> None:
        self.value += n

    def dec(self, n=1) -> None:
        self.value -= n

    def to_dict(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Power-of-two-bucket histogram of non-negative integer observations.

    Bucket ``k`` counts observations with ``bit_length() == k`` (i.e. value in
    ``[2^(k-1), 2^k)``; bucket 0 counts zeros) — fixed, deterministic bucket
    edges with no configuration, good enough for cycle-latency shapes.
    """

    __slots__ = ("name", "help", "count", "sum", "min", "max", "buckets")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.count = 0
        self.sum = 0
        self.min: Optional[int] = None
        self.max: Optional[int] = None
        self.buckets: dict[int, int] = {}

    def observe(self, v: int) -> None:
        v = int(v)
        if v < 0:
            raise ValueError(f"histogram {self.name}: negative observation {v}")
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        b = v.bit_length()
        self.buckets[b] = self.buckets.get(b, 0) + 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> int:
        """Upper edge of the bucket holding the ``q``-th percentile
        observation (conservative: the true value is ≤ the returned one,
        within the bucket's power-of-two resolution). ``q`` in [0, 100];
        0 with no observations."""
        if not 0 <= q <= 100:
            raise ValueError(f"histogram {self.name}: percentile {q} "
                             f"outside [0, 100]")
        if not self.count:
            return 0
        # Rank of the target observation (nearest-rank definition), walked
        # over the cumulative bucket counts in value order.
        rank = max(1, -(-self.count * q // 100))      # ceil without floats
        seen = 0
        for b in sorted(self.buckets):
            seen += self.buckets[b]
            if seen >= rank:
                # Bucket b holds values with bit_length() == b: [2^(b-1),
                # 2^b - 1]; bucket 0 holds zeros. Clamp to the observed max.
                upper = (1 << b) - 1
                return min(upper, self.max)
        return self.max                                # pragma: no cover

    @property
    def p50(self) -> int:
        return self.percentile(50)

    @property
    def p99(self) -> int:
        return self.percentile(99)

    def to_dict(self) -> dict:
        return {"count": self.count, "sum": self.sum, "min": self.min,
                "max": self.max, "mean": self.mean,
                "p50": self.p50, "p99": self.p99,
                "buckets": {f"<2^{k}" if k else "0": n
                            for k, n in sorted(self.buckets.items())}}


class MetricsRegistry:
    """Create-or-get registry of named instruments (one namespace)."""

    def __init__(self) -> None:
        self._metrics: dict[str, Any] = {}

    def _get(self, cls, name: str, help: str):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help)
        elif type(m) is not cls:
            raise MetricsError(
                f"metric {name!r} already registered as {type(m).__name__}, "
                f"requested {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def to_dict(self) -> dict:
        out: dict[str, dict] = {"counters": {}, "gauges": {}, "histograms": {}}
        section = {Counter: "counters", Gauge: "gauges",
                   Histogram: "histograms"}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            out[section[type(m)]][name] = m.to_dict()
        return out


# ======================================================== stall attribution
@dataclasses.dataclass
class KernelStall:
    """One kernel's dispatch-to-retire cycle attribution."""

    kernel: int
    name: str
    ready: int                    # decode complete — dispatchable
    dispatched: int = -1
    retired: int = -1
    vpu: int = -1
    busy: int = 0                 # datapath cycles computing this kernel
    bins: dict[str, int] = dataclasses.field(
        default_factory=lambda: {b: 0 for b in STALL_BINS})
    fallback: bool = False        # retired via the serial fallback path —
                                  # no event-timeline window to conserve
    # transient attribution state (pre-dispatch blocking)
    _mark: int = dataclasses.field(default=-1, repr=False)
    _reason: Optional[str] = dataclasses.field(default=None, repr=False)

    @property
    def latency(self) -> int:
        return self.retired - self.ready

    @property
    def stall_cycles(self) -> int:
        return sum(self.bins.values())

    def conserved(self) -> bool:
        return self.fallback or \
            self.busy + self.stall_cycles == self.latency

    def to_dict(self) -> dict:
        return {"kernel": self.kernel, "name": self.name, "vpu": self.vpu,
                "ready": self.ready, "dispatched": self.dispatched,
                "retired": self.retired, "latency": self.latency,
                "busy": self.busy, "stalls": dict(self.bins),
                "fallback": self.fallback}


class StallTable:
    """Per-kernel stall attribution with the conservation invariant.

    The pipelined scheduler drives the table from its event loop:

      * :meth:`decoded` opens the window at decode completion;
      * :meth:`blocked` records each failed dispatch examination — the cycles
        from the previous examination to this one are charged to the reason
        the *previous* examination found (between examinations nothing about
        the kernel changed, so the old reason held the whole interval);
      * :meth:`dispatched` closes the pre-dispatch phase and attributes the
        post-dispatch window from the booked activity intervals;
      * :meth:`retired` closes the window and checks conservation.
    """

    def __init__(self) -> None:
        self.records: dict[int, KernelStall] = {}

    def decoded(self, kid: int, ready: int, name: str) -> None:
        self.records[kid] = KernelStall(kernel=kid, name=name, ready=ready,
                                        _mark=ready)

    def blocked(self, kid: int, t: int, reason: str) -> None:
        rec = self.records.get(kid)
        if rec is None:
            return
        if rec._reason is not None and t > rec._mark:
            rec.bins[rec._reason] += t - rec._mark
        rec._mark = t
        rec._reason = reason

    def dispatched(self, kid: int, t: int, vpu: int, lock_end: int,
                   dma_start: int,
                   pieces: Iterable[tuple[int, int, int]],
                   fault_end: int = 0) -> None:
        """Attribute the post-dispatch window.

        ``pieces`` is the kernel's compute pieces as ``(gate, start, end)``
        in datapath booking order (``gate`` = the cycle the piece's operand
        tiles were all landed). A cursor walks ``[t, last_end]``; every gap
        before a piece's start is split — cache-lock claim up to
        ``lock_end``, consolidation drain up to ``dma_start``, ECC scrub up
        to ``fault_end`` (the end of the fault-recovery window that delayed
        the operand fetch, 0 when the fetch was clean), operand-tile wait up
        to the piece's gate, and datapath contention for the rest — so
        ``busy + Σ bins`` covers the window with no double counting.
        """
        rec = self.records.get(kid)
        if rec is None:
            return
        if rec._reason is not None and t > rec._mark:
            rec.bins[rec._reason] += t - rec._mark
        rec._reason = None
        rec.dispatched = t
        rec.vpu = vpu
        cursor = t
        for gate, start, end in pieces:
            if start > cursor:
                if cursor < lock_end:
                    step = min(start, lock_end) - cursor
                    rec.bins["cache_lock"] += step
                    cursor += step
                if cursor < dma_start and cursor < start:
                    step = min(start, dma_start) - cursor
                    rec.bins["drain"] += step
                    cursor += step
                if cursor < fault_end and cursor < start:
                    step = min(start, fault_end) - cursor
                    rec.bins["fault_replay"] += step
                    cursor += step
                if cursor < gate and cursor < start:
                    step = min(start, gate) - cursor
                    rec.bins["dma_wait"] += step
                    cursor += step
                if cursor < start:
                    rec.bins["datapath_busy"] += start - cursor
                    cursor = start
            rec.busy += end - start
            cursor = max(cursor, end)
        rec._mark = cursor

    def replayed(self, kid: int, start: int, end: int) -> None:
        """Extend an open dispatch window with one replay attempt booked as
        ``[start, end)`` on the datapath: the gap from the record's cursor
        to ``start`` (replay backoff + port contention) charges to the
        ``fault_replay`` bin and the re-execution counts as busy, so the
        eventual :meth:`retired` check still conserves."""
        rec = self.records.get(kid)
        if rec is None:
            return
        if start > rec._mark:
            rec.bins["fault_replay"] += start - rec._mark
        rec.busy += end - start
        rec._mark = max(rec._mark, end)

    def retired(self, kid: int, t: int) -> KernelStall:
        rec = self.records[kid]
        rec.retired = t
        if not rec.conserved():
            raise MetricsError(
                f"stall-cycle conservation violated for kernel {kid} "
                f"({rec.name}): busy {rec.busy} + stalls {rec.stall_cycles} "
                f"!= latency {rec.latency} ({rec.to_dict()})")
        return rec

    def serial(self, kid: int, name: str, busy: int,
               bins: dict[str, int]) -> None:
        """Record (or supersede) a kernel retired by the *serial* scheduler
        step: the window is synthesized from the phase cycle totals
        (``latency = busy + Σ bins`` by construction). A pre-existing open
        record means the pipelined engine fell back to the serial step for
        this kernel — mark it, its event-timeline window never closed."""
        rec = self.records.get(kid)
        if rec is not None and rec.retired < 0:
            rec.fallback = True
            return
        rec = KernelStall(kernel=kid, name=name, ready=0, dispatched=0,
                          busy=busy)
        for b, v in bins.items():
            rec.bins[b] += v
        rec.retired = busy + rec.stall_cycles
        self.records[kid] = rec

    # ------------------------------------------------------------- reporting
    def conservation_ok(self) -> bool:
        return all(r.conserved() for r in self.records.values()
                   if r.retired >= 0)

    def by_kernel(self) -> dict[str, dict]:
        """Aggregate closed records per kernel *name*."""
        out: dict[str, dict] = {}
        for rec in self.records.values():
            if rec.retired < 0:
                continue
            agg = out.setdefault(rec.name, {
                "count": 0, "busy": 0, "latency": 0,
                "stalls": {b: 0 for b in STALL_BINS}, "fallbacks": 0})
            agg["count"] += 1
            agg["busy"] += rec.busy
            agg["latency"] += rec.latency
            agg["fallbacks"] += int(rec.fallback)
            for b, v in rec.bins.items():
                agg["stalls"][b] += v
        return out


# ========================================================== critical path
@dataclasses.dataclass(frozen=True)
class Activity:
    """One booked resource interval in the completed event graph."""

    aid: int
    name: str
    phase: str
    resource: str
    start: int
    end: int
    kernel: Optional[int] = None
    vpu: Optional[int] = None

    @property
    def duration(self) -> int:
        return self.end - self.start


@dataclasses.dataclass(frozen=True)
class CPSegment:
    """One merged span of the critical path (``resource is None`` = idle)."""

    start: int
    end: int
    resource: Optional[str]
    phase: Optional[str]
    kernel: Optional[int]
    name: str

    @property
    def cycles(self) -> int:
        return self.end - self.start

    def to_dict(self) -> dict:
        return {"start": self.start, "end": self.end, "cycles": self.cycles,
                "resource": self.resource, "phase": self.phase,
                "kernel": self.kernel, "name": self.name}


class ActivityLog:
    """Append-only log of booked activities + critical-path extraction."""

    def __init__(self) -> None:
        self.activities: list[Activity] = []

    def add(self, name: str, phase: str, resource: str, start: int, end: int,
            kernel: Optional[int] = None, vpu: Optional[int] = None) -> int:
        aid = len(self.activities)
        self.activities.append(Activity(
            aid=aid, name=name, phase=phase, resource=resource,
            start=int(start), end=int(end), kernel=kernel, vpu=vpu))
        return aid

    # ---------------------------------------------------------------- walk
    def critical_path(self, end_time: Optional[int] = None) -> list[CPSegment]:
        """Longest dependent chain ending at ``end_time`` (default: the last
        activity end), walked backward to cycle 0.

        Every booked start equals either a gate's completion cycle or the
        resource's previous ``free_at`` — both are activity end cycles — so
        at each step there is an activity ending exactly at the current
        activity's start; ties prefer the same kernel, then the same VPU,
        then the latest-logged activity. Where no activity ends at the
        boundary (a run restarted after pure idle time) an explicit idle
        segment bridges the gap, so the returned segments tile
        ``[0, end_time]`` exactly and their cycles sum to ``end_time``.
        """
        acts = self.activities
        if not acts:
            if end_time:
                return [CPSegment(0, end_time, None, None, None, "idle")]
            return []
        by_end: dict[int, list[Activity]] = {}
        for a in acts:
            by_end.setdefault(a.end, []).append(a)
        t = max(a.end for a in acts) if end_time is None else end_time
        path: list[Activity] = []
        gaps: list[tuple[int, int]] = []       # (start, end) idle spans
        visited: set[int] = set()
        cur: Optional[Activity] = None
        while t > 0:
            cands = [a for a in by_end.get(t, ()) if a.aid not in visited]
            if not cands:
                # Idle bridge: continue from the latest activity ending
                # strictly before t (there is one — acts is non-empty and
                # t > 0 past the earliest start implies some end < t, else
                # bridge to 0).
                prev_ends = [e for e in by_end if e < t]
                if not prev_ends:
                    gaps.append((0, t))
                    break
                e = max(prev_ends)
                gaps.append((e, t))
                t = e
                continue
            cur = self._pick(cands, cur)
            visited.add(cur.aid)
            path.append(cur)
            t = cur.start
        return self._segments(path, gaps)

    @staticmethod
    def _pick(cands: list[Activity], cur: Optional[Activity]) -> Activity:
        def key(a: Activity):
            same_kernel = (cur is not None and cur.kernel is not None
                           and a.kernel == cur.kernel)
            same_vpu = (cur is not None and cur.vpu is not None
                        and a.vpu == cur.vpu)
            # Prefer real work over zero-duration markers, then kinship.
            return (a.duration > 0, same_kernel, same_vpu, a.aid)
        return max(cands, key=key)

    @staticmethod
    def _segments(path: list[Activity],
                  gaps: list[tuple[int, int]]) -> list[CPSegment]:
        entries: list[CPSegment] = [
            CPSegment(a.start, a.end, a.resource, a.phase, a.kernel, a.name)
            for a in path] + [
            CPSegment(s, e, None, None, None, "idle") for s, e in gaps]
        entries.sort(key=lambda s: (s.start, s.end))
        merged: list[CPSegment] = []
        for seg in entries:
            if merged:
                last = merged[-1]
                if (last.resource, last.kernel, last.phase) == \
                        (seg.resource, seg.kernel, seg.phase) \
                        and seg.start <= last.end:
                    merged[-1] = CPSegment(
                        last.start, max(last.end, seg.end), last.resource,
                        last.phase, last.kernel,
                        last.name if last.cycles >= seg.cycles else seg.name)
                    continue
            merged.append(seg)
        return merged


def summarize_critical_path(segments: list[CPSegment],
                            makespan: int, top: int = 5) -> dict:
    """Roll a critical path up into the report dict (fractions of makespan)."""
    by_resource: dict[str, int] = {}
    by_phase: dict[str, int] = {}
    cp_cycles = idle = 0
    for seg in segments:
        if seg.resource is None:
            idle += seg.cycles
            continue
        cp_cycles += seg.cycles
        by_resource[seg.resource] = by_resource.get(seg.resource, 0) \
            + seg.cycles
        by_phase[seg.phase or "?"] = by_phase.get(seg.phase or "?", 0) \
            + seg.cycles
    total = cp_cycles + idle
    denom = max(makespan, 1)
    top_segs = sorted((s for s in segments if s.resource is not None),
                      key=lambda s: (-s.cycles, s.start))[:top]
    return {
        "makespan": makespan,
        "total": total,
        "cp_cycles": cp_cycles,
        "idle_cycles": idle,
        "covers_makespan": total == makespan,
        "by_resource": {r: {"cycles": c, "fraction": c / denom}
                        for r, c in sorted(by_resource.items(),
                                           key=lambda kv: -kv[1])},
        "by_phase": {p: {"cycles": c, "fraction": c / denom}
                     for p, c in sorted(by_phase.items(),
                                        key=lambda kv: -kv[1])},
        "segments": [s.to_dict() for s in segments],
        "top_segments": [s.to_dict() for s in top_segs],
    }


# ================================================================= facade
class SchedulerMetrics:
    """The metrics object threaded through the runtimes.

    ``enabled=False`` turns every hook into a cheap no-op (a single attribute
    check); enabled or not, the hooks never mutate scheduler state, so the
    schedule is bit-identical either way.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self.registry = MetricsRegistry()
        self.stalls = StallTable()
        self.log = ActivityLog()

    # ------------------------------------------------------------- shortcuts
    def inc(self, name: str, n: int = 1) -> None:
        if self.enabled:
            self.registry.counter(name).inc(n)

    def set_gauge(self, name: str, v) -> None:
        if self.enabled:
            self.registry.gauge(name).set(v)

    def observe(self, name: str, v: int) -> None:
        if self.enabled:
            self.registry.histogram(name).observe(v)

    def activity(self, name: str, phase: str, resource: str, start: int,
                 end: int, kernel: Optional[int] = None,
                 vpu: Optional[int] = None) -> Optional[int]:
        if not self.enabled:
            return None
        return self.log.add(name, phase, resource, start, end,
                            kernel=kernel, vpu=vpu)

    # ----------------------------------------------------------- stall hooks
    def kernel_decoded(self, kid: int, ready: int, name: str) -> None:
        if self.enabled:
            self.stalls.decoded(kid, ready, name)

    def kernel_blocked(self, kid: int, t: int, reason: str) -> None:
        if self.enabled:
            self.stalls.blocked(kid, t, reason)

    def kernel_dispatched(self, kid: int, t: int, vpu: int, lock_end: int,
                          dma_start: int, pieces, fault_end: int = 0) -> None:
        if not self.enabled:
            return
        self.stalls.dispatched(kid, t, vpu, lock_end, dma_start, pieces,
                               fault_end=fault_end)
        self.inc("kernels.dispatched")
        rec = self.stalls.records.get(kid)
        if rec is not None:
            self.observe("kernel.dispatch_wait_cycles", t - rec.ready)

    def kernel_replayed(self, kid: int, t: int, start: int, end: int) -> None:
        """One instruction-replay attempt detected at ``t`` and re-executed
        over ``[start, end)``: feeds the stall table (conservation), the
        ``faults.replayed`` counter, and the replay-latency histogram."""
        if not self.enabled:
            return
        self.stalls.replayed(kid, start, end)
        self.inc("faults.replayed")
        self.observe("fault.replay_latency_cycles", end - t)

    def kernel_retired(self, kid: int, t: int) -> None:
        if not self.enabled:
            return
        rec = self.stalls.retired(kid, t)
        self.inc("kernels.retired")
        self.observe("kernel.latency_cycles", rec.latency)
        self.observe("kernel.busy_cycles", rec.busy)

    def kernel_serial(self, kid: int, name: str, busy: int,
                      bins: dict[str, int]) -> None:
        if not self.enabled:
            return
        self.stalls.serial(kid, name, busy, bins)
        self.inc("kernels.retired")

    # ------------------------------------------------------------- reporting
    def critical_path(self, makespan: Optional[int] = None) -> dict:
        segs = self.log.critical_path(end_time=makespan)
        return summarize_critical_path(segs, makespan if makespan is not None
                                       else (segs[-1].end if segs else 0))

    def report(self, makespan: Optional[int] = None,
               extra: Optional[dict] = None,
               with_critical_path: bool = True) -> dict:
        """The unified metrics report: typed instruments, per-kernel stall
        attribution (+ conservation verdict), and — when the activity log is
        populated (pipelined runs) — the critical-path breakdown."""
        doc = {
            "schema_version": METRICS_SCHEMA_VERSION,
            "enabled": self.enabled,
            **self.registry.to_dict(),
            "kernels": self.stalls.by_kernel(),
            "per_kernel": [r.to_dict()
                           for _, r in sorted(self.stalls.records.items())
                           if r.retired >= 0],
            "conservation_ok": self.stalls.conservation_ok(),
            "extra": dict(extra or {}),
        }
        if with_critical_path and self.log.activities:
            doc["critical_path"] = self.critical_path(makespan)
        else:
            doc["critical_path"] = None
        return doc


# ---------------------------------------------------------------------------
# Per-request serving lifecycle
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RequestRecord:
    """One request's lifecycle timestamps (sim cycles) under a serving run.

    ``ttft`` counts from *arrival* (queue wait included) to the first
    generated token — the latency a client observes; ``tpot`` is the mean
    inter-token gap over the remaining ``tokens - 1`` decode steps."""

    rid: int
    prompt_len: int
    max_new: int
    arrived: int
    admitted: Optional[int] = None
    first_token: Optional[int] = None
    finished: Optional[int] = None
    rejected: Optional[int] = None     # admission-validation bounce time
    tokens: int = 0

    @property
    def done(self) -> bool:
        return self.finished is not None

    @property
    def queue_wait(self) -> Optional[int]:
        if self.admitted is None:
            return None
        return self.admitted - self.arrived

    @property
    def ttft(self) -> Optional[int]:
        if self.first_token is None:
            return None
        return self.first_token - self.arrived

    @property
    def tpot(self) -> Optional[float]:
        if self.finished is None or self.first_token is None:
            return None
        if self.tokens <= 1:
            return 0.0
        return (self.finished - self.first_token) / (self.tokens - 1)

    def to_dict(self) -> dict:
        return {"rid": self.rid, "prompt_len": self.prompt_len,
                "max_new": self.max_new, "arrived": self.arrived,
                "admitted": self.admitted, "first_token": self.first_token,
                "finished": self.finished, "rejected": self.rejected,
                "tokens": self.tokens,
                "queue_wait": self.queue_wait, "ttft": self.ttft,
                "tpot": self.tpot}


def _exact_percentile(vals: list, q: float) -> float:
    """Nearest-rank percentile over raw values (exact, unlike the
    power-of-two histogram buckets). ``q`` may be fractional — p99.9 ranks
    on 99.9, not a truncated 99."""
    if not vals:
        return 0.0
    s = sorted(vals)
    # ceil(len * q / 100) in integer arithmetic: q is scaled to 1e-4
    # percentile resolution first, so float noise (1000 * 99.9 / 100 ->
    # 999.0000000000001) can never bump the rank past the true one.
    qi = int(round(q * 10_000))
    rank = min(len(s), max(1, -(-len(s) * qi // 1_000_000)))
    return float(s[rank - 1])


class RequestLog:
    """Request lifecycle tracking for the serving scenario.

    Each transition feeds the shared metrics instruments —
    ``serving.ttft`` / ``serving.tpot`` / ``serving.queue_wait`` histograms
    and a ``serving.goodput_tokens_per_kcycle`` gauge — so a serving run's
    report carries them alongside the scheduler's stall attribution.
    ``summary()`` additionally computes *exact* percentiles from the raw
    records (the histograms quantize to power-of-two buckets)."""

    def __init__(self, metrics: "SchedulerMetrics"):
        self.metrics = metrics
        self.records: dict[int, RequestRecord] = {}

    # ----------------------------------------------------------- transitions
    def arrive(self, rid: int, prompt_len: int, max_new: int,
               t: int) -> RequestRecord:
        if rid in self.records:
            raise MetricsError(f"request {rid} already arrived")
        rec = RequestRecord(rid=rid, prompt_len=prompt_len, max_new=max_new,
                            arrived=int(t))
        self.records[rid] = rec
        self.metrics.inc("serving.requests.arrived")
        return rec

    def reject(self, rid: int, t: int) -> None:
        """Admission validation bounced the request (it can never fit the
        per-request KV budget): it arrived but is never admitted, so it
        stays out of every latency percentile."""
        rec = self.records[rid]
        rec.rejected = int(t)
        self.metrics.inc("serving.rejected")
        self.metrics.inc("serving.requests.rejected")

    def admit(self, rid: int, t: int) -> None:
        rec = self.records[rid]
        rec.admitted = int(t)
        self.metrics.inc("serving.requests.admitted")
        self.metrics.observe("serving.queue_wait", rec.queue_wait)

    def first_token(self, rid: int, t: int) -> None:
        rec = self.records[rid]
        rec.first_token = int(t)
        rec.tokens = max(rec.tokens, 1)
        self.metrics.observe("serving.ttft", rec.ttft)

    def token(self, rid: int, n: int = 1) -> None:
        self.records[rid].tokens += n

    def finish(self, rid: int, t: int) -> None:
        rec = self.records[rid]
        rec.finished = int(t)
        self.metrics.inc("serving.requests.finished")
        if rec.tokens > 1:
            self.metrics.observe("serving.tpot", int(round(rec.tpot)))
        done = [r for r in self.records.values() if r.done]
        toks = sum(r.tokens for r in done)
        if t > 0:
            self.metrics.set_gauge("serving.goodput_tokens_per_kcycle",
                                   round(1000.0 * toks / t, 3))

    # ------------------------------------------------------------- reporting
    def summary(self, now: Optional[int] = None) -> dict:
        """Exact lifecycle aggregates from the raw records."""
        done = [r for r in self.records.values() if r.done]
        ttfts = [r.ttft for r in done if r.ttft is not None]
        tpots = [r.tpot for r in done if r.tpot is not None and r.tokens > 1]
        waits = [r.queue_wait for r in done if r.queue_wait is not None]
        toks = sum(r.tokens for r in done)
        end = now if now is not None else max(
            (r.finished for r in done), default=0)
        return {
            "requests": len(self.records),
            "finished": len(done),
            "rejected": sum(1 for r in self.records.values()
                            if r.rejected is not None),
            "tokens_generated": toks,
            "ttft_p50": _exact_percentile(ttfts, 50),
            "ttft_p99": _exact_percentile(ttfts, 99),
            "ttft_p999": _exact_percentile(ttfts, 99.9),
            "ttft_mean": (sum(ttfts) / len(ttfts)) if ttfts else 0.0,
            "tpot_p50": _exact_percentile(tpots, 50),
            "tpot_p99": _exact_percentile(tpots, 99),
            "queue_wait_p50": _exact_percentile(waits, 50),
            "queue_wait_p99": _exact_percentile(waits, 99),
            "goodput_tokens_per_kcycle":
                round(1000.0 * toks / end, 3) if end else 0.0,
            "per_request": [r.to_dict() for r in
                            sorted(self.records.values(),
                                   key=lambda r: r.rid)],
        }
