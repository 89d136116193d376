"""Per-event trace capture + Chrome ``trace_event`` export.

Every activity the pipelined scheduler books on a resource is mirrored into a
:class:`Tracer` as a :class:`TraceRecord`. The records can be exported as a
Chrome/Perfetto ``trace_event`` JSON document (open ``chrome://tracing`` or
https://ui.perfetto.dev and load the file): one *thread* row per modeled
resource (eCPU, cache-lock, each VPU datapath and DMA port), one complete
("ph": "X") event per activity, with the kernel id / phase carried in
``args``. Modeled cycles map 1:1 onto the trace's microsecond timestamps —
the absolute unit is meaningless, only the overlap structure matters.

Own copy of repro.sim.trace (pure Python; the port imports nothing of
``repro``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

#: Canonical phase categories — match PhaseStats / Fig. 3 axes.
PHASES = ("preamble", "allocation", "compute", "writeback")

#: The export's process name and source tag: the reference's, so a trace of
#: the same run from either package is the same document.
TRACE_PROCESS = "repro.sim"
TRACE_SOURCE = "repro.sim.PipelinedRuntime"


@dataclasses.dataclass(frozen=True)
class TraceRecord:
    name: str              # human label, e.g. "gemm k3 dma-in"
    phase: str             # one of PHASES
    resource: str          # resource/thread name, e.g. "vpu1.dma"
    start: int             # cycles
    duration: int          # cycles
    args: tuple            # sorted (key, value) pairs — keeps records hashable
    lane: Optional[str] = None   # sub-lane within the resource, e.g. "op1" or
                                 # "op1.c2" (per-operand / per-column-tile DMA
                                 # trains) — display only; busy/phase
                                 # accounting stays per resource
    instant: bool = False        # zero-cycle marker (e.g. a reuse-skipped
                                 # DMA-in) — exported as a Chrome instant
                                 # event; contributes nothing to busy/phase
                                 # totals (emit rejects a nonzero duration)

    @property
    def row(self) -> str:
        """Display row in the Chrome export: resource, or resource/lane."""
        return f"{self.resource}/{self.lane}" if self.lane else self.resource


@dataclasses.dataclass(frozen=True)
class CounterRecord:
    """A Chrome counter sample (``"ph": "C"``): one or more named series
    sampled at a cycle timestamp — per-VPU occupancy, AT free slots,
    reuse-FIFO bytes. Counters live on their own tracks and contribute
    nothing to busy/phase accounting."""

    name: str              # counter track name, e.g. "at.free_slots"
    ts: int                # cycles
    series: tuple          # sorted (series_name, value) pairs


@dataclasses.dataclass(frozen=True)
class FlowRecord:
    """A Chrome flow arrow (``"ph": "s"`` → ``"ph": "f"``) linking a DMA
    tile slice to the compute piece it gates. Row names must refer to rows
    that carry at least one TraceRecord (the arrow endpoints bind to the
    enclosing slices on those rows)."""

    name: str
    phase: str
    fid: int               # flow id — unique per tracer
    src_row: str
    src_ts: int
    dst_row: str
    dst_ts: int


class Tracer:
    """Accumulates trace records; exports Chrome trace_event JSON.

    ``enabled=False`` turns the tracer into a sink: ``emit`` returns
    immediately and no records accumulate. Long benchmark sweeps use this —
    record capture is pure overhead (time and memory) when nobody exports
    the trace — while every default construction keeps full capture."""

    def __init__(self, process_name: str = TRACE_PROCESS, enabled: bool = True):
        self.process_name = process_name
        self.enabled = enabled
        self.records: list[TraceRecord] = []
        self.counters: list[CounterRecord] = []
        self.flows: list[FlowRecord] = []
        self._resources: list[str] = []   # insertion order -> tid

    def emit(self, name: str, phase: str, resource: str, start: int,
             duration: int, lane: Optional[str] = None, instant: bool = False,
             **args: Any) -> Optional[TraceRecord]:
        if not self.enabled:
            return None
        if phase not in PHASES:
            raise ValueError(f"unknown phase {phase!r}, expected one of {PHASES}")
        if instant and duration:
            raise ValueError(f"instant record carries no duration, "
                             f"got {duration}")
        rec = TraceRecord(name=name, phase=phase, resource=resource,
                          start=int(start), duration=int(duration),
                          args=tuple(sorted(args.items())), lane=lane,
                          instant=instant)
        self.records.append(rec)
        if resource not in self._resources:
            self._resources.append(resource)
        return rec

    def counter(self, name: str, ts: int, **series: Any) -> Optional[CounterRecord]:
        """Sample one or more counter series at ``ts`` (a ``"ph": "C"``
        event in the export — its own track in Perfetto)."""
        if not self.enabled:
            return None
        if not series:
            raise ValueError("counter sample needs at least one series")
        rec = CounterRecord(name=name, ts=int(ts),
                            series=tuple(sorted(series.items())))
        self.counters.append(rec)
        return rec

    def flow(self, name: str, phase: str, src_row: str, src_ts: int,
             dst_row: str, dst_ts: int) -> Optional[FlowRecord]:
        """Link the slice enclosing ``(src_row, src_ts)`` to the slice
        enclosing ``(dst_row, dst_ts)`` with a flow arrow."""
        if not self.enabled:
            return None
        if phase not in PHASES:
            raise ValueError(f"unknown phase {phase!r}, expected one of {PHASES}")
        rec = FlowRecord(name=name, phase=phase, fid=len(self.flows),
                         src_row=src_row, src_ts=int(src_ts),
                         dst_row=dst_row, dst_ts=int(dst_ts))
        self.flows.append(rec)
        return rec

    def clear(self) -> None:
        self.records.clear()
        self.counters.clear()
        self.flows.clear()
        self._resources.clear()

    # ------------------------------------------------------------- exporters
    def to_chrome(self) -> dict:
        """Build the Chrome trace_event JSON object (dict, ready to dump).

        Laned records (per-operand DMA trains) render as their own thread
        rows, grouped directly under their parent resource row."""
        lanes_of: dict[str, list[str]] = {r: [] for r in self._resources}
        for rec in self.records:
            if rec.lane is not None and rec.lane not in lanes_of[rec.resource]:
                lanes_of[rec.resource].append(rec.lane)
        tid_of: dict[str, int] = {}
        for r in self._resources:
            tid_of[r] = len(tid_of)
            for lane in lanes_of[r]:
                tid_of[f"{r}/{lane}"] = len(tid_of)
        meta: list[dict] = [{
            "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
            "args": {"name": self.process_name},
        }]
        for r, tid in tid_of.items():
            meta.append({"name": "thread_name", "ph": "M", "pid": 0,
                         "tid": tid, "args": {"name": r}})
            meta.append({"name": "thread_sort_index", "ph": "M", "pid": 0,
                         "tid": tid, "args": {"sort_index": tid}})
        events: list[dict] = []
        for rec in self.records:
            if rec.instant:
                events.append({
                    "name": rec.name,
                    "cat": rec.phase,
                    "ph": "i",
                    "s": "t",             # thread-scoped instant marker
                    "ts": rec.start,
                    "pid": 0,
                    "tid": tid_of[rec.row],
                    "args": dict(rec.args),
                })
                continue
            events.append({
                "name": rec.name,
                "cat": rec.phase,
                "ph": "X",
                "ts": rec.start,          # 1 modeled cycle == 1 us on screen
                "dur": max(rec.duration, 1),   # zero-width events are invisible
                "pid": 0,
                "tid": tid_of[rec.row],
                "args": dict(rec.args),
            })
        for cr in self.counters:
            events.append({
                "name": cr.name,
                "cat": "counter",
                "ph": "C",
                "ts": cr.ts,
                "pid": 0,
                "tid": 0,
                "args": dict(cr.series),
            })
        for fl in self.flows:
            # Flow endpoints bind to the enclosing slice on the named row;
            # rows referenced here always carry at least one complete event.
            for ph, row, ts in (("s", fl.src_row, fl.src_ts),
                                ("f", fl.dst_row, fl.dst_ts)):
                ev = {
                    "name": fl.name,
                    "cat": fl.phase,
                    "ph": ph,
                    "id": fl.fid,
                    "ts": ts,
                    "pid": 0,
                    "tid": tid_of.get(row, 0),
                }
                if ph == "f":
                    ev["bp"] = "e"        # bind to the enclosing slice
                events.append(ev)
        # Deterministic order so trace files diff cleanly across runs:
        # metadata first (by tid, names before sort indices), then events by
        # (ts, tid, phase-kind, name, flow id).
        ph_rank = {"C": 0, "X": 1, "i": 2, "s": 3, "f": 4}
        events.sort(key=lambda e: (e["ts"], e["tid"], ph_rank[e["ph"]],
                                   e["name"], e.get("id", -1)))
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"source": TRACE_SOURCE}}

    def dump(self, path: str) -> str:
        """Write the Chrome trace JSON to ``path`` (creating parent
        directories as needed); returns the path."""
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=None, separators=(",", ":"))
        return path

    # --------------------------------------------------------------- queries
    def busy_cycles(self, resource: Optional[str] = None) -> int:
        return sum(r.duration for r in self.records
                   if resource is None or r.resource == resource)

    def phase_cycles(self) -> dict[str, int]:
        out = {p: 0 for p in PHASES}
        for r in self.records:
            out[r.phase] += r.duration
        return out
