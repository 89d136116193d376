"""Event-driven timing engine primitives for the pipelined C-RT model.

Two ingredients, both deliberately tiny and deterministic:

  * :class:`EventQueue` — a binary-heap priority queue of timestamped events.
    Ties on ``time`` break by monotonically-increasing insertion sequence, so
    replaying the same program yields the same event order, bit for bit.
  * :class:`Resource` — a single-server FIFO resource (the eCPU, one VPU
    datapath, one VPU DMA port, the cache lock). ``acquire`` books an activity
    on the resource's timeline: the activity starts when both the requester is
    ready *and* the resource is free, and the busy interval is recorded for
    trace export and utilisation reporting.

Times are modeled **cycles** (integers). There is no wall-clock anywhere in
this module — determinism is a hard requirement (the pipelined scheduler must
produce bit-identical numerics and reproducible traces run-to-run).

Own copy of repro.sim.events: host-side scheduling arithmetic, kept on
Python ints and numpy as the reference keeps it (a tensor on the card here
would make every event a device round trip).
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import itertools
from typing import Any, Iterator, Optional

import numpy as np

from repro_torch.core.dataflow import OperandFlow


@dataclasses.dataclass(frozen=True)
class Event:
    """One scheduled occurrence. Ordered by (time, seq) — never by payload."""

    time: int
    seq: int
    kind: str
    payload: Any = None

    def __lt__(self, other: "Event") -> bool:
        return (self.time, self.seq) < (other.time, other.seq)


class EventQueue:
    """Deterministic min-heap of :class:`Event`.

    ``push`` stamps each event with an insertion sequence number; ``pop``
    returns the earliest event, breaking time ties in insertion order. This
    makes the simulation a pure function of the submitted program.
    """

    def __init__(self) -> None:
        self._heap: list[Event] = []
        self._seq = itertools.count()

    def push(self, time: int, kind: str, payload: Any = None) -> Event:
        if time < 0:
            raise ValueError(f"event time must be non-negative, got {time}")
        ev = Event(time=int(time), seq=next(self._seq), kind=kind,
                   payload=payload)
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        if not self._heap:
            raise IndexError("pop from empty EventQueue")
        return heapq.heappop(self._heap)

    def peek(self) -> Optional[Event]:
        return self._heap[0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def drain(self) -> Iterator[Event]:
        while self._heap:
            yield self.pop()


class Timeline(EventQueue):
    """Open-ended event timeline: a persistent :class:`EventQueue` plus the
    current simulation clock.

    The closed-batch scheduler built a fresh queue per drain and ran it to
    empty; a :class:`Timeline` instead lives for the whole session, so events
    can be injected from *outside* the event loop — request arrivals posted at
    future sim times while the clock advances — and the loop can stop at an
    arbitrary ``until`` bound with work still in flight. ``now`` is the time
    of the last processed event (monotonically non-decreasing; the scheduler
    owns advancing it). External events carry a callback payload under the
    reserved kind ``"external"`` and are invoked by the scheduler's event
    loop when their time comes.
    """

    #: Event kind reserved for externally injected events (payload is a
    #: ``fn(t)`` callback invoked by the scheduler loop at the event's time).
    EXTERNAL = "external"

    def __init__(self) -> None:
        super().__init__()
        self.now = 0

    def advance_clock(self, t: int) -> int:
        """Move the clock forward to ``t`` (never backward); returns ``now``."""
        if t > self.now:
            self.now = int(t)
        return self.now

    def post(self, time: int, fn) -> Event:
        """Inject an external event (e.g. a request arrival) at sim time
        ``time``. Times in the past are clamped to ``now`` — the event then
        fires at the next loop step, which is as early as an arrival that
        already happened can be serviced."""
        if not callable(fn):
            raise TypeError(f"external event payload must be callable, got "
                            f"{type(fn).__name__}")
        return self.push(max(int(time), self.now), self.EXTERNAL, fn)


@dataclasses.dataclass
class Interval:
    start: int
    end: int
    label: str = ""

    @property
    def duration(self) -> int:
        return self.end - self.start


def row_chunks(rows: int, row_chunk: int) -> list[int]:
    """Split ``rows`` into chunks of at most ``row_chunk`` rows.

    ``row_chunk <= 0`` disables chunking (one chunk with every row) — the
    whole-transfer granularity the scheduler modeled before intra-instruction
    row pipelining.
    """
    if rows <= 0:
        return []
    if row_chunk <= 0:
        return [rows]
    return [min(row_chunk, rows - r) for r in range(0, rows, row_chunk)]


def split_proportional(total: int, weights: list[int]) -> list[int]:
    """Deterministically split integer ``total`` into ``len(weights)`` parts
    proportional to ``weights``; parts sum to ``total`` exactly (cumulative
    floor rounding, so replays are bit-identical)."""
    if not weights:
        return []
    s = sum(weights)
    if s <= 0:
        raise ValueError(f"weights must sum to a positive value, got {weights}")
    if len(weights) >= 32 and 0 <= total * s < 2 ** 62:
        # Vectorized path for long tile trains; int64 is exact here (the
        # largest intermediate is total * s, guarded above), so the parts are
        # bit-identical to the scalar loop below.
        w = np.asarray(weights, dtype=np.int64)
        if (w < 0).any():
            raise ValueError(f"negative weight {int(w.min())}")
        x = (total * np.cumsum(w)) // s
        return np.diff(x, prepend=0).tolist()
    out, acc, cum = [], 0, 0
    for w in weights:
        if w < 0:
            raise ValueError(f"negative weight {w}")
        cum += w
        x = total * cum // s
        out.append(x - acc)
        acc = x
    return out


def interleave_blocks(parts_per_block: list[list[int]]) -> list[tuple[int, int]]:
    """Round-robin interleave per-block chunk lists into one DMA order.

    Models the C-RT programming one 2D DMA descriptor per row-stacked block
    (e.g. the three channel planes of the conv-layer input) and streaming
    them alternately, so every block's early rows land early. Returns
    ``(block, rows)`` entries in transfer order.
    """
    out: list[tuple[int, int]] = []
    for j in range(max((len(p) for p in parts_per_block), default=0)):
        for b, parts in enumerate(parts_per_block):
            if j < len(parts):
                out.append((b, parts[j]))
    return out


def tile_entries(bands_per_block: list[list[int]], col_parts: list[int],
                 col_major: bool = False) -> list[tuple[int, int, int]]:
    """Transfer order of one operand's 2D tile train.

    Returns ``(block, band, tile)`` index triples: blocks round-robin at band
    granularity (every plane's early rows land early), and within a block's
    band the column tiles stream consecutively. ``col_major`` flips the
    nesting — all bands of column tile 0, then tile 1, … — the order a
    row-FULL / column-streamed operand (GEMM's B) wants, so its first column
    tile is complete as early as possible.
    """
    out: list[tuple[int, int, int]] = []
    n_bands = max((len(p) for p in bands_per_block), default=0)
    if col_major:
        for t in range(len(col_parts)):
            for j in range(n_bands):
                for b, parts in enumerate(bands_per_block):
                    if j < len(parts):
                        out.append((b, j, t))
    else:
        for j in range(n_bands):
            for b, parts in enumerate(bands_per_block):
                if j < len(parts):
                    for t in range(len(col_parts)):
                        out.append((b, j, t))
    return out


@dataclasses.dataclass
class TileTrain:
    """One operand's tile-indexed DMA activity train, per stacked block.

    ``cum_rows[b][i]`` is the cumulative row count of block ``b`` after its
    row band ``i``; ``cum_cols[t]`` the cumulative column count after column
    tile ``t`` (columns are shared across blocks — blocks stack rows);
    ``end_times[b][i][t]`` the modeled completion cycle of tile ``(i, t)`` of
    block ``b``. The gating question "when may compute piece ``(pi, pj)``
    start, given this operand's dataflow policy?" reduces to: per block, which
    band/tile rectangle first covers the rows × cols the policy requires —
    the answer is the prefix maximum of that rectangle's end times.
    """

    cum_rows: list[list[int]]
    cum_cols: list[int]
    end_times: list[list[list[int]]]

    def __post_init__(self):
        # Prefix max over the (band, tile) grid per block: pmax[b][i][t] is
        # the latest completion among tiles (<=i, <=t). Large grids build it
        # vectorized — two np.maximum.accumulate passes per block (exact
        # int64 arithmetic) — small grids keep the scalar loop, which beats
        # numpy's per-call overhead below ~64 cells. Either path yields the
        # same nested lists; gate queries bisect tiny cumulative lists, where
        # plain indexing beats numpy scalar access.
        self._pmax = []
        for grid in self.end_times:
            if len(grid) * len(grid[0]) >= 64:
                self._pmax.append(
                    np.maximum.accumulate(
                        np.maximum.accumulate(
                            np.asarray(grid, dtype=np.int64),
                            axis=0), axis=1).tolist())
                continue
            pm: list[list[int]] = []
            for i, row in enumerate(grid):
                cur = []
                run = 0
                for t, e in enumerate(row):
                    run = max(run, e)
                    cur.append(max(run, pm[i - 1][t]) if i else run)
                pm.append(cur)
            self._pmax.append(pm)

    @property
    def pace(self) -> int:
        """Band count of the longest block — the train's natural row-piece
        count when it paces the compute split."""
        return max(len(c) for c in self.cum_rows)

    @property
    def col_pace(self) -> int:
        """Column-tile count — the natural column-piece count."""
        return len(self.cum_cols)

    def piece_weights(self) -> list[int]:
        """Row weights of the pacing block's bands (compute-split weights)."""
        longest = max(self.cum_rows, key=len)
        return [c - p for c, p in zip(longest, [0] + longest[:-1])]

    def col_weights(self) -> list[int]:
        """Column weights of the tiles (compute column-split weights)."""
        return [c - p for c, p in
                zip(self.cum_cols, [0] + self.cum_cols[:-1])]

    def gate(self, flow: OperandFlow, piece: int, n_pieces: int,
             col_piece: int = 0, n_col_pieces: int = 1) -> int:
        """Cycle at which piece ``(piece, col_piece)`` of an
        ``n_pieces × n_col_pieces`` grid has every tile this operand's
        ``flow`` demands."""
        need_c = flow.cols_required(col_piece, n_col_pieces, self.cum_cols[-1])
        jc = bisect.bisect_left(self.cum_cols, need_c)
        t = 0
        for cum, pm in zip(self.cum_rows, self._pmax):
            need_r = flow.rows_required(piece, n_pieces, cum[-1])
            jr = bisect.bisect_left(cum, need_r)
            t = max(t, pm[jr][jc])
        return t

    def gate_source(self, flow: OperandFlow, piece: int, n_pieces: int,
                    col_piece: int = 0, n_col_pieces: int = 1
                    ) -> tuple[int, Optional[tuple[int, int, int]]]:
        """Like :meth:`gate`, but also name the binding tile.

        Returns ``(gate_cycle, (block, band, tile))`` — the last-landing tile
        inside the required rectangle (the tile whose completion the compute
        piece actually waits for; earliest-indexed on ties). Observability
        helper for flow-event emission: an O(rectangle) scan rather than an
        O(1) prefix-max lookup, so the scheduler's timing path never calls it.
        """
        need_c = flow.cols_required(col_piece, n_col_pieces, self.cum_cols[-1])
        jc = bisect.bisect_left(self.cum_cols, need_c)
        best_t = 0
        best_src: Optional[tuple[int, int, int]] = None
        for b, (cum, grid) in enumerate(zip(self.cum_rows, self.end_times)):
            need_r = flow.rows_required(piece, n_pieces, cum[-1])
            jr = bisect.bisect_left(cum, need_r)
            for i in range(jr + 1):
                row = grid[i]
                for t in range(jc + 1):
                    if row[t] > best_t or best_src is None:
                        best_t = row[t]
                        best_src = (b, i, t)
        return best_t, best_src


def ChunkTrain(cum_rows: list[list[int]],
               end_times: list[list[int]]) -> TileTrain:
    """Backward-compatible 1D constructor: a :class:`TileTrain` with a single
    column tile per band (the PR-3 row-chunked train)."""
    return TileTrain(cum_rows=cum_rows, cum_cols=[1],
                     end_times=[[[e] for e in ends] for ends in end_times])


class Resource:
    """Single-server FIFO resource with an occupancy timeline.

    ``free_at`` is the earliest cycle the next activity could start. Booking
    never reorders: activities occupy the resource in acquire order, which is
    exactly the in-order hardware queue each modeled unit has.
    """

    def __init__(self, name: str):
        self.name = name
        self.free_at = 0
        self.busy_cycles = 0
        self.fenced = False
        self.intervals: list[Interval] = []

    def fence(self, t: int) -> None:
        """Permanently fence the resource at ``t``: a hard fault offlined
        the modeled unit, so any further :meth:`acquire` raises. ``free_at``
        advances to the fence time so utilization reporting never sees
        phantom idle headroom on a dead unit."""
        self.fenced = True
        self.free_at = max(self.free_at, int(t))

    def acquire(self, at: int, duration: int, label: str = "") -> Interval:
        """Book ``duration`` cycles starting no earlier than ``at``.

        Returns the booked interval (start may be later than ``at`` if the
        resource is still busy). Zero-duration bookings are recorded too —
        they matter for trace completeness (e.g. a deferred write-back).
        """
        if self.fenced:
            raise RuntimeError(
                f"{self.name}: resource is fenced (hard fault offlined it); "
                f"the scheduler must not book new work here")
        if duration < 0:
            raise ValueError(f"{self.name}: negative duration {duration}")
        start = max(int(at), self.free_at)
        iv = Interval(start=start, end=start + int(duration), label=label)
        self.free_at = iv.end
        self.busy_cycles += iv.duration
        self.intervals.append(iv)
        return iv

    def idle_at(self, t: int) -> bool:
        return self.free_at <= t

    def utilization(self, horizon: int) -> float:
        return self.busy_cycles / horizon if horizon > 0 else 0.0

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Resource({self.name!r}, free_at={self.free_at})"
