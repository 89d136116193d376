"""Exact 2D strided-region algebra for aliasing decisions.

Own copy of repro.core.regions (pure Python: the port imports nothing of
``repro``).

A kernel operand's main-memory footprint is a *strided band*: ``rows`` row
segments of ``row_bytes`` bytes whose starts form the arithmetic progression
``addr + i * stride_bytes``. Hazard tracking needs one question answered
exactly: can two such footprints share a byte?

Interval intersection of the bounding ranges is necessary but far from
sufficient — two column strips of the same row-major array interleave in the
flat address space without ever touching the same byte, and treating them as
aliases serializes every strip of a strip-mined conv/GEMM through false
WAW/WAR edges. The previous refinement handled only the equal-stride,
non-wrapping case; this module decides the general problem exactly:

Two row segments ``[x, x + ra)`` and ``[y, y + rb)`` intersect iff
``-(rb - 1) <= y - x <= ra - 1``. With ``x = a.addr + i * sa`` and
``y = b.addr + j * sb`` the footprints alias iff some

    t(i, j) = (b.addr - a.addr) + j * sb - i * sa,   0 <= i < a.rows,
                                                     0 <= j < b.rows

falls in the window ``[-(rb - 1), ra - 1]``. Unbounded, ``t`` ranges over a
single residue class mod ``gcd(sa, sb)`` — a cheap necessary condition — and
the bounded decision reduces to, per row of the shorter operand, one integer
interval division. Everything is O(min(rows, rows)) worst case with O(1)
fast paths for the common equal-stride and single-row shapes; no footprint
is ever enumerated byte by byte.
"""
from __future__ import annotations

import dataclasses

import math


@dataclasses.dataclass(frozen=True)
class StridedRegion:
    """One 2D strided byte footprint: ``rows`` segments of ``row_bytes``
    starting at ``addr + i * stride_bytes``.

    ``stride_bytes`` may be smaller than ``row_bytes`` (self-overlapping
    rows) — the algebra does not assume non-wrapping bands.
    """

    addr: int
    rows: int
    row_bytes: int
    stride_bytes: int
    #: One past the last byte touched — precomputed because every index
    #: insert and overlap test reads it (derived, hence excluded from
    #: repr/eq).
    end: int = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.rows <= 0:
            raise ValueError(f"rows must be positive, got {self.rows}")
        if self.row_bytes <= 0:
            raise ValueError(f"row_bytes must be positive, got {self.row_bytes}")
        if self.rows > 1 and self.stride_bytes <= 0:
            raise ValueError(
                f"stride_bytes must be positive for multi-row regions, "
                f"got {self.stride_bytes}")
        object.__setattr__(
            self, "end",
            self.addr + (self.rows - 1) * max(self.stride_bytes, 0)
            + self.row_bytes)
        # Plain-int identity tuple for the memoized pairwise decisions below
        # (tuple-of-ints hashing is C-speed; the generated dataclass
        # __hash__/__eq__ dominated the hot confirmation loops).
        object.__setattr__(self, "_key", (self.addr, self.rows,
                                          self.row_bytes, self.stride_bytes))

    # ------------------------------------------------------------- geometry
    @property
    def start(self) -> int:
        return self.addr

    @property
    def nbytes(self) -> int:
        """Bytes of payload moved (rows may self-overlap in memory)."""
        return self.rows * self.row_bytes

    def row_interval(self, i: int) -> tuple[int, int]:
        """``[start, end)`` of row ``i``."""
        if not 0 <= i < self.rows:
            raise IndexError(f"row {i} out of range [0, {self.rows})")
        s = self.addr + i * self.stride_bytes
        return s, s + self.row_bytes

    # -------------------------------------------------------------- algebra
    def overlaps_interval(self, start: int, end: int) -> bool:
        """Exact test against a flat byte interval ``[start, end)``."""
        if end <= start:
            return False
        return self.overlaps(StridedRegion(addr=start, rows=1,
                                           row_bytes=end - start,
                                           stride_bytes=end - start))

    def overlaps(self, other: "StridedRegion") -> bool:
        """True iff the two footprints share at least one byte. Exact."""
        # Bounding-interval reject (also the exact answer when both are
        # single rows, since then footprint == bounding interval).
        if self.start >= other.end or other.start >= self.end:
            return False
        if self.rows == 1 and other.rows == 1:
            return True

        c = other.addr - self.addr
        sa, sb = self.stride_bytes, other.stride_bytes
        lo, hi = -(other.row_bytes - 1), self.row_bytes - 1

        # Single-row operands degenerate to a 1D progression-vs-interval test.
        if self.rows == 1:
            return _progression_hits(sb, other.rows, lo - c, hi - c)
        if other.rows == 1:
            return _progression_hits(sa, self.rows, c - hi, c - lo)

        # Equal strides: t = c + (j - i) * s with j - i in
        # [-(rows_a - 1), rows_b - 1] — one O(1) division.
        if sa == sb:
            k_lo, k_hi = -(self.rows - 1), other.rows - 1
            j_lo = max(k_lo, _ceil_div(lo - c, sa))
            return j_lo <= k_hi and j_lo * sa <= hi - c

        # Residue fast-reject: every t is ≡ c (mod gcd); if no member of
        # that class lands in the window, the bounded sets can't either.
        g = math.gcd(sa, sb)
        if g > 1 and lo + ((c - lo) % g) > hi:
            return False

        # Exact bounded decision: sweep the shorter operand's rows, answer
        # each row with one interval division on the other progression.
        if self.rows <= other.rows:
            for i in range(self.rows):
                base = i * sa - c
                if _progression_hits(sb, other.rows, base + lo, base + hi):
                    return True
        else:
            for j in range(other.rows):
                base = j * sb + c
                if _progression_hits(sa, self.rows, base - hi, base - lo):
                    return True
        return False

    def contains(self, other: "StridedRegion") -> bool:
        """True iff every byte of ``other`` is also a byte of ``self``. Exact.

        This is the cross-instruction reuse question the pipelined scheduler
        asks: a fresh operand binding may skip its DMA-in train when a copy of
        a *containing* region is already modeled resident and clean. Two
        regimes cover the general case exactly:

        * ``self`` with ``stride_bytes <= row_bytes`` (or a single row) tiles
          memory contiguously — its footprint is the flat interval
          ``[start, end)``, so bounding-interval inclusion is the answer.
        * ``self`` with inter-row gaps: no contained byte run can span two of
          ``self``'s rows (the gap would intrude), so every row of ``other``
          must land inside a single row of ``self`` — one divmod per row of
          ``other``, O(1) when the strides match (the column-tile case).
        """
        if other.start < self.start or other.end > self.end:
            return False
        if self.rows == 1 or self.stride_bytes <= self.row_bytes:
            return True          # contiguous footprint == bounding interval
        sa = self.stride_bytes
        if other.rows > 1 and other.stride_bytes == sa:
            # Equal strides: row j of other sits at the same intra-row offset
            # of self's row i0+j for every j — one check plus a row-count bound.
            i0, off = divmod(other.addr - self.addr, sa)
            return (off + other.row_bytes <= self.row_bytes
                    and i0 + other.rows <= self.rows)
        for j in range(other.rows):
            i, off = divmod(other.addr + j * other.stride_bytes - self.addr, sa)
            if i >= self.rows or off + other.row_bytes > self.row_bytes:
                return False
        return True

#: Bound on each level of a pairwise memo; when a level fills it is cleared
#: wholesale — the steady-state working set of a sweep is far smaller.
_PAIR_CACHE_LIMIT = 1 << 14

#: Top-level memo dicts, registered so ``clear_pair_memos`` can reach them.
_PAIR_MEMO_TABLES: list = []


def _pair_memo(decide, doc: str):
    """Build a memoized pairwise region decision.

    Two-level dicts keyed by the regions' plain int tuples (two
    allocation-free probes instead of hashing a composite key). Sound
    because regions are frozen and ``decide`` is pure. Steady-state
    strip-mined programs ask the same pairwise questions every iteration —
    hazard admission, WAR gating, reuse invalidation all revisit the same
    handful of strip footprints — so the hot-path callers (the alias
    index's exact confirmations) go through these bounded memos."""
    memo: dict = {}
    _PAIR_MEMO_TABLES.append(memo)

    def cached(a: StridedRegion, b: StridedRegion) -> bool:
        d = memo.get(a._key)
        if d is None:
            if len(memo) >= _PAIR_CACHE_LIMIT:
                memo.clear()
            d = memo[a._key] = {}
        v = d.get(b._key)
        if v is None:
            if len(d) >= _PAIR_CACHE_LIMIT:
                d.clear()
            v = d[b._key] = decide(a, b)
        return v

    cached.__doc__ = doc
    return cached


overlaps_cached = _pair_memo(
    StridedRegion.overlaps,
    "Memoized :meth:`StridedRegion.overlaps` (see ``_pair_memo``).")
contains_cached = _pair_memo(
    StridedRegion.contains,
    "Memoized :meth:`StridedRegion.contains` (see ``_pair_memo``).")


def clear_pair_memos() -> None:
    """Drop all memoized pairwise answers (results are unaffected — the
    memos are pure). Benchmarks call this between timed runs so no run
    inherits another's warm cache."""
    for t in _PAIR_MEMO_TABLES:
        t.clear()


def _ceil_div(a: int, b: int) -> int:
    return -((-a) // b)


def _progression_hits(step: int, count: int, lo: int, hi: int) -> bool:
    """Does ``{k * step : 0 <= k < count}`` intersect ``[lo, hi]``?"""
    if hi < lo:
        return False
    k_lo = max(0, _ceil_div(lo, step))
    return k_lo < count and k_lo * step <= hi


def footprints_overlap(a_addr: int, a_rows: int, a_row_bytes: int,
                       a_stride: int, b_addr: int, b_rows: int,
                       b_row_bytes: int, b_stride: int) -> bool:
    """Functional form of :meth:`StridedRegion.overlaps`."""
    return StridedRegion(a_addr, a_rows, a_row_bytes, a_stride).overlaps(
        StridedRegion(b_addr, b_rows, b_row_bytes, b_stride))
