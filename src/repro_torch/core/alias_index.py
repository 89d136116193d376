"""Bucketed byte-interval index over :class:`StridedRegion` footprints.

Own copy of repro.core.alias_index (pure Python: the port imports nothing of
``repro``).

Every aliasing decision in the scheduler stack — hazard admission sweeps,
Address Table host-access checks, WAR dispatch gating, dirty-resident flush
ordering, cross-instruction reuse invalidation — asks the same question: *which
of these tracked footprints could share a byte with this one?* Answering it by
pairwise scans made each of those sites O(live) per query and the program-level
cost O(live²); this module centralises the question behind an index so a query
pays only for its candidates.

Design: a region's *bounding interval* ``[start, end)`` is hashed into
fixed-size address buckets (``1 << bucket_bits`` bytes each). An item is
recorded in every bucket its bounding interval touches; items spanning more
than ``coarse_limit`` buckets go to a coarse overflow set that every query
scans (keeps inserts O(min(span, coarse_limit))). A query gathers the
candidate keys from the buckets its own bounding interval touches (plus the
coarse set), then confirms each candidate with the **exact** strided-region
algebra (:meth:`StridedRegion.overlaps`) — bucketing is a pure accelerator, it
never changes an answer. Queries and inserts are O(buckets touched +
candidates); the exact confirmation keeps the "column strips interleave
without touching" property the region algebra guarantees.

Determinism: :meth:`query` returns keys in sorted order, so callers that pick
"the first hit" see the same hit regardless of bucket-hash iteration order.
Keys within one index must be mutually orderable (ints, or same-shape tuples).

``brute_force_queries()`` switches every index to exhaustive candidate scans —
the pre-index behaviour. It exists for two consumers: the oracle tests (the
indexed and brute answers must be identical on any operation sequence) and
the reference benchmark's baseline mode (measuring what the index
buys). The switch changes *wall-clock only*, never results.
"""
from __future__ import annotations

import contextlib
from typing import Hashable, Iterator, Optional

from repro_torch.core.regions import StridedRegion, overlaps_cached

#: Module-level switch flipped by :func:`brute_force_queries`; when True every
#: AliasIndex query scans all items (exact confirmation still applies).
_BRUTE = False


@contextlib.contextmanager
def brute_force_queries() -> Iterator[None]:
    """Run all AliasIndex queries as exhaustive scans (pre-index baseline)."""
    global _BRUTE
    prev = _BRUTE
    _BRUTE = True
    try:
        yield
    finally:
        _BRUTE = prev


class AliasIndex:
    """Incremental interval index with exact strided-overlap confirmation.

    ``bucket_bits`` sets the bucket granularity (default 4 KiB — one LLC line
    span at the paper's geometry, a good fit for kernel-operand footprints);
    ``coarse_limit`` caps the buckets one item or query may touch before it
    falls back to the coarse path.
    """

    def __init__(self, bucket_bits: int = 12, coarse_limit: int = 128):
        self._bits = bucket_bits
        self._coarse_limit = coarse_limit
        self._buckets: dict[int, set[Hashable]] = {}
        self._coarse: set[Hashable] = set()
        self._regions: dict[Hashable, StridedRegion] = {}
        # Profiling counters (PipelineReport.alias_queries aggregates these).
        self.queries = 0
        self.candidates_checked = 0

    # ---------------------------------------------------------- maintenance
    def __len__(self) -> int:
        return len(self._regions)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._regions

    def region(self, key: Hashable) -> StridedRegion:
        return self._regions[key]

    def _span(self, region: StridedRegion) -> range:
        return range(region.start >> self._bits,
                     ((region.end - 1) >> self._bits) + 1)

    def insert(self, key: Hashable, region: StridedRegion) -> None:
        """Track ``region`` under ``key`` (replaces any previous region)."""
        if key in self._regions:
            self.discard(key)
        self._regions[key] = region
        span = self._span(region)
        if len(span) > self._coarse_limit:
            self._coarse.add(key)
            return
        for b in span:
            bucket = self._buckets.get(b)
            if bucket is None:
                bucket = self._buckets[b] = set()
            bucket.add(key)

    def remove(self, key: Hashable) -> None:
        """Stop tracking ``key``; raises ``KeyError`` if absent."""
        region = self._regions.pop(key)
        if key in self._coarse:
            self._coarse.discard(key)
            return
        for b in self._span(region):
            bucket = self._buckets[b]
            bucket.discard(key)
            if not bucket:
                del self._buckets[b]

    def discard(self, key: Hashable) -> None:
        """Stop tracking ``key`` if present."""
        if key in self._regions:
            self.remove(key)

    def clear(self) -> None:
        self._buckets.clear()
        self._coarse.clear()
        self._regions.clear()

    # --------------------------------------------------------------- queries
    def _candidates(self, region: StridedRegion):
        """Candidate key collection (a set, or a borrowed read-only one)."""
        span = self._span(region)
        if len(span) > self._coarse_limit:
            return self._regions
        get = self._buckets.get
        buckets = [b for b in map(get, span) if b]
        if not self._coarse and len(buckets) == 1:
            return buckets[0]          # borrowed — query() only iterates it
        cands: set[Hashable] = set(self._coarse)
        for b in buckets:
            cands |= b
        return cands

    def query(self, region: StridedRegion) -> list[Hashable]:
        """Keys whose footprint shares at least one byte with ``region``
        (exact), in ascending key order."""
        self.queries += 1
        if not self._regions:
            return []
        if _BRUTE:
            # Baseline mode is the *pre-index* cost model: full scan with
            # uncached exact decisions.
            self.candidates_checked += len(self._regions)
            return self.brute_query(region)
        cands = self._candidates(region)
        self.candidates_checked += len(cands)
        regions = self._regions
        return sorted(k for k in cands
                      if overlaps_cached(regions[k], region))

    def query_interval(self, start: int, end: int) -> list[Hashable]:
        """Keys whose footprint touches the flat byte interval ``[start,
        end)``, in ascending key order. Empty intervals match nothing."""
        if end <= start:
            self.queries += 1
            return []
        return self.query(StridedRegion(addr=start, rows=1,
                                        row_bytes=end - start,
                                        stride_bytes=end - start))

    def brute_query(self, region: StridedRegion) -> list[Hashable]:
        """Exhaustive-scan reference answer (the oracle the tests compare
        against; also what every query does under ``brute_force_queries``)."""
        return sorted(k for k, r in self._regions.items()
                      if r.overlaps(region))
