"""Hazard checking and logical-matrix renaming (paper §IV-B1).

Own copy of repro.core.hazards (pure Python: the port imports nothing of
``repro``).

The Kernel Decoder must cope with out-of-order communication with the host: an
``xmr`` may rebind a logical matrix register while an older kernel that named
the same register is still queued. Physically copying or stalling would erase
the benefit of deferred allocation, so — exactly like an OoO core — the decoder
*renames*: every ``xmr`` mints a fresh physical binding (see
:class:`repro_torch.core.matrix.MatrixMap`), and queued kernels capture the physical
bindings (not the logical indices) at decode time. WAR/WAW on logical registers
then vanish by construction; only true RAW dependencies between kernels remain,
and those are expressed as edges in a dependency DAG used by both the simulator
scheduler and the trace-time production engine (buffer-donation ordering).

Memory-aliasing edges between distinct physical bindings are decided with the
*exact* 2D region algebra (:mod:`repro_torch.core.regions`, via
:meth:`MatrixBinding.overlaps`): unequal-stride interleavings that never share
a byte produce no edge, so strip-mined workloads schedule concurrently.

Tracker state is bounded: when a kernel completes, every per-binding record
(last writer, reader set, captured binding) whose physical id is no longer
referenced by a pending kernel — and not *pinned* by the runtime for a
deferred cache-resident result — is pruned, so long-running programs see
O(live) admission cost and memory, not O(history).

Host-side hazards against main memory regions are handled by the
:class:`repro_torch.core.address_table.AddressTable`; this module covers
kernel↔kernel dependencies.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core.alias_index import AliasIndex
from repro_torch.core.matrix import MatrixBinding


@dataclasses.dataclass(frozen=True)
class KernelDeps:
    """Dependency summary for one decoded kernel instance."""

    kernel_id: int
    sources: tuple[int, ...]       # physical ids read
    destination: int               # physical id written
    depends_on: tuple[int, ...]    # kernel_ids that must complete first


class DependencyTracker:
    """Builds the kernel-level dependency DAG under renaming.

    After renaming, two queued kernels conflict iff:
      * RAW — a later kernel reads the physical destination of an earlier one;
      * output/anti conflicts on the *same physical* destination (possible when
        a program reuses a destination register without re-reserving it —
        renaming only happens at ``xmr``) — kept as WAW/WAR edges;
      * memory aliasing — distinct physical bindings whose main-memory
        footprints overlap (the AT-level view of the same hazard), decided
        exactly by the 2D region algebra.
    """

    def __init__(self):
        self._pending: dict[int, KernelDeps] = {}
        self._writer_of: dict[int, int] = {}   # phys_id -> kernel_id (last writer)
        self._readers_of: dict[int, set[int]] = {}
        self._bindings: dict[int, MatrixBinding] = {}
        self._refs: dict[int, int] = {}        # phys_id -> pending kernels using it
        self._pinned: set[int] = set()         # runtime-held (cache-resident) ids
        # Footprints written by *pending* kernels, keyed by phys_id: the
        # admission alias sweep queries this instead of scanning every live
        # writer record (O(hits) admission instead of O(live) per kernel).
        self._alias_index = AliasIndex()
        self._next_kernel_id = 0
        self._completed_count = 0

    # ------------------------------------------------------------------ api
    def admit(
        self,
        sources: Sequence[MatrixBinding],
        destination: MatrixBinding,
    ) -> KernelDeps:
        kid = self._next_kernel_id
        self._next_kernel_id += 1

        deps: set[int] = set()
        for b in (*sources, destination):
            self._bindings[b.phys_id] = b

        # RAW: read a pending kernel's destination.
        for src in sources:
            w = self._writer_of.get(src.phys_id)
            if w is not None and w in self._pending:
                deps.add(w)
        # WAW: same physical destination written twice without renaming.
        w = self._writer_of.get(destination.phys_id)
        if w is not None and w in self._pending:
            deps.add(w)
        # WAR: we overwrite something a pending kernel still reads.
        for r in self._readers_of.get(destination.phys_id, ()):
            if r in self._pending:
                deps.add(r)
        # Memory aliasing between distinct physical bindings (exact 2D
        # footprint intersection): query the pending-writer footprint index
        # with the destination and every source instead of sweeping all live
        # writer records — the index holds exactly the regions a pending
        # kernel will write.
        aliased: set[int] = set(self._alias_index.query(destination.region))
        for s in sources:
            aliased.update(self._alias_index.query(s.region))
        for other_pid in aliased:
            if other_pid == destination.phys_id:
                continue
            writer = self._writer_of.get(other_pid)
            if writer is not None and writer in self._pending:
                deps.add(writer)

        rec = KernelDeps(
            kernel_id=kid,
            sources=tuple(s.phys_id for s in sources),
            destination=destination.phys_id,
            depends_on=tuple(sorted(deps)),
        )
        self._pending[kid] = rec
        self._writer_of[destination.phys_id] = kid
        self._alias_index.insert(destination.phys_id, destination.region)
        for s in sources:
            self._readers_of.setdefault(s.phys_id, set()).add(kid)
        for pid in {*rec.sources, rec.destination}:
            self._refs[pid] = self._refs.get(pid, 0) + 1
        return rec

    def binding(self, phys_id: int) -> Optional[MatrixBinding]:
        """Binding captured at admission (outlives matrix-map renaming)."""
        return self._bindings.get(phys_id)

    def writer_of(self, phys_id: int) -> Optional[int]:
        """Kernel id of the (last) writer of ``phys_id``; admission order of
        writers is the memory write-back order the runtime must preserve."""
        return self._writer_of.get(phys_id)

    def ready(self, kernel_id: int) -> bool:
        rec = self._pending[kernel_id]
        # A dependency is satisfied iff it is no longer pending: kernel ids
        # are admitted once and only leave via complete().
        return all(d not in self._pending for d in rec.depends_on)

    def unmet_deps(self, kernel_id: int) -> tuple[int, ...]:
        """Still-pending dependencies of ``kernel_id`` — the kernels whose
        completion a wakeup-driven scheduler must wait on before re-examining
        this one (empty ⇔ :meth:`ready`)."""
        rec = self._pending[kernel_id]
        return tuple(d for d in rec.depends_on if d in self._pending)

    def runnable(self) -> list[int]:
        return [k for k in self._pending if self.ready(k)]

    def complete(self, kernel_id: int) -> None:
        rec = self._pending.pop(kernel_id)
        self._completed_count += 1
        # The written footprint leaves the pending-writer index unless a
        # later pending kernel re-wrote the same physical binding (WAW
        # without renaming keeps the newer writer's entry live).
        if self._writer_of.get(rec.destination) == kernel_id:
            self._alias_index.discard(rec.destination)
        for pid in {*rec.sources, rec.destination}:
            readers = self._readers_of.get(pid)
            if readers is not None:
                readers.discard(kernel_id)
            self._refs[pid] -= 1
            self._maybe_prune(pid)

    # ------------------------------------------------------ residency pins
    def pin(self, phys_id: int) -> None:
        """Runtime holds a cache-resident result for ``phys_id``: keep its
        binding and write-order stamp alive past the writer's completion
        (deferred write-backs replay admission order via ``writer_of``)."""
        self._pinned.add(phys_id)

    def unpin(self, phys_id: int) -> None:
        """Residency dropped — prune the records if nothing pending uses them."""
        self._pinned.discard(phys_id)
        self._maybe_prune(phys_id)

    def _maybe_prune(self, phys_id: int) -> None:
        if self._refs.get(phys_id, 0) > 0 or phys_id in self._pinned:
            return
        w = self._writer_of.get(phys_id)
        if w is not None and w in self._pending:
            return
        self._refs.pop(phys_id, None)
        self._writer_of.pop(phys_id, None)
        self._readers_of.pop(phys_id, None)
        self._bindings.pop(phys_id, None)

    # ------------------------------------------------------------- introspect
    def pending_count(self) -> int:
        return len(self._pending)

    def completed_count(self) -> int:
        return self._completed_count

    def tracked_state_size(self) -> int:
        """Entries held across all per-binding maps (bounded-growth metric)."""
        return (len(self._writer_of) + len(self._bindings) + len(self._refs)
                + sum(len(s) for s in self._readers_of.values()))

    def has_cycle(self) -> bool:
        """DAG invariant (property-tested): admission can never create a cycle
        because edges always point from earlier to later kernel ids."""
        return any(
            d >= kid for kid, rec in self._pending.items() for d in rec.depends_on
        )
