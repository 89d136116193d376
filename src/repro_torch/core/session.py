"""Re-entrant runtime sessions — the open-loop execution protocol.

Own copy of repro.core.session (pure Python: the port imports nothing of
``repro``).

A closed batch hands a :class:`~repro_torch.core.program.KernelProgram`
over once, runs it to completion and reads the makespan. A
:class:`RuntimeSession` instead keeps the runtime's
clock **open** between programs, so work can be injected at arbitrary sim
times while earlier work is still in flight — the execution model a serving
scenario needs (requests arrive mid-run; KV-cache state stays resident in
the cache under the real AT-capacity and flush rules between steps).

The protocol (implemented by both runtimes):

  * ``session.issue(prog, at=t)``   — place any unplaced buffers, issue the
    tape, and admit it at sim time ``t`` (default: now). Returns an
    :class:`IssueHandle` whose ``on_done`` callback fires at the sim time
    the program's last kernel retires.
  * ``session.post(t, fn)``        — inject an external event: ``fn(now)``
    runs when the clock reaches ``t`` (e.g. a request arrival that issues
    a prefill program).
  * ``session.advance(until=t)``   — process everything due by ``t``,
    leaving later work in flight.
  * ``session.drain()``            — run everything (chained callbacks
    included) to completion and flush deferred results.

On the pipelined runtime (:class:`repro_torch.sim.pipeline.PipelinedRuntime`)
the session clock is the persistent event timeline; on the serial runtime it
is modeled-cycles-so-far plus injected idle. A closed session
(``open_loop=False``) is the batch path:
:func:`repro_torch.core.program.run_program` is a thin wrapper over one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.core.program import (KernelProgram, _as_cop,
                                      issue_program, place_program)


@dataclasses.dataclass
class IssueHandle:
    """One issued program's lifecycle: the kernel ids it decoded into and
    the sim time its last kernel retired (``None`` while in flight).

    ``on_done(t)`` fires exactly once, re-entrantly from inside the
    scheduler at the retire point — the hook continuous-batching drivers
    chain their next step from."""

    program: KernelProgram
    addrs: dict[str, int]
    issued_at: int
    on_done: Optional[Callable[[int], None]] = None
    kernel_ids: tuple[int, ...] = ()
    done_at: Optional[int] = None
    _outstanding: int = 0
    _sealed: bool = False

    @property
    def done(self) -> bool:
        return self.done_at is not None

    def _add(self, kid: int) -> None:
        self.kernel_ids += (kid,)
        self._outstanding += 1

    def _retired(self, t: int) -> None:
        self._outstanding -= 1
        self._maybe_done(t)

    def _seal(self, t: int) -> None:
        """All kernels are captured; completion may now be declared. (Queue
        backpressure can retire early kernels while later ops are still
        being issued — completion must wait for the full tape.)"""
        self._sealed = True
        self._maybe_done(t)

    def _maybe_done(self, t: int) -> None:
        if self._sealed and self._outstanding == 0 and self.done_at is None:
            self.done_at = t
            if self.on_done is not None:
                self.on_done(t)


class RuntimeSession:
    """A re-entrant execution session over one runtime.

    ``open_loop=True`` (default) keeps the clock open: issues admit work at
    the current sim time without running it; ``advance``/``drain`` move the
    clock. ``open_loop=False`` is the batch discipline (queue
    backpressure drains eagerly) — what :func:`run_program` wraps.
    """

    def __init__(self, rt_or_cop, *, open_loop: bool = True,
                 validate: bool = True):
        self.cop = _as_cop(rt_or_cop)
        self.rt = self.cop.rt
        self.validate = validate
        self.open_loop = bool(open_loop)
        if self.open_loop:
            self.rt._session_open = True

    # ------------------------------------------------------------- protocol
    def now(self) -> int:
        """The session's current sim time."""
        return self.rt.session_now()

    def post(self, t: int, fn: Callable[[int], None]) -> None:
        """Schedule ``fn(now)`` to run at sim time ``t`` (clamped to now)."""
        self.rt.session_post(t, fn)

    def issue(self, prog: KernelProgram, *, at: Optional[int] = None,
              addrs: Optional[dict[str, int]] = None,
              on_done: Optional[Callable[[int], None]] = None) -> IssueHandle:
        """Issue ``prog`` at sim time ``at`` (default: now).

        ``addrs`` pre-places named buffers (shared weights, a request's KV
        buffers from an earlier step) — only buffers not in it are placed.
        The passed mapping is updated **in place** (and the handle aliases
        it): an ``on_done`` callback can fire re-entrantly from inside this
        very call on the synchronous serial runtime, and a chained issue
        sharing the mapping must already see this program's placements, not
        re-place (and silently fork) the live buffers. ``at`` in the future
        first advances the session there."""
        if self.validate:
            prog.validate(self.rt.library)
        if at is not None and at > self.rt.session_now():
            self.advance(until=at)
        placed = place_program(self.cop, prog, prior=addrs)
        if addrs is not None:
            addrs.update(placed)
            placed = addrs
        addrs = placed
        h = IssueHandle(program=prog, addrs=addrs,
                        issued_at=self.rt.session_now(), on_done=on_done)

        def captured(kid: int) -> None:
            h._add(kid)
            self.rt._retire_watchers.setdefault(kid, []).append(h._retired)

        # Save/restore, not set/clear: a retire callback firing during a
        # backpressure stall can issue *another* program re-entrantly while
        # this one is mid-issue — the outer program's capture hook must be
        # intact when its remaining ops decode.
        prev = self.rt._issue_capture
        self.rt._issue_capture = captured
        try:
            issue_program(self.cop, prog, addrs, barrier=False)
        finally:
            self.rt._issue_capture = prev
        if self.open_loop:
            # Admit now so decode bookings anchor at the issue time; the
            # events run at the next advance/drain (or in the enclosing
            # event loop, when issued from a callback).
            self.rt.run_pending()
        h._seal(self.rt.session_now())
        return h

    def advance(self, *, until: int) -> None:
        """Process everything due by sim time ``until``; later work stays
        in flight and the clock lands on ``until``."""
        self.rt.session_advance(int(until))

    def drain(self) -> None:
        """Run all remaining work — posted events, chained callbacks, and
        deferred write-backs — to completion."""
        self.rt.session_drain()
