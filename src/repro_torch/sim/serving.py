"""Continuous-batching serving scenario over re-entrant runtime sessions.

The closed-batch benchmarks answer "how fast does one tape run"; a serving
deployment asks a different question — what latency does a *request* see
when it arrives while other requests are mid-generation and has to share
the cache, the VPUs, and the kernel queue with them. This module drives
that scenario against either runtime through the
:class:`~repro_torch.core.session.RuntimeSession` protocol, mirroring
``serving/engine.py``'s slot discipline:

  * requests arrive at sim times drawn from a Poisson process
    (:func:`poisson_arrivals`) or a bursty replay (:func:`bursty_arrivals`)
    and are posted onto the session timeline as external events;
  * an arrival is admitted into one of ``cfg.slots`` serving slots (or
    queues FIFO when all slots are busy) and issues its **prefill tape** —
    length proportional to the prompt, filling the request's resident KV
    buffers;
  * prefilled requests generate through **batched decode steps**: one
    program per global step concatenating every ready slot's decode ops
    (shapes per :func:`repro_torch.lower.transformer.lower_decode_step`), with
    the KV cache and the ping-pong activation row held as *resident* cache
    state across steps under the real AT-capacity and flush rules — each
    step's K/V-append and activation read are genuine cross-program RAW
    dependencies on bytes the previous step left in the cache.

Everything is callback-driven off the session clock: prefill completion
records the request's first token (TTFT), step completion advances every
batched request one token and chains the next step, request completion
frees the slot and admits the head of the queue. The whole run is
deterministic for a fixed ``(config, arrivals)`` pair — arrival generators
take explicit seeds and the driver never consults wall-clock time.

Own copy of repro.sim.serving. The arrivals keep numpy's generators, so
one seed gives one request list in both packages; the runtime's device is
the caller's (``SimConfig.make_runtime(..., device=)``).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.encoding import ElemWidth
from repro_torch.core.program import (KernelProgram, ProgramBuilder,
                                      ProgramError)
from repro_torch.core.session import RuntimeSession
from repro_torch.lower._strip import DEFAULT_VLEN, DEFAULT_VREGS, emit_gemm
from repro_torch.sim.metrics import RequestLog

__all__ = [
    "ServingConfig", "Request", "ServingDriver",
    "poisson_arrivals", "bursty_arrivals",
    "weights_program", "prefill_program", "decode_step_program",
]


# ------------------------------------------------------------ configuration
@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Scaled model shapes + slot discipline for a serving run.

    ``kv_max`` bounds a request's total context (prompt + generated); the
    per-request KV buffers are allocated at that capacity once and appended
    into column by column, so admission never reallocates."""

    d: int = 32               # model dim (scaled, per lower_decode_step)
    ff: int = 96              # MLP hidden dim
    kv_max: int = 48          # KV capacity per request (prompt + generated)
    slots: int = 4            # concurrent requests in the batch
    width: ElemWidth = ElemWidth.B
    alpha: float = 0.125      # leakyrelu slope (softmax stand-in)
    seed: int = 0
    vregs: int = DEFAULT_VREGS   # tiling knobs, passed to the strip-miner
    vlen: int = DEFAULT_VLEN


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request: arrival sim time, prompt length, tokens to
    generate (the prefill's first token included)."""

    rid: int
    arrival: int
    prompt_len: int
    max_new: int


# -------------------------------------------------------- arrival processes
def poisson_arrivals(n: int, mean_gap: float, *,
                     prompt_range: tuple[int, int] = (4, 12),
                     new_range: tuple[int, int] = (2, 6),
                     seed: int = 0) -> list[Request]:
    """``n`` requests with exponentially distributed inter-arrival gaps
    (mean ``mean_gap`` cycles) — the open-loop Poisson offered load."""
    rng = np.random.default_rng(seed)
    out, t = [], 0
    for rid in range(n):
        t += int(round(rng.exponential(mean_gap)))
        out.append(Request(
            rid=rid, arrival=t,
            prompt_len=int(rng.integers(prompt_range[0], prompt_range[1] + 1)),
            max_new=int(rng.integers(new_range[0], new_range[1] + 1))))
    return out


def bursty_arrivals(n: int, burst: int, gap: int, *, spread: int = 32,
                    prompt_range: tuple[int, int] = (4, 12),
                    new_range: tuple[int, int] = (2, 6),
                    seed: int = 0) -> list[Request]:
    """Bursty replay: requests land in bursts of ``burst`` (jittered within
    ``spread`` cycles), bursts ``gap`` cycles apart — the tail-latency
    stressor a mean-rate Poisson sweep underestimates."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        base = (rid // burst) * gap
        out.append(Request(
            rid=rid, arrival=base + int(rng.integers(0, spread)),
            prompt_len=int(rng.integers(prompt_range[0], prompt_range[1] + 1)),
            max_new=int(rng.integers(new_range[0], new_range[1] + 1))))
    return sorted(out, key=lambda r: (r.arrival, r.rid))


# --------------------------------------------------------- program builders
def _declare_weights(b: ProgramBuilder, cfg: ServingConfig) -> None:
    """The shared model weights. Declared by every program that reads them,
    but placed exactly once — later programs reuse the prior addresses, so
    the declarations only carry shapes (and the reference oracle's images)."""
    b.buffer("wq", cfg.d, cfg.d, init="random", seed=cfg.seed + 1, lo=-3, hi=3)
    b.buffer("wo", cfg.d, cfg.d, init="random", seed=cfg.seed + 2, lo=-3, hi=3)
    b.buffer("w1", cfg.d, cfg.ff, init="random", seed=cfg.seed + 3,
             lo=-3, hi=3)
    b.buffer("w2", cfg.ff, cfg.d, init="random", seed=cfg.seed + 4,
             lo=-3, hi=3)


def _declare_request(b: ProgramBuilder, cfg: ServingConfig, rid: int) -> None:
    """One request's resident state: the KV cache at full ``kv_max``
    capacity plus the ping-pong activation row and per-step scratch."""
    p = f"r{rid}_"
    b.buffer(p + "x0", 1, cfg.d)
    b.buffer(p + "x1", 1, cfg.d)
    b.buffer(p + "kt", cfg.d, cfg.kv_max)
    b.buffer(p + "v", cfg.kv_max, cfg.d)
    b.buffer(p + "scores", 1, cfg.kv_max)
    b.buffer(p + "probs", 1, cfg.kv_max)
    b.buffer(p + "ctx", 1, cfg.d)
    b.buffer(p + "attn", 1, cfg.d)
    b.buffer(p + "h1", 1, cfg.ff)
    b.buffer(p + "act", 1, cfg.ff)
    b.buffer(p + "h2", 1, cfg.d)


def weights_program(cfg: ServingConfig) -> KernelProgram:
    """An ops-free tape that exists to place the shared weights once; its
    address map seeds the session-wide ``prior`` every later issue merges
    into."""
    b = ProgramBuilder("serving-weights", cfg.width)
    _declare_weights(b, cfg)
    return b.build()


def prefill_program(cfg: ServingConfig, rid: int,
                    prompt_len: int) -> KernelProgram:
    """Request ``rid``'s prefill tape — work proportional to the prompt.

    Each prompt position appends one K column and one V row (identity
    leakyrelu moves from the weight matrices — the integer library has no
    embedding lookup, so weight slices stand in for token embeddings), and
    the final position seeds the activation row ``x0`` the first decode
    step reads: a cross-program RAW carried through the resident cache."""
    if not 1 <= prompt_len <= cfg.kv_max:
        raise ProgramError(f"prefill r{rid}: prompt_len {prompt_len} outside "
                           f"[1, kv_max={cfg.kv_max}]")
    b = ProgramBuilder(f"prefill-r{rid}", cfg.width)
    _declare_weights(b, cfg)
    _declare_request(b, cfg, rid)
    p = f"r{rid}_"
    for s in range(prompt_len):
        b.op("leakyrelu", [b.view("wq", cfg.d, 1, col0=(rid + s) % cfg.d)],
             b.view(p + "kt", cfg.d, 1, col0=s), alpha=1.0,
             comment=f"_leakyrelu(m3, m0)  // r{rid} K append, pos {s}")
        b.op("leakyrelu", [b.view("wo", 1, cfg.d, row0=(rid + s) % cfg.d)],
             b.view(p + "v", 1, cfg.d, row0=s), alpha=1.0,
             comment=f"_leakyrelu(m3, m0)  // r{rid} V append, pos {s}")
    b.op("leakyrelu",
         [b.view("wo", 1, cfg.d, row0=(rid + prompt_len) % cfg.d)],
         b.full(p + "x0"), alpha=1.0,
         comment=f"_leakyrelu(m3, m0)  // r{rid} last-position activation")
    return b.build()


def decode_step_program(cfg: ServingConfig, states: Sequence["SlotState"],
                        step: int) -> KernelProgram:
    """One batched decode step: every ready slot's ops concatenated into a
    single tape, so slots compete for VPUs/queue/cache exactly as a
    continuous batch does. Per slot at KV length ``L`` (all appends and the
    activation read are RAW on bytes the *previous* program left resident):

      K/V append at column/row ``L`` → attention scores over ``L+1``
      positions → leakyrelu (softmax stand-in) → context gather → output
      projection → MLP (W1 → leakyrelu → W2) → next activation row into
      the other ping-pong buffer.
    """
    b = ProgramBuilder(f"decode-step-{step}", cfg.width)
    _declare_weights(b, cfg)
    kw = dict(vregs=cfg.vregs, vlen=cfg.vlen)
    for st in states:
        rid, L = st.rid, st.kv_len
        if L >= cfg.kv_max:
            raise ProgramError(f"decode r{rid}: KV length {L} at capacity "
                               f"{cfg.kv_max}")
        _declare_request(b, cfg, rid)
        p = f"r{rid}_"
        x_cur = b.full(p + ("x1" if st.parity else "x0"))
        x_nxt = b.full(p + ("x0" if st.parity else "x1"))
        b.op("leakyrelu", [b.view("wq", cfg.d, 1, col0=L % cfg.d)],
             b.view(p + "kt", cfg.d, 1, col0=L), alpha=1.0,
             comment=f"_leakyrelu(m3, m0)  // r{rid} K append @ {L}")
        b.op("leakyrelu", [x_cur], b.view(p + "v", 1, cfg.d, row0=L),
             alpha=1.0,
             comment=f"_leakyrelu(m3, m0)  // r{rid} V append @ {L}")
        emit_gemm(b, x_cur, b.view(p + "kt", cfg.d, L + 1),
                  b.view(p + "scores", 1, L + 1), alpha=0.5, **kw,
                  comment=f"_gemm(m3, m0, m1, m2)  // r{rid} scores[0:{L + 1}]")
        b.op("leakyrelu", [b.view(p + "scores", 1, L + 1)],
             b.view(p + "probs", 1, L + 1), alpha=cfg.alpha,
             comment=f"_leakyrelu(m3, m0)  // r{rid} probs (softmax stand-in)")
        emit_gemm(b, b.view(p + "probs", 1, L + 1),
                  b.view(p + "v", L + 1, cfg.d), b.full(p + "ctx"), **kw,
                  comment=f"_gemm(m3, m0, m1, m2)  // r{rid} ctx = p @ V")
        emit_gemm(b, b.full(p + "ctx"), b.full("wo"), b.full(p + "attn"),
                  **kw, comment=f"_gemm(m3, m0, m1, m2)  // r{rid} attn")
        emit_gemm(b, b.full(p + "attn"), b.full("w1"), b.full(p + "h1"),
                  **kw, comment=f"_gemm(m3, m0, m1, m2)  // r{rid} h1")
        b.op("leakyrelu", [b.full(p + "h1")], b.full(p + "act"),
             alpha=cfg.alpha,
             comment=f"_leakyrelu(m3, m0)  // r{rid} MLP activation")
        emit_gemm(b, b.full(p + "act"), b.full("w2"), b.full(p + "h2"),
                  **kw, comment=f"_gemm(m3, m0, m1, m2)  // r{rid} h2")
        b.op("leakyrelu", [b.full(p + "h2")], x_nxt, alpha=1.0,
             comment=f"_leakyrelu(m3, m0)  // r{rid} next activation "
                     f"(ping-pong)")
    return b.build()


# ------------------------------------------------------------------- driver
@dataclasses.dataclass
class SlotState:
    """One admitted request's generation state."""

    rid: int
    prompt_len: int
    max_new: int
    kv_len: int = 0           # KV positions filled (prompt after prefill)
    parity: int = 0           # which ping-pong buffer holds the activation
    tokens: int = 0           # tokens generated (1 at prefill completion)
    ready: bool = False       # prefill finished; eligible for decode steps


class ServingDriver:
    """Drives arrivals → admission → prefill → batched decode over one
    runtime session; collect results with :meth:`run`."""

    def __init__(self, rt_or_cop, cfg: Optional[ServingConfig] = None):
        self.cfg = cfg or ServingConfig()
        self.session = RuntimeSession(rt_or_cop, open_loop=True)
        self.rt = self.session.rt
        self.log = RequestLog(self.rt.metrics)
        self.active: dict[int, SlotState] = {}
        self.waiting: collections.deque[Request] = collections.deque()
        self.steps_issued = 0
        self._step_busy = False
        # Place the shared weights once; every later issue merges into this.
        h = self.session.issue(weights_program(self.cfg))
        self.addrs = h.addrs

    # -------------------------------------------------------------- driving
    def run(self, arrivals: Sequence[Request]) -> dict:
        """Post every arrival onto the timeline, drain to completion, and
        return the request-lifecycle summary (exact percentiles)."""
        for r in arrivals:
            self.session.post(r.arrival, lambda t, r=r: self._arrive(r, t))
        self.session.drain()
        if self.active or self.waiting:
            raise RuntimeError(
                f"drain returned with {len(self.active)} active / "
                f"{len(self.waiting)} queued requests — serving deadlock")
        return self.log.summary(self.session.now())

    # ------------------------------------------------------------ callbacks
    def _arrive(self, r: Request, t: int) -> None:
        # Log the nominal arrival time, not the service time: a frontend
        # stall can delay the callback past r.arrival, and that wait must
        # land in queue_wait/TTFT, not vanish from them.
        self.log.arrive(r.rid, r.prompt_len, r.max_new, r.arrival)
        # Admission control: a request whose context could outgrow kv_max
        # is rejected *here* — with a `serving.rejected` count — instead of
        # blowing up mid-tape in a decode step after cycles were spent on
        # its prefill. kv_len peaks at prompt_len + (max_new - 1).
        if (not 1 <= r.prompt_len <= self.cfg.kv_max
                or r.prompt_len + r.max_new > self.cfg.kv_max + 1):
            self.log.reject(r.rid, t)
            return
        if len(self.active) < self.cfg.slots:
            self._admit(r, t)
        else:
            self.waiting.append(r)

    def _admit(self, r: Request, t: int) -> None:
        self.log.admit(r.rid, t)
        st = SlotState(rid=r.rid, prompt_len=r.prompt_len, max_new=r.max_new,
                       kv_len=r.prompt_len)
        self.active[r.rid] = st
        h = self.session.issue(
            prefill_program(self.cfg, r.rid, r.prompt_len), addrs=self.addrs,
            on_done=lambda t, rid=r.rid: self._prefilled(rid, t))
        self.addrs = h.addrs

    def _prefilled(self, rid: int, t: int) -> None:
        st = self.active[rid]
        st.ready = True
        st.tokens = 1                      # the prefill yields token #1
        self.log.first_token(rid, t)
        if st.tokens >= st.max_new:
            self._finish(rid, t)
        else:
            self._maybe_step(t)

    def _maybe_step(self, t: int) -> None:
        if self._step_busy:
            return
        ready = sorted((st for st in self.active.values() if st.ready),
                       key=lambda st: st.rid)
        if not ready:
            return
        self._step_busy = True
        rids = tuple(st.rid for st in ready)
        prog = decode_step_program(self.cfg, ready, self.steps_issued)
        self.steps_issued += 1
        h = self.session.issue(
            prog, addrs=self.addrs,
            on_done=lambda t, rids=rids: self._step_done(rids, t))
        self.addrs = h.addrs

    def _step_done(self, rids: tuple[int, ...], t: int) -> None:
        self._step_busy = False
        for rid in rids:
            st = self.active[rid]
            st.kv_len += 1
            st.parity ^= 1
            st.tokens += 1
            self.log.token(rid)
            if st.tokens >= st.max_new:
                self._finish(rid, t)
        self._maybe_step(t)

    def _finish(self, rid: int, t: int) -> None:
        self.log.finish(rid, t)
        del self.active[rid]
        while self.waiting and len(self.active) < self.cfg.slots:
            self._admit(self.waiting.popleft(), t)
