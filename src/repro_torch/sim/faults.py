"""Deterministic fault injection + recovery plans for the scheduler stack.

Own copy of repro.sim.faults. The plan draws from numpy generators, as the
reference's does, so one FaultConfig plants the same faults in both
packages; the flips land in the cache's torch data array.

The ARCANE offload contract gives the controller a natural recovery point:
every kernel's operands are resident (single residency) when it executes, so
a detected error can be scrubbed or replayed *at the kernel boundary* without
unwinding partial state. This module models that story with three fault
classes mapped onto three recovery tiers:

1. **Transient cache-line bit flips** filtered by a SECDED ECC model.
   A single-bit flip in a freshly DMA-ed source line is corrected in place
   (the syndrome pinpoints the bit) for a configurable ``ecc_penalty``
   cycle charge. A double-bit flip is *detected* but uncorrectable —
   SECDED escalates it, and the controller re-fetches the source region
   from main memory (the clean architectural copy) with replay backoff.
2. **Detected DMA/compute corruption** triggers bounded **instruction
   replay**: the kernel's destination is recomputed from its (still
   resident, still clean) sources, with ``replay_backoff * (attempt+1)``
   cycles of backoff per attempt, up to ``max_replays`` attempts. The
   cycles land in the ``fault_replay`` stall bin so per-kernel
   ``busy + Σ stalls == latency`` conservation survives injection.
3. **Hard faults** (``hard_at``/``hard_vpu``, or replay-budget exhaustion)
   **offline the VPU**: the datapath is fenced, its residents are
   consolidated back to memory, and pending work re-dispatches across the
   surviving VPUs. Only when the *last* VPU dies does the run abort with
   :class:`FaultError`.

Determinism is load-bearing. A :class:`FaultPlan` draws one
:class:`KernelFaults` outcome per *kernel id* from
``np.random.default_rng([seed, kernel_id])`` — keyed by the id alone, never
by dispatch time or VPU choice — so the serial and pipelined schedulers see
the same faults for the same program, and a re-run reproduces the plan
bit-for-bit. Tests bypass the rates entirely with an explicit ``schedule``
of per-kernel entries.

The recovery tiers are *functionally exact* by construction: injection
really flips bits in the modeled SRAM array, and recovery really re-fetches
or recomputes, so a run whose faults are all recoverable flushes a memory
image bit-identical to the fault-free run — the invariant the differential
fuzzer locks in.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["FaultConfig", "FaultError", "FaultPlan", "KernelFaults",
           "as_fault_plan"]


class FaultError(RuntimeError):
    """An unrecoverable fault condition: the last healthy VPU went offline
    (degradation has nowhere left to degrade to)."""


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Knobs for the ``faults:`` YAML section (all rates per *kernel*).

    ``flip_rate``/``corrupt_rate`` drive the seeded random plan;
    ``schedule`` pins explicit per-kernel outcomes for tests (entries win
    over the random draw). ``hard_at``/``hard_vpu`` schedule one hard fault:
    at the first scheduler step at or after cycle ``hard_at``, VPU
    ``hard_vpu`` is fenced and drained. ``hard_at == 0`` disables it."""

    flip_rate: float = 0.0           # P(an ECC event hits a kernel's fetch)
    double_bit_fraction: float = 0.25  # P(uncorrectable | ECC event)
    corrupt_rate: float = 0.0        # P(a compute attempt is corrupted)
    max_replays: int = 3             # replay budget before the VPU is fenced
    ecc_penalty: int = 32            # cycles per ECC scrub (correct/detect)
    replay_backoff: int = 64         # backoff base: attempt i waits (i+1)*base
    hard_at: int = 0                 # cycle of the scheduled hard fault
    hard_vpu: int = 0                # victim VPU of the scheduled hard fault
    seed: int = 0                    # fault-plan RNG seed
    schedule: tuple = ()             # explicit per-kernel overrides (dicts)

    def __post_init__(self):
        for field in ("flip_rate", "double_bit_fraction", "corrupt_rate"):
            v = getattr(self, field)
            if not 0.0 <= float(v) <= 1.0:
                raise ValueError(f"faults.{field} must be in [0, 1], got {v}")
        for field in ("max_replays", "ecc_penalty", "replay_backoff",
                      "hard_at", "hard_vpu", "seed"):
            v = getattr(self, field)
            if int(v) < 0:
                raise ValueError(f"faults.{field} must be >= 0, got {v}")
        object.__setattr__(self, "schedule", tuple(self.schedule or ()))
        for ent in self.schedule:
            if not isinstance(ent, dict) or "kernel" not in ent:
                raise ValueError(f"faults.schedule entries need a 'kernel' "
                                 f"id, got {ent!r}")
            kind = ent.get("kind", "single")
            if kind not in ("single", "double", "corrupt", "hard"):
                raise ValueError(
                    f"faults.schedule kind must be one of "
                    f"single|double|corrupt|hard, got {kind!r}")

    @property
    def is_noop(self) -> bool:
        """True when no fault source is armed — the runtime skips the plan
        entirely, so a zero-rate config is bit- and cycle-identical to no
        ``faults:`` section at all."""
        return (self.flip_rate == 0.0 and self.corrupt_rate == 0.0
                and self.hard_at == 0 and not self.schedule)


@dataclasses.dataclass(frozen=True)
class KernelFaults:
    """The drawn fault outcome for one kernel.

    ``ecc_bits`` is the ECC tier: 0 = clean fetch, 1 = single-bit flip
    (corrected in place), 2 = double-bit flip (detected, re-fetched).
    ``replays`` is how many corrupted compute attempts precede the clean
    one; ``exhausted`` means the corruption outlasted the replay budget —
    the final attempt still completes on scrubbed state, but the VPU is
    fenced as faulty immediately after the kernel retires."""

    ecc_bits: int = 0
    replays: int = 0
    exhausted: bool = False

    @property
    def any(self) -> bool:
        return bool(self.ecc_bits or self.replays or self.exhausted)


def _from_schedule_entry(ent: dict, max_replays: int) -> KernelFaults:
    kind = ent.get("kind", "single")
    n = int(ent.get("replays", 1) or 1)
    if kind == "single":
        return KernelFaults(ecc_bits=1)
    if kind == "double":
        return KernelFaults(ecc_bits=2, replays=0)
    if kind == "corrupt":
        return KernelFaults(replays=min(n, max_replays),
                            exhausted=n > max_replays)
    # "hard": the corruption never clears — the whole budget burns, then
    # the VPU is fenced.
    return KernelFaults(replays=max_replays, exhausted=True)


class FaultPlan:
    """Memoized per-kernel fault outcomes + the recovery cost model.

    One plan per runtime. ``kernel_faults(kid)`` is a pure function of
    ``(seed, kid)`` (or the explicit schedule), so both schedulers — and a
    re-run under a different engine mode — draw identical faults."""

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        self._memo: dict[int, Optional[KernelFaults]] = {}
        # Later schedule entries win, mirroring YAML override layering.
        self._schedule: dict[int, dict] = {
            int(ent["kernel"]): ent for ent in cfg.schedule}

    def kernel_faults(self, kid: int) -> Optional[KernelFaults]:
        """The fault outcome for kernel ``kid`` (None = clean run)."""
        if kid in self._memo:
            return self._memo[kid]
        kf = self._draw(kid)
        if kf is not None and not kf.any:
            kf = None
        self._memo[kid] = kf
        return kf

    def _draw(self, kid: int) -> Optional[KernelFaults]:
        ent = self._schedule.get(kid)
        if ent is not None:
            return _from_schedule_entry(ent, self.cfg.max_replays)
        cfg = self.cfg
        if cfg.flip_rate == 0.0 and cfg.corrupt_rate == 0.0:
            return None
        rng = np.random.default_rng([cfg.seed, kid])
        ecc_bits = 0
        if rng.random() < cfg.flip_rate:
            ecc_bits = 2 if rng.random() < cfg.double_bit_fraction else 1
        failed = 0
        while failed <= cfg.max_replays and rng.random() < cfg.corrupt_rate:
            failed += 1
        return KernelFaults(ecc_bits=ecc_bits,
                            replays=min(failed, cfg.max_replays),
                            exhausted=failed > cfg.max_replays)

    def backoff(self, attempt: int) -> int:
        """Cycle cost of waiting out replay ``attempt`` (0-based): linear
        backoff, so retry storms get progressively more expensive."""
        return self.cfg.replay_backoff * (attempt + 1)

    def flip_position(self, kid: int, salt: int, n_bytes: int) -> tuple[int, int]:
        """Deterministic ``(byte, bit)`` flip target within ``n_bytes`` —
        keyed by ``(seed, kid, salt)`` so every injection site (ECC bits,
        each corrupt attempt) lands on its own reproducible position."""
        rng = np.random.default_rng([self.cfg.seed, kid, salt])
        return int(rng.integers(max(1, n_bytes))), int(rng.integers(8))


def as_fault_plan(faults) -> Optional[FaultPlan]:
    """Coerce the runtime's ``faults=`` argument into a plan (or None).

    Accepts None, a :class:`FaultPlan`, a :class:`FaultConfig`, or a plain
    dict of :class:`FaultConfig` fields. No-op configs collapse to None so
    the schedulers' hot paths stay branch-free when faults are off."""
    if faults is None:
        return None
    if isinstance(faults, FaultPlan):
        return None if faults.cfg.is_noop else faults
    if isinstance(faults, dict):
        faults = FaultConfig(**faults)
    if not isinstance(faults, FaultConfig):
        raise TypeError(f"faults must be a FaultConfig, FaultPlan, dict or "
                        f"None, got {type(faults).__name__}")
    return None if faults.is_noop else FaultPlan(faults)
