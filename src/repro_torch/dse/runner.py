"""Point execution + the parallel worker pool for design-space sweeps
(counterpart of repro.dse.runner).

:func:`run_point` is the unit of work: one serializable point spec in, one
plain-JSON row out, bit for bit the reference's row. Model points run the
scenario's tape on **both** schedulers with the sequential oracle as
referee (golden-tape verification — a sweep row is a verified execution,
not just a timing) and report the pipelined makespan; serving points run
the continuous-batching driver and report goodput. Every row carries the
per-point stall-attribution summary, so when the Pareto join marks a point
dominated, the row itself says *where* its cycles went.

The device. Every runtime of a point is built on one device (its main
memory and cache lines are tensors there): the card unless the caller asks
for the CPU (``device="cpu"``); with no card and no device named,
:func:`run_point` raises. The device is not part of the spec and never
appears in a row: a point gives the same row on the card and on the CPU.

:func:`run_points` fans specs out over a ``ProcessPoolExecutor`` whose
workers are *spawned* (a CUDA context does not survive a fork), each handed
the device by argument, and returns rows in spec order. Several workers on
one card each open a context of their own and share the card in time
slices. A point launches none of the hand-written CUDA kernels (the
simulator's kernel bodies are plain PyTorch on the runtime's device), so
the parent has no kernel to build before it fans out. ``in_process=True``
(or ``jobs=1``, or a single spec) runs the same specs sequentially in the
caller; the tests hold the two paths to identical rows. Rows contain no
wall-clock fields — reruns of the same grid are diffable byte for byte.
"""
from __future__ import annotations

import functools
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.core import (ArcaneCoprocessor, issue_program, place_program,
                              reference_images)
from repro_torch.core.program import ProgramRun
from repro_torch.dse.scenarios import (MODEL_SCENARIOS, SERVING_SCENARIOS,
                                       scenario_kind)
from repro_torch.sim.config import SimConfig, config_from_overrides
from repro_torch.sim.serving import ServingDriver
from repro_torch.sim.trace import Tracer

__all__ = ["run_point", "run_points", "stall_summary", "model_point_images"]


# ---------------------------------------------------------------- summaries
def stall_summary(mrep: dict, top: int = 3) -> dict:
    """Collapse a metrics report's per-kernel stall attribution into one
    point-level summary: total busy/latency, the nonzero stall bins, and
    the ``top`` heaviest bins — the "why this point loses" digest carried
    on every sweep row."""
    if not mrep:
        return {"busy": 0, "latency": 0, "stalls": {}, "top": []}
    bins: dict[str, int] = {}
    busy = latency = 0
    for agg in mrep.get("kernels", {}).values():
        busy += agg["busy"]
        latency += agg["latency"]
        for b, c in agg["stalls"].items():
            if c:
                bins[b] = bins.get(b, 0) + c
    ranked = sorted(bins.items(), key=lambda kv: (-kv[1], kv[0]))
    return {"busy": busy, "latency": latency,
            "stalls": dict(sorted(bins.items())),
            "top": [list(kv) for kv in ranked[:top]]}


def _config_row(cfg: SimConfig) -> dict:
    """The knobs the area model and the front reader need, snapshotted."""
    return {"n_vpus": cfg.n_vpus, "lanes": cfg.lanes,
            "vregs_per_vpu": cfg.vregs_per_vpu,
            "vlen_bytes": cfg.vlen_bytes, "llc_bytes": cfg.llc_bytes,
            "dma_bytes_per_cycle": cfg.dma_bytes_per_cycle,
            "row_chunk": cfg.row_chunk,
            "tiling": list(cfg.tiling) if cfg.tiling else None,
            "reuse": cfg.reuse,
            "reuse_fifo_bytes": (cfg.vregs_per_vpu * cfg.vlen_bytes
                                 if cfg.reuse else 0)}


# ------------------------------------------------------------- point kinds
def _run_model(cfg: SimConfig, scenario: str,
               device: torch.device) -> tuple[dict, dict]:
    """(the point's row fields, the pipelined run's flushed images)."""
    prog = MODEL_SCENARIOS[scenario](vregs_per_vpu=cfg.vregs_per_vpu,
                                     vlen_bytes=cfg.vlen_bytes)
    ref = reference_images(prog, device=device)

    def execute(scheduler: str) -> ProgramRun:
        rt = cfg.make_runtime(scheduler, tracer=Tracer(enabled=False),
                              device=device)
        cop = ArcaneCoprocessor(runtime=rt)
        addrs = place_program(cop, prog)
        issue_program(cop, prog, addrs)
        return ProgramRun(prog=prog, cop=cop, addrs=addrs)

    run_s = execute("serial")
    run_p = execute("pipelined")
    images = run_p.flushed_images()
    run_s.rt.cache.flush_all()
    if not torch.equal(run_s.rt.memory.data, run_p.rt.memory.data):
        raise AssertionError(
            f"{scenario}: serial and pipelined memory images diverged")
    for bname, arr in ref.items():
        if not torch.equal(images[bname], arr):
            raise AssertionError(
                f"{scenario}: buffer {bname} diverged from the oracle")

    serial = run_s.rt.stats.total_cycles
    makespan = run_p.rt.sim_time
    mrep = run_p.rt.metrics_report() if cfg.metrics else {}
    return {
        "kind": "model",
        "n_ops": prog.n_ops,
        "serial_cycles": serial,
        "makespan": makespan,
        "speedup": serial / makespan if makespan else float("inf"),
        "tokens_per_kcycle": None,
        "verified": True,          # the checks above gate reaching this
        "conservation_ok": (mrep.get("conservation_ok", True)
                            if cfg.metrics else True),
        "stall_summary": stall_summary(mrep),
    }, images


def _run_serving_point(cfg: SimConfig, scenario: str,
                       device: torch.device) -> dict:
    scen = SERVING_SCENARIOS[scenario]
    rt = cfg.make_runtime("pipelined", tracer=Tracer(enabled=False),
                          device=device)
    drv = ServingDriver(rt, scen.serving_config(
        vregs_per_vpu=cfg.vregs_per_vpu, vlen_bytes=cfg.vlen_bytes))
    s = drv.run(scen.requests())
    makespan = drv.session.now()
    mrep = rt.metrics_report() if cfg.metrics else {}
    conserved = (rt.metrics.stalls.conservation_ok() if cfg.metrics else True)
    return {
        "kind": "serving",
        "requests": s["requests"],
        "finished": s["finished"],
        "tokens": s["tokens_generated"],
        "steps": drv.steps_issued,
        "serial_cycles": None,
        "makespan": makespan,
        "tokens_per_kcycle": s["goodput_tokens_per_kcycle"],
        "ttft_p50": s["ttft_p50"],
        "ttft_p99": s["ttft_p99"],
        "queue_wait_p99": s["queue_wait_p99"],
        "verified": s["finished"] == s["requests"] and conserved,
        "conservation_ok": conserved,
        "stall_summary": stall_summary(mrep),
    }


# ----------------------------------------------------------------- workers
def _row(spec: dict, cfg: SimConfig, fields: dict) -> dict:
    return {"point_id": spec["point_id"], "scenario": spec["scenario"],
            "labels": dict(spec.get("labels", {})),
            "overrides": dict(spec.get("overrides", {})),
            "config": _config_row(cfg), **fields}


def run_point(spec: dict, *, device=None) -> dict:
    """Execute one point spec (``SweepPoint.to_spec`` shape) on ``device``
    (the card unless the caller asks for the CPU) and return its row:
    identity (point id, labels, overrides), the config snapshot, and the
    verified metrics. Pure function of the spec — no wall-clock, no global
    state, no device — so pool and in-process execution, card and CPU,
    match bit for bit."""
    dev = resolve_device(device)
    cfg = config_from_overrides(spec.get("base", "arcane-default"),
                                spec.get("overrides", {}))
    if scenario_kind(spec["scenario"]) == "model":
        fields, _images = _run_model(cfg, spec["scenario"], dev)
    else:
        fields = _run_serving_point(cfg, spec["scenario"], dev)
    return _row(spec, cfg, fields)


def model_point_images(spec: dict, *, device=None) -> tuple[dict, dict]:
    """A model point's row (as :func:`run_point` gives it) and its
    pipelined run's flushed images, tensors on ``device`` by buffer name:
    what a check of the images against another implementation reads."""
    dev = resolve_device(device)
    cfg = config_from_overrides(spec.get("base", "arcane-default"),
                                spec.get("overrides", {}))
    if scenario_kind(spec["scenario"]) != "model":
        raise ValueError(f"{spec['scenario']!r} is a serving scenario: it "
                         f"leaves no images")
    fields, images = _run_model(cfg, spec["scenario"], dev)
    return _row(spec, cfg, fields), images


def run_points(specs: Sequence[dict], *, jobs: Optional[int] = None,
               in_process: bool = False, device=None) -> list[dict]:
    """Run every spec on ``device`` (the card unless the caller asks for the
    CPU) and return rows in spec order.

    ``in_process=True`` (or a single spec / ``jobs=1``) runs sequentially
    in the calling process; otherwise specs fan out over ``jobs`` spawned
    worker processes (default: one per spec, capped at the CPU count), each
    on the same device."""
    specs = list(specs)
    dev = resolve_device(device)
    if in_process or jobs == 1 or len(specs) <= 1:
        return [run_point(s, device=dev) for s in specs]
    workers = min(len(specs), jobs or os.cpu_count() or 1)
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=multiprocessing.get_context("spawn")
                             ) as ex:
        return list(ex.map(functools.partial(run_point, device=str(dev)),
                           specs))
