"""repro_torch.sim — event-driven pipelined C-RT scheduler + trace subsystem.

Layout:
  * :mod:`repro_torch.sim.events`   — deterministic event queue + resource
    timelines (+ :class:`Timeline`, the open-ended clock external events
    post onto)
  * :mod:`repro_torch.sim.pipeline` — :class:`PipelinedRuntime` (overlapped
    phases)
  * :mod:`repro_torch.sim.serving`  — continuous-batching workload driver
    over the open-loop session API (arrivals, slots, prefill/decode tapes)
  * :mod:`repro_torch.sim.config`   — YAML configs with ``extends``
    composition (the builtins as dicts: no pyyaml needed)
  * :mod:`repro_torch.sim.trace`    — Chrome ``trace_event`` export
  * :mod:`repro_torch.sim.metrics`  — stall attribution, critical path, typed
    counters/gauges/histograms (the unified metrics layer)
  * :mod:`repro_torch.sim.faults`   — seeded fault injection (ECC bit flips,
    bounded instruction replay, hard VPU faults with graceful degradation)

The serial :class:`repro_torch.core.runtime.CacheRuntime` and the pipelined
scheduler share the same decode/allocate/compute/retire steps, so their
kernel outputs are bit-identical; only the modeled timing differs.

Counterpart of repro.sim, module for module. The scheduling (events, the
pipelined event loop, configs, traces, the serving driver) is host Python
on host metadata, as the reference's; the bytes the steps move are tensors
on the runtime's device (the card unless the caller asks for the CPU).
"""
from repro_torch.sim.config import (ConfigError, SimConfig, apply_overrides,
                                    builtin_config_path, config_from_overrides,
                                    deep_merge, load_config, load_raw,
                                    merge_overrides)
from repro_torch.sim.events import (ChunkTrain, Event, EventQueue, Interval,
                                    Resource, TileTrain, Timeline,
                                    interleave_blocks, row_chunks,
                                    split_proportional, tile_entries)
from repro_torch.sim.metrics import (METRICS_SCHEMA_VERSION, STALL_BINS,
                                     Activity, ActivityLog, Counter,
                                     CPSegment, Gauge, Histogram, KernelStall,
                                     MetricsError, MetricsRegistry,
                                     RequestLog, RequestRecord,
                                     SchedulerMetrics, StallTable,
                                     summarize_critical_path)
from repro_torch.sim.faults import (FaultConfig, FaultError, FaultPlan,
                                    KernelFaults, as_fault_plan)
from repro_torch.sim.pipeline import (DeadlockError, PipelinedRuntime,
                                      PipelineReport, ReuseEntry)
from repro_torch.sim.serving import (Request, ServingConfig, ServingDriver,
                                     bursty_arrivals, poisson_arrivals)
from repro_torch.sim.trace import (PHASES, CounterRecord, FlowRecord,
                                   TraceRecord, Tracer)

__all__ = [
    "ConfigError", "SimConfig", "apply_overrides", "builtin_config_path",
    "config_from_overrides", "deep_merge", "load_config", "load_raw",
    "merge_overrides", "ChunkTrain", "Event", "EventQueue",
    "Interval", "Resource", "TileTrain", "Timeline", "interleave_blocks",
    "row_chunks", "split_proportional", "tile_entries", "DeadlockError",
    "FaultConfig", "FaultError", "FaultPlan", "KernelFaults", "as_fault_plan",
    "PipelinedRuntime",
    "PipelineReport", "ReuseEntry", "Request", "ServingConfig",
    "ServingDriver", "bursty_arrivals", "poisson_arrivals",
    "PHASES", "TraceRecord", "Tracer",
    "CounterRecord", "FlowRecord", "METRICS_SCHEMA_VERSION", "STALL_BINS",
    "Activity", "ActivityLog", "Counter", "CPSegment", "Gauge", "Histogram",
    "KernelStall", "MetricsError", "MetricsRegistry", "RequestLog",
    "RequestRecord", "SchedulerMetrics", "StallTable",
    "summarize_critical_path",
]
