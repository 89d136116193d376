"""repro_torch.sim — the simulator's metrics layer and fault plans.

Counterpart of repro.sim, as far as the serial C-RT
(:class:`repro_torch.core.runtime.CacheRuntime`) needs it:

  * :mod:`repro_torch.sim.metrics` — stall attribution, critical path,
    typed counters/gauges/histograms;
  * :mod:`repro_torch.sim.faults`  — seeded fault injection (ECC bit flips,
    bounded instruction replay, hard VPU faults with graceful degradation).

The pipelined scheduler, events, configs, traces and the serving driver are
not ported yet, so nothing here imports a pipeline.
"""
from repro_torch.sim.faults import (FaultConfig, FaultError, FaultPlan,
                                    KernelFaults, as_fault_plan)
from repro_torch.sim.metrics import (METRICS_SCHEMA_VERSION, STALL_BINS,
                                     Activity, ActivityLog, Counter,
                                     CPSegment, Gauge, Histogram, KernelStall,
                                     MetricsError, MetricsRegistry,
                                     SchedulerMetrics, StallTable,
                                     summarize_critical_path)

__all__ = [
    "FaultConfig", "FaultError", "FaultPlan", "KernelFaults", "as_fault_plan",
    "METRICS_SCHEMA_VERSION", "STALL_BINS", "Activity", "ActivityLog",
    "Counter", "CPSegment", "Gauge", "Histogram", "KernelStall",
    "MetricsError", "MetricsRegistry", "SchedulerMetrics", "StallTable",
    "summarize_critical_path",
]
