"""repro_torch.obs — dependency-free tracing, attribution, and exposition.

Port of `repro.obs`, the serving path's instrument panel (DESIGN.md §12):

* `trace` — thread-safe monotonic-clock `Span`/`Tracer` with parent
  links, per-span attributes and CUDA-event device times, a ring-buffer
  `TraceLog` with the offset to `torch.profiler`'s epoch clock, and
  Chrome/Perfetto ``trace_event`` JSON export.
* `attrib` — folds finished spans into a per-stage wall-time ledger
  (enqueue-wait → seed/filter → graph prefilter → DC filter → shard
  scatter → host merge → align → emit) and renders the Amdahl report:
  serial fraction, per-stage p50/p99, projected speedup from sharding
  each stage.
* `http` — stdlib exposition endpoint serving ``/metrics`` (the
  engine's `Metrics.render()`), ``/healthz``, ``/trace`` (last-N
  spans), ``/attrib`` (the live Amdahl report), and ``/roofline``
  (the per-kernel roofline table).
* `roofline` — kernel-level roofline layer (DESIGN.md §13): exact
  analytic op/byte counters per align dispatch site, pluggable JSON
  `DeviceSpec` roofline targets (``h100_sxm``, ``gpu_generic``,
  ``cpu_host``), and the DC kernels' device time from `torch.profiler`.

Stdlib-only at import by design: it must import (and stay cheap) in
every environment the serving path runs in — the roofline module's
measured side imports `torch` only when asked.
"""
from .attrib import (AttributionReport, StageLedger, build_ledger,
                     render_report)
from .http import ObsServer
from .roofline import (DeviceSpec, KernelCounters, RooflineManager,
                       align_counters, dc_window_counters)
from .trace import NULL_TRACER, Span, StageTimer, TraceLog, Tracer

__all__ = [
    "Span", "Tracer", "TraceLog", "StageTimer", "NULL_TRACER",
    "StageLedger", "AttributionReport", "build_ledger", "render_report",
    "ObsServer",
    "DeviceSpec", "KernelCounters", "RooflineManager", "align_counters",
    "dc_window_counters",
]
