# repro_torch.obs — the port's observability layer: the metric registry
# and the span tracer (copies of repro.obs.registry and repro.obs.trace),
# the JSON-lines event log and file sinks (repro.obs.export), and the
# torch counterpart of repro.obs.profiler (first-use builds by region,
# allocator gauges, torch.profiler sessions), and the SLO burn-rate
# engine (a copy of repro.obs.slo); trace also holds the program's own
# spans and counters (span, spanned, count, count_device,
# program_spans).
from repro_torch.obs.export import EventLog, write_chrome_trace, write_metrics
from repro_torch.obs.profiler import (BuildWatcher, compile_region,
                                      current_region, device_memory_gauges,
                                      profiler_session, record_build,
                                      version_family_gauges)
from repro_torch.obs.registry import (REGISTRY, Counter, Gauge, Histogram,
                                      MetricRegistry, default_latency_buckets)
from repro_torch.obs.slo import (AlertState, SLOEngine, SLOSpec,
                                 compiles_source, counter_source,
                                 default_serving_slos, latency_source)
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, Span, Tracer,
                                   count, count_device, program_spans, span,
                                   spanned, spans_on)

__all__ = [
    "EventLog", "write_chrome_trace", "write_metrics",
    "BuildWatcher", "compile_region", "current_region",
    "device_memory_gauges", "profiler_session", "record_build",
    "version_family_gauges",
    "REGISTRY", "Counter", "Gauge", "Histogram", "MetricRegistry",
    "default_latency_buckets",
    "AlertState", "SLOEngine", "SLOSpec", "compiles_source",
    "counter_source", "default_serving_slos", "latency_source",
    "NULL_TRACER", "NullTracer", "Span", "Tracer", "count", "count_device",
    "program_spans", "span", "spanned", "spans_on",
]
