# repro_torch.obs — the port's observability layer. So far the metric
# registry alone (a copy of repro.obs.registry), which the path lane
# counts its batches in.
from repro_torch.obs.registry import (REGISTRY, Counter, Gauge, Histogram,
                                      MetricRegistry, default_latency_buckets)

__all__ = ["REGISTRY", "Counter", "Gauge", "Histogram", "MetricRegistry",
           "default_latency_buckets"]
