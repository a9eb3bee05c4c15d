# repro_torch.serve — the distance/path-serving subsystem over the
# port's ISLabelIndex, the counterpart of repro.serve: shape-bucket
# micro-batching, μ-exact routing, LRU caching, metrics, a multi-graph
# registry, a scenario load generator and the batched shortest-path
# lane. Versioned mutation, replica groups and the HTTP front end are
# not ported yet.
from repro_torch.serve.batcher import Batch, MicroBatcher, PendingRequest
from repro_torch.serve.cache import LRUCache
from repro_torch.serve.engine import DistanceServer, PathAnswer, mu_exact_mask
from repro_torch.serve.loadgen import SCENARIOS, Trace, make_trace
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.registry import IndexRegistry
from repro_torch.serve.versions import MutationOp

__all__ = [
    "Batch", "MicroBatcher", "PendingRequest", "LRUCache",
    "DistanceServer", "PathAnswer", "mu_exact_mask", "SCENARIOS", "Trace",
    "make_trace", "ServeMetrics", "IndexRegistry", "MutationOp",
]
