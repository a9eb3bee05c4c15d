# repro_torch.serve — the distance/path-serving subsystem over the
# port's ISLabelIndex and ShardedIndex, the counterpart of repro.serve:
# shape-bucket micro-batching, μ-exact routing, LRU caching, metrics, a
# multi-graph registry, a scenario load generator, the batched
# shortest-path lane, versioned copy-on-write mutation under live
# traffic, replica groups with straggler health, and an asyncio HTTP
# front end.
from repro_torch.serve.batcher import Batch, MicroBatcher, PendingRequest
from repro_torch.serve.cache import LRUCache
from repro_torch.serve.engine import DistanceServer, PathAnswer, mu_exact_mask
from repro_torch.serve.frontend import (HttpClient, ServiceFrontend,
                                        SSEReader, replay_http)
from repro_torch.serve.loadgen import SCENARIOS, Trace, make_trace
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.registry import IndexRegistry
from repro_torch.serve.replicas import ReplicaSet
from repro_torch.serve.versions import (FamilyCapacityError, IndexVersion,
                                        LabelBlockStore, MutationOp,
                                        VersionFamily, VersionManager,
                                        VersionState)

__all__ = [
    "Batch", "MicroBatcher", "PendingRequest", "LRUCache",
    "DistanceServer", "PathAnswer", "mu_exact_mask", "SCENARIOS", "Trace",
    "make_trace", "ServeMetrics", "IndexRegistry", "ReplicaSet",
    "ServiceFrontend", "HttpClient", "SSEReader", "replay_http",
    "FamilyCapacityError", "IndexVersion", "LabelBlockStore", "MutationOp",
    "VersionFamily", "VersionManager", "VersionState",
]
