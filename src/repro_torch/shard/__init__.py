# repro_torch.shard — partitioned IS-LABEL indexes with batched querying
# over P label blocks: ancestor-partitioned blocks (top hierarchy levels
# replicated), per-shard stages and one cross-shard reduction a batch,
# bitwise equal to the unsharded QueryEngine. The counterpart of
# repro.shard; shard_devices takes the place of make_shard_mesh.
from repro_torch.shard.partition import (REPLICATED, STRATEGIES, LabelBlocks,
                                         assign_shards, partition_labels,
                                         unpartition_labels)
from repro_torch.shard.query import ShardedQueryEngine
from repro_torch.shard.sharded_index import (PLACEMENT, ShardedIndex,
                                             shard_devices)

__all__ = [
    "REPLICATED", "STRATEGIES", "LabelBlocks", "assign_shards",
    "partition_labels", "unpartition_labels", "ShardedQueryEngine",
    "ShardedIndex", "PLACEMENT", "shard_devices",
]
