"""repro_torch.shard — reference sharding with scatter/merge on torch devices.

Port of `repro.shard` (DESIGN.md §11): the reference (linear or
variation graph) is cut into shards with overlap halos (`partition` /
`graph_partition`), placed one device per shard or all on one device;
reads scatter to every shard for independent seeding + filtering
(`mapper` / `graph_mapper`); per-shard winners reduce on the device by
an argmin over a packed order-preserving int64 key (`merge`; the host
lexicographic rule survives as the oracle ``merge_host``); and one align
call finishes the winners — optionally cut into per-shard blocks
(``align_sharded``) and dispatched without host synchronisation through
the ``start``/``finish`` surface (``pipelined``).  `failover` routes the
scatter stage through `repro_torch.dist.fault.WorkQueue` leases so a
lost shard re-queues instead of dropping reads.  Output is
byte-identical to the single-device mappers at any shard count.
"""
from . import merge
from .failover import map_batch_with_failover, map_batch_with_failover_graph
from .graph_mapper import (ShardedGraphMapExecutor, get_graph_executor,
                           map_batch_sharded_graph)
from .graph_partition import (EpochedShardedGraphIndex, GraphShardArrays,
                              ShardedGraphIndex, from_epoched_graph,
                              shard_graph_index)
from .mapper import (PendingBatch, ShardedMapExecutor, get_executor,
                     map_batch_sharded, required_halo, validate_geometry)
from .partition import (DEFAULT_HALO, EpochedShardedIndex, ShardArrays,
                        ShardLayout, ShardedIndex, build_sharded_index,
                        from_epoched, plan_layout, resolve_devices)

__all__ = [
    "DEFAULT_HALO", "EpochedShardedGraphIndex", "EpochedShardedIndex",
    "GraphShardArrays", "PendingBatch", "ShardArrays", "ShardLayout",
    "ShardedGraphIndex", "ShardedGraphMapExecutor", "ShardedIndex",
    "ShardedMapExecutor", "build_sharded_index", "from_epoched",
    "from_epoched_graph", "get_executor", "get_graph_executor",
    "map_batch_sharded", "map_batch_sharded_graph",
    "map_batch_with_failover", "map_batch_with_failover_graph", "merge",
    "plan_layout", "required_halo", "resolve_devices",
    "shard_graph_index", "validate_geometry",
]
