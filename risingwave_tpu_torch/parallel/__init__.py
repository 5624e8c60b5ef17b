"""Vnode-sharded operators over the logical shards of one card.

Port of ``risingwave_tpu/parallel/``: the reference routes rows by
hash(dist key) → vnode → shard over a device mesh, with an on-device
bucketize + ``all_to_all``. Here the shards are a leading axis of the
state on one card, and the exchange is one routing kernel that writes
each row into its owner's block.

    mesh         ShardMesh: n logical shards, the vnode → owner map
    exchange     route (the hash exchange) and its host twins
    agg          ShardedAggKernel: the vnode-sharded grouped aggregation
    join         ShardedJoinKernel: the vnode-sharded join matcher
"""

from risingwave_tpu_torch.parallel.agg import ShardedAggKernel
from risingwave_tpu_torch.parallel.exchange import route, route_plain
from risingwave_tpu_torch.parallel.join import ShardedJoinKernel
from risingwave_tpu_torch.parallel.mesh import ShardMesh

__all__ = ["ShardMesh", "ShardedAggKernel", "ShardedJoinKernel", "route",
           "route_plain"]
