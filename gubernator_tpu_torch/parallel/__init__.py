from gubernator_tpu_torch.parallel.mesh import (
    MeshPlan,
    make_sharded_table,
    shard_of_key,
)
from gubernator_tpu_torch.parallel.global_sync import (
    GlobalConfig,
    GlobalMirror,
    make_global_sync,
)
from gubernator_tpu_torch.parallel.sharded import ShardedEngine

__all__ = [
    "MeshPlan",
    "make_sharded_table",
    "shard_of_key",
    "GlobalConfig",
    "GlobalMirror",
    "make_global_sync",
    "ShardedEngine",
]
