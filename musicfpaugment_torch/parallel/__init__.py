"""The parallel layer: device meshes, placement helpers, the process group
and the sharded augmenter (port of musicfpaugment_tpu/parallel)."""

from musicfpaugment_torch.parallel.augment_sharded import ShardedAugmenter, shard_draws
from musicfpaugment_torch.parallel.mesh import (
    DATA_AXIS,
    batch_sharding,
    init_multihost,
    make_mesh,
    replicate,
    replicated,
    shard_batch,
)

__all__ = [
    "ShardedAugmenter",
    "shard_draws",
    "DATA_AXIS",
    "batch_sharding",
    "init_multihost",
    "make_mesh",
    "replicate",
    "replicated",
    "shard_batch",
]
