"""Data-parallel sampling, attribution and training over a device mesh.

The port of `synt_isic_tpu/parallel/` (`mesh.py`, `sharded_sampler.py`,
`multihost.py`), exporting the same names; `replicas.py` holds what XLA
does there for a sharded jit (module replicas, the per-device threads, the
gradient sum).
"""
from .mesh import create_mesh, batch_sharding, replicated_sharding, shard_batch
from .sharded_sampler import ShardedSampler
from .multihost import (initialize as initialize_multihost, is_multihost,
                        hybrid_mesh, local_batch_bounds, global_batch_array,
                        broadcast_from_host0, sync_hosts, host0_only)

__all__ = ["create_mesh", "batch_sharding", "replicated_sharding",
           "shard_batch", "ShardedSampler", "initialize_multihost",
           "is_multihost", "hybrid_mesh", "local_batch_bounds",
           "global_batch_array", "broadcast_from_host0", "sync_hosts",
           "host0_only"]
