"""Multi-device parallelism: the key-range-sharded conflict window and
resolve step over a ConflictMesh (the port of foundationdb_tpu/parallel/).

FDB's parallelism axes map onto the mesh's axes:
  * "kr"  -- key-range sharding of conflict resolution (the resolver axis;
            reference ProxyCommitData::keyResolvers fan-out with min-combine,
            CommitProxyServer.actor.cpp:152-181, 800-806): the window is
            sharded by digest range and per-shard partial verdicts are
            combined on the mesh's first device;
  * "q"   -- data parallelism over the query batch.
"""

from .sharded_resolver import (ShardedTorchConflictSet,
                               sharded_state_from_numpy,
                               sharded_state_to_numpy)
from .sharded_window import (ConflictMesh, ShardedWindow, default_mesh_axes,
                             digest_splits, make_conflict_mesh,
                             splits_from_sample)

__all__ = ["ConflictMesh", "ShardedTorchConflictSet", "ShardedWindow",
           "default_mesh_axes", "digest_splits", "make_conflict_mesh",
           "sharded_state_from_numpy", "sharded_state_to_numpy",
           "splits_from_sample"]
