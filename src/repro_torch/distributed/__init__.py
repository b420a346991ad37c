"""Multi-GPU serving (port of ``repro.distributed``): the sharding rules and
the process groups the SPMD forward runs its collectives over. The JAX
package's ``compression`` (the int8 cross-pod gradient all-reduce) belongs
to sharded training and is not ported yet."""
from repro_torch.distributed import comm, sharding
from repro_torch.distributed.sharding import (MeshAxes, PartitionSpec, Rules,
                                              ShardedParams, infer_axes,
                                              mesh_fingerprint, shard_params)

__all__ = ["comm", "sharding", "MeshAxes", "PartitionSpec", "Rules",
           "ShardedParams", "infer_axes", "mesh_fingerprint", "shard_params"]
