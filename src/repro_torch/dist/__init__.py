"""Distribution plane: worker meshes and the sharding rules that map every
assigned architecture's trees onto them.

Pure descriptors and tree logic — nothing here allocates on a device
(:meth:`WorkerMesh.torch_devices` is the one call that asks the runtime)
but :func:`~repro_torch.dist.sharding.split_tree` /
:func:`~repro_torch.dist.sharding.join_tree`, which move a tree's leaves
to and from their shards on a mesh's devices.
"""

from repro_torch.dist.meshes import WorkerMesh, plan_worker_meshes
from repro_torch.dist.sharding import (MESH_SIZES, P, Shards, ShardingRules,
                                       batch_specs, cache_specs,
                                       generic_param_specs, join_tree,
                                       mesh_sizes_of, param_specs,
                                       seq_constrainer, split_tree)

__all__ = ["MESH_SIZES", "P", "Shards", "ShardingRules", "WorkerMesh",
           "batch_specs", "cache_specs", "generic_param_specs", "join_tree",
           "mesh_sizes_of", "param_specs", "plan_worker_meshes",
           "seq_constrainer", "split_tree"]
