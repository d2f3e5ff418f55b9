"""Distribution plane: worker meshes and the sharding rules that map every
assigned architecture's trees onto them.

Pure descriptors and tree logic — nothing here allocates on a device
(:meth:`WorkerMesh.torch_devices` is the one call that asks the runtime).
One card runs a one-device mesh; a stage sharded over several cards is
:data:`~repro_torch.dist.sharding.SHARDED_EXECUTION`.
"""

from repro_torch.dist.meshes import WorkerMesh, plan_worker_meshes
from repro_torch.dist.sharding import (MESH_SIZES, SHARDED_EXECUTION, P,
                                       ShardingRules, batch_specs,
                                       cache_specs, generic_param_specs,
                                       mesh_sizes_of, param_specs,
                                       seq_constrainer)

__all__ = ["MESH_SIZES", "P", "SHARDED_EXECUTION", "ShardingRules",
           "WorkerMesh", "batch_specs", "cache_specs", "generic_param_specs",
           "mesh_sizes_of", "param_specs", "plan_worker_meshes",
           "seq_constrainer"]
