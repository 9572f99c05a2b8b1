"""Parallelism layer (port of the JAX package's ``parallel/``): named
device meshes over the ranks of a ``torch.distributed`` process group,
the sharding rules as tuples of mesh-axis names, and the multi-process
bootstrap. One process drives one rank; the code on a rank is
rank-local (it holds its slice and calls the collectives itself), where
JAX drove every chip of an island from one process through
``shard_map``."""
from .distributed import (
    WorldError, distributed_init_from_env, self_worker_id, spawn,
    worker_addresses,
)
from .mesh import MeshSpec, make_mesh, multislice_mesh
from .sharding import (
    logical_axis_rules, mesh_coords, rank_slice, shard_params_spec,
)

__all__ = [
    "MeshSpec",
    "make_mesh",
    "multislice_mesh",
    "logical_axis_rules",
    "shard_params_spec",
    "rank_slice",
    "mesh_coords",
    "distributed_init_from_env",
    "worker_addresses",
    "self_worker_id",
    "spawn",
    "WorldError",
]
