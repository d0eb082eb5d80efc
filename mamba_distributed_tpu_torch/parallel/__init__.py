"""Data-parallel and FSDP training over ``torch.distributed`` (the JAX
package's ``parallel/`` mesh and sharding rules, for the ``data`` and
``fsdp`` axes).

One process per device, started by ``torchrun`` (or by a caller that
sets its ``RANK``, ``LOCAL_RANK`` and ``WORLD_SIZE``): ``mesh`` joins
the process group and builds the device mesh with the JAX axis names,
``sharding`` holds the JAX rules that say which axis of each parameter
an axis of the mesh cuts, and ``collectives`` moves leaves between
their shards and their full form (the collectives XLA inserts itself in
the JAX package).  The sequence, tensor, pipeline and expert axes are
later slices: the rules for tensor, expert and pipe are ported (pure,
held against the JAX package's), only fsdp is executed.
"""

from mamba_distributed_tpu_torch.parallel.mesh import build_mesh, init_distributed
from mamba_distributed_tpu_torch.parallel.sharding import (
    batch_coordinate,
    gather_params,
    param_specs,
    shard_params,
)

__all__ = [
    "batch_coordinate",
    "build_mesh",
    "gather_params",
    "init_distributed",
    "param_specs",
    "shard_params",
]
