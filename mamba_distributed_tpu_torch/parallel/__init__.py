"""Data-parallel, FSDP, sequence-parallel, tensor-parallel,
expert-parallel and pipeline-parallel training over
``torch.distributed`` (the JAX package's ``parallel/`` mesh and sharding
rules, for all six axes).

One process per device, started by ``torchrun`` (or by a caller that
sets its ``RANK``, ``LOCAL_RANK`` and ``WORLD_SIZE``): ``mesh`` joins
the process group and builds the device mesh with the JAX axis names,
``sharding`` holds the JAX rules that say which axis of each parameter
an axis of the mesh cuts, ``tp_layout`` the packed per-rank layout of
tensor parallelism (no JAX counterpart: GSPMD needs none), and
``collectives`` moves leaves between their shards and their full form
and holds the blocks' tensor-group autograd collectives (the
collectives XLA inserts itself in the JAX package); ``seq_parallel``,
``ring_attention`` and ``ulysses`` run the mixers and attention on a
rank's block of the sequence, and ``pipeline`` streams microbatches
through the stages of the layer stack.
"""

from mamba_distributed_tpu_torch.parallel.mesh import (
    build_mesh,
    init_distributed,
    pipe_context,
    seq_context,
    tensor_context,
)
from mamba_distributed_tpu_torch.parallel.sharding import (
    batch_coordinate,
    gather_params,
    param_specs,
    shard_params,
)
from mamba_distributed_tpu_torch.parallel.tp_layout import pack_tp, tp_plan, unpack_tp

__all__ = [
    "batch_coordinate",
    "build_mesh",
    "gather_params",
    "init_distributed",
    "pack_tp",
    "param_specs",
    "pipe_context",
    "seq_context",
    "shard_params",
    "tensor_context",
    "tp_plan",
    "unpack_tp",
]
