"""The process group and the logical device mesh (the JAX package's
``parallel/mesh.py``).

The JAX package lays its six axes (data, fsdp, seq, tensor, pipe,
expert) over the chips in that order, data outermost.  Here each device
is one ``torch.distributed`` rank and ``init_device_mesh`` lays the
ranks out row-major in the same order, expert innermost.  Axes of size
1 are kept, so every rule can name all six.  The groups a step reduces
over are the ranks that differ only on a set of axes (``axes_group``);
the batch ranks are those of ``(data, fsdp, expert)``; the ranks of
one seq group read the same rows and hold blocks of their tokens; the
ranks of one pipe group read the same rows and hold blocks of the
layers.

Serving has a mesh of its own (``serving_mesh``, JAX ``mesh.py:45-100``):
``(data, model)``, or ``(data, stage, model)`` with a stage axis, model
innermost.  It is one process per coordinate; ``ServingMesh`` holds this
rank's coordinates and its three groups: the model group as a
``TPContext`` (``serving=True``), the data group and the stage group as
``GroupContext``s.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist

from mamba_distributed_tpu_torch.config import MeshConfig
from mamba_distributed_tpu_torch.parallel.pipeline import PipeContext
from mamba_distributed_tpu_torch.parallel.seq_parallel import SeqContext
from mamba_distributed_tpu_torch.parallel.sharding import batch_coordinate
from mamba_distributed_tpu_torch.parallel.tp_layout import TPContext

SERVING_AXES = ("data", "stage", "model")

# the mesh axes a batch's rows split over (expert is a batch axis for every
# layer but the MoE's experts, as in the JAX package)
BATCH_AXES = ("data", "fsdp", "expert")
# the mesh axes a batch's tokens split over: its rows, then their columns
TOKEN_AXES = BATCH_AXES + ("seq",)


def init_distributed(device="cuda", init_method: str | None = None,
                     backend: str | None = None) -> torch.device:
    """Join the process group of a ``torchrun`` launch and return this
    rank's device.

    Reads torchrun's ``RANK``, ``LOCAL_RANK`` and ``WORLD_SIZE``.
    ``backend=None`` follows the device, never what happens to be
    installed: NCCL for a CUDA device, gloo for ``device="cpu"``.
    ``backend="gloo"`` with a CUDA device is asked for by name: it is how
    two ranks share one card (gloo stages CUDA tensors through the host).
    A CUDA ``device`` without an index pins ``cuda:{LOCAL_RANK}``; an
    explicit ``"cuda:0"`` pins every rank to that card, which NCCL
    refuses for a world above one, so that pairing raises here by name.
    A CUDA device with no card, a ``LOCAL_RANK`` past the visible cards,
    or no NCCL raise, and nothing drops to a single process when the
    group cannot form.  ``init_method`` defaults to torchrun's ``env://``
    rendezvous (``MASTER_ADDR``/``MASTER_PORT``); pass ``tcp://`` or
    ``file://`` to rendezvous elsewhere.
    """
    missing = [k for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE") if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"init_distributed: {missing} not set; launch under torchrun "
            f"(torchrun --nproc_per_node=N -m mamba_distributed_tpu_torch.train ...)")
    rank, local = int(os.environ["RANK"]), int(os.environ["LOCAL_RANK"])
    world = int(os.environ["WORLD_SIZE"])
    dev = torch.device(device)
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"init_distributed: backend must be None, 'nccl' or 'gloo', "
                         f"got {backend!r}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: a CUDA device was asked for and no card "
                               "is visible; pass device='cpu' to train over gloo")
        backend = backend or "nccl"
        if backend == "nccl" and not dist.is_nccl_available():
            raise RuntimeError("init_distributed: this PyTorch has no NCCL backend")
        if dev.index is None:
            if local >= torch.cuda.device_count():
                raise RuntimeError(
                    f"init_distributed: LOCAL_RANK {local} names no card, "
                    f"{torch.cuda.device_count()} visible")
            dev = torch.device("cuda", local)
        elif backend == "nccl" and world > 1:
            raise RuntimeError(
                f"init_distributed: every rank of a world of {world} pinned to {dev}: NCCL "
                f"cannot run two ranks on one card; pass backend='gloo' to share it")
        torch.cuda.set_device(dev)
    elif dev.type == "cpu":
        if backend == "nccl":
            raise RuntimeError("init_distributed: NCCL runs on cards, not on the CPU")
        backend = "gloo"
    else:
        raise ValueError(f"init_distributed: no backend for a {dev.type!r} device")
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world)
    return dev


def build_mesh(cfg: MeshConfig, device_type: str):
    """The ``(data, fsdp, seq, tensor, pipe, expert)`` device mesh over
    the process group; the world size must equal ``cfg.num_devices``."""
    world = dist.get_world_size()
    if world != cfg.num_devices:
        raise ValueError(f"mesh {dict(zip(cfg.axis_names, cfg.shape))} wants "
                         f"{cfg.num_devices} ranks, the process group has {world}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, cfg.shape, mesh_dim_names=cfg.axis_names)


def axis_size(mesh, names) -> int:
    """The number of ranks that differ only on the mesh axes ``names``."""
    return math.prod(mesh.mesh.shape[mesh.mesh_dim_names.index(n)] for n in names)


def axes_group(mesh, names):
    """The process group of the ranks that differ from this rank only on
    the mesh axes ``names`` (those above 1; at least one must be).  One
    axis: the device mesh's group.  Several: built once per mesh and
    axes, from ``dist.new_group``, every rank building every such group
    in the same order (so every rank must ask for the same axes in the
    same order); None when it is the whole world (the default group).
    Its rank order is the global ranks' (``dist.new_group`` sorts them):
    the row-major order of the mesh's axes, whatever the order of
    ``names``."""
    cache = mesh.__dict__.setdefault("_axes_groups", {})
    names = tuple(n for n in names if axis_size(mesh, (n,)) > 1)
    if not names:
        raise ValueError("axes_group: every named axis is 1, so the group is this rank alone")
    if len(names) == 1:  # the device mesh built it
        return mesh.get_group(names[0])
    if names in cache:
        return cache[names]
    grid = mesh.mesh
    axes = [mesh.mesh_dim_names.index(n) for n in names]
    rest = [i for i in range(grid.ndim) if i not in axes]
    cols = grid.permute(*rest, *axes).reshape(-1, axis_size(mesh, names))
    mine = None
    if cols.shape[0] > 1:
        me = dist.get_rank()
        for ranks in cols.tolist():
            group = dist.new_group(ranks)
            if me in ranks:
                mine = group
    cache[names] = mine
    return mine


@dataclasses.dataclass(frozen=True)
class RouteContext:
    """What the MoE's global routing needs of the ranks that hold the
    global micro-batch's tokens: their group (the batch and seq ranks),
    the number R of batch ranks and this rank's batch coordinate (its
    block of the rows), the number S of seq ranks and this rank's seq
    coordinate (its block of every row's tokens), and ``order``: the
    group ranks in token order (batch coordinate, then seq coordinate;
    the group's own order is the mesh's, seq before expert), None when
    the two agree."""

    group: object
    size: int
    coord: int
    seq: int = 1
    seq_rank: int = 0
    order: tuple | None = None

    @property
    def index(self) -> int:
        """This rank's place in token order (its group rank is
        ``order.index(index)`` when ``order`` is set)."""
        return self.coord * self.seq + self.seq_rank


@dataclasses.dataclass(frozen=True)
class EPContext:
    """What the MoE needs of the expert group: the group, its size and
    this rank's index in it (it holds experts ``[rank E/size, (rank + 1)
    E/size)``)."""

    group: object
    size: int
    rank: int


def route_context(mesh) -> RouteContext | None:
    """The batch and seq ranks as the MoE routes over them, None when
    there is one (the one-device routing)."""
    size, seq = axis_size(mesh, BATCH_AXES), axis_size(mesh, ("seq",))
    if size * seq == 1:
        return None
    names = mesh.mesh_dim_names
    here = tuple(slice(None) if n in TOKEN_AXES else mesh.get_local_rank(n) for n in names)
    kept = [n for n in names if n in TOKEN_AXES]
    # the token ranks' global ranks in token order; a group's rank is its
    # global rank's place among them
    ranks = mesh.mesh[here].permute(*[kept.index(n) for n in TOKEN_AXES]).reshape(-1).tolist()
    order = tuple(sorted(ranks).index(r) for r in ranks)
    return RouteContext(axes_group(mesh, TOKEN_AXES), size, batch_coordinate(mesh), seq,
                        mesh.get_local_rank("seq"),
                        None if order == tuple(range(len(order))) else order)


def expert_context(mesh) -> EPContext | None:
    """The expert group of ``mesh`` as the MoE takes it, None when the
    expert axis is 1."""
    size = axis_size(mesh, ("expert",))
    if size == 1:
        return None
    return EPContext(mesh.get_group("expert"), size, mesh.get_local_rank("expert"))


def tensor_context(mesh) -> TPContext | None:
    """The tensor group of ``mesh`` as the blocks take it, None when the
    tensor axis is 1."""
    size = mesh.mesh.shape[mesh.mesh_dim_names.index("tensor")]
    if size == 1:
        return None
    return TPContext(mesh.get_group("tensor"), size, mesh.get_local_rank("tensor"))


def seq_context(mesh) -> SeqContext | None:
    """The seq group of ``mesh`` as the sequence-parallel ops take it,
    None when the seq axis is 1."""
    size = axis_size(mesh, ("seq",))
    if size == 1:
        return None
    return SeqContext(mesh.get_group("seq"), size, mesh.get_local_rank("seq"))


def pipe_context(mesh) -> PipeContext | None:
    """The pipe group of ``mesh`` as the pipeline schedule takes it (a
    ``parallel/pipeline.PipeContext``: this rank's stage is its index on
    the axis), None when the pipe axis is 1."""
    size = axis_size(mesh, ("pipe",))
    if size == 1:
        return None
    return PipeContext(mesh.get_group("pipe"), size, mesh.get_local_rank("pipe"))


@dataclasses.dataclass(frozen=True)
class GroupContext:
    """One axis of a serving mesh: its group, size, this rank's index on
    the axis and the group's global ranks in axis order (what a
    broadcast names as its source)."""

    group: object
    size: int
    rank: int
    ranks: tuple


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """This rank's place on a serving mesh (``serving_mesh``): the axis
    sizes and coordinates, the model group (``tp``, None at model 1) and
    the data and stage groups (None at size 1)."""

    data: int
    stage: int
    model: int
    data_rank: int
    stage_rank: int
    model_rank: int
    tp: TPContext | None
    data_ctx: GroupContext | None
    stage_ctx: GroupContext | None

    @property
    def shape(self) -> dict:
        """Axis name -> size, as the JAX ``mesh.shape`` (no stage axis at
        stage 1)."""
        if self.stage == 1:
            return {"data": self.data, "model": self.model}
        return {"data": self.data, "stage": self.stage, "model": self.model}


def serving_mesh(num_shards: int, model_shards: int = 1, stage_shards: int = 1,
                 replicas: int = 1) -> ServingMesh:
    """The serving mesh over the process group (JAX ``serving_mesh``):
    ``(data, model)``, or ``(data, stage, model)`` when ``stage_shards >
    1``, model innermost, so rank ``(d S + s) M + m`` of a mesh sits at
    (data d, stage s, model m).  The world must hold exactly ``replicas``
    meshes of ``num_shards x stage_shards x model_shards`` ranks (one
    process per coordinate; replica k the ranks ``[k n, (k+1) n)``, each
    an engine of its own); a world of one needs no process group.  Every
    rank must call it: it builds every group of each axis above 1 of
    every replica, in the same order."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if model_shards < 1:
        raise ValueError(f"model_shards must be >= 1, got {model_shards}")
    if stage_shards < 1:
        raise ValueError(f"stage_shards must be >= 1, got {stage_shards}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    want = num_shards * stage_shards * model_shards
    if want * replicas > world:
        raise ValueError(
            f"serving mesh wants {num_shards} x {stage_shards} x "
            f"{model_shards} = {want} devices, have {world}")
    if want * replicas < world:
        raise ValueError(
            f"serving mesh of {num_shards} x {stage_shards} x {model_shards} = {want} "
            f"ranks ({replicas} replica(s)) in a world of {world}: the port runs one "
            f"process per mesh coordinate, so the world size must equal the product")
    me = dist.get_rank() if dist.is_initialized() else 0
    D, S, M = num_shards, stage_shards, model_shards
    local = me % want
    d, s, m = local // (S * M), (local // M) % S, local % M

    def rank(k, dd, ss, mm):
        return k * want + (dd * S + ss) * M + mm

    def axis(size, members):
        """This rank's group of an axis above 1 (every rank builds every
        group of the axis, in one order), None at 1."""
        if size == 1:
            return None
        mine = None
        for ranks in members:
            group = dist.new_group(list(ranks))
            if me in ranks:
                mine = GroupContext(group, size, ranks.index(me), tuple(ranks))
        return mine

    reps = range(replicas)
    data_ctx = axis(D, [[rank(k, dd, ss, mm) for dd in range(D)]
                        for k in reps for ss in range(S) for mm in range(M)])
    stage_ctx = axis(S, [[rank(k, dd, ss, mm) for ss in range(S)]
                         for k in reps for dd in range(D) for mm in range(M)])
    model_ctx = axis(M, [[rank(k, dd, ss, mm) for mm in range(M)]
                         for k in reps for dd in range(D) for ss in range(S)])
    tp = None if model_ctx is None else TPContext(model_ctx.group, M, m, serving=True)
    return ServingMesh(D, S, M, d, s, m, tp, data_ctx, stage_ctx)
