"""The process group and the logical device mesh (the JAX package's
``parallel/mesh.py``).

The JAX package lays its six axes (data, fsdp, seq, tensor, pipe,
expert) over the chips in that order, data outermost.  Here each device
is one ``torch.distributed`` rank and ``init_device_mesh`` lays the
ranks out row-major in the same order, so rank ``r``'s coordinate on
the ``(data, fsdp)`` axes is ``divmod(r, fsdp)`` while the other axes
are 1.  Axes of size 1 are kept, so every rule can name all six.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from mamba_distributed_tpu_torch.config import MeshConfig
from mamba_distributed_tpu_torch.parallel.tp_layout import TPContext


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


def batch_group(mesh):
    """The process group of the batch ranks: those that differ from this
    rank only on the mesh axes data and fsdp.  Built once per mesh, from
    ``dist.new_group``, every rank building every such group in the same
    order; None when it is the whole world (the default group)."""
    if hasattr(mesh, "_batch_group"):
        return mesh._batch_group
    grid = mesh.mesh
    axes = [mesh.mesh_dim_names.index(n) for n in ("data", "fsdp")]
    rest = [i for i in range(grid.ndim) if i not in axes]
    cols = grid.permute(*rest, *axes).reshape(-1, math.prod(grid.shape[i] for i in axes))
    mine = None
    if cols.shape[0] > 1:
        me = dist.get_rank()
        for ranks in cols.tolist():
            group = dist.new_group(ranks)
            if me in ranks:
                mine = group
    mesh._batch_group = mine
    return mine


def tensor_context(mesh) -> TPContext | None:
    """The tensor group of ``mesh`` as the blocks take it, None when the
    tensor axis is 1."""
    size = mesh.mesh.shape[mesh.mesh_dim_names.index("tensor")]
    if size == 1:
        return None
    return TPContext(mesh.get_group("tensor"), size, mesh.get_local_rank("tensor"))
