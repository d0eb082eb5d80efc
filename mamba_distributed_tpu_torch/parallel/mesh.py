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

import os

import torch
import torch.distributed as dist

from mamba_distributed_tpu_torch.config import MeshConfig


def init_distributed(device="cuda", init_method: str | None = None) -> torch.device:
    """Join the process group of a ``torchrun`` launch and return this
    rank's device.

    Reads torchrun's ``RANK``, ``LOCAL_RANK`` and ``WORLD_SIZE``; a CUDA
    ``device`` pins ``cuda:{LOCAL_RANK}`` and takes NCCL, ``device="cpu"``
    takes gloo.  The backend follows the device, never what happens to be
    installed: a CUDA device with no card or no NCCL raises, and nothing
    drops to a single process when the group cannot form.
    ``init_method`` defaults to torchrun's ``env://`` rendezvous
    (``MASTER_ADDR``/``MASTER_PORT``); pass ``tcp://`` or ``file://`` to
    rendezvous elsewhere.
    """
    missing = [k for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE") if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"init_distributed: {missing} not set; launch under torchrun "
            f"(torchrun --nproc_per_node=N -m mamba_distributed_tpu_torch.train ...)")
    rank, local = int(os.environ["RANK"]), int(os.environ["LOCAL_RANK"])
    world = int(os.environ["WORLD_SIZE"])
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: a CUDA device was asked for and no card "
                               "is visible; pass device='cpu' to train over gloo")
        if not dist.is_nccl_available():
            raise RuntimeError("init_distributed: this PyTorch has no NCCL backend")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
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
