"""Full-state checkpoints: params, optimizer state, loader cursor, step
and the sampling generator's state, so a resumed run reproduces the
uninterrupted run's losses exactly.

One ``torch.save`` file per step in the checkpoint directory
(``ckpt_{step:08d}.pt``), written to a temporary name and renamed, so a
crash never leaves a truncated file under a checkpoint's name; the
newest three are kept, as the JAX package's Orbax manager keeps three.
The Orbax layout of the JAX package is not carried over.

A data-parallel or FSDP run (``training/trainer.py``) writes the same
file from rank 0: the full params and moments gathered from the shards,
the loader cursor of batch rank 0, and under ``loaders`` every batch
rank's cursor.  A world-N run resumes from it at world N, and its
params, moments and rank-0 cursor load into a one-device trainer.
"""

from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"ckpt_(\d{8})\.pt$")
KEEP = 3


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(directory) if (m := _NAME.match(f)))


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def save_checkpoint(directory: str, step: int, params: dict, opt_state: dict,
                    loader_state: dict, rng_state: torch.Tensor,
                    loaders: list[dict] | None = None) -> str:
    """Write one checkpoint; returns its path.  ``loaders``: every batch
    rank's loader cursor, in batch-coordinate order (a mesh run)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    ck = {"step": step, "params": _detach(params), "opt_state": _detach(opt_state),
          "loader": dict(loader_state), "rng": rng_state}
    if loaders is not None:
        ck["loaders"] = [dict(s) for s in loaders]
    torch.save(ck, tmp)
    os.replace(tmp, path)
    for old in _steps(directory)[:-KEEP]:
        os.remove(os.path.join(directory, f"ckpt_{old:08d}.pt"))
    return path


def restore_checkpoint(directory: str, step: int | None = None) -> dict:
    """The checkpoint of ``step`` (the newest when None) as a dict with
    keys step, params, opt_state, loader, rng and, from a mesh run,
    loaders (tensors on the CPU)."""
    steps = _steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoint found in {directory}")
    step = steps[-1] if step is None else step
    path = os.path.join(directory, f"ckpt_{step:08d}.pt")
    # the file holds tensors, dicts and ints that save_checkpoint wrote
    return torch.load(path, map_location="cpu", weights_only=True)
