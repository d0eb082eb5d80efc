"""The collectives of data-parallel and FSDP training.

The JAX package has no counterpart: XLA inserts these itself from the
shardings.  ``torch.distributed`` gathers and scatters along dim 0, so
a leaf whose fsdp axis is another one moves that axis to the front
(contiguous), goes through the collective and moves it back.  Means
are ``ReduceOp.AVG``, which NCCL computes as a pre-multiplied sum
(exact at one rank: a multiply by 1.0).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# DDP's default bucket size
BUCKET_BYTES = 25 << 20

# torch >= 2.13 names them *_single; older versions only have *_tensor
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def all_gather_leaf(shard: torch.Tensor, axis: int, group=None) -> torch.Tensor:
    """Concatenate every rank's ``shard`` along ``axis``, in rank order."""
    size = dist.get_world_size(group)
    s = shard.movedim(axis, 0).contiguous()
    out = s.new_empty((size * s.shape[0], *s.shape[1:]))
    _all_gather(out, s, group=group)
    return out.movedim(0, axis).contiguous()


def reduce_scatter_leaf(full: torch.Tensor, axis: int, group=None) -> torch.Tensor:
    """The mean over ``group`` of ``full``, this rank's block of ``axis``."""
    size = dist.get_world_size(group)
    f = full.movedim(axis, 0).contiguous()
    out = f.new_empty((f.shape[0] // size, *f.shape[1:]))
    _reduce_scatter(out, f, op=dist.ReduceOp.AVG, group=group)
    return out.movedim(0, axis).contiguous()


def buckets(tensors: list[torch.Tensor], bucket_bytes: int = BUCKET_BYTES) -> list[list[int]]:
    """Indices of ``tensors`` cut into consecutive buckets of one dtype
    and at most ``bucket_bytes`` each (a larger tensor is a bucket of its
    own)."""
    out, cur, cur_bytes = [], [], 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if cur and (cur_bytes + nbytes > bucket_bytes or t.dtype != tensors[cur[0]].dtype):
            out.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        out.append(cur)
    return out


def all_reduce_mean_(tensors: list[torch.Tensor], group=None,
                     bucket_bytes: int = BUCKET_BYTES) -> list[int]:
    """Replace every tensor by its mean over ``group``, in place, in its
    own dtype: one async ``all_reduce`` a bucket (a flat copy of the
    bucket's tensors; a lone contiguous tensor is reduced where it lies),
    all of them waited on, then each copied back.  Returns each bucket's
    bytes."""
    pending = []
    for idx in buckets(tensors, bucket_bytes):
        parts = [tensors[i] for i in idx]
        if len(parts) == 1 and parts[0].is_contiguous():
            flat = parts[0]
        else:
            flat = torch.cat([t.reshape(-1) for t in parts])
        work = dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=group, async_op=True)
        pending.append((work, flat, parts))
    for work, flat, parts in pending:
        work.wait()
        if flat is parts[0]:
            continue
        offset = 0
        for t in parts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return [flat.numel() * flat.element_size() for _, flat, _ in pending]


def sharded_global_norm(grads: dict, specs: dict, group=None) -> torch.Tensor:
    """``optimizer.global_norm`` of the full gradients from this rank's
    shards: the squared sums of the leaves fsdp cuts are summed over the
    fsdp ``group``, the replicated leaves (equal on every rank) counted
    once."""
    sharded, replicated = [], []
    for g, spec in zip(_leaves(grads), _leaves(specs)):
        (sharded if "fsdp" in spec else replicated).append(g.float().square().sum())
    zero = _leaves(grads)[0].new_zeros((), dtype=torch.float32)
    part = torch.stack(sharded).sum() if sharded else zero
    dist.all_reduce(part, op=dist.ReduceOp.SUM, group=group)
    return torch.sqrt(part + (torch.stack(replicated).sum() if replicated else zero))



def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]
