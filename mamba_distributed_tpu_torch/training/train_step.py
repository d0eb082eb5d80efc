"""Train and eval steps with gradient accumulation (counterpart of the
JAX package's ``training/train_step.py``).

The JAX step is one jit: a ``lax.scan`` over the leading accum axis
sums the micro-batch gradients, then divides by accum, takes the global
norm before the clip, and applies the optimizer.  Here the same runs
eagerly: a Python loop over the micro-batches, ``torch.autograd.grad``
for each, the same sums and divisions, then ``AdamW.step`` in place.

Over a mesh (one ``torch.distributed`` rank per device, ``parallel/``)
each rank runs that loop on its block of the batch rows, and the
collectives XLA inserts from the JAX shardings are explicit:

* DDP (``shard_params`` off): one bucketed mean all-reduce of the
  gradients and the loss over the batch ranks ``(data, fsdp)`` a step,
  after the last micro-batch (the reference syncs DDP on the last
  micro-step only);
* FSDP (``shard_params`` on, fsdp above 1): the params and AdamW moments
  live as shards; the step gathers the full params, runs the same loop,
  reduce-scatters the mean gradients onto the shards (then averages them
  over ``data``), takes the global norm from the shards and updates the
  shards.  The full params are freed when the step returns;
* tensor parallel (``tensor`` above 1, alone or with the two above):
  each rank holds its packed tensor shard (``parallel/tp_layout.py``)
  and the blocks run their column/row collectives over the tensor group
  (``lm_loss(..., tp=)``).  The gradients of the positions every tensor
  rank holds whole are summed over the tensor group before the batch
  reduction (each rank's covers its own heads only); the replicated
  leaves' gradients are already equal on every tensor rank.  FSDP
  gathers and reduce-scatters over fsdp only, and the global norm
  counts a rank's own positions once per shard and the replicated ones
  once (``collectives.tp_global_norm``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mamba_distributed_tpu_torch.config import TrainConfig
from mamba_distributed_tpu_torch.models.lm import lm_loss
from mamba_distributed_tpu_torch.parallel.collectives import (
    all_reduce_mean_,
    reduce_scatter_leaf,
    sharded_global_norm,
    sum_shared_,
    tp_global_norm,
)
from mamba_distributed_tpu_torch.parallel.mesh import batch_group, tensor_context
from mamba_distributed_tpu_torch.parallel.sharding import fsdp_axis, gather_params
from mamba_distributed_tpu_torch.parallel.tp_layout import plan_tree, tp_plan
from mamba_distributed_tpu_torch.training.optimizer import (
    AdamW,
    global_norm,
    tree_leaves,
    tree_map,
)


def loss_and_grads(params: dict, cfg: TrainConfig, x: torch.Tensor, y: torch.Tensor,
                   tp=None):
    """Mean loss and mean gradients over the accum axis of x, y
    (accum, B, T): (loss 0-d fp32 tensor, grads tree like params).
    ``tp``: the tensor group, ``params`` this rank's packed shard."""
    leaves = tree_leaves(params)
    accum = x.shape[0]
    gsum, lsum = None, None
    for i in range(accum):
        loss = lm_loss(params, cfg.model, x[i], y[i], tp=tp)
        g = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        if gsum is None:
            gsum, lsum = list(g), loss
        else:  # in place: autograd.grad returns fresh tensors
            for a, b in zip(gsum, g):
                a.add_(b)
            lsum = lsum + loss
    if accum > 1:
        for v in gsum:
            v.div_(accum)
        lsum = lsum / accum
    return lsum, _rebuild(params, iter(gsum))


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    return next(it)


def is_fsdp(cfg: TrainConfig) -> bool:
    """Params and moments live as fsdp shards."""
    return cfg.shard_params and cfg.mesh.fsdp > 1


def make_train_step(cfg: TrainConfig, optimizer: AdamW, mesh=None, specs: dict | None = None,
                    overflow_threshold: float | None = None):
    """``step(params, x, y) -> (loss, grad_norm)`` with x/y (accum, B, T);
    ``params`` is updated in place.  The norm is the pre-clip global norm.
    All outputs are 0-d fp32 tensors on the params' device: the caller
    fetches them in one transfer.

    ``mesh`` (``parallel/mesh.build_mesh``; None: one device, the step
    as it always was) makes x/y this rank's rows and adds the DDP or
    FSDP collectives; ``specs`` (``parallel/sharding.param_specs``) says
    which leaves are fsdp shards.  The loss and norm are then the global
    ones, equal on every rank.  ``step.comm`` holds the bytes and buckets
    of the last step's gradient all-reduce.

    With a tensor axis the params are this rank's packed shard and
    ``specs`` those of the packed tree (``sharding.executed_specs``).

    ``overflow_threshold`` (``TelemetryConfig``) appends a third output,
    the overflow flag: 1.0 when the pre-clip global norm exceeds the
    threshold or is non-finite, else 0.0, computed on the device from
    the norm the step already has, so it rides the caller's one fetch
    (the host accumulates the flags, obs/sentinel.py)."""
    fsdp = mesh is not None and is_fsdp(cfg)
    # the last step's all-reduce; the closures hold this dict, not ``step``,
    # so a dropped step (and the optimizer and params it holds) is freed
    # at once, not at the next cyclic collection
    comm = {}
    tp = tensor_context(mesh) if mesh is not None else None
    # a tensor-only mesh has one batch rank and no batch reduction
    batch_reduce = mesh is not None and (cfg.data_parallel_size > 1 or tp is None)
    if batch_reduce:
        bgroup = batch_group(mesh)
    if fsdp:
        fsdp_group, data_group = mesh.get_group("fsdp"), mesh.get_group("data")
    if fsdp or tp is not None:
        spec_leaves = tree_leaves(specs)
    if tp is not None:
        plans = tree_leaves(plan_tree(specs, tp_plan(cfg.model, tp.size)))
        fsdp_cut = [fsdp and fsdp_axis(s) is not None for s in spec_leaves]

    def norm(grads: dict) -> torch.Tensor:
        if tp is not None:
            return tp_global_norm(tree_leaves(grads), plans, fsdp_cut, tp.group,
                                  fsdp_group if fsdp else None)
        if fsdp:
            return sharded_global_norm(grads, specs, fsdp_group)
        return global_norm(grads)

    def reduce(loss, grads):
        """The global loss, gradients (this rank's shards under FSDP) and
        pre-clip norm."""
        if mesh is None:
            return loss, grads, global_norm(grads)
        leaves = tree_leaves(grads)
        if tp is not None:
            sum_shared_(leaves, plans, tp.group)
        if not fsdp:
            # one bucketed mean over the batch ranks, the loss in the last bucket
            sizes = (all_reduce_mean_([*leaves, loss.reshape(1)], bgroup)
                     if batch_reduce else [])
            comm.update(bytes=sum(sizes), buckets=len(sizes))
            return loss, grads, norm(grads)
        out, replicated, sharded = [], [], []
        for g, spec in zip(leaves, spec_leaves):
            ax = fsdp_axis(spec)
            if ax is None:
                replicated.append(g)
                out.append(g)
            else:
                out.append(reduce_scatter_leaf(g, ax, fsdp_group))
                sharded.append(out[-1])
        sizes = all_reduce_mean_([*replicated, loss.reshape(1)], bgroup)
        if cfg.mesh.data > 1:
            sizes += all_reduce_mean_(sharded, data_group)
        comm.update(bytes=sum(sizes), buckets=len(sizes))
        grads = _rebuild(grads, iter(out))
        return loss, grads, norm(grads)

    def step(params: dict, x: torch.Tensor, y: torch.Tensor):
        full = (tree_map(lambda t: t.requires_grad_(), gather_params(params, specs, fsdp_group))
                if fsdp else params)
        loss, grads = loss_and_grads(full, cfg, x, y, tp)
        del full
        loss, grads, grad_norm = reduce(loss, grads)
        optimizer.step(params, grads, grad_norm)
        if overflow_threshold is not None:
            overflow = ~torch.isfinite(grad_norm) | (grad_norm > overflow_threshold)
            return loss, grad_norm, overflow.to(grad_norm.dtype)
        return loss, grad_norm

    step.comm = comm
    return step


def make_eval_step(cfg: TrainConfig, mesh=None):
    """Loss-only step, x/y (B, T), on full params (this rank's packed
    shard with a tensor axis: the train step's forward); over a ``mesh``
    x/y are this rank's rows and the loss is the mean over the batch
    ranks."""
    tp = tensor_context(mesh) if mesh is not None else None
    batch_reduce = mesh is not None and (cfg.data_parallel_size > 1 or tp is None)
    if batch_reduce:
        bgroup = batch_group(mesh)

    @torch.no_grad()
    def eval_step(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        loss = lm_loss(params, cfg.model, x, y, tp=tp)
        if batch_reduce:
            dist.all_reduce(loss, op=dist.ReduceOp.AVG, group=bgroup)
        return loss

    return eval_step
