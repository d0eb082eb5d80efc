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
  once (``collectives.tp_global_norm``);
* expert parallel (``expert`` above 1, alone or with the three above):
  each rank holds its block of every MoE's experts (and its Adam
  moments), and the MoE moves the routed rows to them and back by
  all-to-alls over the expert group (``lm_loss(..., ep=)``).  Expert is
  a batch axis for everything else.  The gradients are reduced by kind:
  a replicated leaf's is the mean over the batch ranks ``(data, fsdp,
  expert)``; an expert leaf's already sums, through the all-to-all's
  backward, its expert group's tokens, so it is divided by the expert
  size and averaged over ``(data, fsdp)``; an fsdp shard is
  reduce-scattered over fsdp first and then averaged over the batch
  axes that remain.  The norm sums the expert leaves' squares over the
  expert group as well.

Sequence parallel (``seq`` above 1, alone or with data and fsdp): the
ranks of one seq group read the same rows and each runs the model on
its block of the tokens (``lm_loss(..., seq=)``: the conv halo, the SSD
or scan state and the ring or Ulysses exchanges over the seq group).
Each rank's loss is the mean over its tokens, so a replicated leaf's
gradient and the loss are averaged over ``(data, fsdp, expert, seq)``,
and an fsdp shard, reduce-scattered over fsdp, over the rest of them.
The params are replicated over seq, so the norm is unchanged.

Seq composes with tensor (each rank runs the sequence-parallel mixers
on its packed heads) and with expert: an expert group holds one seq
block's tokens, so an expert leaf's gradient is partial over seq too and
is averaged over ``(data, fsdp, seq)`` after the division by the expert
size.

Over every mesh whose batch or seq ranks number more than one, the MoE
routes the global micro-batch as the JAX package's one jit does: a
global capacity, global queue slots and global load-balance terms
(``models/lm._moe_mlp(route=)``).

Pipeline parallel (``pipe`` above 1, alone or with data and fsdp): each
rank holds its stage's layers (``parallel/sharding.stage_block``) and
the replicated rest, and the accum micro-batches are the pipeline's
microbatches: one schedule a step (``models/lm.lm_loss_pipelined``), not
a loop of accumulation.  Stage 0 alone embeds and the last stage alone
runs the head and the loss, so a replicated leaf's gradient is summed
over the pipe group (where no stage double counts it), then every
gradient and the loss are averaged over the batch ranks ``(data,
fsdp)``; the norm sums the stage leaves' squares over the pipe group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mamba_distributed_tpu_torch.config import TrainConfig
from mamba_distributed_tpu_torch.models.lm import lm_loss, lm_loss_pipelined
from mamba_distributed_tpu_torch.parallel.collectives import (
    all_reduce_,
    all_reduce_mean_,
    reduce_scatter_leaf,
    sharded_global_norm,
    sum_shared_,
    tp_global_norm,
)
from mamba_distributed_tpu_torch.parallel.mesh import (
    TOKEN_AXES,
    axes_group,
    axis_size,
    expert_context,
    pipe_context,
    route_context,
    seq_context,
    tensor_context,
)
from mamba_distributed_tpu_torch.parallel.sharding import (
    expert_axis,
    fsdp_axis,
    gather_params,
    pipe_axis,
)
from mamba_distributed_tpu_torch.parallel.tp_layout import FULL_LEAF, plan_tree, tp_plan
from mamba_distributed_tpu_torch.training.optimizer import (
    AdamW,
    global_norm,
    tree_leaves,
    tree_map,
)

# the axes a replicated leaf's gradient and the loss are averaged over:
# the batch ranks and the seq ranks (each rank's loss is its tokens' mean)
MEAN_AXES = TOKEN_AXES


def loss_and_grads(params: dict, cfg: TrainConfig, x: torch.Tensor, y: torch.Tensor,
                   tp=None, route=None, ep=None, seq=None, pipe=None):
    """Mean loss and mean gradients over the accum axis of x, y
    (accum, B, T): (loss 0-d fp32 tensor, grads tree like params).
    ``tp``: the tensor group, ``params`` this rank's packed shard;
    ``route``, ``ep``: the MoE's batch ranks and expert group; ``seq``:
    the seq group, x and y this rank's block of the tokens; ``pipe``:
    the pipe group, ``params`` this rank's stage, the accum micro-batches
    one pipeline schedule (this stage's gradients)."""
    leaves = tree_leaves(params)
    if pipe is not None:
        loss = lm_loss_pipelined(params, cfg.model, x, y, pipe)
        # a stage that does not embed or run the head has no gradient there
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), _rebuild(params, iter(
            torch.zeros_like(p) if gi is None else gi for p, gi in zip(leaves, g)))
    accum = x.shape[0]
    gsum, lsum = None, None
    for i in range(accum):
        loss = lm_loss(params, cfg.model, x[i], y[i], tp=tp, route=route, ep=ep, seq=seq)
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

    With a seq axis x/y are this rank's block of the tokens of its rows.

    With a pipe axis the params are this rank's stage (``specs`` say
    which leaves are stage blocks) and x/y its rows, all of their
    micro-batches; a dense loss only, as in the JAX package.

    ``overflow_threshold`` (``TelemetryConfig``) appends a third output,
    the overflow flag: 1.0 when the pre-clip global norm exceeds the
    threshold or is non-finite, else 0.0, computed on the device from
    the norm the step already has, so it rides the caller's one fetch
    (the host accumulates the flags, obs/sentinel.py)."""
    if cfg.mesh.pipe > 1 and cfg.model.loss_impl == "blocked":
        # the JAX package's refusal (train_step.py:80-87)
        raise NotImplementedError(
            "loss_impl='blocked' is not implemented for pipeline "
            "parallelism (mesh.pipe > 1) — use the dense loss there")
    fsdp = mesh is not None and is_fsdp(cfg)
    # the last step's all-reduce; the closures hold this dict, not ``step``,
    # so a dropped step (and the optimizer and params it holds) is freed
    # at once, not at the next cyclic collection
    comm = {}
    tp, route, ep, seq, pipe = ((tensor_context(mesh), route_context(mesh),
                                 expert_context(mesh), seq_context(mesh), pipe_context(mesh))
                                if mesh is not None else (None,) * 5)
    if fsdp:
        fsdp_group = mesh.get_group("fsdp")
    if mesh is not None:
        if specs is None and (fsdp or tp is not None or ep is not None or pipe is not None):
            raise ValueError("make_train_step: a sharded mesh needs the params' specs")
        spec_leaves = tree_leaves(specs) if specs is not None else None
    if tp is not None or ep is not None or pipe is not None:
        plans = (tree_leaves(plan_tree(specs, tp_plan(cfg.model, tp.size)))
                 if tp is not None else [FULL_LEAF] * len(spec_leaves))
        fsdp_cut = [fsdp and fsdp_axis(s) is not None for s in spec_leaves]
        # the leaves one more axis cuts: the expert axis's experts or the
        # pipe axis's stages (pipe composes with neither expert nor tensor)
        cut_axis, cut_ctx = (expert_axis, ep) if pipe is None else (pipe_axis, pipe)
        cut = [cut_axis(s) is not None for s in spec_leaves] if cut_ctx is not None else None

    def mean_axes(fsdp_cut_: bool, expert_cut_: bool) -> tuple:
        """The batch and seq axes a leaf's gradient is still averaged
        over: those that do not cut it (a tensor-only mesh has none)."""
        gone = {"fsdp"} if fsdp_cut_ else set()
        gone |= {"expert"} if expert_cut_ else set()
        return tuple(a for a in MEAN_AXES if a not in gone)

    # every group the reduction uses, built now in one order on every rank
    if mesh is not None:
        groups = {axes: axes_group(mesh, axes)
                  for axes in (mean_axes(f, e) for f in (False, True) for e in (False, True))
                  if axis_size(mesh, axes) > 1}
        if tp is None and pipe is None and MEAN_AXES not in groups:
            groups[MEAN_AXES] = None  # a world of one reduces, as DDP does

    def norm(grads: dict) -> torch.Tensor:
        if tp is not None or ep is not None or pipe is not None:
            return tp_global_norm(tree_leaves(grads), plans, fsdp_cut,
                                  tp.group if tp is not None else None,
                                  fsdp_group if fsdp else None, cut,
                                  cut_ctx.group if cut_ctx is not None else None)
        if fsdp:
            return sharded_global_norm(grads, specs, fsdp_group)
        return global_norm(grads)

    def reduce(loss, grads):
        """The global loss, gradients (this rank's shards under FSDP) and
        pre-clip norm: under pipe the replicated leaves summed over the
        pipe group first (the embedding's stage and the head's), each
        leaf's fsdp shard reduce-scattered, an expert leaf divided by the
        expert size, then one bucketed mean a group of the batch and seq
        axes that remain (the replicated leaves' and the loss over all of
        them, first)."""
        if mesh is None:
            return loss, grads, global_norm(grads)
        leaves = tree_leaves(grads)
        if tp is not None:
            sum_shared_(leaves, plans, tp.group)
        sizes = []
        if pipe is not None:
            sizes += all_reduce_([g for g, staged in zip(leaves, cut) if not staged],
                                 pipe.group, dist.ReduceOp.SUM)
        out, by_axes = [], {MEAN_AXES: []}
        for i, g in enumerate(leaves):
            spec = spec_leaves[i] if spec_leaves is not None else ()
            f_cut = fsdp and fsdp_axis(spec) is not None
            e_cut = ep is not None and expert_axis(spec) is not None
            if f_cut:
                g = reduce_scatter_leaf(g, fsdp_axis(spec), fsdp_group)
            if e_cut:
                g.div_(ep.size)
            out.append(g)
            by_axes.setdefault(mean_axes(f_cut, e_cut), []).append(g)
        by_axes[MEAN_AXES].append(loss.reshape(1))
        for axes, tensors in by_axes.items():
            if axes in groups:
                sizes += all_reduce_mean_(tensors, groups[axes])
        comm.update(bytes=sum(sizes), buckets=len(sizes))
        grads = _rebuild(grads, iter(out))
        return loss, grads, norm(grads)

    def step(params: dict, x: torch.Tensor, y: torch.Tensor):
        full = (tree_map(lambda t: t.requires_grad_(), gather_params(params, specs, fsdp_group))
                if fsdp else params)
        loss, grads = loss_and_grads(full, cfg, x, y, tp, route, ep, seq, pipe)
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
    shard with a tensor axis, its experts with an expert axis, its stage
    with a pipe axis: the train step's forward, a pipeline of one
    microbatch); over a ``mesh`` x/y are this rank's rows (and its block
    of their tokens with a seq axis), the MoE routes the global batch
    and the loss is the mean over the batch and seq ranks."""
    tp, route, ep, seq, pipe = ((tensor_context(mesh), route_context(mesh),
                                 expert_context(mesh), seq_context(mesh), pipe_context(mesh))
                                if mesh is not None else (None,) * 5)
    # a tensor- or pipe-only mesh has one batch rank and no batch reduction
    spread = mesh is not None and axis_size(mesh, MEAN_AXES) > 1
    batch_reduce = mesh is not None and (spread or (tp is None and pipe is None))
    if batch_reduce:
        bgroup = axes_group(mesh, MEAN_AXES) if spread else None

    @torch.no_grad()
    def eval_step(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if pipe is not None:
            loss = lm_loss_pipelined(params, cfg.model, x[None], y[None], pipe)
        else:
            loss = lm_loss(params, cfg.model, x, y, tp=tp, route=route, ep=ep, seq=seq)
        if batch_reduce:
            dist.all_reduce(loss, op=dist.ReduceOp.AVG, group=bgroup)
        return loss

    return eval_step
