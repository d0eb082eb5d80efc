"""Pipeline parallelism over the layer stack (counterpart of the JAX
package's ``parallel/pipeline.py``, ``pipelined_layers``).

The stacked layers are cut on their layer axis over the mesh's ``pipe``
ranks, one contiguous block of layers a stage, and the microbatches
stream through the stages on JAX's GPipe schedule: ``n_micro + S - 1``
clock ticks; at tick t stage s runs its layers on microbatch ``m = t -
s`` (stage 0 injects microbatch t), the last stage keeps microbatch ``t
- (S - 1)``'s output, and every stage hands its output one stage on by
a non-cyclic shift over the pipe group (``collectives.seq_exchange``,
counted in ``PP_COMM``).  Only the last stage holds real outputs.

Where JAX computes on garbage in the bubble ticks (uniform compute is
what its compiler wants), a stage here skips them.  What every stage
keeps is the exchanges: each issues every shift, in the same tick order,
forward and backward, so the ranks' collectives pair up whatever work a
tick holds.  That is why the schedule is one autograd Function with a
hand-written backward (ticks in reverse: receive the output's gradient
from the next stage, back through this stage's layers, send the input's
gradient to the previous one) instead of autograd's walk of a graph,
which would not call the shifts of a bubble tick, whose values no loss
reads.  Each microbatch's stage graph is built in the forward (the
layers checkpointed as the caller's body asks) and released as its
backward runs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from mamba_distributed_tpu_torch.parallel.collectives import PP_COMM, seq_exchange


@dataclasses.dataclass(frozen=True)
class PipeContext:
    """What the schedule needs of the pipe group: the group, its size (the
    stages) and this rank's stage."""

    group: object
    size: int
    rank: int


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    return next(it)


def _shift(x: torch.Tensor, pipe: PipeContext, d: int) -> torch.Tensor:
    """``x`` of stage ``rank - d`` (zeros where it does not exist)."""
    return seq_exchange(x, pipe, d, cyclic=False, comm=PP_COMM)


class _Schedule(torch.autograd.Function):
    """The GPipe schedule over this stage's ``stage(act, leaves)``:
    xs (n_micro, ...) -> outs (n_micro, ...), real on the last stage and
    zeros elsewhere."""

    @staticmethod
    def forward(ctx, stage, pipe, grad, xs, *leaves):
        size, s = (1, 0) if pipe is None else (pipe.size, pipe.rank)
        n_micro = xs.shape[0]
        ticks = n_micro + size - 1
        params = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        graphs = [None] * n_micro
        outs = torch.zeros_like(xs)
        buf = torch.zeros_like(xs[0])
        for t in range(ticks):
            if s == 0 and t < n_micro:
                buf = xs[t]
            m = t - s
            if 0 <= m < n_micro:
                with torch.set_grad_enabled(grad):
                    inp = buf.detach().requires_grad_(grad)
                    y = stage(inp, params)
                if grad:
                    graphs[m] = (inp, y)
                y = y.detach()
                if s == size - 1:
                    outs[m] = y
            else:  # a bubble tick: nothing to compute, the shift still runs
                y = torch.zeros_like(buf)
            if t < ticks - 1 and size > 1:
                buf = _shift(y, pipe, 1)
        ctx.stage_state = (pipe, graphs, params, ticks)
        ctx.xs_shape = xs.shape
        return outs

    @staticmethod
    def backward(ctx, g_outs):
        pipe, graphs, params, ticks = ctx.stage_state
        ctx.stage_state = None
        size, s = (1, 0) if pipe is None else (pipe.size, pipe.rank)
        n_micro = len(graphs)
        wants = [p.requires_grad for p in params]
        g_params = [None] * len(params)
        g_xs = g_outs.new_zeros(ctx.xs_shape)
        g_in = torch.zeros_like(g_xs[0])  # the gradient of this stage's input at tick t + 1
        for t in reversed(range(ticks)):
            # the shift of tick t carried this stage's output on: its
            # gradient comes back from the next stage, and this stage's
            # input gradient of tick t + 1 goes back to the previous one
            g_y = _shift(g_in, pipe, -1) if t < ticks - 1 and size > 1 else None
            m = t - s
            if 0 <= m < n_micro:
                if s == size - 1:
                    g_y = g_outs[m]
                inp, y = graphs[m]
                graphs[m] = None
                wrt = [inp] + [p for p, w in zip(params, wants) if w]
                got = torch.autograd.grad(y, wrt, g_y, allow_unused=True)
                g_in = got[0] if got[0] is not None else torch.zeros_like(inp)
                it = iter(got[1:])
                for i, w in enumerate(wants):
                    g = next(it) if w else None
                    if g is not None:
                        g_params[i] = g if g_params[i] is None else g_params[i] + g
                if s == 0:
                    g_xs[m] = g_in
            else:
                g_in = torch.zeros_like(g_in)
        g_params = [torch.zeros_like(p) if g is None and w else g
                    for p, g, w in zip(params, g_params, wants)]
        return (None, None, None, g_xs, *g_params)


def pipelined_layers(body_fn: Callable, stage_params, xs: torch.Tensor,
                     pipe: PipeContext | None = None) -> torch.Tensor:
    """Run ``body_fn`` over this stage's stacked layers for every
    microbatch, pipelined over ``pipe`` (JAX ``pipelined_layers``).

    ``body_fn(act, layer_params) -> act`` is one layer; ``stage_params``
    is a tree whose leaves carry this stage's layers on a leading axis
    (its block of the layer stack: ``parallel/sharding.stage_block``);
    ``xs`` (n_micro, ...) the activations entering the stack, read on
    stage 0.  Returns (n_micro, ...): on the last stage every
    microbatch's output after all the layers of all the stages, equal to
    a plain loop of ``body_fn`` over the whole stack; zeros on the other
    stages.  ``pipe=None`` is one stage.  Differentiable in ``xs`` (on
    stage 0) and in the stage's params; every stage must call it, and
    autograd must reach its output on every stage (a stage that reads no
    output still runs the backward's shifts)."""
    leaves = _leaves(stage_params)
    n_layers = leaves[0].shape[0]

    def stage(act, flat):
        p = _rebuild(stage_params, iter(flat))
        for i in range(n_layers):
            act = body_fn(act, _index(p, i))
        return act

    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (xs, *leaves))
    return _Schedule.apply(stage, pipe, grad, xs, *leaves)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


class _FromLastStage(torch.autograd.Function):
    """The last stage's value on every stage; the gradient passes to each
    stage's own input."""

    @staticmethod
    def forward(ctx, x, pipe):
        y = x.detach().clone()
        dist.broadcast(y, src=dist.get_global_rank(pipe.group, pipe.size - 1), group=pipe.group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def from_last_stage(x: torch.Tensor, pipe: PipeContext) -> torch.Tensor:
    """The last stage's ``x`` (a loss) on every stage of ``pipe``; a
    stage's gradient of it flows into its own ``x`` (on the stages before
    the last, a zero that reaches the schedule's output, so their
    backward runs its shifts)."""
    return _FromLastStage.apply(x, pipe)
