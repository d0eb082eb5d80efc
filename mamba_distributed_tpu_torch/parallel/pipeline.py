"""Pipeline parallelism over the layer stack (counterpart of the JAX
package's ``parallel/pipeline.py``: ``pipelined_layers`` for training,
``pipelined_decode_layers`` for the serving tick).

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

``pipelined_decode_layers`` is the serving decode step's clock on the
same schedule, with no autograd: the microbatches are blocks of the
decode lanes, and every layer's recurrent state stays on the stage that
owns the layer, advanced in place on the microbatch's rows (a bubble
tick touches none).  Its shifts run over a serving mesh's stage group
and count in ``SERVE_COMM``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from mamba_distributed_tpu_torch.parallel.collectives import PP_COMM, seq_exchange, stage_shift


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


def pipelined_decode_layers(body_fn: Callable, stage_params: list, stage_state: tuple,
                            act: tuple, stage, n_micro: int | None = None,
                            n_layer: int | None = None):
    """One stateful decode sub-step over the layer stack, GPipe-pipelined
    over a serving mesh's stage group (JAX ``pipelined_decode_layers``,
    ``pipeline.py:151-311``).

    ``stage_params``: this stage's layers (a list of per-layer trees);
    ``stage_state``: their layer-stacked state leaves (L_local, S, ...),
    lane axis 1, advanced IN PLACE; ``act``: a tuple of (S, ...) leaves,
    every lane (stage 0's are read); ``body_fn(act, layer_params,
    layer_state) -> act`` runs one layer on one lane block and writes
    its state rows in place.  ``n_layer``: the whole stack's depth (this
    stage's times the stages by default); ``n_micro`` (default the stage
    count) must divide the lanes.  The clock runs ``n_micro + S - 1``
    ticks; at tick t stage s runs microbatch ``m = t - s`` (lanes ``[m
    S/n_micro, (m + 1) S/n_micro)``) through its layers when ``0 <= m <
    n_micro``, then every stage shifts its block one stage on
    (non-cyclic).  Each lane meets the same ops in the same order as in
    the sequential layer loop.  Returns ``(act_out, stage_state)``,
    ``act_out`` on the last stage only (None elsewhere: the caller's head
    runs there, as JAX's psum from the last stage feeds it)."""
    n_stages = 1 if stage is None else stage.size
    s = 0 if stage is None else stage.rank
    n_layer = len(stage_params) * n_stages if n_layer is None else n_layer
    if n_layer % n_stages != 0:
        raise ValueError(
            f"pipelined_decode_layers: n_layer ({n_layer}) must divide "
            f"evenly over the {n_stages} pipeline stages of mesh axis 'stage'")
    n_lanes = act[0].shape[0]
    n_micro = n_stages if n_micro is None else n_micro
    if n_lanes % n_micro != 0:
        raise ValueError(
            f"pipelined_decode_layers: lane count ({n_lanes}) must "
            f"divide over n_micro ({n_micro}) microbatches")
    mw = n_lanes // n_micro
    n_ticks = n_micro + n_stages - 1
    buf = tuple(x[:mw] for x in act)
    outs = []
    for t in range(n_ticks):
        if s == 0 and t < n_micro:
            buf = tuple(x[t * mw:(t + 1) * mw] for x in act)
        m = t - s
        if 0 <= m < n_micro:
            lanes = slice(m * mw, (m + 1) * mw)
            for j, bp in enumerate(stage_params):
                buf = body_fn(buf, bp, tuple(x[j, lanes] for x in stage_state))
            if s == n_stages - 1:
                outs.append(buf)
        if n_stages > 1 and t + 1 < n_ticks:
            buf = tuple(stage_shift(x, stage) for x in buf)
    if s != n_stages - 1:
        return None, stage_state
    return tuple(torch.cat(parts) for parts in zip(*outs)), stage_state
