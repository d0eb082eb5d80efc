"""The collectives of data-parallel, FSDP, tensor-parallel and
expert-parallel training.

The JAX package has no counterpart: XLA inserts these itself from the
shardings.  Tensor parallelism's three autograd Functions over the
tensor group (``copy_to_tp``, ``reduce_from_tp``, ``all_reduce_tp``)
are the identity when the block has no group (``tp=None``); every
all-reduce they run, and the step's gradient and norm sums over the
tensor group, add to ``TP_COMM``.  The MoE's global routing exchanges
each rank's per-expert choice counts (``gather_counts``) and sums its
load-balance terms both ways (``route_sum``) over the batch ranks;
expert parallelism moves the routed rows with ``all_to_all`` over the
expert group, whose backward is the reverse all-to-all.  All three add
to ``EP_COMM``.  Sequence parallelism moves blocks of the sequence
between the seq ranks: ``seq_shift`` hands each rank the value of the
rank ``d`` before it (the conv halo, the SSD and scan state exchange,
the ring's kv hops) and ``seq_all_to_all`` turns a sequence cut into a
head cut and back (Ulysses); both are autograd Functions whose backward
moves the gradient the other way, and both add to ``SP_COMM``.  The
pipeline's stage-to-stage shifts are the same exchange over the pipe
group and add to ``PP_COMM``.
``torch.distributed`` gathers and scatters along dim 0, so a leaf whose
fsdp axis is another one moves that axis to the front
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
    own dtype (``all_reduce_``)."""
    return all_reduce_(tensors, group, dist.ReduceOp.AVG, bucket_bytes)


def all_reduce_(tensors: list[torch.Tensor], group, op,
                bucket_bytes: int = BUCKET_BYTES) -> list[int]:
    """Replace every tensor by its reduction ``op`` over ``group``, in
    place, in its own dtype: one async ``all_reduce`` a bucket (a flat
    copy of the bucket's tensors; a lone contiguous tensor is reduced
    where it lies), all of them waited on, then each copied back.
    Returns each bucket's bytes."""
    pending = []
    for idx in buckets(tensors, bucket_bytes):
        parts = [tensors[i] for i in idx]
        if len(parts) == 1 and parts[0].is_contiguous():
            flat = parts[0]
        else:
            flat = torch.cat([t.reshape(-1) for t in parts])
        work = dist.all_reduce(flat, op=op, group=group, async_op=True)
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



# tensor-group all-reduces (and head gathers) since the last reset: count
# and bytes
TP_COMM = {"calls": 0, "bytes": 0}


def tp_all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` (contiguous) over the tensor ``group`` in place."""
    TP_COMM["calls"] += 1
    TP_COMM["bytes"] += t.numel() * t.element_size()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _CopyToTP(torch.autograd.Function):
    """Identity forward, gradient summed over the tensor group: the
    replicated input of a column-parallel block."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return tp_all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """Sum over the tensor group forward, identity backward: the partial
    output of a row-parallel projection that feeds the replicated
    stream."""

    @staticmethod
    def forward(ctx, x, group):
        return tp_all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceTP(torch.autograd.Function):
    """Sum over the tensor group both ways: a sum that feeds every rank's
    own channels afterwards (Mamba-1's ``x_proj`` output, the gated
    norm's sum of squares), so each rank's gradient of it is partial."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return tp_all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return tp_all_reduce_(g.contiguous().clone(), ctx.group), None


class _GatherTP(torch.autograd.Function):
    """Every tensor rank's ``x`` concatenated along ``axis`` in rank
    order; the backward keeps this rank's block of the gradient.  It
    serves values of which each rank then keeps only its own block's
    results (the heads of a Ulysses exchange the local heads cannot
    feed: every head's output depends on that head's inputs alone), so
    no other rank's gradient reaches this rank's block."""

    @staticmethod
    def forward(ctx, x, tp, axis):
        ctx.tp, ctx.axis, ctx.n = tp, axis, x.shape[axis]
        TP_COMM["calls"] += 1
        TP_COMM["bytes"] += x.numel() * x.element_size()
        return torch.cat(all_gather_list(x, tp.group), axis)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.axis, ctx.tp.rank * ctx.n, ctx.n), None, None


def gather_heads_tp(x: torch.Tensor, tp, axis: int) -> torch.Tensor:
    """``x``'s heads (``axis``) of every tensor rank of ``tp``, in rank
    order (the global heads of the packed layout); differentiable, the
    gradient of this rank's own heads only."""
    return _GatherTP.apply(x, tp, axis)


def copy_to_tp(x: torch.Tensor, tp) -> torch.Tensor:
    return x if tp is None else _CopyToTP.apply(x, tp.group)


def reduce_from_tp(x: torch.Tensor, tp) -> torch.Tensor:
    return x if tp is None else _ReduceFromTP.apply(x, tp.group)


def all_reduce_tp(x: torch.Tensor, tp) -> torch.Tensor:
    return x if tp is None else _AllReduceTP.apply(x, tp.group)


def sum_shared_(grads: list, plans: list, group) -> None:
    """Sum over the tensor ``group``, in place, the gradients of the
    positions every tensor rank holds whole (``"partial"`` leaves): one
    flat all-reduce."""
    picked = []
    for g, lp in zip(grads, plans):
        if lp.kind == "partial":
            ax = g.ndim + lp.axis
            idx = torch.as_tensor(lp.shared, dtype=torch.long, device=g.device)
            picked.append((g, ax, idx, g.index_select(ax, idx)))
    if not picked:
        return
    flat = tp_all_reduce_(torch.cat([p.reshape(-1) for *_, p in picked]), group)
    offset = 0
    for g, ax, idx, p in picked:
        g.index_copy_(ax, idx, flat[offset:offset + p.numel()].view_as(p))
        offset += p.numel()


def tp_global_norm(grads: list, plans: list, fsdp_cut: list, tensor_group,
                   fsdp_group=None, cut: list | None = None, cut_group=None) -> torch.Tensor:
    """``optimizer.global_norm`` of the full gradients from this rank's
    packed (and, where ``fsdp_cut``, fsdp-sharded; where ``cut``, cut by
    one more axis: the expert axis's experts or the pipe axis's stages)
    leaves: the positions a tensor rank holds alone count once per shard
    (summed over the tensor group; with no tensor group every leaf is
    ``"full"``), the replicated ones once; the leaves fsdp cuts are
    summed over ``fsdp_group`` as well, and those ``cut`` marks over
    ``cut_group``."""
    zero = grads[0].new_zeros((), dtype=torch.float32)
    # [own positions, replicated positions] x [fsdp-cut, whole] x [cut, whole]
    acc = [[[zero, zero], [zero, zero]], [[zero, zero], [zero, zero]]]
    for i, (g, lp, sharded) in enumerate(zip(grads, plans, fsdp_cut)):
        g = g.float()
        col = 0 if sharded else 1
        ex = 0 if cut is not None and cut[i] else 1
        if lp.kind == "full":
            acc[1][col][ex] = acc[1][col][ex] + g.square().sum()
            continue
        if lp.kind == "partial":
            ax = g.ndim + lp.axis
            own = torch.as_tensor(lp.own, dtype=torch.long, device=g.device)
            shared = torch.as_tensor(lp.shared, dtype=torch.long, device=g.device)
            acc[1][col][ex] = acc[1][col][ex] + g.index_select(ax, shared).square().sum()
            g = g.index_select(ax, own)
        acc[0][col][ex] = acc[0][col][ex] + g.square().sum()
    # the fsdp-cut terms summed over fsdp, then the other cut ones over their axis
    for group, picks in ((fsdp_group, [(o, 0, e) for o in (0, 1) for e in (0, 1)]),
                         (cut_group, [(o, c, 0) for o in (0, 1) for c in (0, 1)])):
        if group is None:
            continue
        part = torch.stack([acc[o][c][e] for o, c, e in picks])
        dist.all_reduce(part, op=dist.ReduceOp.SUM, group=group)
        for j, (o, c, e) in enumerate(picks):
            acc[o][c][e] = part[j]
    own, sharded, whole = ((acc[o][c][0] + acc[o][c][1]) for o, c in ((0, 0), (1, 0), (1, 1)))
    own = own + acc[0][1][0] + acc[0][1][1]
    if tensor_group is not None:
        own = tp_all_reduce_(own.reshape(1), tensor_group)[0]
    return torch.sqrt(own + sharded + whole)


# the MoE's routing exchanges over the batch ranks (the choice counts, the
# load-balance sums) and its all-to-alls over the expert group since the
# last reset: count and bytes (sent by this rank)
EP_COMM = {"calls": 0, "bytes": 0, "route_calls": 0, "route_bytes": 0}


def gather_counts(counts: torch.Tensor, group, size: int) -> torch.Tensor:
    """Every batch rank's (k, E) integer choice counts, stacked in the
    group's rank order: (size, k, E).  One all-gather; it also gives
    every rank the split sizes of every all-to-all of the layer."""
    EP_COMM["route_calls"] += 1
    EP_COMM["route_bytes"] += counts.numel() * counts.element_size()
    out = counts.new_empty((size * counts.shape[0], *counts.shape[1:]))
    _all_gather(out, counts.contiguous(), group=group)
    return out.reshape(size, *counts.shape)


def _route_all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    EP_COMM["route_calls"] += 1
    EP_COMM["route_bytes"] += t.numel() * t.element_size()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _RouteSum(torch.autograd.Function):
    """Sum over the batch ranks both ways: the load-balance sums feed
    every rank's loss, so each rank's gradient of them is its own loss's
    share (the step's batch mean then gives the global gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _route_all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _route_all_reduce_(g.contiguous().clone(), ctx.group), None


def route_sum(x: torch.Tensor, route) -> torch.Tensor:
    """``x`` summed over the batch ranks of ``route`` (``RouteContext``),
    gradient summed too."""
    return _RouteSum.apply(x, route.group)


def _all_to_all(x: torch.Tensor, send: list, recv: list, group) -> torch.Tensor:
    """Rows ``x`` cut into ``send[i]`` rows for expert rank i; returns the
    ``recv[i]`` rows from each rank i, in rank order."""
    EP_COMM["calls"] += 1
    EP_COMM["bytes"] += x.numel() * x.element_size()
    out = x.new_empty((sum(recv), *x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), recv, send, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """The expert group's all-to-all of routed rows; its backward sends
    the rows' gradients back the way they came."""

    @staticmethod
    def forward(ctx, x, send, recv, group):
        ctx.send, ctx.recv, ctx.group = send, recv, group
        return _all_to_all(x, send, recv, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.recv, ctx.send, ctx.group), None, None, None


def all_to_all(x: torch.Tensor, send: list, recv: list, ep) -> torch.Tensor:
    """``x``'s rows, ``send[i]`` of them for rank i of the expert group
    ``ep`` (``EPContext``), exchanged for the ``recv[i]`` rows each rank
    i sends this one (differentiable)."""
    return _AllToAll.apply(x, send, recv, ep.group)


# the seq group's exchanges since the last reset: count and bytes (sent by
# this rank)
SP_COMM = {"calls": 0, "bytes": 0}
# the pipe group's shifts of the pipeline schedule, likewise
PP_COMM = {"calls": 0, "bytes": 0}


def seq_exchange(x: torch.Tensor, seq, d: int, cyclic: bool, comm: dict = SP_COMM
                 ) -> torch.Tensor:
    """The value of ``x`` on seq rank ``rank - d`` (mod the size when
    ``cyclic``; zeros where that rank does not exist).  One
    ``all_to_all_single`` over the seq group in which every rank sends
    its whole ``x`` to rank ``rank + d`` (mod the size) and receives from
    rank ``rank - d``, so the sends and receives pair up on every rank
    and no rank sends to itself (``0 < |d| < size``); a rank whose sender
    does not exist drops what it receives.  ``seq`` is any group context
    with ``group``, ``size`` and ``rank`` (the pipeline's too), and the
    exchange is counted in ``comm``.  Returns a fresh contiguous
    tensor."""
    n, r = seq.size, seq.rank
    flat = x.detach().contiguous().reshape(-1)
    send, recv = [0] * n, [0] * n
    send[(r + d) % n], recv[(r - d) % n] = flat.numel(), flat.numel()
    comm["calls"] += 1
    comm["bytes"] += flat.numel() * flat.element_size()
    out = torch.empty_like(flat)
    dist.all_to_all_single(out, flat, recv, send, group=seq.group)
    if not cyclic and not 0 <= r - d < n:
        return torch.zeros_like(x, memory_format=torch.contiguous_format)
    return out.view(x.shape)


class _SeqShift(torch.autograd.Function):
    """``seq_exchange`` forward; the gradient goes back ``d`` ranks the
    other way (the backward of JAX's ``ppermute`` over the seq axis)."""

    @staticmethod
    def forward(ctx, x, seq, d, cyclic):
        ctx.seq, ctx.d, ctx.cyclic = seq, d, cyclic
        return seq_exchange(x, seq, d, cyclic)

    @staticmethod
    def backward(ctx, g):
        return seq_exchange(g, ctx.seq, -ctx.d, ctx.cyclic), None, None, None


def seq_shift(x: torch.Tensor, seq, d: int = 1, cyclic: bool = False) -> torch.Tensor:
    """The value of ``x`` on the seq rank ``d`` before this one
    (``seq``: a ``SeqContext``); zeros into the first ``d`` ranks unless
    ``cyclic``, where rank r receives rank ``(r - d) mod size``'s.
    Differentiable; every seq rank must call it, in the same order."""
    return _SeqShift.apply(x, seq, d, cyclic)


def _tiled_all_to_all(x: torch.Tensor, seq, split_axis: int, concat_axis: int) -> torch.Tensor:
    n = seq.size
    parts = torch.stack(x.chunk(n, split_axis)).contiguous()
    SP_COMM["calls"] += 1
    SP_COMM["bytes"] += parts.numel() * parts.element_size()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=seq.group)
    return torch.cat(out.unbind(0), concat_axis)


class _SeqAllToAll(torch.autograd.Function):
    """JAX's tiled ``all_to_all`` over the seq axis; its backward is the
    reverse all-to-all."""

    @staticmethod
    def forward(ctx, x, seq, split_axis, concat_axis):
        ctx.seq, ctx.axes = seq, (split_axis, concat_axis)
        return _tiled_all_to_all(x, seq, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return _tiled_all_to_all(g, ctx.seq, concat_axis, split_axis), None, None, None


def seq_all_to_all(x: torch.Tensor, seq, split_axis: int, concat_axis: int) -> torch.Tensor:
    """``x`` cut into ``seq.size`` blocks along ``split_axis``, block j
    sent to seq rank j; the blocks received, in rank order, concatenated
    along ``concat_axis`` (JAX's ``all_to_all(..., tiled=True)``).
    Differentiable."""
    return _SeqAllToAll.apply(x, seq, split_axis, concat_axis)


def all_gather_list(t: torch.Tensor, group) -> list:
    """Every rank's ``t`` (the same shape on each), in rank order, through
    the list form of ``all_gather`` (which gloo implements for CUDA
    tensors too)."""
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]
