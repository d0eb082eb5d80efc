"""Tensor parallelism's packed per-rank layout.

The JAX package has no counterpart: its TP is GSPMD's, which cuts the
packed ``in_proj`` (z|x|B|C|dt) and ``wqkv`` (q|k|v) evenly on their
last axis, across segment boundaries, and lets XLA reshard after the
projection (``parallel/sharding.py`` there).  Eager PyTorch has no
compiler to reshard, so each tensor rank holds its own columns of every
segment side by side: its z, x, dt, q, k and v are whole heads it uses
without a collective.  It is a physical layout of the same math; the
logical (checkpointed) tree is the single device's.

Each leaf is of one of three kinds:

* ``"split"``: every rank holds its own heads or channels along the
  packed axis; its gradient needs no reduction over the tensor group;
* ``"partial"``: the leaf also holds positions that every rank keeps
  whole and whose gradient each rank computes from its own heads only,
  so those positions' gradients are summed over the tensor group: the
  B|C columns of Mamba-2's ``in_proj`` (and its bias) and the B|C
  channels of ``conv`` (kernel and bias) at ``ngroups = 1``; the rest
  of the leaf is split (at an ``ngroups`` the tensor size divides, each
  rank takes its own groups of B and C);
* ``"full"``: replicated, with a gradient that is already equal on every
  rank: the embedding, the norms, the MoE router, the bias of a
  row-parallel projection (added once, after the all-reduce) and every
  leaf of a block that runs whole.

A block whose heads (Mamba-2: ``nheads``, and ``ngroups`` unless it is
1; attention: query and KV heads; Mamba-1: ``d_inner``; the gated MLP
and MoE: ``d_intermediate``) the tensor size does not divide runs whole
on every tensor rank, all its leaves ``"full"``: the JAX package's
replicate-what-does-not-divide rule (``_spec_for``), at the grain of a
block instead of a leaf.

Positions are given along the leaf's packed axis, counted from the end
(as the JAX ``_TP_RULES``), so a layer-stacked leaf and one layer of it
share a plan.
"""

from __future__ import annotations

import dataclasses

import torch

from mamba_distributed_tpu_torch.config import ModelConfig

SPLIT, PARTIAL, FULL = "split", "partial", "full"


@dataclasses.dataclass(frozen=True)
class TPContext:
    """What a block needs of the tensor group: the group, its size and
    this rank's index in it."""

    group: object
    size: int
    rank: int


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """The packed layout of one leaf.  ``index[r]``: the positions of the
    full axis that rank r holds, in its packed order; ``shared``: the
    positions of the local (packed) axis that every rank holds whole
    (replicated-partial), ``own`` the others."""

    kind: str
    axis: int | None = None
    full_len: int = 0
    index: tuple[tuple[int, ...], ...] = ()
    shared: tuple[int, ...] = ()

    @property
    def own(self) -> tuple[int, ...]:
        s = set(self.shared)
        return tuple(i for i in range(len(self.index[0])) if i not in s)


FULL_LEAF = LeafPlan(FULL)


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """``leaves``: path (tuple of keys) -> ``LeafPlan`` for every leaf a
    split block may hold (a path the tree lacks is never looked up);
    every other leaf is ``"full"``."""

    leaves: dict

    def leaf(self, path) -> LeafPlan:
        return self.leaves.get(tuple(path), FULL_LEAF)


def block_divides(cfg: ModelConfig, kind: str, size: int) -> bool:
    """True when block ``kind`` ("ssm", "attn" or "ffn") splits over
    ``size`` tensor ranks, False when it runs whole on each."""
    if kind == "ssm":
        if cfg.ssm_layer == "mamba1":
            return cfg.d_inner % size == 0
        return cfg.nheads % size == 0 and (cfg.ngroups == 1 or cfg.ngroups % size == 0)
    if kind == "attn":
        return (cfg.effective_attn_num_heads % size == 0
                and cfg.effective_attn_num_kv_heads % size == 0)
    if kind == "ffn":
        return cfg.d_intermediate % size == 0
    raise ValueError(f"unknown block kind {kind!r}")


def block_tp(tp: TPContext | None, cfg: ModelConfig, kind: str) -> TPContext | None:
    """``tp`` for a block that splits over it, None for one that runs
    whole (or with no tensor group)."""
    if tp is None or not block_divides(cfg, kind, tp.size):
        return None
    return tp


def _leaf(segments, size: int, axis: int) -> LeafPlan:
    """A leaf whose packed axis is the concatenation of ``segments``
    ((length, split) pairs, in the full order): a split segment is cut
    into ``size`` contiguous blocks, one a rank; a whole one is held by
    every rank (replicated-partial)."""
    index = [[] for _ in range(size)]
    shared, off = [], 0
    for length, split in segments:
        if split:
            n = length // size
            for r in range(size):
                index[r].extend(range(off + r * n, off + (r + 1) * n))
        else:
            shared.extend(range(len(index[0]), len(index[0]) + length))
            for r in range(size):
                index[r].extend(range(off, off + length))
        off += length
    return LeafPlan(PARTIAL if shared else SPLIT, axis, off,
                    tuple(tuple(i) for i in index), tuple(shared))


def _mamba2_leaves(cfg: ModelConfig, size: int) -> dict:
    di, ds, g, nh = cfg.d_inner, cfg.effective_d_state, cfg.ngroups, cfg.nheads
    bc = (g * ds, g > 1)  # at ngroups 1 every rank holds B and C whole
    in_proj = [(di, True), (di, True), bc, bc, (nh, True)]
    conv = [(di, True), bc, bc]
    return {
        ("in_proj", "kernel"): _leaf(in_proj, size, -1),
        ("in_proj", "bias"): _leaf(in_proj, size, -1),
        ("conv", "kernel"): _leaf(conv, size, -2),
        ("conv", "bias"): _leaf(conv, size, -1),
        ("dt_bias",): _leaf([(nh, True)], size, -1),
        ("A_log",): _leaf([(nh, True)], size, -1),
        ("D",): _leaf([(di if cfg.d_has_hdim else nh, True)], size, -1),
        ("norm", "weight"): _leaf([(di, True)], size, -1),
        ("out_proj", "kernel"): _leaf([(di, True)], size, -2),
    }


def _mamba1_leaves(cfg: ModelConfig, size: int) -> dict:
    di = cfg.d_inner
    cut = [(di, True)]
    return {
        ("in_proj", "kernel"): _leaf([(di, True), (di, True)], size, -1),
        ("in_proj", "bias"): _leaf([(di, True), (di, True)], size, -1),
        ("conv", "kernel"): _leaf(cut, size, -2),
        ("conv", "bias"): _leaf(cut, size, -1),
        ("x_proj", "kernel"): _leaf(cut, size, -2),
        ("dt_proj", "kernel"): _leaf(cut, size, -1),
        ("dt_proj", "bias"): _leaf(cut, size, -1),
        ("A_log",): _leaf(cut, size, -2),
        ("D",): _leaf(cut, size, -1),
        ("out_proj", "kernel"): _leaf(cut, size, -2),
    }


def _attention_leaves(cfg: ModelConfig, size: int) -> dict:
    nh, nkv = cfg.effective_attn_num_heads, cfg.effective_attn_num_kv_heads
    hd = cfg.effective_attn_head_dim
    qkv = [(nh * hd, True), (nkv * hd, True), (nkv * hd, True)]
    return {
        ("wqkv", "kernel"): _leaf(qkv, size, -1),
        ("wqkv", "bias"): _leaf(qkv, size, -1),
        ("out_proj", "kernel"): _leaf([(nh * hd, True)], size, -2),
    }


def _ffn_leaves(cfg: ModelConfig, size: int) -> dict:
    dff = cfg.d_intermediate
    # fc1 and w1 hold y | gate (the chunk order of models/lm._gated_mlp)
    fc1 = _leaf([(dff, True), (dff, True)], size, -1)
    fc2 = _leaf([(dff, True)], size, -2)
    return {("mlp", "fc1", "kernel"): fc1, ("mlp", "fc2", "kernel"): fc2,
            ("moe", "w1"): fc1, ("moe", "w2"): fc2}


def tp_plan(cfg: ModelConfig, size: int) -> TPPlan:
    """The packed layout of every leaf of ``cfg``'s tree over ``size``
    tensor ranks (module docstring)."""
    leaves = {}
    stacks = ["blocks"] + (["attn_blocks"] if cfg.attn_layer_idx else [])
    if size > 1 and block_divides(cfg, "ssm", size):
        mixer = (_mamba1_leaves if cfg.ssm_layer == "mamba1" else _mamba2_leaves)(cfg, size)
        leaves.update({("blocks", "mixer", *k): v for k, v in mixer.items()})
    if size > 1 and cfg.attn_layer_idx and block_divides(cfg, "attn", size):
        leaves.update({("attn_blocks", "mixer", *k): v
                       for k, v in _attention_leaves(cfg, size).items()})
    if size > 1 and cfg.d_intermediate > 0 and block_divides(cfg, "ffn", size):
        for stack in stacks:
            leaves.update({(stack, *k): v for k, v in _ffn_leaves(cfg, size).items()})
    return TPPlan(leaves)


def plan_tree(tree, plan: TPPlan, path: tuple = ()):
    """A tree like ``tree`` (params, gradients or specs: any nest of
    dicts) of each leaf's ``LeafPlan``."""
    if isinstance(tree, dict):
        return {k: plan_tree(v, plan, (*path, str(k))) for k, v in tree.items()}
    return plan.leaf(path)


def _map(fn, tree, plans):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], plans[k]) for k in tree}
    return fn(tree, plans)


def _positions(idx, device) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.long, device=device)


def pack_leaf(full: torch.Tensor, lp: LeafPlan, rank: int) -> torch.Tensor:
    """Rank ``rank``'s packed shard of one full leaf (a fresh tensor; a
    ``"full"`` leaf comes back as it is)."""
    if lp.kind == FULL:
        return full
    ax = full.ndim + lp.axis
    if full.shape[ax] != lp.full_len:
        raise ValueError(f"a leaf of {full.shape[ax]} positions on its packed axis, the "
                         f"plan wants {lp.full_len}")
    return full.index_select(ax, _positions(lp.index[rank], full.device))


def pack_tp(full_tree: dict, plan: TPPlan, rank: int) -> dict:
    """Rank ``rank``'s packed tree of a full (logical) tree."""
    return _map(lambda t, lp: pack_leaf(t.detach(), lp, rank), full_tree,
                plan_tree(full_tree, plan))


def unpack_leaf(shards: list, lp: LeafPlan) -> torch.Tensor:
    """The full leaf from every rank's packed shard (rank order); the
    positions every rank holds are taken from rank 0."""
    if lp.kind == FULL:
        return shards[0]
    first = shards[0]
    ax = first.ndim + lp.axis
    shape = list(first.shape)
    shape[ax] = lp.full_len
    out = first.new_empty(shape)
    for r in reversed(range(len(shards))):
        out.index_copy_(ax, _positions(lp.index[r], first.device), shards[r])
    return out


def unpack_tp(shards: list, plan: TPPlan) -> dict:
    """The full (logical) tree from the list of every rank's packed tree,
    in rank order: the inverse of ``pack_tp``."""
    plans = plan_tree(shards[0], plan)

    def walk(trees, plans):
        if isinstance(plans, dict):
            return {k: walk([t[k] for t in trees], plans[k]) for k in plans}
        return unpack_leaf([t.detach() for t in trees], plans)

    return walk(shards, plans)

