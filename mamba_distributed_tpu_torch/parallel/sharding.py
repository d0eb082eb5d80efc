"""Sharding rules: how params, optimizer state and batches lay out on
the mesh (the JAX package's ``parallel/sharding.py``).

A spec is a tuple with one entry per axis of the leaf: the mesh axis
that cuts it or None; ``()`` is replicated (``tuple(P(...))`` of the
JAX spec).  ``param_specs`` is the JAX rule leaf for leaf: the expert
axis first (MoE stacks), then the tensor-parallel axis by rule, then
the largest remaining fsdp-divisible axis, never the layer axis of a
stacked leaf; whatever does not divide stays replicated.  Adam moments
inherit their param's spec and scalars replicate.  Batches split their
rows over ``(data, fsdp)`` (and ``expert``, a pure-DP batch axis for
the non-MoE layers), data outermost.

Every axis is executed.  ``expert_shard`` cuts a MoE stack to this
rank's block of experts (the axis JAX's spec gives ``expert``);
``shard_params`` packs each leaf into this rank's tensor shard
(``parallel/tp_layout.py``: its own heads of every segment side by
side, not JAX's even cut of the packed axis), then narrows it to its
block of the fsdp axis; ``stage_block`` cuts every stacked leaf to
this rank's pipeline stage (the layer axis JAX's spec gives ``pipe``);
``gather_params`` reverses all four.  The fsdp axis of a packed leaf is
the one JAX's spec gives ``fsdp``, checked against the local shape
(``executed_specs``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mamba_distributed_tpu_torch.parallel.collectives import all_gather_leaf, all_gather_list
from mamba_distributed_tpu_torch.parallel.tp_layout import (
    FULL,
    PARTIAL,
    pack_tp,
    plan_tree,
    unpack_leaf,
)

# (path-suffix pattern, axis-from-end carrying the d_inner/head dimension)
# column-parallel weights shard their output axis, row-parallel their input
_TP_RULES: tuple[tuple[tuple[str, ...], int], ...] = (
    (("mixer", "in_proj", "kernel"), -1),   # column
    (("mixer", "out_proj", "kernel"), -2),  # row
    (("mixer", "conv", "kernel"), -2),
    (("mixer", "conv", "bias"), -1),
    (("mixer", "x_proj", "kernel"), -2),    # row (input is sharded x)
    (("mixer", "dt_proj", "kernel"), -1),
    (("mixer", "dt_proj", "bias"), -1),
    (("mixer", "A_log"), -1),               # mamba2 (nh,); mamba1 handled below
    (("mixer", "dt_bias"), -1),
    (("mixer", "D"), -1),
    (("mixer", "norm", "weight"), -1),
    (("mixer", "wqkv", "kernel"), -1),
    (("mlp", "fc1", "kernel"), -1),
    (("mlp", "fc2", "kernel"), -2),
    (("moe", "w1"), -1),                    # (E, d, 2*di): column
    (("moe", "w2"), -2),                    # (E, di, d): row
)

# leaves whose first non-layer axis is the MoE expert dimension
_EXPERT_RULES: tuple[tuple[str, ...], ...] = (
    ("moe", "w1"),
    ("moe", "w2"),
)


def _tp_axis(names: list[str], ndim: int, stacked: bool) -> int | None:
    """Which axis (if any) of this param shards over the tensor axis."""
    for pattern, ax in _TP_RULES:
        k = len(pattern)
        if tuple(names[-k:]) == pattern:
            # mamba1's A_log is (di, n): the head/channel axis is -2 there
            if pattern[-1] == "A_log" and ndim - (1 if stacked else 0) == 2:
                ax = -2
            return ndim + ax
    return None


def _spec_for(names: list[str], shape: tuple[int, ...], fsdp_size: int,
              tensor_size: int, stacked: bool, expert_size: int = 1) -> tuple:
    """Expert axis first (MoE stacks), then the tensor-parallel axis (by
    rule), then the largest remaining fsdp-divisible axis (skipping the
    layer axis of stacked params); replicate whatever doesn't divide."""
    spec: list = [None] * len(shape)
    if expert_size > 1:
        for pattern in _EXPERT_RULES:
            k = len(pattern)
            if tuple(names[-k:]) == pattern:
                ax = 1 if stacked else 0
                if shape[ax] % expert_size == 0:
                    spec[ax] = "expert"
                break
    if tensor_size > 1:
        ax = _tp_axis(names, len(shape), stacked)
        if ax is not None and shape[ax] % tensor_size == 0:
            spec[ax] = "tensor"
    if fsdp_size > 1:
        start = 1 if stacked and len(shape) > 1 else 0
        cands = [(shape[i], i) for i in range(start, len(shape))
                 if spec[i] is None and shape[i] % fsdp_size == 0]
        if cands:
            _, axis = max(cands)
            spec[axis] = "fsdp"
    if all(s is None for s in spec):
        return ()
    return tuple(spec)


def param_specs(params: dict, shard: bool, fsdp_size: int, tensor_size: int = 1,
                pipe_size: int = 1, expert_size: int = 1) -> dict:
    """Spec tree matching ``params`` (a dict of tensors, or of anything
    with a ``shape``).  ``shard=False`` disables FSDP; with
    ``pipe_size > 1`` the stacked blocks' layer axis shards over pipe."""

    def walk(tree, names):
        if isinstance(tree, dict):
            return {k: walk(v, names + [str(k)]) for k, v in tree.items()}
        shape = tuple(tree.shape)
        stacked = "blocks" in names or "attn_blocks" in names
        spec = _spec_for(names, shape, fsdp_size if shard else 1, tensor_size, stacked,
                         expert_size)
        if pipe_size > 1 and stacked and len(shape) > 0:
            spec = ("pipe", *spec[1:])  # layer axis -> pipe; keep fsdp/tp tail
        return spec

    return walk(params, [])


def opt_state_specs(opt_state: dict, specs: dict) -> dict:
    """Specs of ``AdamW.state_dict()``: the moments (params-shaped trees)
    inherit their param's spec, scalars (the step count) replicate
    (sharding.py:159-189)."""
    return {k: specs if isinstance(v, dict) else () for k, v in opt_state.items()}


def fsdp_axis(spec: tuple) -> int | None:
    """The axis of a leaf that the fsdp axis cuts, or None."""
    return spec.index("fsdp") if "fsdp" in spec else None


def batch_spec(mesh_shape: dict) -> tuple:
    """(B, T) batches: B over (data, fsdp) and, with an expert axis above
    1, expert (a pure-DP batch axis for the non-MoE layers); T whole."""
    rows = ("data", "fsdp", "expert") if mesh_shape.get("expert", 1) > 1 else ("data", "fsdp")
    return (rows, None)


def batch_coordinate(mesh) -> int:
    """This rank's block of a batch's rows: its flat index over the
    batch-row axes of ``batch_spec``, the first outermost."""
    shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    c = 0
    for name in batch_spec(shape)[0]:
        c = c * shape[name] + mesh.get_local_rank(name)
    return c


def _tree_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


def expert_axis(spec: tuple) -> int | None:
    """The axis of a leaf that the expert axis cuts, or None."""
    return spec.index("expert") if "expert" in spec else None


def pipe_axis(spec: tuple) -> int | None:
    """The axis of a leaf that the pipe axis cuts (a stacked leaf's layer
    axis), or None."""
    return spec.index("pipe") if "pipe" in spec else None


def narrow_leaf(full: torch.Tensor, spec: tuple, index: int, size: int,
                axis=fsdp_axis) -> torch.Tensor:
    """Block ``index`` of ``size`` along the leaf's fsdp axis (``axis``:
    the rule that finds it), as a contiguous clone (the whole leaf,
    cloned, when that axis does not cut it)."""
    ax = axis(spec)
    if ax is None:
        return full.clone()
    n = full.shape[ax] // size
    return full.narrow(ax, index * n, n).clone(memory_format=torch.contiguous_format)


def executed_specs(specs: dict, local: dict, fsdp_size: int, plan) -> dict:
    """``specs`` (``param_specs``, JAX's) as the packed ``local`` tree
    (``plan``'s) executes them: a leaf keeps its fsdp axis when the
    local shape divides by ``fsdp_size`` there, and when that axis is
    not the packed axis of a leaf with replicated-partial positions
    (whose positions must stay whole on each rank); otherwise it is
    whole over fsdp."""

    def fix(t, spec, lp):
        ax = fsdp_axis(spec)
        if ax is None:
            return spec
        bad = t.shape[ax] % fsdp_size != 0 or (lp.kind == PARTIAL and ax == t.ndim + lp.axis)
        return tuple(None if s == "fsdp" else s for s in spec) if bad else spec

    def walk(t, spec, lp):
        if isinstance(t, dict):
            return {k: walk(t[k], spec[k], lp[k]) for k in t}
        return fix(t, spec, lp)

    return walk(local, specs, plan_tree(local, plan))


def expert_shard(params: dict, specs: dict, ep) -> dict:
    """This rank's block of experts of every MoE stack (``ep``: the
    ``EPContext``); the other leaves as they are."""
    return _tree_map(lambda t, s: t if expert_axis(s) is None
                     else narrow_leaf(t.detach(), s, ep.rank, ep.size, expert_axis),
                     params, specs)


def stage_block(params: dict, specs: dict, pipe) -> dict:
    """This rank's pipeline stage of every stacked leaf (``pipe``: the
    ``PipeContext``), its contiguous block of layers (of supersteps, for a
    periodic hybrid, whose Mamba and attention stacks cut alike); the
    other leaves as they are."""
    return _tree_map(lambda t, s: t if pipe_axis(s) is None
                     else narrow_leaf(t.detach(), s, pipe.rank, pipe.size, pipe_axis),
                     params, specs)


def shard_params(params: dict, specs: dict, group=None, tp=None, plan=None) -> dict:
    """This rank's shard of every leaf (of its experts, ``expert_shard``,
    under an expert axis), contiguous clones: with ``tp`` (``TPContext``)
    and its ``plan``, first its packed tensor shard
    (``tp_layout.pack_tp``), then its block of the leaf's fsdp axis (the
    rank's index in ``group``, the fsdp group).  ``specs`` are the
    specs of the packed tree (``executed_specs``)."""
    if tp is not None:
        params = pack_tp(params, plan, tp.rank)
    index, size = dist.get_rank(group), dist.get_world_size(group)
    return _tree_map(lambda t, s: narrow_leaf(t.detach(), s, index, size), params, specs)


def gather_params(shards: dict, specs: dict, group=None, tp=None, plan=None,
                  ep=None, pipe=None) -> dict:
    """The full leaves from every rank's shard: ``all_gather`` over the
    fsdp ``group``, then, with ``tp`` and its ``plan``, every tensor
    rank's packed leaf (the list form of ``all_gather``) unpacked into
    the logical leaf, then, with ``ep``, every expert rank's experts,
    then, with ``pipe``, every stage's layers.
    Fresh tensors; a leaf no axis cuts comes back as a detached alias of
    its own storage."""
    out = _tree_map(lambda t, s: t.detach() if fsdp_axis(s) is None
                    else all_gather_leaf(t.detach(), fsdp_axis(s), group), shards, specs)
    if tp is not None:
        plans = plan_tree(out, plan)
        out = _tree_map(lambda t, lp: t if lp.kind == FULL
                        else unpack_leaf(all_gather_list(t, tp.group), lp), out, plans)
    if ep is not None:
        out = _tree_map(lambda t, s: t if expert_axis(s) is None
                        else all_gather_leaf(t, expert_axis(s), ep.group), out, specs)
    if pipe is not None:
        out = _tree_map(lambda t, s: t if pipe_axis(s) is None
                        else all_gather_leaf(t, pipe_axis(s), pipe.group), out, specs)
    return out


# ------------------------------------------- serving tensor parallelism


def _tp_rule_end_axis(names: list[str]) -> int | None:
    """The raw rule axis from the end (-1 column-parallel, -2
    row-parallel) of a param path: what the LoRA factor rules key off."""
    for pattern, ax in _TP_RULES:
        if tuple(names[-len(pattern):]) == pattern:
            return ax
    return None


def serving_param_specs(params: dict, model_shards: int, stage_shards: int = 1) -> dict:
    """Spec tree of the SERVING weights over a serving mesh (JAX
    ``serving_param_specs``, ``sharding.py:192-284``): the leading layer
    axis of every ``blocks``/``attn_blocks`` leaf (LoRA factor pools
    included) over ``stage`` when it divides, and over ``model`` the
    training ``_TP_RULES`` axis, the vocab axis of the embedding (0) and
    of an untied ``lm_head`` (last), an int8 ``scale`` riding its
    kernel's axis, and the LoRA ``A`` on ``d_in`` beside a row-parallel
    kernel, ``B`` on ``d_out`` beside a column-parallel one.  What does
    not divide replicates; ``()`` is replicated.  The specs are the
    record of what each rank holds: the port executes them with
    ``parallel/tp_layout.serving_plan`` (its packed cut of the model
    axis) and ``stage_cut``."""

    def leaf_spec(names, shape):
        spec: list = [None] * len(shape)
        if (stage_shards > 1 and shape and ("blocks" in names or "attn_blocks" in names)
                and shape[0] % stage_shards == 0):
            spec[0] = "stage"
        if model_shards > 1 and len(names) >= 2 and names[-2] == "lora":
            base_ax = _tp_rule_end_axis(names[:-2] + ["kernel"])
            ax = None
            if names[-1] == "A" and base_ax == -2:
                ax = len(shape) - 2
            elif names[-1] == "B" and base_ax == -1:
                ax = len(shape) - 1
            if ax is not None and shape[ax] % model_shards == 0:
                spec[ax] = "model"
            return () if all(s is None for s in spec) else tuple(spec)
        if model_shards > 1 and shape:
            lookup = names[:-1] + ["kernel"] if names and names[-1] == "scale" else names
            stacked = "blocks" in lookup or "attn_blocks" in lookup
            ax = _tp_axis(lookup, len(shape), stacked)
            if ax is None:
                if lookup[-1] == "embedding" or lookup[-2:] == ["embedding", "kernel"]:
                    ax = 0
                elif lookup[-2:] == ["lm_head", "kernel"]:
                    ax = len(shape) - 1
            if ax is not None and shape[ax] % model_shards == 0:
                spec[ax] = "model"
        return () if all(s is None for s in spec) else tuple(spec)

    def walk(tree, names):
        if isinstance(tree, dict):
            return {k: walk(v, names + [str(k)]) for k, v in tree.items()}
        return leaf_spec(names, tuple(tree.shape))

    return walk(params, [])


def validate_serving_model_shards(cfg, model_shards: int) -> None:
    """Refuse a ``serving_model_shards`` the model's dimensions cannot
    tile, at engine construction, naming each (JAX
    ``validate_serving_model_shards``, its rules and message)."""
    if model_shards <= 1:
        return
    problems = []
    if cfg.d_inner % model_shards:
        problems.append(f"d_inner={cfg.d_inner} (expand * d_model — the Mamba "
                        f"in/out projection and conv/SSM channel axis)")
    if cfg.ssm_layer == "mamba2":
        g, ds, nh = cfg.ngroups, cfg.effective_d_state, cfg.nheads
        d_in_proj = 2 * cfg.d_inner + 2 * g * ds + nh
        conv_dim = cfg.d_inner + 2 * g * ds
        if nh % model_shards:
            problems.append(f"nheads={nh} (d_inner/headdim — the per-head "
                            f"A_log/dt_bias/D axis and the dt segment of in_proj)")
        if d_in_proj % model_shards:
            problems.append(f"in_proj width {d_in_proj} (the packed "
                            f"2*d_inner + 2*ngroups*d_state + nheads column axis)")
        if conv_dim % model_shards:
            problems.append(f"conv width {conv_dim} (d_inner + 2*ngroups*d_state)")
    if cfg.vocab_size_padded % model_shards:
        problems.append(f"padded vocab={cfg.vocab_size_padded} (the embedding/"
                        f"lm_head vocab axis)")
    if cfg.attn_layer_idx:
        nh = cfg.effective_attn_num_heads
        nkv = cfg.effective_attn_num_kv_heads
        if nh % model_shards:
            problems.append(f"attn_num_heads={nh}")
        if nkv % model_shards:
            problems.append(f"attn_num_kv_heads={nkv}")
    if problems:
        raise ValueError(
            f"serving_model_shards={model_shards} does not divide "
            + "; ".join(problems)
            + " — pick a divisor of every listed dimension (or 1 to "
              "replicate weights)")


def validate_serving_stage_shards(cfg, stage_shards: int) -> None:
    """Refuse a ``serving_stage_shards`` the layer stacks cannot tile:
    every stacked family must divide (JAX
    ``validate_serving_stage_shards``, its rules and message)."""
    if stage_shards <= 1:
        return
    problems = []
    n_attn = len(cfg.attn_layer_idx)
    n_mamba = cfg.n_layer - n_attn
    if cfg.n_layer % stage_shards:
        problems.append(f"n_layer={cfg.n_layer} (the layer stack)")
    if n_attn:
        if n_mamba % stage_shards:
            problems.append(
                f"mamba stack={n_mamba} (n_layer - the "
                f"{n_attn} attention layers — the hybrid 'blocks' "
                f"family shards separately)")
        if n_attn % stage_shards:
            problems.append(
                f"attention stack={n_attn} (the hybrid 'attn_blocks' "
                f"family — per-layer KV page pools shard with it)")
    if problems:
        raise ValueError(
            f"serving_stage_shards={stage_shards} does not divide "
            + "; ".join(problems)
            + " — pick a divisor of every listed stack (or 1 to keep "
              "the layer stacks unsharded)")


def slot_pool_specs(pool: dict, num_shards: int, stage_shards: int = 1) -> dict:
    """Spec tree of a serving slot pool over a serving mesh (JAX
    ``slot_pool_specs``, ``sharding.py:413-466``): the slot axis (axis 1
    of a ``blocks`` leaf (L, S, ...), the page axis 1 of an
    ``attn_blocks`` leaf (A, P+1, ...), axis 0 of ``logits`` and every
    ``meta`` leaf) over ``data`` where it divides, and at ``stage_shards
    > 1`` the layer axis of the stacked leaves over ``stage``.  Every
    spec keeps one entry per axis (JAX's ``P(*spec)``).  The tuples of
    the pool's ``state`` stacks are walked like the JAX tree's."""

    def leaf_spec(names, shape):
        stacked = "blocks" in names or "attn_blocks" in names
        ax = 1 if stacked else 0
        spec: list = [None] * len(shape)
        if len(shape) > ax and shape[ax] % num_shards == 0:
            spec[ax] = "data"
        if stage_shards > 1 and stacked and shape and shape[0] % stage_shards == 0:
            spec[0] = "stage"
        return tuple(spec)

    def walk(tree, names):
        if isinstance(tree, dict):
            return {k: walk(v, names + [str(k)]) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(v, names + [str(i)]) for i, v in enumerate(tree))
        return leaf_spec(names, tuple(tree.shape))

    return walk(pool, [])
