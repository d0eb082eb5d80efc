"""Language model (counterpart of ``mamba_distributed_tpu/models/lm.py``):
embedding -> N prenorm blocks -> final norm -> tied or untied head.
Every block is a Mamba mixer of ``cfg.ssm_layer`` (Mamba-2 SSD or
Mamba-1 selective scan), or, in a hybrid stack, an attention mixer at
the layers ``cfg.attn_layer_idx`` over a paged KV cache
(models/attention.py); with ``cfg.d_intermediate > 0`` a second
add+norm and a gated MLP (or, with ``cfg.moe_num_experts``, a top-k
mixture of gated-MLP experts) follow the mixer.

Parameters are a plain dict that mirrors the JAX ``init_lm_params`` tree
key for key, with the blocks stacked on a leading layer axis:

    {"embedding": (V, d), "norm_f": {"weight": (d,)},
     "blocks": {"norm": {"weight": (L, d)},
                # Mamba-2
                "mixer": {"in_proj": {"kernel": (L, d, d_in_proj)},
                          "conv": {"kernel": (L, conv_dim, w), "bias": (L, conv_dim)},
                          "dt_bias": (L, h), "A_log": (L, h), "D": (L, h),
                          "norm": {"weight": (L, d_inner)},
                          "out_proj": {"kernel": (L, d_inner, d)}}},
                # Mamba-1 (di = d_inner, r = dt_rank)
                "mixer": {"in_proj": {"kernel": (L, d, 2 di)},
                          "conv": {"kernel": (L, di, w), "bias": (L, di)},
                          "x_proj": {"kernel": (L, di, r + 2 n)},
                          "dt_proj": {"kernel": (L, r, di), "bias": (L, di)},
                          "A_log": (L, di, n), "D": (L, di),
                          "out_proj": {"kernel": (L, di, d)}}},
     # hybrid stacks only; "blocks" then stacks the Mamba layers alone
     "attn_blocks": {"norm": {"weight": (A, d)},
                     "mixer": {"wqkv": {"kernel": (A, d, (nh + 2 nkv) hd)},
                               "out_proj": {"kernel": (A, nh hd, d)}}},
     # untied heads only
     "lm_head": {"kernel": (d, V)}}

With ``d_intermediate = di > 0`` every block of both stacks also holds
``"norm2": {"weight": (L, d)}`` and either ``"mlp": {"fc1": {"kernel":
(L, d, 2 di)}, "fc2": {"kernel": (L, di, d)}}`` or, with E experts,
``"moe": {"router": {"kernel": (L, d, E)}, "w1": (L, E, d, 2 di), "w2":
(L, E, di, d)}``.

The JAX ``lax.scan`` over stacked layers (and, for periodic hybrids, its
scan over supersteps) becomes one Python loop over the layers in global
order, with a Mamba and an attention counter; it computes the same thing
in the same order.  Decode state is ``{"blocks": (conv, ssm)}``, stacked
on the layer axis: for Mamba-2 conv (L, b, d_conv-1, conv_dim) and ssm
(L, b, h, p, n) fp32, for Mamba-1 conv (L, b, d_conv-1, d_inner) and ssm
(L, b, d_inner, n) fp32; for hybrids also ``"attn_blocks": (k_pages,
v_pages)`` each (A, P, nkv, page, hd), or with int8 pages the 4-tuple
``(k_pages, v_pages, k_scale, v_scale)`` with scales (A, P, nkv) fp32,
and ``"attn_meta": (page_table (b, W) int32, lengths (b,) int32)``,
shared by every attention layer.

Serving params may be int8 (``cfg.serving_weight_dtype="int8"``, cast by
inference/generate._decode_params): the embedding is then ``{"kernel":
int8 (V, d), "scale": (V, 1)}``, dequantized row by row in the lookup
and folded into the tied head's fp32 output.

Training (pure and hybrid stacks): ``lm_forward``/``lm_loss`` carry one
post-add fp32 stream through the layers in global order, as the JAX
``_backbone`` does, each block (Mamba or attention) checkpointed as a
whole under ``cfg.remat_policy`` when ``cfg.remat`` is on
(ops/remat.py); a MoE model's load-balance terms are summed on the way.
``lm_loss_pipelined`` streams microbatches through the same blocks cut
into pipeline stages (``parallel/pipeline.py``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from mamba_distributed_tpu_torch.config import ModelConfig, _hybrid_period
from mamba_distributed_tpu_torch.models.attention import (
    attention_mixer,
    attention_mixer_chunk,
    attention_mixer_step,
    attention_page_meta,
    init_attention_params,
    init_attention_state,
    pack_attention_pages,
)
from mamba_distributed_tpu_torch.models.common import (
    init_linear,
    linear,
    mm_f32,
    out_proj_rescale,
    row_parallel_linear,
    uniform_fan_in,
)
from mamba_distributed_tpu_torch.models.mamba1 import (
    init_mamba1_params,
    init_mamba1_state,
    mamba1_mixer,
    mamba1_mixer_step,
)
from mamba_distributed_tpu_torch.models.mamba2 import (
    init_mamba2_params,
    init_mamba2_state,
    mamba2_mixer,
    mamba2_mixer_step,
)
from mamba_distributed_tpu_torch.ops.norm import add_rms_norm, rms_norm
from mamba_distributed_tpu_torch.ops.remat import remat_block
from mamba_distributed_tpu_torch.parallel.collectives import (
    all_to_all,
    copy_to_tp,
    gather_counts,
    reduce_from_tp,
    route_sum,
    serve_all_reduce_,
    serve_broadcast_,
    serve_gather,
    stage_handoff,
)
from mamba_distributed_tpu_torch.parallel.pipeline import (
    from_last_stage,
    pipelined_decode_layers,
    pipelined_layers,
)
from mamba_distributed_tpu_torch.parallel.tp_layout import block_tp


class _Mixer(NamedTuple):
    init: Callable
    init_state: Callable
    forward: Callable
    step: Callable


# the Mamba mixer of each ssm_layer, as the JAX _init_mixer, _mixer_fwd
# and init_lm_blocks_state dispatch (lm.py:53-63, :990-1000)
_MIXERS = {
    "mamba1": _Mixer(init_mamba1_params, init_mamba1_state, mamba1_mixer, mamba1_mixer_step),
    "mamba2": _Mixer(init_mamba2_params, init_mamba2_state, mamba2_mixer, mamba2_mixer_step),
}


def _unstack(tree, n: int) -> list:
    """Layer-stacked tree -> list of n per-layer trees (views)."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _layer_plan(cfg: ModelConfig) -> list[tuple[bool, int]]:
    """(is_attention, index in its own stack) for every layer, in order."""
    attn = set(cfg.attn_layer_idx)
    plan, mi, ai = [], 0, 0
    for i in range(cfg.n_layer):
        if i in attn:
            plan.append((True, ai))
            ai += 1
        else:
            plan.append((False, mi))
            mi += 1
    return plan


def _init_ffn(cfg: ModelConfig, generator: torch.Generator, n: int, device) -> dict:
    """``norm2`` and the gated MLP or the MoE of ``n`` stacked blocks
    (lm.py:72-106): fc2 and the experts' w2 divided by the residual
    rescale, as the mixers' out_proj."""
    d, di = cfg.d_model, cfg.d_intermediate
    rescale = (out_proj_rescale(cfg.n_layer, di) if cfg.rescale_prenorm_residual else 1.0)
    p = {"norm2": {"weight": torch.ones((n, d), device=device)}}
    if cfg.moe_num_experts:
        E = cfg.moe_num_experts
        p["moe"] = {
            "router": init_linear(d, E, generator, False, (n,), device),
            "w1": uniform_fan_in((n, E, d, 2 * di), d, generator, device),
            "w2": uniform_fan_in((n, E, di, d), di, generator, device) / rescale,
        }
    else:
        p["mlp"] = {"fc1": init_linear(d, 2 * di, generator, False, (n,), device),
                    "fc2": init_linear(di, d, generator, False, (n,), device)}
        p["mlp"]["fc2"]["kernel"] /= rescale
    return p


def init_lm_params(cfg: ModelConfig, generator: torch.Generator,
                   device=None) -> dict:
    """Full parameter tree (fp32 masters), random from ``generator``."""
    n_attn = len(cfg.attn_layer_idx)
    n = cfg.n_layer - n_attn
    emb = torch.randn((cfg.vocab_size_padded, cfg.d_model), generator=generator,
                      device=device) * cfg.initializer_range
    params = {
        "embedding": emb,
        "norm_f": {"weight": torch.ones((cfg.d_model,), device=device)},
        "blocks": {
            "norm": {"weight": torch.ones((n, cfg.d_model), device=device)},
            "mixer": _MIXERS[cfg.ssm_layer].init(cfg, generator, n, device),
        },
    }
    if n_attn:
        params["attn_blocks"] = {
            "norm": {"weight": torch.ones((n_attn, cfg.d_model), device=device)},
            "mixer": init_attention_params(cfg, generator, n_attn, device),
        }
    if cfg.d_intermediate > 0:
        params["blocks"].update(_init_ffn(cfg, generator, n, device))
        if n_attn:
            params["attn_blocks"].update(_init_ffn(cfg, generator, n_attn, device))
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(cfg.d_model, cfg.vocab_size_padded, generator,
                                        device=device)
    return params


def _embed(params: dict, ids: torch.Tensor, compute_dtype, tp=None) -> torch.Tensor:
    """Embedding lookup; an int8 embedding dequantizes the gathered rows
    in fp32, then casts once (lm.py:110-121).  Under a serving ``tp``
    the embedding holds this rank's block of the vocab: each rank looks
    up the ids in its block, zeroes the others and the model group sums
    (exact: one row is nonzero)."""
    emb = params["embedding"]
    if tp is None:
        if isinstance(emb, dict):
            return (emb["kernel"][ids].float() * emb["scale"][ids]).to(compute_dtype)
        return emb[ids].to(compute_dtype)
    kernel = emb["kernel"] if isinstance(emb, dict) else emb
    vl = kernel.shape[0]
    local = ids - tp.rank * vl
    inside = (local >= 0) & (local < vl)
    rows = local.clamp(0, vl - 1)
    x = (kernel[rows].float() * emb["scale"][rows] if isinstance(emb, dict)
         else kernel[rows].to(compute_dtype))
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    return serve_all_reduce_(x.contiguous(), tp.group, "embed").to(compute_dtype)


def _tied_logits(params: dict, normed: torch.Tensor, compute_dtype,
                 rows: int | None = None) -> torch.Tensor:
    """Tied head: ``normed @ embedding.T`` with fp32 accumulation and fp32
    logits; an int8 embedding's per-vocab-row scales multiply the fp32
    output (lm.py:124-141).  ``rows``: the row count the GEMM runs at
    (``common.matmul``)."""
    emb = params["embedding"]
    if isinstance(emb, dict):
        y = mm_f32(normed.to(compute_dtype), emb["kernel"].to(compute_dtype).t(), rows)
        return y * emb["scale"][:, 0]
    return mm_f32(normed.to(compute_dtype), emb.to(compute_dtype).t(), rows)


def _residual_dtype(cfg: ModelConfig):
    return torch.float32 if cfg.residual_in_fp32 else cfg.torch_compute_dtype


def _gated_mlp(params: dict, x: torch.Tensor, compute_dtype, tp=None,
               rows: int | None = None) -> torch.Tensor:
    """GatedMLP (lm.py:144-148): fc2(y * silu(gate)), the gate in fp32.
    Under ``tp`` fc1 holds this rank's y_r | gate_r columns and fc2 is
    row-parallel.  ``rows``: the row count the GEMMs run at
    (``common.matmul``)."""
    y, gate = linear(params["fc1"], copy_to_tp(x, tp), compute_dtype, rows).chunk(2, dim=-1)
    return row_parallel_linear(params["fc2"], y * F.silu(gate.float()).to(y.dtype),
                               compute_dtype, tp, rows)


def _einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``einsum`` of compute-dtype operands with an fp32 result (the JAX
    ``preferred_element_type=float32``): the operands are rounded to the
    compute dtype, then multiplied in fp32, where their products are exact."""
    return torch.einsum(eq, a.to(compute_dtype).float(), b.to(compute_dtype).float())


def _moe_mlp(params: dict, cfg: ModelConfig, x: torch.Tensor, compute_dtype, tp=None,
             route=None, ep=None):
    """Token-choice top-k mixture of gated-MLP experts -> (out, aux), in
    the JAX package's dense-dispatch formulation (lm.py:151-208):
    every choice takes the next slot of its expert's queue, primary
    choices of all tokens before any secondary one; a choice past the
    capacity is dropped (its token rides the residual).  ``aux`` is the
    Switch load-balance loss E * sum_e f_e P_e / k (1 at perfect balance).

    Under ``tp`` every expert holds this rank's columns of w1 (y_r |
    gate_r) and rows of w2, and ``out`` (n, d) is summed over the tensor
    group.  The router is replicated and its gradient full on every
    rank: the gate weights' gradient (partial: it reads this rank's
    expert outputs) is summed over the group where they enter the
    combine, and the router reads ``x`` before ``copy_to_tp``, so only
    the experts' share of x's gradient is summed.

    With ``route`` (``parallel/mesh.RouteContext``: the batch and seq
    ranks of a mesh) ``x`` is this rank's block of the global micro-batch
    (its rows, and its block of their tokens under seq) and the
    routing is the JAX package's on the whole of it (``_moe_routed``);
    with ``ep`` (``EPContext``) this rank holds only its block of the
    experts."""
    if route is not None:
        return _moe_routed(params, cfg, x, compute_dtype, tp, route, ep)
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    b, t, d = x.shape
    n = b * t
    xt = x.reshape(n, d)
    r = moe_route(params, cfg, xt)
    cap, probs = r.cap, r.probs
    oh = F.one_hot(r.gate_idx, E).float()  # (n, k, E)
    keep = r.keep.float()
    gate_vals = r.gate_vals * keep
    # (n, k, E, C) one-hot over (expert, slot) -> dispatch / combine (n, E, C);
    # a dropped choice's slot is clipped into range, then masked by keep
    slot = F.one_hot(r.pos.clamp_max(cap - 1), cap).float()
    sel = oh[..., None] * slot[:, :, None, :] * keep[..., None, None]
    dispatch = sel.sum(1)
    combine = (sel * copy_to_tp(gate_vals, tp)[..., None, None]).sum(1)

    cd = compute_dtype
    xe = _einsum_f32("nd,nec->ecd", copy_to_tp(xt, tp), dispatch, cd).to(cd)
    ye = _experts(params, xe, cd)  # (E, C, d)
    out = torch.einsum("nec,ecd->nd", combine, ye)
    if tp is not None and tp.serving:
        out = serve_all_reduce_(out.contiguous(), tp.group, "sum")
    else:
        out = reduce_from_tp(out, tp)

    f = oh.sum(1).mean(0)  # share of choices routed to each expert
    aux = E * (f * probs.mean(0)).sum() / k
    return out.reshape(b, t, d).to(x.dtype), aux


def _route_topk(params: dict, xt: torch.Tensor, k: int):
    """The router: fp32 probabilities (n, E), their top k and the gate
    weights renormalized over them."""
    probs = torch.softmax(linear(params["router"], xt, torch.float32), dim=-1)  # (n, E)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)  # (n, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return gate_vals, gate_idx, probs


def _experts(params: dict, xe: torch.Tensor, cd) -> torch.Tensor:
    """The experts' gated MLPs on their slots (E, C, d) -> fp32 (E, C, d)."""
    y, gate = _einsum_f32("ecd,edf->ecf", xe, params["w1"], cd).chunk(2, dim=-1)
    h = (y * F.silu(gate)).to(cd)
    return _einsum_f32("ecf,efd->ecd", h, params["w2"], cd)


def moe_queue(counts: torch.Tensor, cap: int, seq: int = 1):
    """The global queue of the global micro-batch's choices from every
    token rank's per-row integer counts (R S, b, k, E): rank ``c S + s``
    holds rows ``[c b, (c + 1) b)`` and their s-th block of tokens.
    Returns (first, kept), each (R S, b, k, E).  ``first[g, i, j, e]``
    is the slot of the first choice-j token of rank g's row i at expert
    e in the JAX package's priority order, which flattens the global
    (rows, tokens) row-major: every choice-j token after every
    choice-(j-1) one; within one choice the rows in order, a row's S
    blocks one after another, a block's tokens in order.  Its tokens take
    the next slots, and ``kept`` of them fit under ``cap``."""
    g, b, k, E = counts.shape
    # the segments (row, block) in the queue's order: (c, i, s)
    segs = counts.reshape(g // seq, seq, b, k, E).transpose(1, 2).reshape(-1, k, E)
    total = segs.sum(0)  # (k, E)
    first = (total.cumsum(0) - total)[None] + (segs.cumsum(0) - segs)
    kept = (cap - first).clamp(min=0).minimum(segs)

    def back(v):  # queue order -> rank order
        return v.reshape(g // seq, b, seq, k, E).transpose(1, 2).reshape(g, b, k, E)

    return back(first), back(kept)


class MoERoute(NamedTuple):
    """One rank's routing of its block of the global micro-batch."""

    gate_vals: torch.Tensor  # (n, k) fp32, renormalized over the top k
    gate_idx: torch.Tensor   # (n, k) experts
    probs: torch.Tensor      # (n, E) fp32
    pos: torch.Tensor        # (n, k) global slots in the experts' queues
    keep: torch.Tensor       # (n, k) bool: the slot is under the capacity
    first: torch.Tensor      # (R S, b, k, E) from moe_queue
    kept: torch.Tensor       # (R S, b, k, E)
    cap: int


def moe_route(params: dict, cfg: ModelConfig, xt: torch.Tensor, route=None,
              rows: int = 1) -> MoERoute:
    """The routing of this rank's tokens ``xt`` (n, d), ``rows`` rows of
    n / rows tokens each, over the token ranks of ``route`` (None: one
    device, the tokens are the whole micro-batch), as the JAX package
    routes the concatenated global micro-batch: the capacity counts the
    global tokens, and a choice's slot is its expert's count of the
    earlier choices, of the earlier rows and row blocks' same choice
    (``moe_queue``, from every rank's per-row (b, k, E) counts,
    all-gathered over the batch and seq ranks) and the exclusive cumsum
    within its row block: exact integers, the JAX package's float cumsum
    of one-hots."""
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    n = xt.shape[0]
    ranks, seq, index = ((1, 1, 0) if route is None
                         else (route.size * route.seq, route.seq, route.index))
    cap = max(1, -(-int(cfg.moe_capacity_factor * k * n * ranks) // E))
    gate_vals, gate_idx, probs = _route_topk(params, xt, k)
    oh = F.one_hot(gate_idx, E).reshape(rows, n // rows, k, E)  # int64
    counts = oh.sum(1)  # (b, k, E)
    if route is None:
        counts = counts[None]
    else:
        counts = gather_counts(counts, route.group, ranks)
        if route.order is not None:  # into token order
            counts = counts[list(route.order)]
    first, kept = moe_queue(counts, cap, seq)
    pos = ((oh.cumsum(1) - oh + first[index][:, None]) * oh).sum(-1).reshape(n, k)
    return MoERoute(gate_vals, gate_idx, probs, pos, pos < cap, first, kept, cap)


def _moe_routed(params: dict, cfg: ModelConfig, x: torch.Tensor, cd, tp, route, ep):
    """``_moe_mlp`` over the token ranks of ``route``: the result of the
    JAX package's ``_moe_mlp`` on the concatenated global micro-batch,
    for this rank's tokens.

    The routing is ``moe_route``'s.  The load-balance sums are summed
    over the batch and seq ranks both ways (``route_sum``) and divided by
    the global token count.

    The kept (token, choice) rows go, in the compute dtype (JAX's ``xe``),
    ordered by (expert, slot), to the rank that holds their expert: with
    ``ep`` the expert rank of this rank's expert group (the ranks that
    differ from it on the expert axis alone, so the same seq block), by
    one all-to-all whose split sizes, like every received row's slot,
    every rank reads off the gathered counts (so only the rows cross);
    without ``ep``, this rank.  The expert rank scatters them into its
    (E/ep, C, d) slots at their global slot, runs its experts' gated MLPs
    and gathers the fp32 outputs back in received order; the reverse
    all-to-all returns them, and the gate weights combine them at their
    source rank."""
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    b, t, d = x.shape
    n = b * t
    xt = x.reshape(n, d)
    r = moe_route(params, cfg, xt, route, rows=b)
    cap, first, kept = r.cap, r.first, r.kept

    # this rank's kept rows, ordered by (expert, slot)
    tok, ch = r.keep.nonzero(as_tuple=True)
    expert, slot = r.gate_idx[tok, ch], r.pos[tok, ch]
    order = torch.argsort(expert * cap + slot)
    tok, ch = tok[order], ch[order]
    rows = copy_to_tp(xt, tp).to(cd)[tok]
    gate = copy_to_tp(r.gate_vals, tp)[tok, ch]

    # the sources of the rows this rank's experts take, in order: the
    # token ranks of its expert group
    size, rank = (1, 0) if ep is None else (ep.size, ep.rank)
    el = E // size
    srcs = (torch.arange(size, device=x.device) + route.coord - rank) * route.seq + route.seq_rank
    if ep is not None:
        per_rank = kept.sum((1, 2)).reshape(-1, size, el).sum(-1).tolist()  # (R S, size)
        send = per_rank[route.index]
        recv = [per_rank[s][rank] for s in srcs.tolist()]
        rows = all_to_all(rows, send, recv, ep)
    # received rows: by source, then local expert, then choice, then row, then slot
    mine = slice(rank * el, (rank + 1) * el)
    starts = first[srcs][..., mine].permute(0, 3, 2, 1).reshape(-1)  # (size, el, k, b)
    lengths = kept[srcs][..., mine].permute(0, 3, 2, 1).reshape(-1)
    local_e = torch.arange(el, device=x.device).repeat_interleave(k * b).repeat(size)
    offsets = lengths.cumsum(0) - lengths
    total = int(lengths.sum()) if ep is None else sum(recv)
    within = torch.arange(total, device=x.device) - offsets.repeat_interleave(lengths, 0,
                                                                              output_size=total)
    flat = (local_e * cap + starts).repeat_interleave(lengths, 0, output_size=total) + within

    xe = rows.new_zeros((el * cap, d)).index_copy(0, flat, rows).reshape(el, cap, d)
    ye = _experts(params, xe, cd).reshape(el * cap, d)[flat]  # fp32, received order
    if ep is not None:
        ye = all_to_all(ye, recv, send, ep)
    out = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    out = reduce_from_tp(out.index_add(0, tok, ye * gate[:, None]), tp)

    # the Switch aux over the global micro-batch: global f and P
    f = F.one_hot(r.gate_idx, E).sum((0, 1)).float()
    f, p_mean = route_sum(torch.stack([f, r.probs.sum(0)]), route) / (n * route.size
                                                                      * route.seq)
    aux = E * (f * p_mean).sum() / k
    return out.reshape(b, t, d).to(x.dtype), aux


def _ffn(bp: dict, cfg: ModelConfig, hidden, residual, residual_dtype=None, tp=None,
         route=None, ep=None, rows: int | None = None):
    """The block's second half (lm.py:281-297): add + ``norm2``, then the
    gated MLP or the MoE -> (hidden, residual, aux or None).  The stream
    is carried in ``residual_dtype`` (default: the config's); ``tp``: the
    tensor group, when the FFN splits over it; ``route`` and ``ep``: the
    MoE's batch ranks and expert group (``_moe_mlp``); ``rows``: the row
    count the gated MLP's GEMMs run at (``common.matmul``)."""
    normed, residual = add_rms_norm(hidden, residual, bp["norm2"]["weight"], cfg.norm_eps,
                                    residual_dtype=residual_dtype or _residual_dtype(cfg))
    cd = cfg.torch_compute_dtype
    if cfg.moe_num_experts:
        hidden, aux = _moe_mlp(bp["moe"], cfg, normed, cd, tp, route, ep)
        return hidden, residual, aux
    return _gated_mlp(bp["mlp"], normed, cd, tp, rows), residual, None


def _block_fwd(bp: dict, cfg: ModelConfig, hidden, residual, token_mask=None,
               initial_state=None, attn: bool = False, tp=None):
    """One prenorm block with its mixer's decode state:
    (hidden, residual) -> (hidden, residual, state).  A Mamba block's
    ``initial_state``/state is ``(conv_state, ssm_state)``.  An attention
    block (``attn=True``) in a chunked prefill takes ``(kv, page_table,
    lengths)``, ``kv`` the layer's 2- or 4-tuple of pages, and returns
    them, written in place; with no ``initial_state`` (one-shot prefill) it returns the
    raw full-sequence ``(k, v)``.  ``tp``: a serving mesh's model group
    (each block on it when its heads divide, ``block_tp``)."""
    normed, residual = add_rms_norm(
        hidden, residual, bp["norm"]["weight"], cfg.norm_eps,
        residual_dtype=_residual_dtype(cfg),
    )
    mixer_tp = block_tp(tp, cfg, "attn" if attn else "ssm")
    if attn and initial_state is None:
        hidden, state = attention_mixer(bp["mixer"], cfg, normed, return_final_state=True,
                                        tp=mixer_tp)
    elif attn:
        kv, page_table, lengths = initial_state
        hidden, state = attention_mixer_chunk(bp["mixer"], cfg, normed, kv, page_table,
                                              lengths, token_mask=token_mask, tp=mixer_tp)
    else:
        ics, iss = (None, None) if initial_state is None else initial_state
        hidden, state = _MIXERS[cfg.ssm_layer].forward(
            bp["mixer"], cfg, normed, initial_conv_state=ics,
            initial_ssm_state=iss, return_final_state=True, token_mask=token_mask,
            tp=mixer_tp,
        )
    if cfg.d_intermediate > 0:
        hidden, residual, _ = _ffn(bp, cfg, hidden, residual, tp=block_tp(tp, cfg, "ffn"))
    return hidden, residual, state


def _head_logits(params: dict, cfg: ModelConfig, normed: torch.Tensor,
                 tp=None, rows: int | None = None) -> torch.Tensor:
    """LM head in serving: the tied head's fp32-accumulated fp32 logits,
    or the untied ``lm_head`` through ``linear``, rounded to the compute
    dtype and returned in fp32 (lm.py:331-340, :1191-1195).  Under a
    serving ``tp`` the head is column-parallel over the vocab and the
    model group gathers every rank's block, so each rank holds the full
    row.  ``rows``: the row count the GEMM runs at (``common.matmul``)."""
    if cfg.tie_embeddings:
        logits = _tied_logits(params, normed, cfg.torch_compute_dtype, rows)
    else:
        logits = linear(params["lm_head"], normed, cfg.torch_compute_dtype, rows).float()
    return logits if tp is None else serve_gather(logits, tp, -1, "logits")


def count_params(params: dict) -> int:
    """Number of scalars in a parameter tree."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()


def _train_block(bp: dict, cfg: ModelConfig, res: torch.Tensor, attn: bool, tp=None,
                 route=None, ep=None, seq=None):
    """One prenorm block in the single-carry form of the JAX
    ``_backbone`` (lm.py:437-444; the JAX ``_block_fwd`` of training):
    the post-add stream -> (the next one, the MoE aux term or None),
    through the attention mixer at an attention layer.  ``tp``: the
    tensor group (``TPContext``); the mixer and the FFN each split over it
    when their heads divide by its size and run whole otherwise
    (``tp_layout.block_tp``).  ``route`` and ``ep``: the MoE's batch
    ranks and expert group (``_moe_mlp``).  ``seq``: the seq group
    (``SeqContext``), ``res`` this rank's block of the sequence."""
    normed = rms_norm(res, bp["norm"]["weight"], cfg.norm_eps).to(cfg.torch_compute_dtype)
    mixer = attention_mixer if attn else _MIXERS[cfg.ssm_layer].forward
    mixer_tp = block_tp(tp, cfg, "attn" if attn else "ssm")
    hidden, aux = mixer(bp["mixer"], cfg, normed, tp=mixer_tp, seq=seq), None
    if cfg.d_intermediate > 0:
        hidden, res, aux = _ffn(bp, cfg, hidden, res, tp=block_tp(tp, cfg, "ffn"),
                                route=route, ep=ep)
    return res + hidden.to(res.dtype), aux


def _backbone(params: dict, cfg: ModelConfig, input_ids: torch.Tensor, tp=None, route=None,
              ep=None, seq=None):
    """Embedding -> layer stack in global order -> (the post-add stream
    before the final norm, the sum of the MoE aux terms or None)
    (lm.py:415-519; the JAX periodic-hybrid scan over supersteps and its
    unrolled aperiodic loop are this one loop).  With ``cfg.remat`` and
    autograd on, each block is checkpointed as a whole under
    ``cfg.remat_policy`` (ops/remat.py), as the JAX ``mbody``/``abody``;
    under ``tp`` a recompute runs the block's forward all-reduces again,
    in the same order on every tensor rank, and under ``route``/``ep``
    the MoE's count exchange and all-to-alls, which route exactly as the
    forward did (the slots come from integer counts); under ``seq``
    (``input_ids`` this rank's block of the sequence) the halo, state
    and ring or Ulysses exchanges, in the same order on every seq rank."""
    res = _embed(params, input_ids, cfg.torch_compute_dtype).to(_residual_dtype(cfg))
    remat = cfg.remat and torch.is_grad_enabled()
    mblocks = _unstack(params["blocks"], cfg.n_layer - len(cfg.attn_layer_idx))
    ablocks = (_unstack(params["attn_blocks"], len(cfg.attn_layer_idx))
               if cfg.attn_layer_idx else [])
    aux_total = None
    for attn, j in _layer_plan(cfg):
        bp = ablocks[j] if attn else mblocks[j]
        if remat:
            res, aux = remat_block(_train_block, cfg.remat_policy, bp, cfg, res, attn, tp,
                                   route, ep, seq)
        else:
            res, aux = _train_block(bp, cfg, res, attn, tp, route, ep, seq)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    return res, aux_total


def _final_norm(params: dict, cfg: ModelConfig, res: torch.Tensor) -> torch.Tensor:
    """Final norm of the post-add stream (lm.py:299-316, single-carry form)."""
    return rms_norm(res.to(_residual_dtype(cfg)), params["norm_f"]["weight"], cfg.norm_eps)


def _head_matrix(params: dict, cfg: ModelConfig) -> torch.Tensor:
    """(V, d) LM-head matrix of the blocked loss: the tied embedding, or
    the ``lm_head`` kernel transposed (lm.py:319-328)."""
    if cfg.tie_embeddings:
        return params["embedding"]
    if "bias" in params["lm_head"]:  # not an assert: must survive python -O
        raise ValueError(
            "blocked CE assumes a bias-free lm_head; a bias would be "
            "silently ignored, training against a wrong loss"
        )
    return params["lm_head"]["kernel"].t()


def _mean_aux(cfg: ModelConfig, aux_total, like: torch.Tensor) -> torch.Tensor:
    """The per-layer mean of the MoE aux terms, 0 without a MoE (lm.py:538-541)."""
    if aux_total is None:
        return like.new_zeros((), dtype=torch.float32)
    return aux_total / cfg.n_layer


def _train_logits(params: dict, cfg: ModelConfig, res: torch.Tensor) -> torch.Tensor:
    """The final norm and the head of the post-add stream: one
    compute-dtype GEMM (``lm_forward``)."""
    cd = cfg.torch_compute_dtype
    normed = _final_norm(params, cfg, res)
    if cfg.tie_embeddings:
        return normed.to(cd) @ params["embedding"].to(cd).t()
    return linear(params["lm_head"], normed, cd)


def _dense_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy in fp32: ``logsumexp - gathered logit``."""
    lf = logits.float()
    tgt = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    return (torch.logsumexp(lf, dim=-1) - tgt).mean()


def lm_forward(params: dict, cfg: ModelConfig, input_ids: torch.Tensor,
               return_aux: bool = False, tp=None, route=None, ep=None, seq=None):
    """input_ids (b, t) -> logits (b, t, V) in the compute dtype (lm.py:522-542)
    [, the per-layer mean of the MoE aux terms, 0 for a dense model].

    The head is one compute-dtype GEMM: fp32 accumulation rounded once to
    the compute dtype, the rounding the JAX package applies to its fp32
    logits (lm.py:538), and a product autograd differentiates.  ``tp``:
    this rank's packed params over the tensor group
    (``parallel/tp_layout.py``); the head is replicated, so every tensor
    rank returns the whole logits.  ``route``/``ep``: this rank's block
    of the global micro-batch and its experts (``_moe_mlp``).  ``seq``:
    ``input_ids`` (b, t_local) is this rank's block of every sequence
    (``SeqContext``), and so are the logits."""
    res, aux_total = _backbone(params, cfg, input_ids, tp, route, ep, seq)
    logits = _train_logits(params, cfg, res)
    if return_aux:
        return logits, _mean_aux(cfg, aux_total, res)
    return logits


def lm_loss(params: dict, cfg: ModelConfig, input_ids: torch.Tensor,
            targets: torch.Tensor, tp=None, route=None, ep=None, seq=None) -> torch.Tensor:
    """Mean cross-entropy in fp32 against the loader's pre-shifted
    targets, plus ``moe_aux_weight`` times the mean MoE aux term for a
    MoE model (lm.py:545-586).  ``loss_impl="dense"``: one head product,
    then ``logsumexp - gathered logit`` (no (b, t, V) log-prob tensor);
    ``"blocked"``: ops/loss.py, where no (b, t, V) tensor exists at all.
    Under ``seq`` the mean is over this rank's block of the tokens (the
    step's mean over the seq ranks makes it the global one)."""
    if cfg.loss_impl == "blocked":
        from mamba_distributed_tpu_torch.ops.loss import blocked_cross_entropy

        res, aux_total = _backbone(params, cfg, input_ids, tp, route, ep, seq)
        ce = blocked_cross_entropy(_final_norm(params, cfg, res), _head_matrix(params, cfg),
                                   targets, cfg.loss_vocab_blocks, cfg.torch_compute_dtype)
        aux = _mean_aux(cfg, aux_total, res)
    else:
        logits, aux = lm_forward(params, cfg, input_ids, return_aux=True, tp=tp,
                                 route=route, ep=ep, seq=seq)
        ce = _dense_ce(logits, targets)
    if cfg.moe_num_experts:
        return ce + cfg.moe_aux_weight * aux
    return ce


def lm_loss_pipelined(params: dict, cfg: ModelConfig, input_ids: torch.Tensor,
                      targets: torch.Tensor, pipe=None) -> torch.Tensor:
    """``lm_loss`` averaged over the microbatches of input_ids/targets
    (n_micro, b, t), the layer stack pipelined over the pipe group
    ``pipe`` (``parallel/pipeline.PipeContext``; None: one stage)
    (lm.py:589-660).  ``params`` holds this stage's block of every
    stacked leaf (``parallel/sharding.stage_block``) and the whole of
    the others.

    The microbatches are the pipeline's (``pipelined_layers``).  Stage 0
    embeds them; a uniform stack pipelines per layer, a periodic hybrid
    per superstep ``[offset mamba] -> attn -> [rest mamba]`` (JAX
    ``_group_mamba_stack``), each block checkpointed under
    ``cfg.remat_policy`` when ``cfg.remat`` is on, as in
    ``_backbone``.  The last stage alone runs the final norm, the head
    and the dense loss, and broadcasts the loss to the other stages,
    whose gradient of it runs the schedule's backward only: so the
    embedding's gradient is stage 0's, the head's and the final norm's
    the last stage's (a tied embedding gets both), and their sum over
    the pipe group is the whole gradient (the train step's)."""
    size, stage = (1, 0) if pipe is None else (pipe.size, pipe.rank)
    rdt = _residual_dtype(cfg)
    if stage == 0:
        xs = _embed(params, input_ids, cfg.torch_compute_dtype).to(rdt)
    else:  # only stage 0 reads the microbatches
        xs = torch.zeros((*input_ids.shape, cfg.d_model), dtype=rdt, device=input_ids.device)

    def block(bp, res, attn):
        if cfg.remat and torch.is_grad_enabled():
            return remat_block(_train_block, cfg.remat_policy, bp, cfg, res, attn)[0]
        return _train_block(bp, cfg, res, attn)[0]

    if cfg.attn_layer_idx:
        period, offset = _hybrid_period(cfg)
        groups = params["attn_blocks"]["norm"]["weight"].shape[0]  # this stage's supersteps
        stacked = {"mamba": _map_leaves(lambda v: v.reshape(groups, period - 1, *v.shape[1:]),
                                        params["blocks"]),
                   "attn": params["attn_blocks"]}

        def body(res, grp):
            mamba = _unstack(grp["mamba"], period - 1)
            for bp in mamba[:offset]:
                res = block(bp, res, False)
            res = block(grp["attn"], res, True)
            for bp in mamba[offset:]:
                res = block(bp, res, False)
            return res
    else:
        stacked = params["blocks"]

        def body(res, bp):
            return block(bp, res, False)

    res = pipelined_layers(body, stacked, xs, pipe)
    if stage == size - 1:
        ce = _dense_ce(_train_logits(params, cfg, res), targets)
    else:  # no loss here; the zero ties the schedule's output to the graph
        ce = res.sum() * 0.0
    return ce if pipe is None else from_last_stage(ce, pipe)


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack_states(states: list) -> tuple:
    """Per-layer state tuples -> one tuple of layer-stacked tensors (a
    Mamba (conv, ssm), or an attention layer's 2- or 4-tuple of pages)."""
    return tuple(torch.stack(parts) for parts in zip(*states))




# ------------------------------------------------ serving over a stage axis


def stage_layers(cfg: ModelConfig, stages: int) -> tuple[int, int]:
    """Layers of each family a stage holds: (Mamba, attention).  Stage s
    holds the s-th contiguous block of each stack (``blocks`` and
    ``attn_blocks`` cut separately, JAX ``validate_serving_stage_shards``)."""
    n_attn = len(cfg.attn_layer_idx)
    return (cfg.n_layer - n_attn) // stages, n_attn // stages


def _walk(cfg: ModelConfig, hidden, residual, run, stage=None):
    """The layer plan in order: ``run(attn, j, hidden, residual) ->
    (hidden, residual)`` for each layer, ``j`` its index in this rank's
    stack of its family.  With ``stage`` (a serving mesh's stage group)
    only the layers this stage owns run here, and before a layer owned
    by another stage than the one holding the activation pair, the pair
    moves there point to point (``stage_handoff``); a hybrid plan can
    cross a stage boundary more than once.  The last layer of each
    family lives on the last stage, so the pair ends there."""
    if stage is None:
        for attn, j in _layer_plan(cfg):
            hidden, residual = run(attn, j, hidden, residual)
        return hidden, residual
    per = stage_layers(cfg, stage.size)
    cur = 0
    for attn, j in _layer_plan(cfg):
        owner, jl = divmod(j, per[1] if attn else per[0])
        if owner != cur:
            hidden = stage_handoff(hidden, stage, cur, owner)
            residual = stage_handoff(residual, stage, cur, owner)
            cur = owner
        if owner == stage.rank:
            hidden, residual = run(attn, jl, hidden, residual)
    return hidden, residual


def _start(params: dict, cfg: ModelConfig, ids: torch.Tensor, residual_dtype, tp=None,
           stage=None):
    """The embedded ids and a zero residual (stage 0 embeds; a later
    stage holds buffers of their shape until the pair reaches it)."""
    cd = cfg.torch_compute_dtype
    if stage is None or stage.rank == 0:
        hidden = _embed(params, ids, cd, tp)
    else:
        hidden = torch.empty((*ids.shape, cfg.d_model), dtype=cd, device=ids.device)
    return hidden, torch.zeros_like(hidden, dtype=residual_dtype)


def _stage_logits(params: dict, cfg: ModelConfig, hidden, residual, residual_dtype,
                  tp=None, stage=None, rows: int | None = None) -> torch.Tensor:
    """Final add+norm -> LM head, fp32 logits, on the last stage, which
    then broadcasts them over the stage group (JAX's psum from the last
    stage); every rank returns them.  ``rows``: as in ``_head_logits``."""
    if stage is None or stage.rank == stage.size - 1:
        normed, _ = add_rms_norm(hidden, residual, params["norm_f"]["weight"], cfg.norm_eps,
                                 residual_dtype=residual_dtype)
        logits = _head_logits(params, cfg, normed, tp, rows)
    else:
        logits = torch.empty((*hidden.shape[:-1], cfg.vocab_size_padded),
                             dtype=torch.float32, device=hidden.device)
    if stage is not None:
        serve_broadcast_(logits, stage, stage.size - 1, "stage_logits")
    return logits


def lm_prefill(params: dict, cfg: ModelConfig, input_ids: torch.Tensor,
               max_len: int = 0, token_mask: torch.Tensor | None = None, tp=None,
               stage=None):
    """Parallel prefill: one full-sequence forward that also returns
    every layer's decode state (lm.py:672-801).  ``token_mask`` (b, t)
    marks left-padded bucketed prompts (inference/bucketing.py; pure-SSM
    stacks only).  ``tp`` and ``stage``: a serving mesh's model and
    stage groups (``params`` then this rank's serving shard,
    parallel/tp_layout.serving_plan and ``stage_cut``; the state is this
    rank's heads of its stage's layers).

    Returns (last_logits (b, V) fp32, state): ``{"blocks": (conv, ssm)}``,
    and for a hybrid stack each attention layer's K/V packed into an
    identity-paged cache of capacity ``max_len`` (> the prompt length)
    with every row's length at t."""
    b, t = input_ids.shape
    hybrid = bool(cfg.attn_layer_idx)
    if hybrid and max_len <= t:
        raise ValueError(
            f"hybrid prefill needs KV capacity beyond the prompt: "
            f"max_len={max_len} <= prompt length {t}"
        )
    if hybrid and token_mask is not None:
        raise ValueError(
            "token_mask prefill is SSM-only (full-sequence attention would "
            "attend the pad keys); hybrid bucketed prompts go through the "
            "chunk step (serving/prefill.py) instead"
        )
    rdt = _residual_dtype(cfg)
    hidden, residual = _start(params, cfg, input_ids, rdt, tp, stage)
    n_m, n_a = stage_layers(cfg, 1 if stage is None else stage.size)
    mblocks = _unstack(params["blocks"], n_m)
    ablocks = _unstack(params["attn_blocks"], n_a) if hybrid else []
    states, pages = [], []

    def run(attn, j, hidden, residual):
        hidden, residual, st = _block_fwd(ablocks[j] if attn else mblocks[j], cfg, hidden,
                                          residual, token_mask=token_mask, attn=attn, tp=tp)
        if attn:
            pages.append(pack_attention_pages(cfg, *st, max_len))
        else:
            states.append(st)
        return hidden, residual

    hidden, residual = _walk(cfg, hidden, residual, run, stage)
    logits = _stage_logits(params, cfg, hidden[:, -1:], residual[:, -1:], rdt, tp, stage)
    state = {"blocks": _stack_states(states)}
    if hybrid:
        state["attn_blocks"] = _stack_states(pages)
        state["attn_meta"] = (attention_page_meta(cfg, b, max_len, input_ids.device)[0],
                              torch.full((b,), t, dtype=torch.int32, device=input_ids.device))
    return logits[:, 0].float(), state


def _chunk_backbone(params: dict, cfg: ModelConfig, input_ids, state,
                    token_mask=None, tp=None, stage=None):
    """Embed -> carry-threaded layer stack -> (hidden, residual, state').
    Hybrid stacks write each attention layer's pages in place and
    advance ``lengths`` by the chunk's real tokens."""
    hidden, residual = _start(params, cfg, input_ids, _residual_dtype(cfg), tp, stage)
    conv, ssm = state["blocks"]
    mblocks = _unstack(params["blocks"], conv.shape[0])
    states = []
    if cfg.attn_layer_idx:
        kv_all = state["attn_blocks"]
        ablocks = _unstack(params["attn_blocks"], kv_all[0].shape[0])
        tbl, lengths = state["attn_meta"]

    def run(attn, j, hidden, residual):
        if attn:
            hidden, residual, _ = _block_fwd(
                ablocks[j], cfg, hidden, residual, token_mask=token_mask,
                initial_state=(tuple(x[j] for x in kv_all), tbl, lengths), attn=True, tp=tp,
            )
        else:
            hidden, residual, st = _block_fwd(
                mblocks[j], cfg, hidden, residual, token_mask=token_mask,
                initial_state=(conv[j], ssm[j]), tp=tp,
            )
            states.append(st)
        return hidden, residual

    hidden, residual = _walk(cfg, hidden, residual, run, stage)
    new_state = {"blocks": _stack_states(states)}
    if cfg.attn_layer_idx:
        b, c = input_ids.shape
        n_real = (torch.full((b,), c, dtype=torch.int32, device=lengths.device)
                  if token_mask is None
                  else (token_mask > 0.5).sum(dim=1).to(torch.int32))
        new_state["attn_blocks"] = kv_all
        new_state["attn_meta"] = (tbl, lengths + n_real)
    return hidden, residual, new_state


def lm_prefill_chunk(params: dict, cfg: ModelConfig, input_ids: torch.Tensor,
                     state: dict, token_mask: torch.Tensor | None = None, tp=None,
                     stage=None):
    """Resumable prefill of one chunk: every layer's mixer starts from
    ``state`` (what ``init_lm_state`` or a previous chunk produced).
    Returns (last_logits (b, V) fp32, new state).  The conv and SSM
    carries of ``state`` are not modified; a hybrid stack's KV pages are
    written IN PLACE (the new state holds the same page tensors) and its
    lengths advance by the chunk's real tokens.  ``tp``/``stage``: as in
    ``lm_prefill``."""
    hidden, residual, new_state = _chunk_backbone(params, cfg, input_ids,
                                                  state, token_mask, tp, stage)
    logits = _stage_logits(params, cfg, hidden[:, -1:], residual[:, -1:],
                           _residual_dtype(cfg), tp, stage)
    return logits[:, 0].float(), new_state


def lm_verify_chunk(params: dict, cfg: ModelConfig, input_ids: torch.Tensor,
                    state: dict, token_mask: torch.Tensor | None = None, tp=None,
                    stage=None):
    """The speculative-decoding verify step (lm.py:844-872): the chunk
    step of ``lm_prefill_chunk`` (the same carry threading and paged KV
    write) with the logits of EVERY position.  Returns (logits (b, c, V)
    fp32, new state), ``logits[:, i]`` scoring the token after
    ``input_ids[:, i]``.

    The new state has passed all ``c`` fed tokens, so a caller that
    accepts fewer keeps the input carries, which this step leaves
    untouched (serving/spec_decode.py).  A hybrid's pages are written in
    place at ``[lengths, lengths + n_real)``; on a rejection the caller
    does not advance its lengths, so those cells stay dead and the next
    verify writes them again.  ``tp``/``stage``: as in ``lm_prefill``."""
    hidden, residual, new_state = _chunk_backbone(params, cfg, input_ids,
                                                  state, token_mask, tp, stage)
    return _stage_logits(params, cfg, hidden, residual, _residual_dtype(cfg), tp,
                         stage).float(), new_state


def init_lm_blocks_state(cfg: ModelConfig, batch: int, device=None, tp=None, stages: int = 1):
    """Layer-stacked zero conv+SSM decode states of the Mamba layers (in a
    hybrid stack the attention layers' KV lives in the paged cache); on a
    serving mesh, this rank's heads (``tp``) of one stage's layers (of
    ``stages``)."""
    cs, ss = _MIXERS[cfg.ssm_layer].init_state(cfg, batch, device, tp=tp)
    n = stage_layers(cfg, stages)[0]
    return (cs[None].repeat(n, *([1] * cs.ndim)),
            ss[None].repeat(n, *([1] * ss.ndim)))


def init_lm_state(cfg: ModelConfig, batch: int, max_len: int = 0,
                  device=None, tp=None, stages: int = 1) -> dict:
    """Zero decode state.  Hybrid stacks add a private paged KV cache
    sized for ``max_len`` tokens per row (identity page table, zero
    lengths), one page pool per attention layer.  ``tp``/``stages``: as
    in ``init_lm_blocks_state``."""
    state = {"blocks": init_lm_blocks_state(cfg, batch, device, tp, stages)}
    if cfg.attn_layer_idx:
        n_attn = stage_layers(cfg, stages)[1]
        state["attn_blocks"] = tuple(
            x[None].repeat(n_attn, *([1] * x.ndim))
            for x in init_attention_state(cfg, batch, max_len, device,
                                          tp=block_tp(tp, cfg, "attn")))
        state["attn_meta"] = attention_page_meta(cfg, batch, max_len, device)
    return state


def _block_step(bp: dict, cfg: ModelConfig, hidden, residual, st, attn_ctx=None, tp=None,
                rows: int | None = None):
    """One decode-step block; its state ``st`` is updated in place.  A
    Mamba block's ``st`` is ``(conv, ssm)``; an attention block's is
    ``(k_pages, v_pages)`` (int8: with ``k_scale, v_scale``) and
    ``attn_ctx = (page_table, lengths, write_mask, split_rows)``.
    ``tp``: a serving mesh's model group; ``rows``: the row count the
    block's GEMMs run at (``common.matmul``)."""
    normed, residual = add_rms_norm(hidden, residual, bp["norm"]["weight"],
                                    cfg.norm_eps)
    if attn_ctx is not None:
        hidden, _ = attention_mixer_step(bp["mixer"], cfg, normed, st, *attn_ctx,
                                         tp=block_tp(tp, cfg, "attn"), rows=rows)
    else:
        hidden, _ = _MIXERS[cfg.ssm_layer].step(bp["mixer"], cfg, normed, *st,
                                                tp=block_tp(tp, cfg, "ssm"), rows=rows)
    if cfg.d_intermediate > 0:
        ffn_tp = block_tp(tp, cfg, "ffn")
        if cfg.moe_num_experts:
            # the MoE routes a (b, 1) token block (lm.py:1047-1058)
            hidden, residual, _ = _ffn(bp, cfg, hidden[:, None], residual[:, None],
                                       torch.float32, tp=ffn_tp)
            return hidden[:, 0], residual[:, 0]
        hidden, residual, _ = _ffn(bp, cfg, hidden, residual, torch.float32, tp=ffn_tp,
                                   rows=rows)
    return hidden, residual


def lm_step(params: dict, cfg: ModelConfig, state: dict, token: torch.Tensor,
            write_mask: torch.Tensor | None = None, split_rows: int | None = None,
            tp=None, stage=None, pipeline: int | None = None, gemm_rows: int | None = None):
    """One decode step: token (b,) -> (logits (b, V) fp32, state).

    The state is updated IN PLACE (each layer's conv cache and SSM state,
    and a hybrid's KV pages, are overwritten in the caller's tensors):
    decode state is the largest thing a decode step touches, and a
    functional update would copy all of it every token.  A hybrid's
    ``lengths`` advance by one per row (by ``write_mask`` when given: its
    masked rows write the trash page and keep their length) in a new
    ``attn_meta`` of the returned state dict.  ``split_rows`` pins the
    paged decode's split rule (``models/attention.attention_mixer_step``);
    ``gemm_rows`` the row count every GEMM of the step runs at, zero-padded
    (``models/common.matmul``; None: the batch's own).

    ``tp``/``stage``: a serving mesh's model and stage groups (as in
    ``lm_prefill``).  ``pipeline=n_micro`` (a pure-SSM stack over
    ``stage``) runs the Mamba stack through the GPipe decode clock
    (``parallel/pipeline.pipelined_decode_layers``, JAX lm.py:1166-1185)
    instead of the layer walk: the same per-lane arithmetic."""
    hidden, residual = _start(params, cfg, token, torch.float32, tp, stage)
    conv, ssm = state["blocks"]
    mblocks = _unstack(params["blocks"], conv.shape[0])
    if pipeline is not None:
        if cfg.attn_layer_idx or stage is None:
            raise ValueError("lm_step(pipeline=) runs a pure-SSM stack over a stage group")

        def body(act, bp, st):
            return _block_step(bp, cfg, *act, st, tp=tp, rows=gemm_rows)

        out, _ = pipelined_decode_layers(
            body, mblocks, (conv, ssm), (hidden, residual), stage, n_micro=pipeline,
            n_layer=cfg.n_layer)
        if out is not None:  # the last stage's; the others' logits come from it
            hidden, residual = out
        logits = _stage_logits(params, cfg, hidden, residual, torch.float32, tp, stage,
                               gemm_rows)
        return logits, state
    if cfg.attn_layer_idx:
        kv_all = state["attn_blocks"]
        ablocks = _unstack(params["attn_blocks"], kv_all[0].shape[0])
        tbl, lengths = state["attn_meta"]
        attn_ctx = (tbl, lengths, write_mask, split_rows)

    def run(attn, j, hidden, residual):
        if attn:
            return _block_step(ablocks[j], cfg, hidden, residual,
                               tuple(x[j] for x in kv_all), attn_ctx, tp=tp, rows=gemm_rows)
        return _block_step(mblocks[j], cfg, hidden, residual, (conv[j], ssm[j]), tp=tp,
                           rows=gemm_rows)

    hidden, residual = _walk(cfg, hidden, residual, run, stage)
    logits = _stage_logits(params, cfg, hidden, residual, torch.float32, tp, stage, gemm_rows)
    if cfg.attn_layer_idx:
        adv = 1 if write_mask is None else write_mask.to(lengths.dtype)
        state = {**state, "attn_meta": (tbl, lengths + adv)}
    return logits, state
