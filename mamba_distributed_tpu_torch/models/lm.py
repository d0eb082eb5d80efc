"""Language model (counterpart of ``mamba_distributed_tpu/models/lm.py``):
embedding -> N prenorm blocks -> final norm -> tied head.  Every block is
a Mamba mixer of ``cfg.ssm_layer`` (Mamba-2 SSD or Mamba-1 selective
scan), or, in a hybrid stack, an attention mixer at the layers
``cfg.attn_layer_idx`` over a paged KV cache (models/attention.py).

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
                               "out_proj": {"kernel": (A, nh hd, d)}}}}

The JAX ``lax.scan`` over stacked layers (and, for periodic hybrids, its
scan over supersteps) becomes one Python loop over the layers in global
order, with a Mamba and an attention counter; it computes the same thing
in the same order.  Decode state is ``{"blocks": (conv, ssm)}``, stacked
on the layer axis: for Mamba-2 conv (L, b, d_conv-1, conv_dim) and ssm
(L, b, h, p, n) fp32, for Mamba-1 conv (L, b, d_conv-1, d_inner) and ssm
(L, b, d_inner, n) fp32; for hybrids also ``"attn_blocks": (k_pages,
v_pages)`` each (A, P, nkv, page, hd) and ``"attn_meta": (page_table
(b, W) int32, lengths (b,) int32)``, shared by every attention layer.

Training (pure and hybrid stacks): ``lm_forward``/``lm_loss`` carry one
post-add fp32 stream through the layers in global order, as the JAX
``_backbone`` does, each block (Mamba or attention) checkpointed as a
whole when ``cfg.remat`` is on.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.models.attention import (
    attention_mixer,
    attention_mixer_chunk,
    attention_mixer_step,
    attention_page_meta,
    init_attention_params,
    init_attention_state,
    pack_attention_pages,
)
from mamba_distributed_tpu_torch.models.common import mm_f32
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
    return params


def _embed(params: dict, ids: torch.Tensor, compute_dtype) -> torch.Tensor:
    return params["embedding"][ids].to(compute_dtype)


def _residual_dtype(cfg: ModelConfig):
    return torch.float32 if cfg.residual_in_fp32 else cfg.torch_compute_dtype


def _block_fwd(bp: dict, cfg: ModelConfig, hidden, residual, token_mask=None,
               initial_state=None, attn: bool = False):
    """One prenorm block with its mixer's decode state:
    (hidden, residual) -> (hidden, residual, state).  A Mamba block's
    ``initial_state``/state is ``(conv_state, ssm_state)``.  An attention
    block (``attn=True``) in a chunked prefill takes ``((k_pages,
    v_pages), page_table, lengths)`` and returns the pages, written in
    place; with no ``initial_state`` (one-shot prefill) it returns the
    raw full-sequence ``(k, v)``."""
    normed, residual = add_rms_norm(
        hidden, residual, bp["norm"]["weight"], cfg.norm_eps,
        residual_dtype=_residual_dtype(cfg),
    )
    if attn and initial_state is None:
        hidden, state = attention_mixer(bp["mixer"], cfg, normed, return_final_state=True)
        return hidden, residual, state
    if attn:
        kv, page_table, lengths = initial_state
        hidden, state = attention_mixer_chunk(bp["mixer"], cfg, normed, kv, page_table,
                                              lengths, token_mask=token_mask)
        return hidden, residual, state
    ics, iss = (None, None) if initial_state is None else initial_state
    hidden, state = _MIXERS[cfg.ssm_layer].forward(
        bp["mixer"], cfg, normed, initial_conv_state=ics,
        initial_ssm_state=iss, return_final_state=True, token_mask=token_mask,
    )
    return hidden, residual, state


def _final_logits(params: dict, cfg: ModelConfig, hidden, residual):
    """Final add+norm -> tied head, fp32-accumulated fp32 logits."""
    normed, _ = add_rms_norm(
        hidden, residual, params["norm_f"]["weight"], cfg.norm_eps,
        residual_dtype=_residual_dtype(cfg),
    )
    cd = cfg.torch_compute_dtype
    return mm_f32(normed.to(cd), params["embedding"].to(cd).t())


def count_params(params: dict) -> int:
    """Number of scalars in a parameter tree."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()


def _train_block(bp: dict, cfg: ModelConfig, res: torch.Tensor, attn: bool) -> torch.Tensor:
    """One prenorm block in the single-carry form of the JAX
    ``_backbone`` (lm.py:437-444): the post-add stream -> the next one,
    through the attention mixer at an attention layer."""
    normed = rms_norm(res, bp["norm"]["weight"], cfg.norm_eps).to(cfg.torch_compute_dtype)
    mixer = attention_mixer if attn else _MIXERS[cfg.ssm_layer].forward
    return res + mixer(bp["mixer"], cfg, normed).to(res.dtype)


def _backbone(params: dict, cfg: ModelConfig, input_ids: torch.Tensor) -> torch.Tensor:
    """Embedding -> layer stack in global order -> the post-add stream,
    before the final norm (lm.py:415-519; the JAX periodic-hybrid scan
    over supersteps and its unrolled aperiodic loop are this one loop).
    With ``cfg.remat`` and autograd on, each block is checkpointed as a
    whole (``remat_policy="all"``, as the JAX ``mbody``/``abody``): the
    backward keeps only each block's input stream and recomputes the
    rest, the SSD and flash forwards included."""
    res = _embed(params, input_ids, cfg.torch_compute_dtype).to(_residual_dtype(cfg))
    remat = cfg.remat and torch.is_grad_enabled()
    mblocks = _unstack(params["blocks"], cfg.n_layer - len(cfg.attn_layer_idx))
    ablocks = (_unstack(params["attn_blocks"], len(cfg.attn_layer_idx))
               if cfg.attn_layer_idx else [])
    for attn, j in _layer_plan(cfg):
        bp = ablocks[j] if attn else mblocks[j]
        if remat:
            res = checkpoint(_train_block, bp, cfg, res, attn, use_reentrant=False)
        else:
            res = _train_block(bp, cfg, res, attn)
    return res


def _final_norm(params: dict, cfg: ModelConfig, res: torch.Tensor) -> torch.Tensor:
    """Final norm of the post-add stream (lm.py:299-316, single-carry form)."""
    return rms_norm(res.to(_residual_dtype(cfg)), params["norm_f"]["weight"], cfg.norm_eps)


def lm_forward(params: dict, cfg: ModelConfig, input_ids: torch.Tensor) -> torch.Tensor:
    """input_ids (b, t) -> logits (b, t, V) in the compute dtype (lm.py:522-542).

    The tied head is one compute-dtype GEMM: fp32 accumulation rounded
    once to the compute dtype, the rounding the JAX package applies to
    its fp32 logits (lm.py:538), and a product autograd differentiates."""
    cd = cfg.torch_compute_dtype
    normed = _final_norm(params, cfg, _backbone(params, cfg, input_ids))
    return normed.to(cd) @ params["embedding"].to(cd).t()


def lm_loss(params: dict, cfg: ModelConfig, input_ids: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy in fp32 against the loader's pre-shifted
    targets, as ``logsumexp - gathered logit`` (the dense loss of
    lm.py:545-586: no (b, t, V) log-prob tensor)."""
    lf = lm_forward(params, cfg, input_ids).float()
    tgt = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    return (torch.logsumexp(lf, dim=-1) - tgt).mean()


def _stack_states(states: list) -> tuple:
    return (torch.stack([s[0] for s in states]),
            torch.stack([s[1] for s in states]))


def lm_prefill(params: dict, cfg: ModelConfig, input_ids: torch.Tensor,
               max_len: int = 0, token_mask: torch.Tensor | None = None):
    """Parallel prefill: one full-sequence forward that also returns
    every layer's decode state (lm.py:672-801).  ``token_mask`` (b, t)
    marks left-padded bucketed prompts (inference/bucketing.py; pure-SSM
    stacks only).

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
    cd = cfg.torch_compute_dtype
    hidden = _embed(params, input_ids, cd)
    residual = torch.zeros_like(hidden, dtype=_residual_dtype(cfg))
    mblocks = _unstack(params["blocks"], cfg.n_layer - len(cfg.attn_layer_idx))
    ablocks = _unstack(params["attn_blocks"], len(cfg.attn_layer_idx)) if hybrid else []
    states, pages = [], []
    for attn, j in _layer_plan(cfg):
        hidden, residual, st = _block_fwd(ablocks[j] if attn else mblocks[j], cfg, hidden,
                                          residual, token_mask=token_mask, attn=attn)
        if attn:
            pages.append(pack_attention_pages(cfg, *st, max_len))
        else:
            states.append(st)
    logits = _final_logits(params, cfg, hidden[:, -1:], residual[:, -1:])
    state = {"blocks": _stack_states(states)}
    if hybrid:
        state["attn_blocks"] = _stack_states(pages)
        state["attn_meta"] = (attention_page_meta(cfg, b, max_len, input_ids.device)[0],
                              torch.full((b,), t, dtype=torch.int32, device=input_ids.device))
    return logits[:, 0].float(), state


def _chunk_backbone(params: dict, cfg: ModelConfig, input_ids, state,
                    token_mask=None):
    """Embed -> carry-threaded layer stack -> (hidden, residual, state').
    Hybrid stacks write each attention layer's pages in place and
    advance ``lengths`` by the chunk's real tokens."""
    cd = cfg.torch_compute_dtype
    hidden = _embed(params, input_ids, cd)
    residual = torch.zeros_like(hidden, dtype=_residual_dtype(cfg))
    conv, ssm = state["blocks"]
    mblocks = _unstack(params["blocks"], conv.shape[0])
    states = []
    if cfg.attn_layer_idx:
        ablocks = _unstack(params["attn_blocks"], len(cfg.attn_layer_idx))
        k_all, v_all = state["attn_blocks"]
        tbl, lengths = state["attn_meta"]
    for attn, j in _layer_plan(cfg):
        if attn:
            hidden, residual, _ = _block_fwd(
                ablocks[j], cfg, hidden, residual, token_mask=token_mask,
                initial_state=((k_all[j], v_all[j]), tbl, lengths), attn=True,
            )
        else:
            hidden, residual, st = _block_fwd(
                mblocks[j], cfg, hidden, residual, token_mask=token_mask,
                initial_state=(conv[j], ssm[j]),
            )
            states.append(st)
    new_state = {"blocks": _stack_states(states)}
    if cfg.attn_layer_idx:
        b, c = input_ids.shape
        n_real = (torch.full((b,), c, dtype=torch.int32, device=lengths.device)
                  if token_mask is None
                  else (token_mask > 0.5).sum(dim=1).to(torch.int32))
        new_state["attn_blocks"] = (k_all, v_all)
        new_state["attn_meta"] = (tbl, lengths + n_real)
    return hidden, residual, new_state


def lm_prefill_chunk(params: dict, cfg: ModelConfig, input_ids: torch.Tensor,
                     state: dict, token_mask: torch.Tensor | None = None):
    """Resumable prefill of one chunk: every layer's mixer starts from
    ``state`` (what ``init_lm_state`` or a previous chunk produced).
    Returns (last_logits (b, V) fp32, new state).  The conv and SSM
    carries of ``state`` are not modified; a hybrid stack's KV pages are
    written IN PLACE (the new state holds the same page tensors) and its
    lengths advance by the chunk's real tokens."""
    hidden, residual, new_state = _chunk_backbone(params, cfg, input_ids,
                                                  state, token_mask)
    logits = _final_logits(params, cfg, hidden[:, -1:], residual[:, -1:])
    return logits[:, 0].float(), new_state


def init_lm_blocks_state(cfg: ModelConfig, batch: int, device=None):
    """Layer-stacked zero conv+SSM decode states of the Mamba layers (in a
    hybrid stack the attention layers' KV lives in the paged cache)."""
    cs, ss = _MIXERS[cfg.ssm_layer].init_state(cfg, batch, device)
    n = cfg.n_layer - len(cfg.attn_layer_idx)
    return (cs[None].repeat(n, *([1] * cs.ndim)),
            ss[None].repeat(n, *([1] * ss.ndim)))


def init_lm_state(cfg: ModelConfig, batch: int, max_len: int = 0,
                  device=None) -> dict:
    """Zero decode state.  Hybrid stacks add a private paged KV cache
    sized for ``max_len`` tokens per row (identity page table, zero
    lengths), one page pool per attention layer."""
    state = {"blocks": init_lm_blocks_state(cfg, batch, device)}
    if cfg.attn_layer_idx:
        n_attn = len(cfg.attn_layer_idx)
        k, v = init_attention_state(cfg, batch, max_len, device)
        state["attn_blocks"] = (k[None].repeat(n_attn, *([1] * k.ndim)),
                                v[None].repeat(n_attn, *([1] * v.ndim)))
        state["attn_meta"] = attention_page_meta(cfg, batch, max_len, device)
    return state


def _block_step(bp: dict, cfg: ModelConfig, hidden, residual, st, attn_ctx=None):
    """One decode-step block; its state ``st`` is updated in place.  A
    Mamba block's ``st`` is ``(conv, ssm)``; an attention block's is
    ``(k_pages, v_pages)`` with ``attn_ctx = (page_table, lengths,
    write_mask)``."""
    normed, residual = add_rms_norm(hidden, residual, bp["norm"]["weight"],
                                    cfg.norm_eps)
    if attn_ctx is not None:
        hidden, _ = attention_mixer_step(bp["mixer"], cfg, normed, st, *attn_ctx)
    else:
        hidden, _ = _MIXERS[cfg.ssm_layer].step(bp["mixer"], cfg, normed, *st)
    return hidden, residual


def lm_step(params: dict, cfg: ModelConfig, state: dict, token: torch.Tensor,
            write_mask: torch.Tensor | None = None):
    """One decode step: token (b,) -> (logits (b, V) fp32, state).

    The state is updated IN PLACE (each layer's conv cache and SSM state,
    and a hybrid's KV pages, are overwritten in the caller's tensors):
    decode state is the largest thing a decode step touches, and a
    functional update would copy all of it every token.  A hybrid's
    ``lengths`` advance by one per row (by ``write_mask`` when given: its
    masked rows write the trash page and keep their length) in a new
    ``attn_meta`` of the returned state dict."""
    cd = cfg.torch_compute_dtype
    hidden = _embed(params, token, cd)
    residual = torch.zeros_like(hidden, dtype=torch.float32)
    conv, ssm = state["blocks"]
    mblocks = _unstack(params["blocks"], conv.shape[0])
    if cfg.attn_layer_idx:
        ablocks = _unstack(params["attn_blocks"], len(cfg.attn_layer_idx))
        k_all, v_all = state["attn_blocks"]
        tbl, lengths = state["attn_meta"]
        attn_ctx = (tbl, lengths, write_mask)
    for attn, j in _layer_plan(cfg):
        if attn:
            hidden, residual = _block_step(ablocks[j], cfg, hidden, residual,
                                           (k_all[j], v_all[j]), attn_ctx)
        else:
            hidden, residual = _block_step(mblocks[j], cfg, hidden, residual,
                                           (conv[j], ssm[j]))
    normed, _ = add_rms_norm(hidden, residual, params["norm_f"]["weight"],
                             cfg.norm_eps)
    logits = mm_f32(normed.to(cd), params["embedding"].to(cd).t())
    if cfg.attn_layer_idx:
        adv = 1 if write_mask is None else write_mask.to(lengths.dtype)
        state = {**state, "attn_meta": (tbl, lengths + adv)}
    return logits, state
