"""Language model, pure-SSM branch (counterpart of
``mamba_distributed_tpu/models/lm.py``): embedding -> N prenorm Mamba-2
blocks -> final norm -> tied head.

Parameters are a plain dict that mirrors the JAX ``init_lm_params`` tree
key for key, with the blocks stacked on a leading layer axis:

    {"embedding": (V, d), "norm_f": {"weight": (d,)},
     "blocks": {"norm": {"weight": (L, d)},
                "mixer": {"in_proj": {"kernel": (L, d, d_in_proj)},
                          "conv": {"kernel": (L, conv_dim, w), "bias": (L, conv_dim)},
                          "dt_bias": (L, h), "A_log": (L, h), "D": (L, h),
                          "norm": {"weight": (L, d_inner)},
                          "out_proj": {"kernel": (L, d_inner, d)}}}}

The JAX ``lax.scan`` over stacked layers becomes a Python loop over the
stacked tensors' per-layer views.  Decode state is
``{"blocks": (conv (L, b, d_conv-1, conv_dim), ssm (L, b, h, p, n) fp32)}``.
"""

from __future__ import annotations

import torch

from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.models.common import mm_f32
from mamba_distributed_tpu_torch.models.mamba2 import (
    init_mamba2_params,
    init_mamba2_state,
    mamba2_mixer,
    mamba2_mixer_step,
)
from mamba_distributed_tpu_torch.ops.norm import add_rms_norm


def _unstack(tree, n: int) -> list:
    """Layer-stacked tree -> list of n per-layer trees (views)."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def init_lm_params(cfg: ModelConfig, generator: torch.Generator,
                   device=None) -> dict:
    """Full parameter tree (fp32 masters), random from ``generator``."""
    n = cfg.n_layer
    emb = torch.randn((cfg.vocab_size_padded, cfg.d_model), generator=generator,
                      device=device) * cfg.initializer_range
    return {
        "embedding": emb,
        "norm_f": {"weight": torch.ones((cfg.d_model,), device=device)},
        "blocks": {
            "norm": {"weight": torch.ones((n, cfg.d_model), device=device)},
            "mixer": init_mamba2_params(cfg, generator, n, device),
        },
    }


def _embed(params: dict, ids: torch.Tensor, compute_dtype) -> torch.Tensor:
    return params["embedding"][ids].to(compute_dtype)


def _residual_dtype(cfg: ModelConfig):
    return torch.float32 if cfg.residual_in_fp32 else cfg.torch_compute_dtype


def _block_fwd(bp: dict, cfg: ModelConfig, hidden, residual, token_mask=None,
               initial_state=None):
    """One prenorm block with its mixer's decode state:
    (hidden, residual) -> (hidden, residual, (conv_state, ssm_state))."""
    normed, residual = add_rms_norm(
        hidden, residual, bp["norm"]["weight"], cfg.norm_eps,
        residual_dtype=_residual_dtype(cfg),
    )
    ics, iss = (None, None) if initial_state is None else initial_state
    hidden, state = mamba2_mixer(
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


def _stack_states(states: list) -> tuple:
    return (torch.stack([s[0] for s in states]),
            torch.stack([s[1] for s in states]))


def lm_prefill(params: dict, cfg: ModelConfig, input_ids: torch.Tensor,
               token_mask: torch.Tensor | None = None):
    """Parallel prefill: one full-sequence forward that also returns
    every layer's decode state.  ``token_mask`` (b, t) marks left-padded
    bucketed prompts (inference/bucketing.py).

    Returns (last_logits (b, V) fp32, {"blocks": (conv, ssm)})."""
    cd = cfg.torch_compute_dtype
    hidden = _embed(params, input_ids, cd)
    residual = torch.zeros_like(hidden, dtype=_residual_dtype(cfg))
    states = []
    for bp in _unstack(params["blocks"], cfg.n_layer):
        hidden, residual, st = _block_fwd(bp, cfg, hidden, residual,
                                          token_mask=token_mask)
        states.append(st)
    logits = _final_logits(params, cfg, hidden[:, -1:], residual[:, -1:])
    return logits[:, 0].float(), {"blocks": _stack_states(states)}


def _chunk_backbone(params: dict, cfg: ModelConfig, input_ids, state,
                    token_mask=None):
    """Embed -> carry-threaded layer stack -> (hidden, residual, state')."""
    cd = cfg.torch_compute_dtype
    hidden = _embed(params, input_ids, cd)
    residual = torch.zeros_like(hidden, dtype=_residual_dtype(cfg))
    conv, ssm = state["blocks"]
    states = []
    for i, bp in enumerate(_unstack(params["blocks"], cfg.n_layer)):
        hidden, residual, st = _block_fwd(
            bp, cfg, hidden, residual, token_mask=token_mask,
            initial_state=(conv[i], ssm[i]),
        )
        states.append(st)
    return hidden, residual, {"blocks": _stack_states(states)}


def lm_prefill_chunk(params: dict, cfg: ModelConfig, input_ids: torch.Tensor,
                     state: dict, token_mask: torch.Tensor | None = None):
    """Resumable prefill of one chunk: every layer's mixer starts from
    ``state`` (what ``init_lm_state`` or a previous chunk produced).
    Returns (last_logits (b, V) fp32, new state); ``state`` is not
    modified."""
    hidden, residual, new_state = _chunk_backbone(params, cfg, input_ids,
                                                  state, token_mask)
    logits = _final_logits(params, cfg, hidden[:, -1:], residual[:, -1:])
    return logits[:, 0].float(), new_state


def init_lm_blocks_state(cfg: ModelConfig, batch: int, device=None):
    """Layer-stacked zero conv+SSM decode states."""
    cs, ss = init_mamba2_state(cfg, batch, device)
    n = cfg.n_layer
    return (cs[None].repeat(n, *([1] * cs.ndim)),
            ss[None].repeat(n, *([1] * ss.ndim)))


def init_lm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    return {"blocks": init_lm_blocks_state(cfg, batch, device)}


def _block_step(bp: dict, cfg: ModelConfig, hidden, residual, conv, ssm):
    """One decode-step block; ``conv``/``ssm`` are updated in place."""
    normed, residual = add_rms_norm(hidden, residual, bp["norm"]["weight"],
                                    cfg.norm_eps)
    hidden, _ = mamba2_mixer_step(bp["mixer"], cfg, normed, conv, ssm)
    return hidden, residual


def lm_step(params: dict, cfg: ModelConfig, state: dict, token: torch.Tensor):
    """One decode step: token (b,) -> (logits (b, V) fp32, state).

    The state is updated IN PLACE (each layer's conv cache and SSM state
    are overwritten in the caller's tensors) and returned: decode state
    is the largest thing a decode step touches, and a functional update
    would copy all of it every token."""
    cd = cfg.torch_compute_dtype
    hidden = _embed(params, token, cd)
    residual = torch.zeros_like(hidden, dtype=torch.float32)
    conv, ssm = state["blocks"]
    for i, bp in enumerate(_unstack(params["blocks"], cfg.n_layer)):
        hidden, residual = _block_step(bp, cfg, hidden, residual, conv[i], ssm[i])
    normed, _ = add_rms_norm(hidden, residual, params["norm_f"]["weight"],
                             cfg.norm_eps)
    return mm_f32(normed.to(cd), params["embedding"].to(cd).t()), state
