"""Parameter trees between the JAX package and the port.

``params_from_jax`` takes the JAX ``init_lm_params`` tree as numpy arrays
(e.g. ``jax.tree.map(np.asarray, params)``) and returns the port's tree
of tensors, key for key: ``embedding``, ``norm_f.weight``,
``blocks.{norm, mixer}`` with the Mamba-2 mixer keys ``{in_proj, conv,
dt_bias, A_log, D, norm, out_proj}`` or the Mamba-1 ones ``{in_proj,
conv, x_proj, dt_proj.{kernel, bias}, A_log, D, out_proj}`` (the tree
says which) and, for hybrid stacks, ``attn_blocks.{norm.weight,
mixer.{wqkv, out_proj}.kernel}``, each stacked on the layer axis; with
an MLP, each block's ``norm2.weight`` and ``mlp.{fc1, fc2}.kernel`` or
``moe.{router.kernel, w1, w2}``; with an untied head, ``lm_head.kernel``.
Both packages store linear kernels (d_in, d_out), so no leaf is
transposed.  ``params_to_numpy`` goes the other way.  Any other key
raises.
"""

from __future__ import annotations

import numpy as np
import torch

_MIXER_KEYS = {"in_proj", "conv", "dt_bias", "A_log", "D", "norm", "out_proj"}
_MAMBA1_MIXER_KEYS = {"in_proj", "conv", "x_proj", "dt_proj", "A_log", "D", "out_proj"}
_ATTN_MIXER_KEYS = {"wqkv", "out_proj"}
# a block's second half, when the model has an MLP
_FFN = {"mlp": {"fc1", "fc2"}, "moe": {"router", "w1", "w2"}}


def _check_block(block: dict, mixers: tuple, where: str) -> None:
    """A block holds norm and mixer (its keys one of ``mixers``), and
    either nothing else or norm2 and one of mlp / moe with their keys."""
    ffn = [k for k in _FFN if k in block]
    want = {"norm", "mixer"} | ({"norm2", *ffn} if len(ffn) == 1 else set())
    if set(block) != want or (len(ffn) == 1 and set(block[ffn[0]]) != _FFN[ffn[0]]):
        raise ValueError(
            f"{where} must hold norm and mixer[, norm2 and mlp.{{fc1, fc2}} or "
            f"moe.{{router, w1, w2}}], got {sorted(block)}")
    if set(block["mixer"]) not in mixers:
        raise ValueError(f"{where} mixer keys {sorted(block['mixer'])} are none of "
                         f"{[sorted(m) for m in mixers]}")


def _check_keys(tree: dict) -> None:
    if not {"embedding", "norm_f", "blocks"} <= set(tree) or (
            set(tree) - {"embedding", "norm_f", "blocks", "attn_blocks", "lm_head"}):
        raise ValueError(
            f"expected the tree of a pure Mamba-2 or Mamba-1 stack or a hybrid "
            f"stack (embedding, norm_f, blocks[, attn_blocks][, lm_head]), got keys "
            f"{sorted(tree)}")
    _check_block(tree["blocks"], (_MIXER_KEYS, _MAMBA1_MIXER_KEYS), "blocks")
    if "attn_blocks" in tree:
        _check_block(tree["attn_blocks"], (_ATTN_MIXER_KEYS,), "attn_blocks")
    if "lm_head" in tree and set(tree["lm_head"]) != {"kernel"}:
        raise ValueError(f"lm_head keys {sorted(tree['lm_head'])} != ['kernel']")


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: dict, device=None) -> dict:
    """JAX ``init_lm_params`` tree (numpy leaves) -> the port's tree."""
    _check_keys(tree)
    return _map(tree, lambda a: torch.from_numpy(np.array(a, copy=True)).to(device))


def params_to_numpy(params: dict) -> dict:
    """The port's tree -> numpy leaves, same keys."""
    _check_keys(params)
    return _map(params, lambda t: t.detach().cpu().numpy())
