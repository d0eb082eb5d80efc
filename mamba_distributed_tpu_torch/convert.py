"""Parameter trees between the JAX package and the port.

``params_from_jax`` takes the JAX ``init_lm_params`` tree as numpy arrays
(e.g. ``jax.tree.map(np.asarray, params)``) and returns the port's tree
of tensors, key for key: ``embedding``, ``norm_f.weight``,
``blocks.{norm, mixer.{in_proj, conv, dt_bias, A_log, D, norm,
out_proj}}`` and, for hybrid stacks, ``attn_blocks.{norm.weight,
mixer.{wqkv, out_proj}.kernel}``, each stacked on the layer axis.  Both
packages store linear kernels (d_in, d_out), so no leaf is transposed.
``params_to_numpy`` goes the other way.  Keys the port does not serve
(an untied head, MLPs) raise.
"""

from __future__ import annotations

import numpy as np
import torch

_MIXER_KEYS = {"in_proj", "conv", "dt_bias", "A_log", "D", "norm", "out_proj"}
_ATTN_MIXER_KEYS = {"wqkv", "out_proj"}


def _check_keys(tree: dict) -> None:
    if set(tree) - {"attn_blocks"} != {"embedding", "norm_f", "blocks"}:
        raise ValueError(
            f"expected the tied-head tree of a pure Mamba-2 or hybrid stack "
            f"(embedding, norm_f, blocks[, attn_blocks]), got keys {sorted(tree)}")
    if set(tree["blocks"]) != {"norm", "mixer"}:
        raise ValueError(f"blocks keys {sorted(tree['blocks'])} != [mixer, norm]")
    if set(tree["blocks"]["mixer"]) != _MIXER_KEYS:
        raise ValueError(f"mixer keys {sorted(tree['blocks']['mixer'])}")
    if "attn_blocks" in tree:
        attn = tree["attn_blocks"]
        if set(attn) != {"norm", "mixer"} or set(attn["mixer"]) != _ATTN_MIXER_KEYS:
            raise ValueError(
                f"attn_blocks must hold norm and mixer.{{wqkv, out_proj}}, got "
                f"{sorted(attn)} / {sorted(attn.get('mixer', {}))}")


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
