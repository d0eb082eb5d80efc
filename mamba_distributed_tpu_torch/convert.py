"""Parameter trees between the JAX package and the port.

``params_from_jax`` takes the JAX ``init_lm_params`` tree as numpy arrays
(e.g. ``jax.tree.map(np.asarray, params)``) and returns the port's tree
of tensors, key for key: ``embedding``, ``norm_f.weight`` and
``blocks.{norm, mixer.{in_proj, conv, dt_bias, A_log, D, norm,
out_proj}}`` stacked on the layer axis.  Both packages store linear
kernels (d_in, d_out), so no leaf is transposed.  ``params_to_numpy``
goes the other way.  Keys the port does not serve (attention blocks, an
untied head, MLPs) raise.
"""

from __future__ import annotations

import numpy as np
import torch

_MIXER_KEYS = {"in_proj", "conv", "dt_bias", "A_log", "D", "norm", "out_proj"}


def _check_keys(tree: dict) -> None:
    if set(tree) != {"embedding", "norm_f", "blocks"}:
        raise ValueError(
            f"expected a pure Mamba-2 tied-head tree (embedding, norm_f, "
            f"blocks), got keys {sorted(tree)}")
    if set(tree["blocks"]) != {"norm", "mixer"}:
        raise ValueError(f"blocks keys {sorted(tree['blocks'])} != [mixer, norm]")
    if set(tree["blocks"]["mixer"]) != _MIXER_KEYS:
        raise ValueError(f"mixer keys {sorted(tree['blocks']['mixer'])}")


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
