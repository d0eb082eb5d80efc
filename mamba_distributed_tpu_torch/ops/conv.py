"""Causal depthwise 1-D convolution (counterpart of
``mamba_distributed_tpu/ops/conv.py``): the ``"shift"`` formulation
(width shifted multiply-adds) and ``"xla_conv"`` (one depthwise
``conv1d``, the JAX package's grouped ``conv_general_dilated``).

Plain PyTorch: the JAX package wrote no kernel for the width-4 conv.
Layouts follow the JAX package: x (b, t, d), weight (d, width), conv
state (b, width-1, d) holding the last inputs, oldest first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_conv1d(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None = None,
                  activation: str | None = "silu",
                  initial_state: torch.Tensor | None = None,
                  return_final_state: bool = False, impl: str = "shift"):
    """y (b, t, d) [, final_state (b, width-1, d)] in fp32, output in
    ``x.dtype``: a sum of shifted multiply-adds (``impl="shift"``) or one
    depthwise ``conv1d`` over the padded input (``"xla_conv"``; a
    cross-correlation, so the taps keep their order)."""
    b, t, d = x.shape
    dim, width = weight.shape
    if dim != d:
        raise ValueError(f"conv weight has {dim} channels, input {d}")
    if initial_state is None:
        pad = x.new_zeros((b, width - 1, d))
    else:
        if tuple(initial_state.shape) != (b, width - 1, d):
            raise ValueError(f"conv state shape {tuple(initial_state.shape)}")
        pad = initial_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (b, t + width - 1, d)
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    wf = weight.to(acc_dtype)
    if impl == "xla_conv":
        # back to (b, t, d) with the channels contiguous, as the SSD and
        # scan kernels read their inputs
        y = F.conv1d(xp.to(acc_dtype).transpose(1, 2), wf[:, None, :],
                     groups=d).transpose(1, 2).contiguous()
    elif impl == "shift":
        y = torch.zeros((b, t, d), dtype=acc_dtype, device=x.device)
        for i in range(width):
            # tap i sees the input shifted (width - 1 - i) steps into the past
            y = y + xp[:, i:i + t, :].to(acc_dtype) * wf[:, i]
    else:
        raise ValueError(f"unsupported conv impl: {impl}")
    if bias is not None:
        y = y + bias.to(acc_dtype)
    if activation == "silu":
        y = F.silu(y)
    elif activation is not None:
        raise ValueError(f"unsupported activation: {activation}")
    y = y.to(x.dtype)
    if return_final_state:
        return y, xp[:, t:, :]
    return y


def causal_conv1d_update(x_t: torch.Tensor, conv_state: torch.Tensor,
                         weight: torch.Tensor,
                         bias: torch.Tensor | None = None,
                         activation: str | None = "silu",
                         out_state: torch.Tensor | None = None):
    """One decode step: x_t (b, d), conv_state (b, width-1, d) ->
    (y_t (b, d), new state).  With ``out_state`` the new state is
    written there (it may be ``conv_state`` itself: an in-place update)
    and returned."""
    window = torch.cat([conv_state, x_t[:, None, :].to(conv_state.dtype)], dim=1)
    y = torch.einsum("bwd,dw->bd", window.float(), weight.float())
    if bias is not None:
        y = y + bias.float()
    if activation == "silu":
        y = F.silu(y)
    elif activation is not None:
        raise ValueError(f"unsupported activation: {activation}")
    new_state = window[:, 1:, :]
    if out_state is not None:
        out_state.copy_(new_state)
        new_state = out_state
    return y.to(x_t.dtype), new_state
