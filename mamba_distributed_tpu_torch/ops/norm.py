"""RMSNorm family (counterpart of ``mamba_distributed_tpu/ops/norm.py``).

Plain PyTorch: the JAX package wrote no kernel for these.  Statistics
are taken in fp32 and the output is cast back to the input dtype; the
residual stream is carried in ``residual_dtype``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    """RMSNorm in fp32, output cast back to ``x.dtype``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def add_rms_norm(x: torch.Tensor, residual: torch.Tensor | None,
                 weight: torch.Tensor, eps: float = 1e-5,
                 residual_dtype: torch.dtype = torch.float32):
    """Residual add + RMSNorm (prenorm form): returns
    ``(rms_norm(x + residual) in x.dtype, x + residual)``."""
    r = x.to(residual_dtype)
    if residual is not None:
        r = r + residual.to(residual_dtype)
    return rms_norm(r, weight, eps).to(x.dtype), r


def rms_norm_gated(x: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-5, group_size: int | None = None):
    """Gated RMSNorm ``rms_norm(x * silu(z))``, per contiguous group of
    ``group_size`` channels when given."""
    xf = x.float() * F.silu(z.float())
    d = xf.shape[-1]
    if group_size is None or group_size == d:
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
    else:
        if d % group_size:
            raise ValueError(f"{d} channels do not split into groups of {group_size}")
        xg = xf.reshape(*xf.shape[:-1], d // group_size, group_size)
        var = xg.square().mean(dim=-1, keepdim=True)
        y = (xg * torch.rsqrt(var + eps)).reshape(xf.shape)
    return (y * weight.float()).to(x.dtype)
