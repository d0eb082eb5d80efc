"""RMSNorm family (counterpart of ``mamba_distributed_tpu/ops/norm.py``).

Statistics are taken in fp32 and the output is cast back to the input
dtype; the residual stream is carried in ``residual_dtype``.

The JAX package wrote no kernel for these.  The port has two
(ops/cuda/norm_kernels.py), whose per-row result does not depend on the
number of rows in the call, which PyTorch's row reductions do not
promise: serving, ``generate()``, eval and the verify step take them on
a CUDA tensor when autograd does not need the op
(``ops/dispatch.use_norm_kernel``).  Under autograd (the train step,
which needs the backward and no row invariance) and on the CPU, the
plain expressions run.

Under tensor parallelism a Mamba-2 block at ``ngroups = 1`` normalises
its gated output over the whole d_inner, which its tensor ranks hold a
part each: ``rms_norm_gated(..., tp=)`` sums each row's squares over the
tensor group (both ways: every rank's gradient of the sum is partial)
and divides by the full width.  That composite runs on the card too
(the named exception of ``ops/dispatch``): the kernel normalises the
local row only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mamba_distributed_tpu_torch.ops.cuda import norm_kernels as nk
from mamba_distributed_tpu_torch.ops.dispatch import use_norm_kernel
from mamba_distributed_tpu_torch.parallel.collectives import all_reduce_tp


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    """RMSNorm in fp32, output cast back to ``x.dtype``."""
    if use_norm_kernel(x, weight):
        return nk.rms_norm_kernel(x, weight, eps)
    return nk.rms_norm_plain(x, weight, eps)


def add_rms_norm(x: torch.Tensor, residual: torch.Tensor | None,
                 weight: torch.Tensor, eps: float = 1e-5,
                 residual_dtype: torch.dtype = torch.float32):
    """Residual add + RMSNorm (prenorm form): returns
    ``(rms_norm(x + residual) in x.dtype, x + residual)``."""
    if use_norm_kernel(x, residual, weight):
        return nk.add_rms_norm_kernel(x, residual, weight, eps, residual_dtype)
    return nk.add_rms_norm_plain(x, residual, weight, eps, residual_dtype)


def rms_norm_gated(x: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-5, group_size: int | None = None, tp=None):
    """Gated RMSNorm ``rms_norm(x * silu(z))``, per contiguous group of
    ``group_size`` channels when given.  With ``tp`` (a ``TPContext``)
    and no groups, a row is this rank's part of one that spans the
    tensor group (module docstring)."""
    if tp is not None and group_size is None:
        # ops/dispatch's named exception: the kernel would normalise the
        # local row only, so the tensor-group composite runs on the card too
        xf = x.float() * F.silu(z.float())
        ss = all_reduce_tp(xf.square().sum(dim=-1, keepdim=True), tp)
        y = xf * torch.rsqrt(ss / (xf.shape[-1] * tp.size) + eps)
        return (y * weight.float()).to(x.dtype)
    if use_norm_kernel(x, z, weight):
        return nk.rms_norm_gated_kernel(x, z, weight, eps, group_size)
    return nk.rms_norm_gated_plain(x, z, weight, eps, group_size)
