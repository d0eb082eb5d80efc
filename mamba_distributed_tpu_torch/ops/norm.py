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
"""

from __future__ import annotations

import torch

from mamba_distributed_tpu_torch.ops.cuda import norm_kernels as nk
from mamba_distributed_tpu_torch.ops.dispatch import use_norm_kernel


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
                   eps: float = 1e-5, group_size: int | None = None):
    """Gated RMSNorm ``rms_norm(x * silu(z))``, per contiguous group of
    ``group_size`` channels when given."""
    if use_norm_kernel(x, z, weight):
        return nk.rms_norm_gated_kernel(x, z, weight, eps, group_size)
    return nk.rms_norm_gated_plain(x, z, weight, eps, group_size)
