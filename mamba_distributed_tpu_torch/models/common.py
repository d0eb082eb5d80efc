"""Linear layer and init helpers (counterpart of
``mamba_distributed_tpu/models/common.py``, without LoRA).

Weights are stored (in_features, out_features), as in the JAX package,
so the forward pass is ``x @ W`` and the two packages' trees map key for
key.  Init distributions match the JAX package (themselves those of the
reference's mamba-ssm model constructors); the random numbers come from an explicit
``torch.Generator`` and differ from ``jax.random``'s.
"""

from __future__ import annotations

import math

import torch


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with fp32 accumulation and an fp32 result.

    For bf16 inputs on a card this is one bf16 GEMM with an fp32 output
    (no rounding of the result); elsewhere the inputs are upcast, which
    is the same function (bf16 x bf16 products are exact in fp32)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a.reshape(-1, a.shape[-1]), b,
                        out_dtype=torch.float32).reshape(*a.shape[:-1], b.shape[-1])
    return a.float() @ b.float()


def linear(params: dict, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``x @ kernel (+ bias)`` with compute-dtype inputs, fp32
    accumulation and a compute-dtype output (common.py:44-102).

    An int8 kernel (ops/quant.py: ``{"kernel": int8, "scale": fp32}``)
    dequantizes at use.  Row scales (trailing axis 1) fold into the
    activation in fp32 before its cast: ``(x * scale) @ q``; column
    scales multiply the fp32 accumulator: ``(x @ q) * scale``.  The
    int8 codes are exact in the compute dtype, so the cast that feeds
    the product is lossless."""
    scale = params.get("scale")
    if scale is not None and scale.shape[-1] == 1:
        x = x.float() * scale[..., 0]
        scale = None
    w = params["kernel"].to(compute_dtype)
    xc = x.to(compute_dtype)
    if scale is None and "bias" not in params:
        # one GEMM: fp32 accumulation, rounded once to the compute dtype
        return xc @ w
    y = mm_f32(xc, w)
    if scale is not None:
        y = y * scale
    if "bias" in params:
        # the bias lands on the fp32 accumulator before the one rounding
        y = y + params["bias"].float()
    return y.to(compute_dtype)


def out_proj_rescale(n_layer: int, d_intermediate: int) -> float:
    """The divisor of the residual out-projections' init when
    ``rescale_prenorm_residual`` is on: ``sqrt(n_residuals * n_layer)``,
    with two residual branches per block when it has an MLP
    (models/mamba2.py:64-67, mamba1.py:68-72, attention.py:46-50 of the
    JAX package)."""
    n_residuals = 2 if d_intermediate > 0 else 1
    return math.sqrt(n_residuals * n_layer)


def uniform_fan_in(shape, fan_in: int, generator: torch.Generator,
                   device=None) -> torch.Tensor:
    """PyTorch Linear/Conv default init: U(-1/sqrt(fan_in), +1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    return u * (2 * bound) - bound


def init_linear(d_in: int, d_out: int, generator: torch.Generator,
                bias: bool = False, lead=(), device=None) -> dict:
    """(*lead, d_in, d_out) kernel [+ zero bias]; ``lead`` stacks layers."""
    p = {"kernel": uniform_fan_in((*lead, d_in, d_out), d_in, generator, device)}
    if bias:
        p["bias"] = torch.zeros((*lead, d_out), device=device)
    return p


def init_dt_bias(shape, dt_min: float, dt_max: float, dt_init_floor: float,
                 generator: torch.Generator, device=None) -> torch.Tensor:
    """Inverse-softplus of dt ~ LogUniform(dt_min, dt_max), floored."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
    dt = torch.clamp(dt, min=dt_init_floor)
    return dt + torch.log(-torch.expm1(-dt))


def init_dt_proj(dt_rank: int, d_inner: int, dt_init: str, dt_scale: float,
                 generator: torch.Generator, lead=(), device=None) -> torch.Tensor:
    """Mamba-1 ``dt_proj`` kernel (*lead, dt_rank, d_inner): U(+-s) for
    "random", the constant s for "constant", s = dt_rank^-0.5 * dt_scale
    (mamba1.py:39-49)."""
    std = dt_rank ** -0.5 * dt_scale
    shape = (*lead, dt_rank, d_inner)
    if dt_init == "constant":
        return torch.full(shape, std, device=device)
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    return u * (2 * std) - std


def init_conv(channels: int, width: int, bias: bool,
              generator: torch.Generator, lead=(), device=None) -> dict:
    p = {"kernel": uniform_fan_in((*lead, channels, width), width, generator, device)}
    if bias:
        p["bias"] = uniform_fan_in((*lead, channels), width, generator, device)
    return p
