"""Mamba-1 mixer (selective scan) (counterpart of
``mamba_distributed_tpu/models/mamba1.py``).

Forward:  u -> in_proj -> split(x, z) -> causal_conv1d(x) ->
          x_proj -> (dt, B, C) -> dt_proj -> selective_scan(..., z=z) ->
          out_proj

With ``cfg.ssm_impl="pallas"`` the scan runs through the hand-written
CUDA kernels on a CUDA tensor and through their plain versions on a CPU
tensor (``selective_scan_kernel``, ops/cuda/scan_kernels.py, with the
dispatch rule of ops/dispatch.py inside); ``"xla"`` takes the plain
chunked ``selective_scan`` everywhere.

``dt_proj`` is the JAX package's ``jnp.dot(bf16, bf16,
preferred_element_type=fp32)``: here the product of the compute-dtype
operands upcast to fp32, the same function (a bf16 x bf16 product is
exact in fp32) and one that autograd differentiates on the card, where
``torch.mm(..., out_dtype=fp32)`` has no derivative.
"""

from __future__ import annotations

import torch

from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.models.common import (
    init_conv,
    init_dt_bias,
    init_dt_proj,
    init_linear,
    linear,
    out_proj_rescale,
)
from mamba_distributed_tpu_torch.ops.conv import causal_conv1d, causal_conv1d_update
from mamba_distributed_tpu_torch.ops.cuda.scan_kernels import selective_scan_kernel
from mamba_distributed_tpu_torch.ops.scan import selective_scan, selective_state_update


def init_mamba1_params(cfg: ModelConfig, generator: torch.Generator,
                       n_layers: int, device=None) -> dict:
    """Layer-stacked (n_layers, ...) mixer params, fp32."""
    di, ds, dtr = cfg.d_inner, cfg.effective_d_state, cfg.effective_dt_rank
    lead = (n_layers,)
    # S4D-real init: A[d, n] = n + 1, stored as log (A = -exp(A_log))
    A = torch.arange(1, ds + 1, dtype=torch.float32, device=device).expand(*lead, di, ds)
    params = {
        "in_proj": init_linear(cfg.d_model, 2 * di, generator, cfg.proj_bias, lead, device),
        "conv": init_conv(di, cfg.d_conv, cfg.conv_bias, generator, lead, device),
        "x_proj": init_linear(di, dtr + 2 * ds, generator, False, lead, device),
        "dt_proj": {
            "kernel": init_dt_proj(dtr, di, cfg.dt_init, cfg.dt_scale, generator, lead,
                                   device),
            "bias": init_dt_bias((*lead, di), cfg.dt_min, cfg.dt_max, cfg.dt_init_floor,
                                 generator, device),
        },
        "A_log": torch.log(A).contiguous(),
        "D": torch.ones((*lead, di), device=device),
        "out_proj": init_linear(di, cfg.d_model, generator, cfg.proj_bias, lead, device),
    }
    if cfg.rescale_prenorm_residual:
        params["out_proj"]["kernel"] /= out_proj_rescale(cfg.n_layer, cfg.d_intermediate)
    return params


def _scan_inputs(params: dict, cfg: ModelConfig, x: torch.Tensor):
    """x (conv output, compute dtype) -> (dt fp32 without its bias, A,
    B fp32, C fp32)."""
    ds, dtr = cfg.effective_d_state, cfg.effective_dt_rank
    cd = cfg.torch_compute_dtype
    x_db = linear(params["x_proj"], x, cd)
    B = x_db[..., dtr:dtr + ds].float()
    C = x_db[..., dtr + ds:].float()
    # dt_proj without its bias: the bias folds into the scan's delta_bias
    # so the softplus happens in fp32
    dt = x_db[..., :dtr].float() @ params["dt_proj"]["kernel"].to(cd).float()
    return dt, -torch.exp(params["A_log"].float()), B, C


def mamba1_mixer(params: dict, cfg: ModelConfig, u: torch.Tensor,
                 initial_conv_state=None, initial_ssm_state=None,
                 return_final_state: bool = False, token_mask=None):
    """Full-sequence mixer forward: u (b, t, d_model) -> y (b, t, d_model)
    [, (conv_state (b, d_conv-1, d_inner), ssm_state (b, d_inner, n) fp32)].

    ``token_mask`` (b, t) {0,1} zeroes the conv and scan inputs at
    left-pad positions (before and after the conv, as in
    ``mamba2_mixer``): with x = 0 the update term dt*B*x vanishes and a
    zero initial state stays zero through the pad prefix."""
    di = cfg.d_inner
    cd = cfg.torch_compute_dtype
    xz = linear(params["in_proj"], u, cd)
    x, z = xz[..., :di], xz[..., di:]
    if token_mask is not None:
        x = x * token_mask[..., None].to(x.dtype)
    x, conv_state = causal_conv1d(
        x, params["conv"]["kernel"], params["conv"].get("bias"), activation="silu",
        initial_state=initial_conv_state, return_final_state=True, impl=cfg.conv_impl,
    )
    if token_mask is not None:
        x = x * token_mask[..., None].to(x.dtype)
    dt, A, B, C = _scan_inputs(params, cfg, x)
    scan = selective_scan_kernel if cfg.ssm_impl == "pallas" else selective_scan
    kw = dict(D=params["D"], z=z, delta_bias=params["dt_proj"]["bias"], delta_softplus=True)
    if initial_ssm_state is None and not return_final_state:
        y, ssm_state = scan(x, dt, A, B, C, **kw), None
    else:
        y, ssm_state = scan(x, dt, A, B, C, **kw, initial_state=initial_ssm_state,
                            return_final_state=True)
    out = linear(params["out_proj"], y, cd)
    if return_final_state:
        return out, (conv_state, ssm_state)
    return out


def init_mamba1_state(cfg: ModelConfig, batch: int, device=None, dtype=None):
    """Zero decode state of one mixer: conv cache (b, d_conv-1, d_inner)
    in the compute dtype, SSM state (b, d_inner, n) in fp32."""
    dtype = cfg.torch_compute_dtype if dtype is None else dtype
    di = cfg.d_inner
    return (torch.zeros((batch, cfg.d_conv - 1, di), dtype=dtype, device=device),
            torch.zeros((batch, di, cfg.effective_d_state), dtype=torch.float32,
                        device=device))


def mamba1_mixer_step(params: dict, cfg: ModelConfig, u_t: torch.Tensor,
                      conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """O(1) decode step: u_t (b, d_model) -> (y_t (b, d_model),
    (conv_state, ssm_state)).  The two states are updated IN PLACE (the
    caller's tensors are overwritten and returned)."""
    di = cfg.d_inner
    cd = cfg.torch_compute_dtype
    xz = linear(params["in_proj"], u_t, cd)
    x, z = xz[..., :di], xz[..., di:]
    x, conv_state = causal_conv1d_update(
        x, conv_state, params["conv"]["kernel"], params["conv"].get("bias"),
        activation="silu", out_state=conv_state,
    )
    dt, A, B, C = _scan_inputs(params, cfg, x)
    y, ssm_state = selective_state_update(
        ssm_state, x, dt, A, B, C, D=params["D"], z_t=z,
        dt_bias=params["dt_proj"]["bias"], dt_softplus=True, out=ssm_state,
    )
    return linear(params["out_proj"], y, cd), (conv_state, ssm_state)
