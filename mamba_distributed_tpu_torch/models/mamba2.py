"""Mamba-2 mixer (SSD) (counterpart of ``mamba_distributed_tpu/models/mamba2.py``).

Forward:  u -> in_proj -> split(z, xBC, dt) -> causal_conv1d(xBC) ->
          split(x, B, C) -> SSD(x, dt, A, B, C, D) -> gated RMSNorm(y, z)
          -> out_proj

With ``cfg.ssm_impl="pallas"`` the SSD runs through the hand-written
CUDA kernel on a CUDA tensor (ops/cuda/ssd_kernels.py) and through the
plain formulation on a CPU tensor (ops/dispatch.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.models.common import (
    init_conv,
    init_dt_bias,
    init_linear,
    linear,
    out_proj_rescale,
)
from mamba_distributed_tpu_torch.ops.conv import causal_conv1d, causal_conv1d_update
from mamba_distributed_tpu_torch.ops.cuda.ssd_kernels import ssd_chunked_kernel
from mamba_distributed_tpu_torch.ops.norm import rms_norm_gated
from mamba_distributed_tpu_torch.ops.ssd import ssd_chunked, ssd_state_update


def _dims(cfg: ModelConfig):
    di = cfg.d_inner
    ds = cfg.effective_d_state
    g = cfg.ngroups
    nh = cfg.nheads
    return di, ds, g, nh, 2 * di + 2 * g * ds + nh, di + 2 * g * ds


def init_mamba2_params(cfg: ModelConfig, generator: torch.Generator,
                       n_layers: int, device=None) -> dict:
    """Layer-stacked (n_layers, ...) mixer params, fp32."""
    di, ds, g, nh, d_in_proj, conv_dim = _dims(cfg)
    lead = (n_layers,)
    params = {
        "in_proj": init_linear(cfg.d_model, d_in_proj, generator,
                               cfg.proj_bias, lead, device),
        "conv": init_conv(conv_dim, cfg.d_conv, cfg.conv_bias, generator,
                          lead, device),
        "dt_bias": init_dt_bias((*lead, nh), cfg.dt_min, cfg.dt_max,
                                cfg.dt_init_floor, generator, device),
        # A ~ U(a_init_min, a_init_max), stored as log (A = -exp(A_log))
        "A_log": torch.log(
            torch.rand((*lead, nh), generator=generator, device=device)
            * (cfg.a_init_max - cfg.a_init_min) + cfg.a_init_min
        ),
        "D": torch.ones((*lead, di if cfg.d_has_hdim else nh), device=device),
        "norm": {"weight": torch.ones((*lead, di), device=device)},
        "out_proj": init_linear(di, cfg.d_model, generator, cfg.proj_bias,
                                lead, device),
    }
    if cfg.rescale_prenorm_residual:
        params["out_proj"]["kernel"] /= out_proj_rescale(cfg.n_layer, cfg.d_intermediate)
    return params


def _split_zxbcdt(zxbcdt, cfg: ModelConfig):
    di, _, _, _, _, conv_dim = _dims(cfg)
    return (zxbcdt[..., :di], zxbcdt[..., di:di + conv_dim],
            zxbcdt[..., di + conv_dim:])


def _split_xbc(xBC, cfg: ModelConfig):
    di, ds, g, _, _, _ = _dims(cfg)
    return xBC[..., :di], xBC[..., di:di + g * ds], xBC[..., di + g * ds:]


def _D(params, cfg: ModelConfig):
    return params["D"].reshape(cfg.nheads, cfg.headdim) if cfg.d_has_hdim else params["D"]


def mamba2_mixer(params: dict, cfg: ModelConfig, u: torch.Tensor,
                 initial_conv_state=None, initial_ssm_state=None,
                 return_final_state: bool = False, token_mask=None):
    """Full-sequence mixer forward: u (b, t, d_model) -> y (b, t, d_model)
    [, (conv_state (b, d_conv-1, conv_dim), ssm_state (b, h, p, n) fp32)].

    ``token_mask`` (b, t) {0,1} zeroes the conv/SSM inputs at left-pad
    positions: BEFORE the conv (pads must look like the zero initial
    conv state) and AFTER it (the conv bias + silu would otherwise leak
    into x and B).  dt is not masked: a zero x and B add nothing to the
    state, and dt only decays a state that is still zero."""
    di, ds, g, nh, _, _ = _dims(cfg)
    b, t, _ = u.shape
    cd = cfg.torch_compute_dtype

    z, xBC, dt = _split_zxbcdt(linear(params["in_proj"], u, cd), cfg)
    if token_mask is not None:
        xBC = xBC * token_mask[..., None].to(xBC.dtype)
    xBC, conv_state = causal_conv1d(
        xBC, params["conv"]["kernel"], params["conv"].get("bias"),
        activation="silu", initial_state=initial_conv_state,
        return_final_state=True, impl=cfg.conv_impl,
    )
    if token_mask is not None:
        xBC = xBC * token_mask[..., None].to(xBC.dtype)
    x, B, C = _split_xbc(xBC, cfg)
    x = x.reshape(b, t, nh, cfg.headdim)
    B = B.reshape(b, t, g, ds)
    C = C.reshape(b, t, g, ds)
    dtf = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    ssd = ssd_chunked_kernel if cfg.ssm_impl == "pallas" else ssd_chunked
    kw = dict(chunk_size=cfg.chunk_size, D=_D(params, cfg), compute_dtype=cd)
    if initial_ssm_state is None and not return_final_state:
        # the training path: no final state, so under the "mixer" remat
        # policy the SSD's y alone is kept (ops/remat.py)
        y, ssm_state = ssd(x, dtf, A, B, C, **kw), None
    else:
        y, ssm_state = ssd(x, dtf, A, B, C, **kw, initial_state=initial_ssm_state,
                           return_final_state=True)
    y = rms_norm_gated(y.reshape(b, t, di), z, params["norm"]["weight"],
                       cfg.norm_eps, group_size=di // g if g > 1 else None)
    out = linear(params["out_proj"], y, cd)
    if return_final_state:
        return out, (conv_state, ssm_state)
    return out


def init_mamba2_state(cfg: ModelConfig, batch: int, device=None, dtype=None):
    """Zero decode state of one mixer: conv cache in the compute dtype,
    SSM state in fp32."""
    _, ds, _, nh, _, conv_dim = _dims(cfg)
    dtype = cfg.torch_compute_dtype if dtype is None else dtype
    return (torch.zeros((batch, cfg.d_conv - 1, conv_dim), dtype=dtype, device=device),
            torch.zeros((batch, nh, cfg.headdim, ds), dtype=torch.float32, device=device))


def mamba2_mixer_step(params: dict, cfg: ModelConfig, u_t: torch.Tensor,
                      conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """O(1) decode step: u_t (b, d_model) -> (y_t (b, d_model),
    (conv_state, ssm_state)).  The two states are updated IN PLACE (the
    caller's tensors are overwritten and returned)."""
    di, ds, g, nh, _, _ = _dims(cfg)
    b = u_t.shape[0]
    cd = cfg.torch_compute_dtype

    z, xBC, dt = _split_zxbcdt(linear(params["in_proj"], u_t, cd), cfg)
    xBC, conv_state = causal_conv1d_update(
        xBC, conv_state, params["conv"]["kernel"], params["conv"].get("bias"),
        activation="silu", out_state=conv_state,
    )
    x, B, C = _split_xbc(xBC, cfg)
    y, ssm_state = ssd_state_update(
        ssm_state, x.reshape(b, nh, cfg.headdim), dt.float(),
        -torch.exp(params["A_log"].float()), B.reshape(b, g, ds),
        C.reshape(b, g, ds), _D(params, cfg), dt_bias=params["dt_bias"],
        dt_softplus=True, out=ssm_state,
    )
    y = rms_norm_gated(y.reshape(b, di), z, params["norm"]["weight"],
                       cfg.norm_eps, group_size=di // g if g > 1 else None)
    return linear(params["out_proj"], y, cd), (conv_state, ssm_state)
