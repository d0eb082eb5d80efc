"""Analytic FLOPs accounting for MFU (counterpart of the JAX package's
``utils/flops.py``, the Mamba-2, Mamba-1 and attention layers).

Matmul FLOPs: 2*m*n per (m x n) matvec per token, 3x the forward for a
training step (forward + 2x backward), attention causally halved.  Two
conventions:

- ``hardware``: what the chunked SSD algorithm executes, the O(chunk)
  Gram/decay products included;
- ``model``: the math the model defines, parameter matmuls plus the
  recurrent state update/readout (no chunk-size term), the 6ND-style
  number MFU is judged on.

The two differ only for Mamba-2 layers: Mamba-1's accounting is already
the recurrence.

The peak is the card's, from its name: only cards with a published
dense bf16 rate in this table are known, and any other raises.
"""

from __future__ import annotations

import torch

from mamba_distributed_tpu_torch.config import ModelConfig

# dense bf16 tensor-core peak (NVIDIA data sheet), keyed by substrings
# of torch.cuda.get_device_name
_PEAK_BF16 = (
    (("H100", "HBM3"), 989e12),  # H100 SXM
    (("H100", "SXM"), 989e12),
)


def peak_flops(device: torch.device | str = "cuda") -> float:
    """Dense bf16 peak FLOP/s of the card ``device``; raises for a card
    (or a device) with no entry."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no peak FLOP/s for a {device.type!r} device")
    name = torch.cuda.get_device_name(device)
    for keys, val in _PEAK_BF16:
        if all(k in name for k in keys):
            return val
    raise ValueError(f"no published bf16 peak for {name!r}; add it to utils/flops.py")


def _mamba2_layer_flops(cfg: ModelConfig, seq_len: int, convention: str) -> float:
    d, di = cfg.d_model, cfg.d_inner
    n, h, p = cfg.effective_d_state, cfg.nheads, cfg.headdim
    g = cfg.ngroups
    l = min(cfg.chunk_size, seq_len)
    f = 2 * d * (2 * di + 2 * g * n + h)  # in_proj
    f += 2 * (di + 2 * g * n) * cfg.d_conv  # depthwise conv
    if convention == "hardware":
        # chunked SSD per token: the Gram matrix is group-shared, M@x
        # (l*p), chunk states (n*p) and off-diagonal (n*p) per head
        f += 2 * (g * l * n + h * l * p + 2 * h * n * p)
    else:
        # recurrent formulation: B (x) x state update + C . state readout
        f += 2 * (2 * h * n * p)
    f += 2 * di * d  # out_proj
    return f


def _mamba1_layer_flops(cfg: ModelConfig) -> float:
    d, di = cfg.d_model, cfg.d_inner
    n, dtr = cfg.effective_d_state, cfg.effective_dt_rank
    f = 2 * d * 2 * di  # in_proj
    f += 2 * di * cfg.d_conv  # depthwise conv
    f += 2 * di * (dtr + 2 * n)  # x_proj
    f += 2 * dtr * di  # dt_proj
    f += 8 * di * n  # recurrence (dA, dBu, state update, C reduction)
    f += 2 * di * d  # out_proj
    return f


def _attn_layer_flops(cfg: ModelConfig, seq_len: int) -> float:
    nh = cfg.effective_attn_num_heads
    nkv = cfg.effective_attn_num_kv_heads
    hd = cfg.d_model // nh
    f = 2 * cfg.d_model * (nh + 2 * nkv) * hd  # qkv
    f += 2 * seq_len * nh * hd  # scores + AV, causally halved
    f += 2 * nh * hd * cfg.d_model  # out_proj
    return f


def flops_per_token(cfg: ModelConfig, seq_len: int, training: bool = True,
                    convention: str = "hardware") -> float:
    """Matmul FLOPs per token for one forward (x3 when ``training``)."""
    if convention not in ("hardware", "model"):
        raise ValueError(f"unknown FLOPs convention {convention!r}")
    attn_idx = set(cfg.attn_layer_idx)
    total = 0.0
    for i in range(cfg.n_layer):
        if i in attn_idx:
            total += _attn_layer_flops(cfg, seq_len)
        elif cfg.ssm_layer == "mamba2":
            total += _mamba2_layer_flops(cfg, seq_len, convention)
        else:
            total += _mamba1_layer_flops(cfg)
    total += 2 * cfg.d_model * cfg.vocab_size_padded  # LM head
    return total * (3.0 if training else 1.0)
