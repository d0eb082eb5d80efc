"""HF / mamba_ssm checkpoint importer (counterpart of the JAX package's
``models/hf.py``).

Maps a *local* ``state-spaces``-style torch state dict
(``MambaLMHeadModel`` naming: ``backbone.layers.{i}.mixer...``) onto the
port's layer-stacked param tree: the keys, layouts and stacking that
``convert.params_from_jax`` produces, fp32 tensors on a given device.

Layout differences handled here:
  * torch Linear stores (out, in) -> ours is (in, out): transpose
  * torch depthwise Conv1d stores (ch, 1, width) -> ours (ch, width)
  * per-layer tensors -> stacked along a leading n_layer axis; a
    hybrid's attention layers (``Wqkv`` + ``out_proj``) stack apart into
    ``attn_blocks``
  * the embedding is zero-padded to the padded vocab; a tied
    ``lm_head.weight`` is dropped (ours reuses the embedding)

Nothing is downloaded: a directory holds ``config.json`` +
``pytorch_model.bin``, or a ``.pt`` file holds a raw state dict or the
reference trainer's ``{"model": state_dict, ...}`` wrapper.
"""

from __future__ import annotations

import json
import os

import torch

from mamba_distributed_tpu_torch.config import ModelConfig


def config_from_hf_json(config_data: dict) -> ModelConfig:
    """mamba_ssm MambaConfig json -> ModelConfig."""
    if not config_data.get("rms_norm", True):
        # the JAX package takes the flag and runs RMSNorm all the same
        raise ValueError("rms_norm=false: the port's blocks use RMSNorm only")
    ssm_cfg = config_data.get("ssm_cfg") or {}
    layer = ssm_cfg.get("layer", "Mamba1").lower()
    kw = dict(
        d_model=config_data["d_model"],
        n_layer=config_data["n_layer"],
        vocab_size=config_data["vocab_size"],
        ssm_layer="mamba2" if layer == "mamba2" else "mamba1",
        d_intermediate=config_data.get("d_intermediate", 0),
        residual_in_fp32=config_data.get("residual_in_fp32", True),
        tie_embeddings=config_data.get("tie_embeddings", True),
        pad_vocab_size_multiple=config_data.get("pad_vocab_size_multiple", 8),
    )
    for key in ("d_state", "d_conv", "expand", "headdim", "ngroups", "chunk_size"):
        if key in ssm_cfg:
            kw[key] = ssm_cfg[key]
    # hybrid (Jamba-style): MambaConfig.attn_layer_idx + attn_cfg (mamba_ssm
    # MHA naming: num_heads / num_heads_kv / head_dim / rotary_emb_dim,
    # whose default 0 means NO rotary, matching attn_rotary_dim=0; the
    # config's "full head dim" is -1)
    attn_idx = config_data.get("attn_layer_idx") or []
    if attn_idx:
        attn_cfg = config_data.get("attn_cfg") or {}
        kw["attn_layer_idx"] = tuple(attn_idx)
        for src, dst in (("num_heads", "attn_num_heads"),
                         ("num_heads_kv", "attn_num_kv_heads"),
                         ("head_dim", "attn_head_dim")):
            if src in attn_cfg:
                kw[dst] = attn_cfg[src]
        kw["attn_rotary_dim"] = attn_cfg.get("rotary_emb_dim", 0)
    return ModelConfig(**kw)


def import_state_dict(state_dict: dict, cfg: ModelConfig, device=None) -> dict:
    """torch MambaLMHeadModel state dict -> the port's layer-stacked tree
    of fp32 tensors on ``device``."""
    sd = {k: torch.as_tensor(v).detach().to("cpu", torch.float32)
          for k, v in state_dict.items()}
    attn_idx = set(cfg.attn_layer_idx or ())

    def linear(key: str) -> dict:
        out = {"kernel": sd[key + ".weight"].t()}
        if key + ".bias" in sd:
            out["bias"] = sd[key + ".bias"]
        return out

    def ffn(pre: str, block: dict) -> dict:
        if cfg.d_intermediate > 0:
            block["norm2"] = {"weight": sd[pre + "norm2.weight"]}
            block["mlp"] = {"fc1": {"kernel": sd[pre + "mlp.fc1.weight"].t()},
                            "fc2": {"kernel": sd[pre + "mlp.fc2.weight"].t()}}
        return block

    def attn_layer(i: int) -> dict:
        pre = f"backbone.layers.{i}."
        wqkv = sd[pre + "mixer.Wqkv.weight"]
        nh = cfg.effective_attn_num_heads
        nkv = cfg.effective_attn_num_kv_heads
        hd = cfg.effective_attn_head_dim
        want = (nh + 2 * nkv) * hd
        if wqkv.shape[0] != want:
            raise ValueError(
                f"layer {i}: Wqkv rows {wqkv.shape[0]} != "
                f"(nh={nh} + 2*nkv={nkv}) * head_dim={hd} = {want}; "
                "check attn_cfg (num_heads/num_heads_kv/head_dim)"
            )
        mixer = {"wqkv": linear(pre + "mixer.Wqkv"),
                 "out_proj": linear(pre + "mixer.out_proj")}
        return ffn(pre, {"norm": {"weight": sd[pre + "norm.weight"]}, "mixer": mixer})

    def layer(i: int) -> dict:
        pre = f"backbone.layers.{i}."
        conv_w = sd[pre + "mixer.conv1d.weight"]  # (ch, 1, width)
        conv = {"kernel": conv_w.reshape(conv_w.shape[0], conv_w.shape[-1])}
        if pre + "mixer.conv1d.bias" in sd:
            conv["bias"] = sd[pre + "mixer.conv1d.bias"]
        mixer = {"in_proj": linear(pre + "mixer.in_proj"), "conv": conv,
                 "A_log": sd[pre + "mixer.A_log"], "D": sd[pre + "mixer.D"],
                 "out_proj": linear(pre + "mixer.out_proj")}
        if cfg.ssm_layer == "mamba2":
            mixer["dt_bias"] = sd[pre + "mixer.dt_bias"]
            mixer["norm"] = {"weight": sd[pre + "mixer.norm.weight"]}
        else:
            mixer["x_proj"] = {"kernel": sd[pre + "mixer.x_proj.weight"].t()}
            mixer["dt_proj"] = {"kernel": sd[pre + "mixer.dt_proj.weight"].t(),
                                "bias": sd[pre + "mixer.dt_proj.bias"]}
        return ffn(pre, {"norm": {"weight": sd[pre + "norm.weight"]}, "mixer": mixer})

    def stack(trees: list) -> dict:
        first = trees[0]
        if isinstance(first, dict):
            return {k: stack([t[k] for t in trees]) for k in first}
        return torch.stack(trees).to(device)

    n = cfg.n_layer
    params = {"blocks": stack([layer(i) for i in range(n) if i not in attn_idx])}
    if attn_idx:
        params["attn_blocks"] = stack([attn_layer(i) for i in range(n) if i in attn_idx])
    emb = sd["backbone.embedding.weight"]
    vp = cfg.vocab_size_padded
    if emb.shape[0] < vp:  # pad rows as pad_vocab_size_multiple does
        emb = torch.cat([emb, emb.new_zeros((vp - emb.shape[0], emb.shape[1]))])
    params["embedding"] = emb.contiguous().to(device)
    params["norm_f"] = {"weight": sd["backbone.norm_f.weight"].to(device)}
    if not cfg.tie_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = {"kernel": sd["lm_head.weight"].t().contiguous().to(device)}
    return params


def load_hf_checkpoint(path: str, cfg: ModelConfig | None = None, device=None):
    """Load (params, cfg) from a local HF-style directory or .pt file.

    Directory: ``config.json`` + ``pytorch_model.bin``.  File: a torch
    checkpoint holding either a raw state dict or the reference trainer's
    ``{"model": state_dict, ...}`` wrapper; its ``cfg`` must be given.
    """
    if os.path.isdir(path):
        with open(os.path.join(path, "config.json")) as f:
            cfg = config_from_hf_json(json.load(f))
        sd = torch.load(os.path.join(path, "pytorch_model.bin"),
                        map_location="cpu", weights_only=True)
    else:
        if cfg is None:
            raise ValueError("pass a ModelConfig when loading a bare .pt")
        obj = torch.load(path, map_location="cpu", weights_only=True)
        sd = obj.get("model", obj) if isinstance(obj, dict) else obj
    sd = {k.removeprefix("module."): v for k, v in sd.items()}  # DDP prefix
    return import_state_dict(sd, cfg, device), cfg
