"""The port's checkpoint importer (``models/hf.py``) against the JAX
package's, on the CPU in fp32.

The same synthetic ``MambaLMHeadModel``-named state dicts (the JAX
tests' own state-dict makers: Mamba-2, Mamba-1, a hybrid with ``Wqkv``/``out_proj``
layers, plus a gated MLP and an untied head here) go through both
importers: the port's tree equals JAX's key for key, bit for bit, with
the vocab padding, the ``module.`` prefix, the reference's ``{"model":
...}`` wrapper and a directory with ``config.json``; the logits of the
two imported models agree at 1e-4.  ``chip_smoke.hf_state_dict`` (the
inverse mapping the card run uses) round-trips port params bit for bit.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import chip_smoke
from mamba_distributed_tpu.config import ModelConfig as JaxConfig
from mamba_distributed_tpu.models import lm as jlm
from mamba_distributed_tpu.models import hf as jhf
from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.models import hf
from mamba_distributed_tpu_torch.models.lm import count_params, init_lm_params, lm_forward
from tests.test_hf_import import (
    CFG,
    HYBRID_CFG,
    M1_CFG,
    hybrid_synthetic_state_dict,
    m1_synthetic_state_dict,
    synthetic_state_dict,
)

pytestmark = pytest.mark.torch


def _port_cfg(jcfg: JaxConfig) -> ModelConfig:
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in names})


def _with_mlp(sd: dict, cfg, di: int, seed: int = 1) -> dict:
    """``sd`` plus each layer's norm2 and gated MLP (fc1 (2 di, d), fc2 (d, di))."""
    g = torch.Generator().manual_seed(seed)
    out = dict(sd)
    for i in range(cfg.n_layer):
        pre = f"backbone.layers.{i}."
        out[pre + "norm2.weight"] = torch.rand(cfg.d_model, generator=g) + 0.5
        out[pre + "mlp.fc1.weight"] = torch.randn(2 * di, cfg.d_model, generator=g) * 0.05
        out[pre + "mlp.fc2.weight"] = torch.randn(cfg.d_model, di, generator=g) * 0.05
    return out


MLP_CFG = dataclasses.replace(HYBRID_CFG, d_intermediate=24)
UNTIED_CFG = dataclasses.replace(CFG, tie_embeddings=False)


def _untied_sd(cfg):
    sd = synthetic_state_dict(cfg)
    sd["lm_head.weight"] = torch.randn(cfg.vocab_size, cfg.d_model,
                                       generator=torch.Generator().manual_seed(3)) * 0.05
    return sd


CASES = {
    "mamba2": (CFG, lambda: synthetic_state_dict(CFG)),
    "mamba1": (M1_CFG, lambda: m1_synthetic_state_dict(M1_CFG)),
    "hybrid": (HYBRID_CFG, lambda: hybrid_synthetic_state_dict(HYBRID_CFG)),
    "hybrid_mlp": (MLP_CFG, lambda: _with_mlp(hybrid_synthetic_state_dict(MLP_CFG), MLP_CFG, 24)),
    "untied": (UNTIED_CFG, lambda: _untied_sd(UNTIED_CFG)),
}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree.detach().cpu() if isinstance(tree, torch.Tensor)
                                    else tree)}


def _assert_same_tree(port: dict, jax_tree: dict):
    a, b = _leaves(port), _leaves(jax_tree)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _ids(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_import_equals_jax_tree_and_logits(case):
    jcfg, make = CASES[case]
    sd = make()
    cfg = _port_cfg(jcfg)
    port = hf.import_state_dict(sd, cfg)
    jtree = jhf.import_state_dict(sd, jcfg)
    _assert_same_tree(port, jtree)
    if jcfg.tie_embeddings:  # an untied head keeps the checkpoint's vocab rows
        assert count_params(port) == jcfg.num_params()
    assert port["embedding"].shape == (cfg.vocab_size_padded, cfg.d_model)
    assert all(t.is_contiguous() for t in _tensors(port))
    ids = _ids(cfg)
    want = np.asarray(jlm.lm_forward(jtree, jcfg, ids), np.float32)
    got = lm_forward(port, cfg, torch.from_numpy(ids).long()).float().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def test_reference_pt_wrapper_and_module_prefix(tmp_path):
    """The reference trainer's {"model": sd, ...} wrapper with DDP's
    ``module.`` prefix loads, equal to the JAX importer's tree; a bare
    ``.pt`` without a config is refused."""
    sd = synthetic_state_dict(CFG)
    path = str(tmp_path / "model_03000.pt")
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}, "step": 3000,
                "val_loss": 3.26}, path)
    params, cfg = hf.load_hf_checkpoint(path, _port_cfg(CFG))
    jparams, _ = jhf.load_hf_checkpoint(path, CFG)
    _assert_same_tree(params, jparams)
    with pytest.raises(ValueError, match="ModelConfig"):
        hf.load_hf_checkpoint(path)


def test_hf_dir_with_config(tmp_path):
    config = {
        "d_model": CFG.d_model, "n_layer": CFG.n_layer, "vocab_size": CFG.vocab_size,
        "ssm_cfg": {"layer": "Mamba2", "d_state": 16, "headdim": 8, "chunk_size": 16},
        "rms_norm": True, "residual_in_fp32": True, "tie_embeddings": True,
        "pad_vocab_size_multiple": 8,
    }
    d = tmp_path / "hf"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(config))
    torch.save(synthetic_state_dict(CFG), str(d / "pytorch_model.bin"))
    params, cfg = hf.load_hf_checkpoint(str(d), device="cpu")
    jparams, jcfg = jhf.load_hf_checkpoint(str(d))
    assert cfg.ssm_layer == "mamba2" and cfg.effective_d_state == 16
    assert params["blocks"]["mixer"]["A_log"].shape == (2, cfg.nheads)
    _assert_same_tree(params, jparams)
    _assert_same_config(cfg, jcfg)


def _assert_same_config(cfg: ModelConfig, jcfg: JaxConfig):
    shared = {f.name for f in dataclasses.fields(ModelConfig)} & {
        f.name for f in dataclasses.fields(JaxConfig)}
    for name in sorted(shared):
        assert getattr(cfg, name) == getattr(jcfg, name), name


@pytest.mark.parametrize("data", [
    {"d_model": 768, "n_layer": 64, "vocab_size": 50277},
    {"d_model": 64, "n_layer": 4, "vocab_size": 61,
     "ssm_cfg": {"layer": "Mamba2", "headdim": 8},
     "attn_layer_idx": [1, 3],
     "attn_cfg": {"num_heads": 8, "num_heads_kv": 2, "rotary_emb_dim": 4, "causal": True}},
    {"d_model": 64, "n_layer": 4, "vocab_size": 61,
     "ssm_cfg": {"layer": "Mamba2", "headdim": 8},
     "attn_layer_idx": [1], "attn_cfg": {"num_heads": 4, "head_dim": 32}},
    {"d_model": 64, "n_layer": 2, "vocab_size": 61, "d_intermediate": 96,
     "tie_embeddings": False, "ssm_cfg": {"layer": "Mamba2", "headdim": 16, "d_state": 32,
                                          "ngroups": 2, "chunk_size": 32}},
], ids=["mamba1_default", "hybrid_gqa_rotary", "hybrid_head_dim", "mlp_untied"])
def test_config_from_hf_json_equals_jax(data):
    cfg = hf.config_from_hf_json(data)
    _assert_same_config(cfg, jhf.config_from_hf_json(data))


def test_rms_norm_false_is_refused():
    with pytest.raises(ValueError, match="RMSNorm"):
        hf.config_from_hf_json({"d_model": 64, "n_layer": 2, "vocab_size": 61,
                                "rms_norm": False})


def test_wqkv_row_check_message_equals_jax():
    bad = JaxConfig(d_model=32, n_layer=2, vocab_size=61, ssm_layer="mamba2", headdim=8,
                    chunk_size=16, d_state=16, attn_layer_idx=(1,), attn_num_heads=4,
                    compute_dtype="float32")
    sd = hybrid_synthetic_state_dict(dataclasses.replace(bad, attn_num_kv_heads=2))
    with pytest.raises(ValueError, match="Wqkv rows") as port_err:
        hf.import_state_dict(sd, _port_cfg(bad))
    with pytest.raises(ValueError) as jax_err:
        jhf.import_state_dict(sd, bad)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("preset_kw", [
    dict(d_model=64, n_layer=3, headdim=16, d_state=32, chunk_size=16, vocab_size=100),
    dict(d_model=64, n_layer=3, ssm_layer="mamba1", d_state=8, vocab_size=100),
    dict(d_model=64, n_layer=4, headdim=16, d_state=32, chunk_size=16, vocab_size=100,
         attn_layer_idx=(1, 3), attn_num_heads=4, attn_num_kv_heads=2,
         d_intermediate=32, tie_embeddings=False),
], ids=["mamba2", "mamba1", "hybrid_mlp_untied"])
def test_inverse_mapping_round_trips_bit_for_bit(tmp_path, preset_kw):
    """Port params -> ``chip_smoke.hf_state_dict`` + ``hf_config_json`` ->
    a directory -> ``load_hf_checkpoint``: every tensor bit-identical,
    the config the same model, the logits bit-identical."""
    cfg = ModelConfig(compute_dtype="float32", **preset_kw)
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))
    (tmp_path / "config.json").write_text(json.dumps(chip_smoke.hf_config_json(cfg)))
    torch.save(chip_smoke.hf_state_dict(params, cfg), str(tmp_path / "pytorch_model.bin"))
    back, bcfg = hf.load_hf_checkpoint(str(tmp_path))
    a, b = _leaves(params), _leaves(back)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    bcfg = dataclasses.replace(bcfg, compute_dtype="float32")
    ids = torch.from_numpy(_ids(cfg, 1)).long()
    assert torch.equal(lm_forward(params, cfg, ids), lm_forward(back, bcfg, ids))
