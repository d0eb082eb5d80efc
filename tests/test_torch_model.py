"""The port's model stack against the JAX package's, on the CPU in fp32.

One parameter tree is built with the JAX ``init_lm_params``, converted
with ``convert.params_from_jax``, and both packages run it on the same
numpy inputs: the mixer, ``lm_prefill`` (with a left-pad token mask),
``lm_prefill_chunk`` and ``lm_step`` agree in logits and states at
1e-4.  JAX runs ``ssm_impl="xla"``, the plain reference that
tests/test_pallas.py holds its kernel to, and ``ssm_impl="pallas"`` (in
interpret mode) once at the smallest shape.  Hybrid stacks (attention at
``attn_layer_idx`` over a paged KV cache) hold ``lm_prefill_chunk`` with
a left pad, ``lm_step`` with a partial ``write_mask`` and the one-shot
``lm_prefill(max_len=)`` (full-sequence attention, K/V packed into
pages) to JAX in logits, conv and SSM states, pages and lengths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_distributed_tpu.config import ModelConfig as JaxConfig
from mamba_distributed_tpu.inference.bucketing import pad_to_bucket as jax_pad
from mamba_distributed_tpu.models import lm as jlm
from mamba_distributed_tpu.models.mamba2 import mamba2_mixer as jax_mixer
from mamba_distributed_tpu_torch import convert
from mamba_distributed_tpu_torch.config import ModelConfig, get_preset
from mamba_distributed_tpu_torch.inference.bucketing import pad_to_bucket
from mamba_distributed_tpu_torch.models import lm
from mamba_distributed_tpu_torch.models.mamba2 import mamba2_mixer
from mamba_distributed_tpu_torch.serving import ServingEngine

pytestmark = pytest.mark.torch

TOL = dict(atol=1e-4, rtol=1e-4)
# the tiny config of tests/test_serving.py:33
TINY = dict(d_model=32, n_layer=2, vocab_size=64, headdim=8, chunk_size=16,
            d_state=16, compute_dtype="float32")


@pytest.fixture(scope="module")
def pair():
    jcfg = JaxConfig(**TINY)
    jparams = jlm.init_lm_params(jax.random.PRNGKey(0), jcfg)
    np_tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, ModelConfig(**TINY), convert.params_from_jax(np_tree)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), **tol)


def _ids(seed, b, t):
    return np.random.default_rng(seed).integers(0, 64, (b, t)).astype(np.int32)


def test_params_round_trip(pair):
    jcfg, jparams, cfg, params = pair
    back = convert.params_to_numpy(params)
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat_j) == len(jax.tree.leaves(back))
    for path, leaf in flat_j:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert params["blocks"]["mixer"]["in_proj"]["kernel"].shape == (
        2, 32, jnp.shape(jparams["blocks"]["mixer"]["in_proj"]["kernel"])[2])
    with pytest.raises(ValueError, match="pure Mamba-2"):
        convert.params_from_jax({**jax.tree.map(np.asarray, jparams), "bogus": {}})


def test_port_init_matches_jax_shapes_and_scale(pair):
    """The port's own init builds the same tree (same keys, shapes and
    init scales) from a torch.Generator."""
    _, jparams, cfg, _ = pair
    mine = lm.init_lm_params(cfg, torch.Generator().manual_seed(0))
    ref = convert.params_to_numpy(convert.params_from_jax(jax.tree.map(np.asarray, jparams)))
    for (p, a), b in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                         jax.tree.leaves(convert.params_to_numpy(mine))):
        assert a.shape == b.shape, p
        assert abs(float(np.abs(a).max()) - float(np.abs(b).max())) < 0.5 * float(np.abs(a).max()) + 1e-6, p


def test_config_rejects_unserved_models():
    with pytest.raises(ValueError, match="attn_layer_idx"):
        ModelConfig(**TINY, attn_layer_idx=(2,))
    with pytest.raises(ValueError, match="chunked prefill"):
        ServingEngine({}, ModelConfig(**TINY, attn_layer_idx=(1,), attn_num_heads=4,
                                      prefill_chunk_tokens=0), device="cpu")
    with pytest.raises(ValueError, match="attn_num_kv_heads"):
        ModelConfig(**TINY, attn_layer_idx=(1,), attn_num_heads=4, attn_num_kv_heads=3)
    with pytest.raises(ValueError, match="kv_page_dtype"):
        ModelConfig(**TINY, kv_page_dtype="int4")
    with pytest.raises(ValueError, match="serving_weight_dtype"):
        ModelConfig(**TINY, serving_weight_dtype="fp8")
    with pytest.raises(ValueError, match="multiple of 8"):
        ModelConfig(**TINY, kv_page_tokens=12)
    with pytest.raises(ValueError, match="mamba1"):
        ModelConfig(**TINY, ssm_layer="mamba3")
    with pytest.raises(ValueError, match="d_intermediate"):
        ModelConfig(**TINY, moe_num_experts=4)  # a MoE replaces an MLP, so needs one
    hyb = get_preset("hybrid-280m")
    assert (hyb.attn_layer_idx, hyb.effective_attn_num_heads,
            hyb.effective_attn_num_kv_heads, hyb.effective_attn_head_dim,
            hyb.kv_pages_per_slot, hyb.effective_prefill_chunk_tokens) == (
        tuple(range(3, 64, 8)), 12, 4, 64, 16, 256)
    cfg = get_preset("mamba2-280m")
    assert (cfg.d_model, cfg.n_layer, cfg.effective_d_state, cfg.nheads,
            cfg.vocab_size_padded) == (768, 64, 128, 24, 50304)
    assert ModelConfig(**{**TINY, "prefill_chunk_tokens": 20}).effective_prefill_chunk_tokens == 32


@pytest.mark.parametrize("masked,seeded", [(False, False), (True, True)])
def test_mixer_matches_jax(pair, masked, seeded):
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(1)
    u = rng.standard_normal((2, 32, 32)).astype(np.float32)
    mask = np.ones((2, 32), np.float32)
    if masked:
        mask[0, :9] = 0.0
    conv0 = rng.standard_normal((2, 3, 96)).astype(np.float32)  # conv_dim
    ssm0 = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    jb = jax.tree.map(lambda a: a[0], jparams["blocks"]["mixer"])
    tb = jax.tree.map(lambda a: a[0], params["blocks"]["mixer"])
    kw_j = dict(return_final_state=True, token_mask=jnp.asarray(mask) if masked else None)
    kw_t = dict(return_final_state=True, token_mask=torch.from_numpy(mask) if masked else None)
    if seeded:
        kw_j.update(initial_conv_state=jnp.asarray(conv0), initial_ssm_state=jnp.asarray(ssm0))
        kw_t.update(initial_conv_state=torch.from_numpy(conv0),
                    initial_ssm_state=torch.from_numpy(ssm0))
    yj, (cj, sj) = jax_mixer(jb, jcfg, jnp.asarray(u), **kw_j)
    yt, (ct, st) = mamba2_mixer(tb, cfg, torch.from_numpy(u), **kw_t)
    _close(yt, yj)
    _close(ct, cj)
    _close(st, sj)


@pytest.mark.parametrize("t", [5, 16, 27])
def test_lm_prefill_matches_jax(pair, t):
    """Left-padded bucketed prefill: logits and every layer's state."""
    jcfg, jparams, cfg, params = pair
    ids = _ids(t, 1, t)
    bucket = 32 if t > 16 else 16
    pj, mj = jax_pad(jnp.asarray(ids), bucket)
    pt, mt = pad_to_bucket(torch.from_numpy(ids).long(), bucket)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    lj, stj = jlm.lm_prefill(jparams, jcfg, pj, token_mask=mj)
    lt, stt = lm.lm_prefill(params, cfg, pt, token_mask=mt)
    _close(lt, lj)
    for a, b in zip(stt["blocks"], stj["blocks"]):
        _close(a, b)


def test_lm_prefill_chunk_matches_jax(pair):
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(5)
    conv0 = rng.standard_normal((2, 2, 3, 96)).astype(np.float32)
    ssm0 = rng.standard_normal((2, 2, 8, 8, 16)).astype(np.float32) * 0.1
    ids = _ids(9, 2, 16)
    mask = np.ones((2, 16), np.float32)
    mask[1, :4] = 0.0
    lj, sj = jlm.lm_prefill_chunk(jparams, jcfg, jnp.asarray(ids),
                                  {"blocks": (jnp.asarray(conv0), jnp.asarray(ssm0))},
                                  token_mask=jnp.asarray(mask))
    state = {"blocks": (torch.from_numpy(conv0), torch.from_numpy(ssm0))}
    lt, st = lm.lm_prefill_chunk(params, cfg, torch.from_numpy(ids).long(), state,
                                 token_mask=torch.from_numpy(mask))
    _close(lt, lj)
    for a, b in zip(st["blocks"], sj["blocks"]):
        _close(a, b)
    # the input state is left untouched
    np.testing.assert_array_equal(state["blocks"][0].numpy(), conv0)


def test_lm_step_matches_jax(pair):
    """Three decode steps from a prefill state: logits and states."""
    jcfg, jparams, cfg, params = pair
    ids = _ids(2, 3, 8)
    _, sj = jlm.lm_prefill(jparams, jcfg, jnp.asarray(ids))
    state = {"blocks": tuple(torch.from_numpy(np.array(a)) for a in sj["blocks"])}
    for i in range(3):
        tok = _ids(20 + i, 1, 3)[0]
        lj, sj = jlm.lm_step(jparams, jcfg, sj, jnp.asarray(tok))
        lt, state = lm.lm_step(params, cfg, state, torch.from_numpy(tok).long())
        _close(lt, lj)
        for a, b in zip(state["blocks"], sj["blocks"]):
            _close(a, b)


def test_pallas_impl_prefill_matches_jax_pallas(pair):
    """ssm_impl="pallas" on both sides at the smallest shape: JAX runs its
    kernel in interpret mode, the port its plain version (CPU tensors)."""
    jcfg, jparams, cfg, params = pair
    jcfg_p = dataclasses.replace(jcfg, ssm_impl="pallas")
    cfg_p = dataclasses.replace(cfg, ssm_impl="pallas")
    ids = _ids(3, 1, 8)
    lj, sj = jlm.lm_prefill(jparams, jcfg_p, jnp.asarray(ids))
    lt, st = lm.lm_prefill(params, cfg_p, torch.from_numpy(ids).long())
    _close(lt, lj)
    for a, b in zip(st["blocks"], sj["blocks"]):
        _close(a, b)


# -------------------------------------------------------------- hybrid stacks

# the hybrid config of tests/test_serving.py:426-434, and a periodic
# 4-layer stack with attention at layers 1 and 3
HYBRID = dict(TINY, attn_layer_idx=(1,), attn_num_heads=4, attn_num_kv_heads=2,
              kv_page_tokens=8, kv_slot_tokens=64, prefill_chunk_tokens=16)
HYBRID4 = dict(HYBRID, n_layer=4, attn_layer_idx=(1, 3))


@pytest.fixture(scope="module", params=[HYBRID, HYBRID4], ids=["attn1of2", "attn13of4"])
def hybrid_pair(request):
    jcfg = JaxConfig(**request.param, remat=False)
    jparams = jlm.init_lm_params(jax.random.PRNGKey(1), jcfg)
    return (jcfg, jparams, ModelConfig(**request.param),
            convert.params_from_jax(jax.tree.map(np.asarray, jparams)))


def test_hybrid_params_round_trip(hybrid_pair):
    jcfg, jparams, cfg, params = hybrid_pair
    back = convert.params_to_numpy(params)
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat_j) == len(jax.tree.leaves(back))
    for path, leaf in flat_j:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    n_attn = len(cfg.attn_layer_idx)
    assert params["attn_blocks"]["mixer"]["wqkv"]["kernel"].shape == (n_attn, 32, 8 * 8)
    assert params["blocks"]["norm"]["weight"].shape[0] == cfg.n_layer - n_attn
    # the port's own init builds the same keys and shapes
    mine = convert.params_to_numpy(lm.init_lm_params(cfg, torch.Generator().manual_seed(0)))
    for (pth, a), b in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                           jax.tree.leaves(mine)):
        assert a.shape == b.shape, pth


def _close_state(got, ref):
    for a, b in zip(got["blocks"], ref["blocks"]):
        _close(a, b)
    for a, b in zip(got["attn_blocks"], ref["attn_blocks"]):
        # page 0 is the trash page: its content is garbage by contract
        _close(a[:, 1:], np.asarray(b)[:, 1:])
    for a, b in zip(got["attn_meta"], ref["attn_meta"]):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_hybrid_chunk_and_steps_match_jax(hybrid_pair):
    """Two prefill chunks (the first with a left pad, the rows at
    different lengths), then three decode steps with a partial write
    mask: logits, conv and SSM states, pages and lengths."""
    jcfg, jparams, cfg, params = hybrid_pair
    b, c = 2, 16
    sj = jlm.init_lm_state(jcfg, b, max_len=48)
    st = lm.init_lm_state(cfg, b, max_len=48)
    assert st["attn_blocks"][0].shape == sj["attn_blocks"][0].shape
    mask = np.ones((b, c), np.float32)
    mask[1, :5] = 0.0
    for i in range(2):
        ids = _ids(40 + i, b, c)
        m = mask if i == 0 else np.ones_like(mask)
        lj, sj = jlm.lm_prefill_chunk(jparams, jcfg, jnp.asarray(ids), sj,
                                      token_mask=jnp.asarray(m))
        lt, st = lm.lm_prefill_chunk(params, cfg, torch.from_numpy(ids).long(), st,
                                     token_mask=torch.from_numpy(m))
        _close(lt, lj)
        _close_state(st, sj)
    assert st["attn_meta"][1].tolist() == [32, 27]
    for i, wm in enumerate(([True, False], [True, True], [False, True])):
        tok = _ids(50 + i, 1, b)[0]
        lj, sj = jlm.lm_step(jparams, jcfg, sj, jnp.asarray(tok),
                             write_mask=jnp.asarray(wm))
        lt, st = lm.lm_step(params, cfg, st, torch.from_numpy(tok).long(),
                            write_mask=torch.tensor(wm))
        _close(lt, lj)
        _close_state(st, sj)
    assert st["attn_meta"][1].tolist() == [34, 29]


def test_hybrid_one_shot_prefill_raises(hybrid_pair):
    """As in JAX: no KV capacity beyond the prompt, or a pad mask (the
    full-sequence attention would attend the pad keys), raises."""
    _, _, cfg, params = hybrid_pair
    ids = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="max_len"):
        lm.lm_prefill(params, cfg, ids)
    with pytest.raises(ValueError, match="max_len"):
        lm.lm_prefill(params, cfg, ids, max_len=8)
    with pytest.raises(ValueError, match="chunk step"):
        lm.lm_prefill(params, cfg, ids, max_len=16, token_mask=torch.ones((1, 8)))


@pytest.mark.parametrize("t,max_len", [(13, 30), (16, 17)])
def test_hybrid_one_shot_prefill_matches_jax(hybrid_pair, t, max_len):
    """One-shot hybrid prefill: last logits, conv and SSM states, every
    attention layer's packed pages (trash page included) and the meta;
    then decode steps from that state still agree."""
    jcfg, jparams, cfg, params = hybrid_pair
    ids = _ids(60 + t, 2, t)
    lj, sj = jlm.lm_prefill(jparams, jcfg, jnp.asarray(ids), max_len=max_len)
    lt, st = lm.lm_prefill(params, cfg, torch.from_numpy(ids).long(), max_len=max_len)
    _close(lt, lj)
    _close_state(st, sj)
    for a, b in zip(st["attn_blocks"], sj["attn_blocks"]):
        _close(a[:, 0], np.asarray(b)[:, 0])
    for i in range(2):
        tok = _ids(70 + i, 1, 2)[0]
        lj, sj = jlm.lm_step(jparams, jcfg, sj, jnp.asarray(tok))
        lt, st = lm.lm_step(params, cfg, st, torch.from_numpy(tok).long())
        _close(lt, lj)
        _close_state(st, sj)
