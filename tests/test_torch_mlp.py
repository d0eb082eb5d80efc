"""The port's gated MLP, MoE and untied head against the JAX package's,
on the CPU in fp32 at 1e-4 of the largest JAX value.

* ``_gated_mlp`` and ``_moe_mlp`` (values, the MoE aux term and every
  gradient) on the same numpy inputs;
* the MoE cases of tests/test_moe.py that need no mesh: identical
  experts equal the dense MLP, the aux term is 1 at perfect balance,
  capacity drops stay finite and the router learns, the decode step
  equals the full forward, the aux term reaches the loss, the parameter
  count;
* a tiny hybrid with a gated MLP and an untied head, and one with a MoE:
  ``lm_loss``, its aux term and every gradient equal
  ``jax.value_and_grad(lm_loss)``;
* ``generate()`` with an MLP and an untied head decodes JAX's greedy
  tokens; a tiny hybrid-7b-shaped model (MLP, GQA rep 4, untied head)
  serves through the engine with int8 weights what ``generate()`` gives,
  and the int8 codes and scales of its MLP and head equal JAX's;
* ``convert`` round trips of the new keys, the decode cast, the FLOPs
  accounting and the config's new fields and ``hybrid-7b`` preset against
  the JAX package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_distributed_tpu.config import ModelConfig as JaxConfig
from mamba_distributed_tpu.config import get_preset as jax_get_preset
from mamba_distributed_tpu.inference import generate as jax_generate
from mamba_distributed_tpu.inference.generate import _decode_params as jax_decode_params
from mamba_distributed_tpu.models import lm as jlm
from mamba_distributed_tpu.utils import flops as jflops
from mamba_distributed_tpu_torch import convert
from mamba_distributed_tpu_torch.config import ModelConfig, get_preset, get_train_preset
from mamba_distributed_tpu_torch.inference.generate import _decode_params, generate
from mamba_distributed_tpu_torch.models import lm
from mamba_distributed_tpu_torch.serving import GenerationRequest, ServingEngine
from mamba_distributed_tpu_torch.training.optimizer import tree_map
from mamba_distributed_tpu_torch.utils import flops

pytestmark = pytest.mark.torch

BASE = dict(d_model=32, n_layer=2, vocab_size=64, headdim=8, chunk_size=16, d_state=16,
            compute_dtype="float32", attn_layer_idx=(1,), attn_num_heads=4,
            attn_num_kv_heads=2, kv_page_tokens=8, kv_slot_tokens=64,
            prefill_chunk_tokens=16, prefill_tokens_per_tick=16)
MODELS = {
    "mlp": dict(BASE, d_intermediate=48, tie_embeddings=False),  # and an untied head
    "moe": dict(BASE, d_intermediate=48, moe_num_experts=4),
}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, ref):
    ref = _np(ref)
    return float(np.abs(_np(got) - ref).max() / max(np.abs(ref).max(), 1e-30))


def _flat(tree, prefix="", leaf=_np):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}.", leaf))
        return out
    return {prefix[:-1]: leaf(tree)}


def _pair(kw, seed=0):
    jcfg = JaxConfig(**kw, remat=False)
    jparams = jax.jit(jlm.init_lm_params, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jparams, ModelConfig(**kw), convert.params_from_jax(
        jax.tree.map(np.asarray, jparams))


def _ids(seed, shape, v=64):
    return np.random.default_rng(seed).integers(0, v, shape).astype(np.int32)


@pytest.mark.parametrize("kind", ["mlp", "moe"])
def test_mlp_and_moe_blocks_match_jax(kind):
    """One layer's MLP or MoE: output, aux and the gradients of
    sum(out * w) + aux in the params and the input."""
    jcfg, jparams, cfg, params = _pair(MODELS[kind])
    key = "mlp" if kind == "mlp" else "moe"
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][key])
    x = np.random.default_rng(3).standard_normal((2, 16, 32)).astype(np.float32)
    w = np.random.default_rng(4).standard_normal((2, 16, 32)).astype(np.float32)

    def jfn(p, xx):
        if kind == "mlp":
            out, aux = jlm._gated_mlp(p, xx, jnp.float32), jnp.zeros(())
        else:
            out, aux = jlm._moe_mlp(p, jcfg, xx, jnp.float32)
        return jnp.sum(out * w) + aux, (out, aux)

    jg, (jout, jaux) = jax.jit(jax.grad(jfn, argnums=(0, 1), has_aux=True))(
        jp, jnp.asarray(x))
    tp = tree_map(lambda a: a[0].clone().requires_grad_(), params["blocks"][key])
    tx = torch.from_numpy(x).requires_grad_()
    if kind == "mlp":
        out, aux = lm._gated_mlp(tp, tx, torch.float32), torch.zeros(())
    else:
        out, aux = lm._moe_mlp(tp, cfg, tx, torch.float32)
    (out * torch.from_numpy(w)).sum().add(aux).backward()
    assert _rel(out, jout) <= 1e-4 and abs(float(aux.detach()) - float(jaux)) <= 1e-5
    got = _flat(tree_map(lambda a: a.grad, tp))
    for k, v in _flat(jg[0]).items():
        assert _rel(got[k], v) <= 1e-4, k
    assert _rel(tx.grad, jg[1]) <= 1e-4


@pytest.mark.parametrize("kind", ["mlp", "moe"])
def test_model_loss_aux_and_grads_match_jax(kind):
    jcfg, jparams, cfg, params = _pair(MODELS[kind])
    x, y = _ids(1, (2, 32)), _ids(2, (2, 32))
    jloss, jgrads = jax.jit(jax.value_and_grad(jlm.lm_loss), static_argnums=1)(
        jparams, jcfg, jnp.asarray(x), jnp.asarray(y))
    jaux = jax.jit(lambda p, i: jlm.lm_forward(p, jcfg, i, return_aux=True)[1])(
        jparams, jnp.asarray(x))
    p = tree_map(lambda t: t.clone().requires_grad_(), params)
    loss = lm.lm_loss(p, cfg, torch.from_numpy(x).long(), torch.from_numpy(y).long())
    loss.backward()
    _, aux = lm.lm_forward(params, cfg, torch.from_numpy(x).long(), return_aux=True)
    assert abs(loss.item() - float(jloss)) <= 1e-4 * abs(float(jloss))
    assert abs(float(aux) - float(jaux)) <= 1e-5
    grads, want = _flat(tree_map(lambda t: t.grad, p)), _flat(jgrads)
    assert set(grads) == set(want)
    for k in want:
        assert _rel(grads[k], want[k]) <= 1e-4, k


def test_moe_cases_of_the_jax_tests():
    """tests/test_moe.py:33-121 without the mesh."""
    cfg = ModelConfig(**MODELS["moe"], moe_capacity_factor=8.0)
    d, di, E = 32, 48, 4
    g = torch.Generator().manual_seed(0)
    w1, w2 = torch.randn((d, 2 * di), generator=g) * 0.1, torch.randn((di, d), generator=g) * 0.1
    x = torch.randn((2, 16, d), generator=g)
    moe = {"router": {"kernel": torch.randn((d, E), generator=g)},
           "w1": w1.expand(E, d, 2 * di), "w2": w2.expand(E, di, d)}
    dense = lm._gated_mlp({"fc1": {"kernel": w1}, "fc2": {"kernel": w2}}, x, torch.float32)
    out, aux = lm._moe_mlp(moe, cfg, x, torch.float32)
    torch.testing.assert_close(out, dense, atol=1e-5, rtol=1e-5)  # identical experts
    # a uniform router: f_e = P_e = 1/E, aux == 1
    flat = {"router": {"kernel": torch.zeros((d, E))}, "w1": torch.zeros((E, d, 2 * di)),
            "w2": torch.zeros((E, di, d))}
    _, aux = lm._moe_mlp(flat, dataclasses.replace(cfg, moe_top_k=1), x, torch.float32)
    assert abs(float(aux) - 1.0) <= 1e-6
    # a tiny capacity drops tokens: still finite, the router still learns
    small = dataclasses.replace(cfg, moe_capacity_factor=0.25)
    params = tree_map(lambda t: t.requires_grad_(),
                      lm.init_lm_params(small, torch.Generator().manual_seed(0)))
    ids = torch.from_numpy(_ids(5, (2, 32))).long()
    loss = lm.lm_loss(params, small, ids, torch.from_numpy(_ids(6, (2, 32))).long())
    loss.backward()
    assert torch.isfinite(loss) and params["blocks"]["moe"]["router"]["kernel"].grad.abs().max() > 0
    # the aux term reaches the loss (aux >= 1, weight 10)
    base = lm.init_lm_params(cfg, torch.Generator().manual_seed(0))
    l0, l1 = (float(lm.lm_loss(base, dataclasses.replace(cfg, moe_aux_weight=w), ids, ids))
              for w in (0.0, 10.0))
    assert l1 > l0 + 1.0
    # the decode step through the MoE equals the full forward
    ref = lm.lm_forward(base, cfg, ids[:, :17])
    _, state = lm.lm_prefill(base, cfg, ids[:, :16], max_len=17)
    step, _ = lm.lm_step(base, cfg, state, ids[:, 16])
    torch.testing.assert_close(step, ref[:, -1].float(), atol=2e-4, rtol=2e-3)
    # the parameter count of the JAX tree of the same config
    jcfg = JaxConfig(**MODELS["moe"])
    jp = jax.eval_shape(lambda k: jlm.init_lm_params(k, jcfg), jax.random.PRNGKey(0))
    assert lm.count_params(base) == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))


def test_generate_matches_jax_greedy():
    """Greedy ``generate()`` with an MLP and an untied head decodes the
    JAX ``generate()``'s tokens over the chunk step and one-shot."""
    jcfg, jparams, cfg, params = _pair(MODELS["mlp"], seed=7)
    for i, (t, bucketing) in enumerate(((20, True), (9, False))):
        p = _ids(40 + i, t).astype(np.int64)
        want = jax_generate(jparams, jcfg, jnp.asarray(p[None].astype(np.int32)),
                            jax.random.PRNGKey(0), max_new_tokens=8, top_k=1,
                            length_bucketing=bucketing)
        got = generate(params, cfg, torch.from_numpy(p)[None], max_new_tokens=8, top_k=1,
                       length_bucketing=bucketing)
        assert got[0].tolist() == np.asarray(want)[0].tolist()


def test_hybrid_7b_shaped_engine_matches_generate():
    """A tiny config of hybrid-7b's shape (a gated MLP after every mixer,
    attention with GQA rep 4, attention at layer 3 of 4) through the
    engine: with int8 weights every greedy stream equals ``generate()``'s
    and no page leaks; the int8 codes and scales of the MLP and the
    untied head equal the JAX package's."""
    kw = dict(BASE, n_layer=4, attn_layer_idx=(3,), attn_num_heads=8, attn_num_kv_heads=2,
              d_intermediate=48, tie_embeddings=False)
    jcfg, jparams, cfg, params = _pair(kw, seed=3)
    c = dataclasses.replace(cfg, serving_weight_dtype="int8")
    prompts = [_ids(50 + i, t).astype(np.int64) for i, t in enumerate((5, 37))]
    eng = ServingEngine(params, c, capacity=2, max_top_k=1, tokens_per_tick=4, device="cpu")
    res = eng.run([GenerationRequest(prompt_ids=p, max_new_tokens=5, top_k=1)
                   for p in prompts])
    for p, r in zip(prompts, res):
        want = generate(params, c, torch.from_numpy(p)[None], max_new_tokens=5, top_k=1,
                        decode_rows=2)
        assert r.new_tokens.tolist() == want[0, len(p):].tolist()
    assert eng.page_pool.pages_in_use == 0
    q, jq = (_flat(f(p, dataclasses.replace(c, serving_weight_dtype="int8")))
             for f, p, c in ((_decode_params, params, cfg),
                             (jax.jit(jax_decode_params, static_argnums=1), jparams, jcfg)))
    for k in ("blocks.mlp.fc1", "blocks.mlp.fc2", "attn_blocks.mlp.fc2", "lm_head"):
        assert q[f"{k}.kernel"].dtype == np.int8
        np.testing.assert_array_equal(q[f"{k}.kernel"], jq[f"{k}.kernel"], err_msg=k)
        np.testing.assert_allclose(q[f"{k}.scale"], jq[f"{k}.scale"], rtol=1e-6, err_msg=k)


def test_convert_decode_cast_and_keys():
    """The new keys round trip key for key; unknown keys still raise; the
    decode cast takes the MLP, the experts and the head to the compute
    dtype and keeps the router in fp32, as the JAX cast does."""
    for kind in ("moe", "mlp"):
        _, jparams, cfg, params = _pair(MODELS[kind])
        back = convert.params_to_numpy(params)
        want = _flat(jax.tree.map(np.asarray, jparams))
        assert set(_flat(back)) == set(want)
        for k, v in _flat(back).items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    tree = jax.tree.map(np.asarray, jparams)
    for bad in ({**tree, "bogus": {}},
                {**tree, "blocks": {**tree["blocks"], "mlp": {"fc1": 0}}},
                {**tree, "blocks": {k: v for k, v in tree["blocks"].items() if k != "norm2"}}):
        with pytest.raises(ValueError):
            convert.params_from_jax(bad)
    jcfg, jparams, cfg, params = _pair(dict(MODELS["moe"], tie_embeddings=False))
    bf = dict(compute_dtype="bfloat16")
    d = _flat(_decode_params(params, dataclasses.replace(cfg, **bf)), leaf=lambda v: v)
    j = _flat(jax_decode_params(jparams, dataclasses.replace(jcfg, **bf)))
    for k in ("lm_head.kernel", "blocks.mixer.in_proj.kernel"):
        assert d[k].dtype == torch.bfloat16 and j[k].dtype == jnp.bfloat16, k
    # routed in fp32 in both; the experts are cast at use (the same values)
    assert d["blocks.moe.router.kernel"].dtype == torch.float32
    assert j["blocks.moe.router.kernel"].dtype == np.float32
    assert d["blocks.moe.w1"].dtype == torch.bfloat16


def test_flops_config_and_hybrid_7b_preset_match_jax():
    """The MLP and MoE FLOPs of both conventions, the six new fields'
    validation and the ``hybrid-7b`` preset (model half, and the training
    half without its mesh) against the JAX package's."""
    for kw in (MODELS["mlp"], MODELS["moe"], dict(MODELS["moe"], moe_top_k=1)):
        for conv in ("hardware", "model"):
            assert flops.flops_per_token(ModelConfig(**kw), 64, convention=conv) == \
                jflops.flops_per_token(JaxConfig(**kw), 64, convention=conv)
    j, t = jax_get_preset("hybrid-7b"), get_train_preset("hybrid-7b")
    for f in ("d_model", "n_layer", "d_intermediate", "attn_layer_idx", "nheads",
              "effective_attn_num_heads", "effective_attn_num_kv_heads",
              "effective_attn_head_dim", "moe_num_experts", "tie_embeddings", "loss_impl"):
        assert getattr(t.model, f) == getattr(j.model, f), f
    assert (t.seq_len, t.micro_batch_size, t.total_batch_size) == (
        j.seq_len, j.micro_batch_size, j.total_batch_size)
    assert get_preset("hybrid-7b").d_intermediate == 14336
    for conv in ("hardware", "model"):
        assert flops.flops_per_token(t.model, 4096, convention=conv) == \
            jflops.flops_per_token(j.model, 4096, convention=conv)
    cases = [dict(d_intermediate=8, moe_num_experts=1), dict(moe_num_experts=4),
             dict(d_intermediate=8, moe_num_experts=4, moe_top_k=5),
             dict(d_intermediate=8, moe_num_experts=4, moe_top_k=0),
             dict(d_intermediate=8, moe_num_experts=4, moe_top_k=4, moe_capacity_factor=0.5,
                  moe_aux_weight=0.0),
             dict(loss_impl="blocked", loss_vocab_blocks=7), dict(loss_impl="blocked",
                                                                 loss_vocab_blocks=0),
             dict(loss_impl="blocked", loss_vocab_blocks=16), dict(loss_impl="sparse"),
             dict(loss_vocab_blocks=7), dict(remat_policy="dots"), dict(remat_policy="mixer"),
             dict(remat_policy="none"), dict(conv_impl="xla_conv"), dict(conv_impl="fft"),
             dict(tie_embeddings=False), dict(d_intermediate=64)]
    for kw in cases:
        kw = dict(d_model=32, n_layer=2, vocab_size=64, **kw)
        try:
            JaxConfig(**kw)
            jax_ok = True
        except ValueError:
            jax_ok = False
        if jax_ok:
            ModelConfig(**kw)
        else:
            with pytest.raises(ValueError):
                ModelConfig(**kw)
