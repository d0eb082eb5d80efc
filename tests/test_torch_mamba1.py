"""The port's Mamba-1 path against the JAX package's, on the CPU in fp32.

One parameter tree is built with the JAX ``init_lm_params`` and carried
across by ``convert.params_from_jax``; both packages run it on the same
numpy inputs, at 1e-4 unless a line says otherwise:

* ``mamba1_mixer`` (token mask, seeded conv and SSM states,
  ``return_final_state``) and ``mamba1_mixer_step``, with ``ssm_impl``
  "xla" and "pallas" (the selective-scan Function through its plain
  kernel versions on a CPU tensor);
* ``lm_loss`` and every gradient leaf (remat on and off, both impls);
  ``lm_prefill`` over a pow2 bucket, ``lm_prefill_chunk`` and
  ``lm_step``; a Mamba-1 hybrid (attention at layer 1) in loss,
  gradients, chunks and steps;
* the tree round trip, the decay mask leaf for leaf, ``count_params``
  against ``ModelConfig.num_params``, the port's own init;
* serving: a ``ServingEngine`` stream equals the port's solo
  ``generate()`` over a mix of one-shot and chunked prompts, and
  ``generate()`` equals the JAX ``generate()`` greedy, token for token;
* training: an accum-2 train step with "pallas" equals "xla" and the
  JAX step's loss and gradients; ``Trainer`` runs two finite steps;
* the ``mamba1-280m`` presets and ``flops_per_token`` equal the JAX
  package's, and invalid Mamba-1 configs raise where the JAX one does.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_distributed_tpu.config import ModelConfig as JaxConfig
from mamba_distributed_tpu.config import get_preset as jax_get_preset
from mamba_distributed_tpu.inference import generate as jax_generate
from mamba_distributed_tpu.inference.bucketing import pad_to_bucket as jax_pad
from mamba_distributed_tpu.models import lm as jlm
from mamba_distributed_tpu.models.mamba1 import init_mamba1_params as jax_init_mixer
from mamba_distributed_tpu.models.mamba1 import mamba1_mixer as jax_mixer
from mamba_distributed_tpu.models.mamba1 import mamba1_mixer_step as jax_mixer_step
from mamba_distributed_tpu.training import optimizer as jopt
from mamba_distributed_tpu.utils import flops as jflops
from mamba_distributed_tpu_torch import convert
from mamba_distributed_tpu_torch.config import (
    DataConfig,
    ModelConfig,
    get_preset,
    get_train_preset,
)
from mamba_distributed_tpu_torch.inference.bucketing import pad_to_bucket
from mamba_distributed_tpu_torch.inference.generate import generate
from mamba_distributed_tpu_torch.models import lm
from mamba_distributed_tpu_torch.models.mamba1 import mamba1_mixer, mamba1_mixer_step
from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
from mamba_distributed_tpu_torch.serving import GenerationRequest, ServingEngine
from mamba_distributed_tpu_torch.training import Trainer
from mamba_distributed_tpu_torch.training.optimizer import decay_mask, tree_map
from mamba_distributed_tpu_torch.training.train_step import loss_and_grads
from mamba_distributed_tpu_torch.utils import flops

pytestmark = pytest.mark.torch

TOL = dict(atol=1e-4, rtol=1e-4)
# a tiny Mamba-1 LM: d_inner 64, d_state 8, dt_rank 2
TINY = dict(d_model=32, n_layer=2, vocab_size=64, ssm_layer="mamba1", d_state=8,
            compute_dtype="float32", prefill_chunk_tokens=16)
HYBRID = dict(TINY, attn_layer_idx=(1,), attn_num_heads=4, attn_num_kv_heads=2,
              kv_page_tokens=8, kv_slot_tokens=64)


def _pair(kw, seed=0):
    jcfg = JaxConfig(**kw, remat=False)
    jparams = jlm.init_lm_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jparams, ModelConfig(**kw), convert.params_from_jax(
        jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def pair():
    return _pair(TINY)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), **tol)


def _rel(got, ref):
    ref = _np(ref)
    return float(np.abs(_np(got) - ref).max() / max(np.abs(ref).max(), 1e-30))


def _ids(seed, *shape):
    return np.random.default_rng(seed).integers(0, 64, shape).astype(np.int32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: _np(tree)}


# ------------------------------------------------------------------- mixer


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("masked,seeded", [(False, False), (True, True), (False, True)])
def test_mixer_matches_jax(pair, impl, masked, seeded):
    jcfg, jparams, cfg, params = pair
    cfg = dataclasses.replace(cfg, ssm_impl=impl)
    rng = np.random.default_rng(1)
    u = rng.standard_normal((2, 21, 32)).astype(np.float32)
    mask = np.ones((2, 21), np.float32)
    if masked:
        mask[0, :6] = 0.0
    conv0 = rng.standard_normal((2, 3, 64)).astype(np.float32)
    ssm0 = rng.standard_normal((2, 64, 8)).astype(np.float32)
    jb = jax.tree.map(lambda a: a[0], jparams["blocks"]["mixer"])
    tb = jax.tree.map(lambda a: a[0], params["blocks"]["mixer"])
    kw_j = dict(return_final_state=True, token_mask=jnp.asarray(mask) if masked else None)
    kw_t = dict(return_final_state=True, token_mask=torch.from_numpy(mask) if masked else None)
    if seeded:
        kw_j.update(initial_conv_state=jnp.asarray(conv0), initial_ssm_state=jnp.asarray(ssm0))
        kw_t.update(initial_conv_state=torch.from_numpy(conv0),
                    initial_ssm_state=torch.from_numpy(ssm0))
    yj, (cj, sj) = jax_mixer(jb, jcfg, jnp.asarray(u), **kw_j)
    yt, (ct, st) = mamba1_mixer(tb, cfg, torch.from_numpy(u), **kw_t)
    _close(yt, yj)
    _close(ct, cj)
    _close(st, sj)
    if not seeded:  # the training form: no state in, none out
        _close(mamba1_mixer(tb, cfg, torch.from_numpy(u)), jax_mixer(jb, jcfg, jnp.asarray(u)))


def test_mixer_step_matches_jax(pair):
    """Three decode steps from random states, updated in place."""
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(2)
    cj = jnp.asarray(rng.standard_normal((3, 3, 64)).astype(np.float32))
    sj = jnp.asarray(rng.standard_normal((3, 64, 8)).astype(np.float32))
    ct, st = torch.from_numpy(np.array(cj)), torch.from_numpy(np.array(sj))
    jb = jax.tree.map(lambda a: a[1], jparams["blocks"]["mixer"])
    tb = jax.tree.map(lambda a: a[1], params["blocks"]["mixer"])
    for i in range(3):
        u = rng.standard_normal((3, 32)).astype(np.float32)
        yj, (cj, sj) = jax_mixer_step(jb, jcfg, jnp.asarray(u), cj, sj)
        yt, (c2, s2) = mamba1_mixer_step(tb, cfg, torch.from_numpy(u), ct, st)
        assert c2 is ct and s2 is st
        _close(yt, yj)
        _close(ct, cj)
        _close(st, sj)


# ---------------------------------------------------------------------- LM


@pytest.fixture(scope="module")
def jax_loss_grads(pair):
    jcfg, jparams, _, _ = pair
    x, y = _ids(1, 2, 24), _ids(2, 2, 24)
    loss, grads = jax.value_and_grad(jlm.lm_loss)(jparams, jcfg, jnp.asarray(x), jnp.asarray(y))
    return x, y, float(loss), _flat(grads)


def _loss_grads(params, cfg, x, y):
    p = tree_map(lambda t: t.clone().requires_grad_(), params)
    loss = lm.lm_loss(p, cfg, torch.from_numpy(x).long(), torch.from_numpy(y).long())
    loss.backward()
    return loss.item(), _flat(tree_map(lambda t: t.grad, p))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_lm_loss_and_grads_match_jax(pair, jax_loss_grads, remat, impl):
    _, _, cfg, params = pair
    x, y, jloss, jgrads = jax_loss_grads
    loss, grads = _loss_grads(params, dataclasses.replace(cfg, remat=remat, ssm_impl=impl),
                              x, y)
    assert abs(loss - jloss) <= 1e-4 * abs(jloss)
    assert set(grads) == set(jgrads)
    for k in jgrads:
        assert _rel(grads[k], jgrads[k]) <= 1e-4, k


@pytest.mark.parametrize("t", [5, 16, 27])
def test_lm_prefill_and_steps_match_jax(pair, t):
    """Left-padded bucketed prefill, then three decode steps: logits and
    every layer's conv and SSM state."""
    jcfg, jparams, cfg, params = pair
    ids = _ids(t, 2, t)
    bucket = 32 if t > 16 else 16
    pj, mj = jax_pad(jnp.asarray(ids), bucket)
    pt, mt = pad_to_bucket(torch.from_numpy(ids).long(), bucket)
    lj, sj = jlm.lm_prefill(jparams, jcfg, pj, token_mask=mj)
    lt, st = lm.lm_prefill(params, cfg, pt, token_mask=mt)
    _close(lt, lj)
    assert st["blocks"][1].shape == (2, 2, 64, 8)  # (L, b, d_inner, n)
    for a, b in zip(st["blocks"], sj["blocks"]):
        _close(a, b)
    for i in range(3):
        tok = _ids(20 + i, 2)
        lj, sj = jlm.lm_step(jparams, jcfg, sj, jnp.asarray(tok))
        lt, st = lm.lm_step(params, cfg, st, torch.from_numpy(tok).long())
        _close(lt, lj)
        for a, b in zip(st["blocks"], sj["blocks"]):
            _close(a, b)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_lm_prefill_chunk_matches_jax(pair, impl):
    """A seeded chunk with a left pad in one row: the scan from the
    carried state with its final state, "pallas" through the Function."""
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(5)
    conv0 = rng.standard_normal((2, 2, 3, 64)).astype(np.float32)
    ssm0 = rng.standard_normal((2, 2, 64, 8)).astype(np.float32) * 0.1
    ids = _ids(9, 2, 16)
    mask = np.ones((2, 16), np.float32)
    mask[1, :4] = 0.0
    lj, sj = jlm.lm_prefill_chunk(jparams, jcfg, jnp.asarray(ids),
                                  {"blocks": (jnp.asarray(conv0), jnp.asarray(ssm0))},
                                  token_mask=jnp.asarray(mask))
    state = {"blocks": (torch.from_numpy(conv0), torch.from_numpy(ssm0))}
    lt, st = lm.lm_prefill_chunk(params, dataclasses.replace(cfg, ssm_impl=impl),
                                 torch.from_numpy(ids).long(), state,
                                 token_mask=torch.from_numpy(mask))
    _close(lt, lj)
    for a, b in zip(st["blocks"], sj["blocks"]):
        _close(a, b)
    np.testing.assert_array_equal(state["blocks"][1].numpy(), ssm0)  # input untouched


def test_params_round_trip_mask_and_count(pair):
    jcfg, jparams, cfg, params = pair
    back = convert.params_to_numpy(params)
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat_j) == len(jax.tree.leaves(back))
    for path, leaf in flat_j:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    mixer = params["blocks"]["mixer"]
    assert set(mixer) == {"in_proj", "conv", "x_proj", "dt_proj", "A_log", "D", "out_proj"}
    assert mixer["A_log"].shape == (2, 64, 8) and mixer["dt_proj"]["kernel"].shape == (2, 2, 64)
    jm = {k: bool(v) for k, v in _flat(jopt.decay_mask(jparams)).items()}
    assert {k: bool(v) for k, v in _flat(decay_mask(params)).items()} == jm
    assert jm["blocks.mixer.A_log"] and jm["blocks.mixer.dt_proj.kernel"]
    assert not jm["blocks.mixer.dt_proj.bias"] and not jm["blocks.mixer.D"]
    assert lm.count_params(params) == jcfg.num_params()
    big = get_preset("mamba1-280m")
    assert lm.count_params(lm.init_lm_params(dataclasses.replace(big, n_layer=1),
                                             torch.Generator().manual_seed(0))) == \
        dataclasses.replace(jax_get_preset("mamba1-280m").model, n_layer=1).num_params()


@pytest.mark.parametrize("dt_init", ["random", "constant"])
def test_port_init_matches_jax_shapes_and_scale(dt_init):
    """The port's own init (a torch.Generator) builds the JAX tree's keys
    and shapes, A_log and D exactly, and the dt_proj and dt bias ranges."""
    jcfg = JaxConfig(**TINY, dt_init=dt_init)
    cfg = ModelConfig(**TINY, dt_init=dt_init)
    ref = _flat(jlm.init_lm_params(jax.random.PRNGKey(0), jcfg))
    mine = _flat(lm.init_lm_params(cfg, torch.Generator().manual_seed(0)))
    assert {k: v.shape for k, v in mine.items()} == {k: v.shape for k, v in ref.items()}
    for k in ("blocks.mixer.A_log", "blocks.mixer.D"):
        np.testing.assert_allclose(mine[k], ref[k], rtol=1e-6, atol=0)
    w = mine["blocks.mixer.dt_proj.kernel"]
    bound = cfg.effective_dt_rank ** -0.5 * cfg.dt_scale
    if dt_init == "constant":
        np.testing.assert_allclose(w, ref["blocks.mixer.dt_proj.kernel"], rtol=1e-6)
    else:
        assert np.abs(w).max() <= bound and np.abs(w).max() > 0.5 * bound
    dt = np.log1p(np.exp(mine["blocks.mixer.dt_proj.bias"]))  # softplus(bias)
    assert dt.min() >= cfg.dt_init_floor * 0.999 and dt.max() <= cfg.dt_max * 1.001
    for k in ref:
        if "kernel" in k:
            assert np.abs(mine[k]).max() <= 1.5 * np.abs(ref[k]).max(), k


# -------------------------------------------------------------- hybrid stack


@pytest.fixture(scope="module")
def hybrid_pair():
    return _pair(HYBRID, seed=1)


def test_hybrid_loss_grads_chunks_and_steps_match_jax(hybrid_pair):
    """A Mamba-1 hybrid (attention at layer 1 of 2): loss and gradients
    ("pallas" on both mixers), two prefill chunks with a left pad, then
    three decode steps with a partial write mask."""
    jcfg, jparams, cfg, params = hybrid_pair
    x, y = _ids(30, 2, 24), _ids(31, 2, 24)
    jloss, jgrads = jax.value_and_grad(jlm.lm_loss)(jparams, jcfg, jnp.asarray(x),
                                                     jnp.asarray(y))
    loss, grads = _loss_grads(params, dataclasses.replace(cfg, ssm_impl="pallas",
                                                          attn_impl="pallas"), x, y)
    assert abs(loss - float(jloss)) <= 1e-4 * abs(float(jloss))
    jgrads = _flat(jgrads)
    assert set(grads) == set(jgrads)
    for k in jgrads:
        assert _rel(grads[k], jgrads[k]) <= 1e-4, k

    b, c = 2, 16
    sj = jlm.init_lm_state(jcfg, b, max_len=48)
    st = lm.init_lm_state(cfg, b, max_len=48)
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
    for i, wm in enumerate(([True, False], [True, True], [False, True])):
        tok = _ids(50 + i, b)
        lj, sj = jlm.lm_step(jparams, jcfg, sj, jnp.asarray(tok), write_mask=jnp.asarray(wm))
        lt, st = lm.lm_step(params, cfg, st, torch.from_numpy(tok).long(),
                            write_mask=torch.tensor(wm))
        _close(lt, lj)
        for a, b_ in zip(st["blocks"], sj["blocks"]):
            _close(a, b_)
        for a, b_ in zip(st["attn_blocks"], sj["attn_blocks"]):
            _close(a[:, 1:], np.asarray(b_)[:, 1:])  # page 0 is the trash page
    assert st["attn_meta"][1].tolist() == [34, 29]


# ------------------------------------------------------------------ serving


def _prompt(seed, t):
    return np.random.default_rng(seed).integers(0, 64, t).astype(np.int64)


def test_engine_matches_generate_over_one_shot_and_chunked_prompts(pair):
    """Four sampled requests through a 2-slot engine: prompts of 5 and 12
    tokens take the one-shot bucketed prefill, 40 and 70 the chunked one
    (chunk 16, seeded from the carried state); every stream equals the
    solo generate() at the engine's row count."""
    _, _, cfg, params = pair
    assert cfg.effective_prefill_chunk_tokens == 16  # no SSD chunk rounding
    spec = [(5, 9), (40, 6), (12, 7), (70, 5)]
    reqs = [GenerationRequest(prompt_ids=_prompt(i, t), max_new_tokens=n, top_k=5,
                              temperature=0.8, seed=100 + i)
            for i, (t, n) in enumerate(spec)]
    eng = ServingEngine(params, cfg, capacity=2, max_top_k=5, tokens_per_tick=2,
                        prefill_tokens_per_tick=16, device="cpu")
    for r, res in zip(reqs, eng.run(reqs)):
        out = generate(params, cfg, torch.from_numpy(r.prompt_ids)[None], seed=r.seed,
                       max_new_tokens=r.max_new_tokens, top_k=5, temperature=0.8,
                       decode_rows=2)
        assert res.new_tokens.tolist() == out[0, len(r.prompt_ids):].tolist()
    assert eng.pending == 0


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_generate_matches_jax_greedy(pair, impl):
    """Greedy generate() equals the JAX generate() token for token, for a
    one-shot (9 tokens) and a chunked (40 tokens) prompt."""
    jcfg, jparams, cfg, params = pair
    jcfg = dataclasses.replace(jcfg, prefill_chunk_tokens=16)
    for i, t in enumerate((9, 40)):
        p = _prompt(60 + i, t)
        want = jax_generate(jparams, jcfg, jnp.asarray(p[None].astype(np.int32)),
                            jax.random.PRNGKey(0), max_new_tokens=10, top_k=1)
        got = generate(params, dataclasses.replace(cfg, ssm_impl=impl),
                       torch.from_numpy(p)[None], max_new_tokens=10, top_k=1)
        assert got[0].tolist() == np.asarray(want)[0].tolist()


# ----------------------------------------------------------------- training


def test_train_step_accum2_pallas_matches_xla_and_jax(pair):
    """One accum-2 step's loss and gradients: "pallas" (the Function's
    plain kernel versions) against "xla" (autograd of the chunked scan),
    both against the JAX gradients averaged over the two micro-batches."""
    jcfg, jparams, cfg, params = pair
    x, y = _ids(3, 2, 2, 24), _ids(4, 2, 2, 24)
    g = [jax.value_and_grad(jlm.lm_loss)(jparams, jcfg, jnp.asarray(x[i]), jnp.asarray(y[i]))
         for i in range(2)]
    jloss = (float(g[0][0]) + float(g[1][0])) / 2
    jgrads = _flat(jax.tree.map(lambda a, b: (a + b) / 2, g[0][1], g[1][1]))
    res = {}
    for impl in ("pallas", "xla"):
        tcfg = get_train_preset("mamba1-280m", model=dataclasses.replace(cfg, ssm_impl=impl),
                                micro_batch_size=2, seq_len=24, total_batch_size=96)
        assert tcfg.grad_accum_steps == 2
        before = dict(LAUNCHES)
        p = tree_map(lambda t: t.clone().requires_grad_(), params)
        loss, grads = loss_and_grads(p, tcfg, torch.from_numpy(x).long(),
                                     torch.from_numpy(y).long())
        assert LAUNCHES == before
        res[impl] = (float(loss), _flat(grads))
    for impl in ("pallas", "xla"):
        assert abs(res[impl][0] - jloss) <= 1e-4 * abs(jloss)
        for k in jgrads:
            assert _rel(res[impl][1][k], jgrads[k]) <= 1e-4, (impl, k)
    for k in jgrads:
        assert _rel(res["pallas"][1][k], res["xla"][1][k]) <= 1e-4, k


def test_trainer_runs_two_finite_steps(tmp_path):
    cfg = get_train_preset(
        "mamba1-280m", model=ModelConfig(**dict(TINY, ssm_impl="pallas")),
        micro_batch_size=2, seq_len=32, total_batch_size=64, warmup_steps=2, val_every=1,
        val_steps=1, log_dir=os.path.join(str(tmp_path), "log"),
        data=DataConfig(data_dir=os.path.join(str(tmp_path), "data"),
                        synthetic_tokens_per_shard=20_000))
    trainer = Trainer(cfg, device="cpu", verbose=False).run(max_steps=2)
    trainer.finish()
    hist = [trainer.history[s] for s in range(2)]
    assert all(np.isfinite(v) for h in hist for v in h), hist


# -------------------------------------------------------- config and flops


def test_presets_flops_and_invalid_configs_match_jax():
    j, t = jax_get_preset("mamba1-280m"), get_train_preset("mamba1-280m")
    for f in dataclasses.fields(ModelConfig):
        assert getattr(t.model, f.name) == getattr(j.model, f.name), f.name
    for f in dataclasses.fields(t):
        if f.name not in ("model", "mesh", "data", "telemetry"):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert dataclasses.asdict(t.telemetry) == dataclasses.asdict(j.telemetry)
    m = t.model
    assert (m.d_inner, m.effective_d_state, m.effective_dt_rank, m.d_conv,
            m.effective_prefill_chunk_tokens) == (1536, 16, 48, 4, 256)
    assert get_preset("mamba1-280m") == m
    for conv in ("hardware", "model"):
        for seq in (1024, 256):
            assert flops.flops_per_token(m, seq, convention=conv) == \
                jflops.flops_per_token(j.model, seq, convention=conv)
            assert flops.flops_per_token(m, seq, training=False, convention=conv) == \
                jflops.flops_per_token(j.model, seq, training=False, convention=conv)
    # a bad dt_init: the JAX package raises at init, the port at construction
    with pytest.raises(ValueError):
        jax_init_mixer(jax.random.PRNGKey(0), JaxConfig(**TINY, dt_init="uniform"))
    with pytest.raises(ValueError, match="dt_init"):
        ModelConfig(**TINY, dt_init="uniform")
    # an unknown mixer: the JAX package raises building the params
    with pytest.raises(ValueError):
        jlm.init_lm_params(jax.random.PRNGKey(0), JaxConfig(**dict(TINY, ssm_layer="mamba3")))
    with pytest.raises(ValueError, match="mamba1"):
        ModelConfig(**dict(TINY, ssm_layer="mamba3"))
    # the Mamba-2-only checks do not apply to Mamba-1 (as in JAX)
    assert ModelConfig(**TINY, headdim=48, ngroups=5).ssm_layer == "mamba1"
    JaxConfig(**TINY, headdim=48, ngroups=5)
