"""The port's serving engine, on the CPU.

* Engine streams are bit-identical to the port's own solo
  ``generate(..., decode_rows=capacity)`` with sampling on, whatever
  shares the batch: one-shot and chunked prefills, admissions and
  evictions interleaved with ticks.
* Greedy streams are identical to the JAX ``ServingEngine`` on the same
  weights (fp32), over one-shot and chunked prompts.
* ``ServingEngine()`` without ``device="cpu"`` raises on a host with no
  card.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mamba_distributed_tpu.config import ModelConfig as JaxConfig
from mamba_distributed_tpu.models import init_lm_params as jax_init
from mamba_distributed_tpu.serving import GenerationRequest as JaxRequest
from mamba_distributed_tpu.serving import ServingEngine as JaxEngine
from mamba_distributed_tpu_torch import convert
from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.inference.generate import generate
from mamba_distributed_tpu_torch.models.lm import init_lm_params, lm_prefill
from mamba_distributed_tpu_torch.serving import GenerationRequest, ServingEngine
from mamba_distributed_tpu_torch.serving import state_cache
from mamba_distributed_tpu_torch.serving.prefill import (
    cast_decode_params,
    chunk_inputs,
    chunked_prefill,
    plan_chunks,
)

pytestmark = pytest.mark.torch

TINY = dict(d_model=32, n_layer=2, vocab_size=64, headdim=8, chunk_size=16,
            d_state=16, compute_dtype="float32", prefill_chunk_tokens=16)


@pytest.fixture(scope="module")
def setup():
    cfg = ModelConfig(**TINY)
    return cfg, init_lm_params(cfg, torch.Generator().manual_seed(0))


def _prompt(seed, t):
    return np.random.default_rng(seed).integers(0, 64, t).astype(np.int64)


def solo(params, cfg, prompt, rows, **kw):
    out = generate(params, cfg, torch.from_numpy(prompt)[None], decode_rows=rows, **kw)
    return out[0, len(prompt):].tolist()


def test_chunk_plan_and_inputs():
    plan = plan_chunks(40, 16)
    assert (plan.bucket, plan.n_chunks, plan.pad) == (48, 3, 8)
    assert plan_chunks(16, 16) is None and plan_chunks(40, 0) is None
    prompt = np.arange(1, 41)
    ids, mask = chunk_inputs(prompt, plan, 0)
    assert ids[0, :8].tolist() == [0] * 8 and ids[0, 8:].tolist() == list(range(1, 9))
    assert mask[0].tolist() == [0.0] * 8 + [1.0] * 8
    ids2, _ = chunk_inputs(prompt, plan, 2)
    assert ids2[0].tolist() == list(range(25, 41))


def test_pool_insert_stash_evict(setup):
    cfg, params = setup
    pool = state_cache.init_pool(cfg, capacity=3)
    st = {"blocks": tuple(torch.full_like(t[:, :1], 2.0) for t in pool["state"]["blocks"])}
    logits = torch.ones((1, cfg.vocab_size_padded))
    state_cache.insert(pool, 1, st, logits, max_new=5, top_k=7, temperature=0.5, eos_id=3)
    meta = pool["meta"]
    assert meta["active"].tolist() == [False, True, False]
    assert int(meta["top_k"][1]) == 7 and int(meta["eos_id"][1]) == 3
    for t in pool["state"]["blocks"]:
        assert bool((t[:, 1] == 2).all()) and not t[:, 0].any() and not t[:, 2].any()
    state_cache.stash_prefill(pool, 2, st, max_new=4, top_k=1, temperature=1.0, eos_id=-1)
    assert meta["prefilling"].tolist() == [False, False, True]
    back = state_cache.read_state(pool, 2)
    back["blocks"][1].zero_()  # a copy: the pool keeps its carry
    assert bool((pool["state"]["blocks"][1][:, 2] == 2).all())
    state_cache.finish_prefill(pool, 2, st, logits)
    state_cache.evict(pool, 1)
    assert meta["active"].tolist() == [False, False, True]
    assert meta["prefilling"].tolist() == [False, False, False]


def test_engine_matches_generate_with_sampling(setup):
    """Seven sampled requests through a 3-slot engine (short one-shot and
    long chunked prompts, different budgets, an EOS stop), so slots free
    and refill between ticks; every stream equals its solo generate()."""
    cfg, params = setup
    spec = [(5, 9, None), (40, 6, None), (12, 3, None), (70, 7, None),
            (3, 11, 17), (33, 5, None), (16, 8, None)]
    reqs = [GenerationRequest(prompt_ids=_prompt(i, t), max_new_tokens=n, top_k=5,
                              temperature=0.8, eos_id=eos, seed=100 + i)
            for i, (t, n, eos) in enumerate(spec)]
    eng = ServingEngine(params, cfg, capacity=3, max_top_k=5, tokens_per_tick=2,
                        prefill_tokens_per_tick=16, device="cpu")
    results = eng.run(reqs)
    assert eng.pending == 0 and sorted(eng._free) == [0, 1, 2]
    for i, (r, res) in enumerate(zip(reqs, results)):
        ref = solo(params, cfg, r.prompt_ids, 3, seed=r.seed, max_new_tokens=r.max_new_tokens,
                   top_k=5, temperature=0.8, eos_id=r.eos_id)
        if r.eos_id is not None and r.eos_id in ref:
            ref = ref[:ref.index(r.eos_id) + 1]
            assert res.finish_reason == "eos"
        else:
            assert res.finish_reason == "length"
        assert res.new_tokens.tolist() == ref, i


def test_engine_stream_independent_of_batch(setup):
    """One request's stream is the same alone and among strangers."""
    cfg, params = setup
    target = GenerationRequest(prompt_ids=_prompt(1, 20), max_new_tokens=10, top_k=4,
                               temperature=1.0, seed=9)

    def run(extra):
        eng = ServingEngine(params, cfg, capacity=4, max_top_k=4, tokens_per_tick=3,
                            device="cpu")
        others = [GenerationRequest(prompt_ids=_prompt(50 + i, 7 + 9 * i),
                                    max_new_tokens=4 + i, top_k=4, seed=i)
                  for i in range(extra)]
        res = eng.run(others[:1] + [dataclasses.replace(target)] + others[1:])
        return res[min(1, extra)].new_tokens.tolist()

    assert run(0) == run(3)


def test_chunked_prefill_matches_one_shot(setup):
    """Chunked and one-shot prefill of one prompt agree up to summation order."""
    cfg, params = setup
    prompt = torch.from_numpy(_prompt(4, 48))[None]
    dparams = cast_decode_params(params, cfg)
    lc, sc = chunked_prefill(dparams, cfg, prompt)
    lo, so = lm_prefill(dparams, cfg, prompt)
    torch.testing.assert_close(lc, lo, atol=1e-4, rtol=1e-4)
    for a, b in zip(sc["blocks"], so["blocks"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_greedy_streams_match_jax_engine():
    """Same weights, greedy: the port's engine emits the JAX engine's
    tokens for one-shot (5, 12 tokens) and chunked (40 tokens) prompts."""
    jcfg = JaxConfig(**TINY)
    jparams = jax_init(jax.random.PRNGKey(3), jcfg)
    cfg = ModelConfig(**TINY)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    prompts = [_prompt(10 + i, t) for i, t in enumerate((5, 12, 40))]
    jeng = JaxEngine(jparams, jcfg, capacity=2, max_top_k=1, tokens_per_tick=4)
    jres = jeng.run([JaxRequest(prompt_ids=p.astype(np.int32), max_new_tokens=16,
                                top_k=1) for p in prompts])
    eng = ServingEngine(params, cfg, capacity=2, max_top_k=1, tokens_per_tick=4,
                        device="cpu")
    res = eng.run([GenerationRequest(prompt_ids=p, max_new_tokens=16, top_k=1)
                   for p in prompts])
    for a, b in zip(res, jres):
        assert a.new_tokens.tolist() == np.asarray(b.new_tokens).tolist()


def test_engine_defaults_to_the_card(setup):
    cfg, params = setup
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(params, cfg)


def test_submit_validation(setup):
    cfg, params = setup
    eng = ServingEngine(params, cfg, capacity=2, max_top_k=3, device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        eng.submit(GenerationRequest(prompt_ids=np.array([1, 2]), top_k=4))
    with pytest.raises(ValueError, match="prompt"):
        eng.submit(GenerationRequest(prompt_ids=np.array([], np.int64), top_k=1))
    with pytest.raises(ValueError, match="max_top_k"):
        ServingEngine(params, cfg, max_top_k=0, device="cpu")
