"""The port's serving engine, on the CPU.

* Engine streams are bit-identical to the port's own solo
  ``generate(..., decode_rows=capacity)`` with sampling on, whatever
  shares the batch: one-shot and chunked prefills, admissions and
  evictions interleaved with ticks.
* Greedy streams are identical to the JAX ``ServingEngine`` on the same
  weights (fp32), over one-shot and chunked prompts.
* ``ServingEngine()`` without ``device="cpu"`` raises on a host with no
  card.
* Hybrid stacks (paged KV): the page allocator's refcounts and named
  errors; engine streams bit-identical to ``generate()`` with sampling
  on through admission mid-flight, a chunked long prompt, eviction and
  slot and page reuse, with no page leaked; admission waits while the
  pool is short and an over-budget request raises at ``submit``; greedy
  streams equal the JAX package's solo ``generate()``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_distributed_tpu.config import ModelConfig as JaxConfig
from mamba_distributed_tpu.inference import generate as jax_generate
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
from mamba_distributed_tpu_torch.serving.state_cache import PagePool, PagePoolError

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
    forced = plan_chunks(9, 16, force=True)
    assert (forced.n_chunks, forced.pad, forced.real_tokens(0)) == (1, 7, 9)
    assert [plan.real_tokens(i) for i in range(3)] == [8, 16, 16]
    assert plan_chunks(9, 0, force=True) is None


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


# ------------------------------------------------- hybrid paged-KV serving

def hybrid_cfg(**kw):
    """The hybrid config of tests/test_serving.py:426-434."""
    kw.setdefault("prefill_chunk_tokens", 16)
    kw.setdefault("prefill_tokens_per_tick", 16)
    return dict(d_model=32, n_layer=2, vocab_size=64, headdim=8, chunk_size=16,
                d_state=16, compute_dtype="float32", attn_layer_idx=(1,),
                attn_num_heads=4, attn_num_kv_heads=2, kv_page_tokens=8,
                kv_slot_tokens=64, **kw)


@pytest.fixture(scope="module")
def hybrid():
    cfg = ModelConfig(**hybrid_cfg())
    return cfg, init_lm_params(cfg, torch.Generator().manual_seed(1))


def test_page_pool_refcounts_and_named_errors():
    pool = PagePool(6)
    a = pool.alloc(2)
    b = pool.alloc(3)
    assert (a, b, pool.pages_in_use, pool.free_pages) == ([1, 2], [3, 4, 5], 5, 1)
    pool.incref([3])
    pool.free(b)
    assert pool.refcount(3) == 1 and pool.pages_in_use == 3
    pool.free([3])
    pool.free(a)
    assert pool.pages_in_use == 0 and pool.alloc(2) == [1, 2]
    with pytest.raises(PagePoolError, match="double free"):
        pool.free([4])
    with pytest.raises(PagePoolError, match="trash page"):
        pool.free([0])
    with pytest.raises(PagePoolError, match="outside"):
        pool.free([7])
    with pytest.raises(PagePoolError, match="not allocated"):
        pool.incref([5])
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc(5)
    with pytest.raises(ValueError, match="sharded"):
        PagePool(6, num_shards=2)


def test_hybrid_engine_matches_generate_with_sampling(hybrid):
    """The A/L/C scenario of tests/test_serving.py:443-473, sampling on:
    A decodes alone, L (53 tokens, 4 chunks) is admitted mid-flight, C
    waits for a slot and reuses A's slot and pages."""
    cfg, params = hybrid
    prompts = {"A": _prompt(2, 9), "L": _prompt(3, 53), "C": _prompt(4, 7)}
    budgets = {"A": 4, "L": 5, "C": 6}
    seeds = {"A": 40, "L": 41, "C": 42}

    def req(n):
        return GenerationRequest(prompt_ids=prompts[n], max_new_tokens=budgets[n],
                                 top_k=5, temperature=0.8, seed=seeds[n])

    eng = ServingEngine(params, cfg, capacity=2, max_top_k=5, tokens_per_tick=1,
                        device="cpu")
    ids = {"A": eng.submit(req("A"))}
    eng.step()
    ids["L"] = eng.submit(req("L"))
    eng.step()
    assert eng.page_pool.pages_in_use == 2 + 8  # A: 13 tokens, L: 58 tokens
    ids["C"] = eng.submit(req("C"))
    while eng.pending:
        eng.step()
    for n in "ALC":
        want = solo(params, cfg, prompts[n], 2, seed=seeds[n],
                    max_new_tokens=budgets[n], top_k=5, temperature=0.8)
        assert eng.results[ids[n]].new_tokens.tolist() == want, n
    assert eng.page_pool.pages_in_use == 0
    assert not eng._page_tbl.any() and not eng._kv_len.any()


def test_hybrid_admission_waits_for_pages(hybrid):
    """With a 5-page pool, requests needing 3 pages run one at a time
    although two slots are free; over-budget requests raise at submit."""
    _, params = hybrid
    cfg = ModelConfig(**hybrid_cfg(kv_pool_pages=5))
    eng = ServingEngine(params, cfg, capacity=2, max_top_k=1, tokens_per_tick=2,
                        device="cpu")
    reqs = [GenerationRequest(prompt_ids=_prompt(20 + i, 14), max_new_tokens=6, top_k=1)
            for i in range(3)]
    ids = [eng.submit(r) for r in reqs]
    eng.step()
    assert len(eng._slots) == 1 and eng.scheduler.depth == 2
    assert eng.page_pool.pages_in_use == 3
    while eng.pending:
        eng.step()
        assert eng.page_pool.pages_in_use <= 5
    for r, i in zip(reqs, ids):
        assert eng.results[i].new_tokens.tolist() == solo(
            params, cfg, r.prompt_ids, 2, seed=0, max_new_tokens=6, top_k=1)
    assert eng.page_pool.pages_in_use == 0
    with pytest.raises(ValueError, match="kv_slot_tokens"):
        eng.submit(GenerationRequest(prompt_ids=_prompt(1, 60), max_new_tokens=5, top_k=1))
    with pytest.raises(ValueError, match="could never be admitted"):
        eng.submit(GenerationRequest(prompt_ids=_prompt(1, 40), max_new_tokens=5, top_k=1))


def test_hybrid_generate_requires_chunk_step(hybrid):
    cfg, params = hybrid
    with pytest.raises(ValueError, match="chunk step"):
        generate(params, cfg, torch.zeros((1, 4), dtype=torch.long), length_bucketing=False)
    with pytest.raises(ValueError, match="max_len"):
        chunked_prefill(cast_decode_params(params, cfg), cfg, torch.zeros((1, 4)), max_len=2)


def test_hybrid_greedy_streams_match_jax_engine():
    """Same weights, greedy: the port's hybrid engine emits, for a
    one-chunk, a two-chunk and a four-chunk prompt sharing its slots, the
    tokens of the JAX package's solo ``generate()`` on each prompt (its
    chunked prefill and decode scan are the JAX hybrid engine's own
    computation, and reproducible from run to run, where the JAX
    engine's greedy streams are not under the CPU backend's
    asynchronous dispatch)."""
    kw = hybrid_cfg()
    jcfg = JaxConfig(**kw, remat=False)
    jparams = jax_init(jax.random.PRNGKey(5), jcfg)
    cfg = ModelConfig(**kw)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    prompts = [_prompt(30 + i, t) for i, t in enumerate((5, 20, 50))]
    eng = ServingEngine(params, cfg, capacity=2, max_top_k=1, tokens_per_tick=4,
                        device="cpu")
    res = eng.run([GenerationRequest(prompt_ids=p, max_new_tokens=9, top_k=1)
                   for p in prompts])
    for p, r in zip(prompts, res):
        want = jax_generate(jparams, jcfg, jnp.asarray(p[None].astype(np.int32)),
                            jax.random.PRNGKey(0), max_new_tokens=9, top_k=1)
        assert r.new_tokens.tolist() == np.asarray(want)[0, len(p):].tolist()
    assert eng.page_pool.pages_in_use == 0
