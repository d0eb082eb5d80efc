"""The port's prefix-state cache and copy-on-write KV pages, on the CPU.

* The key scheme gives the JAX package's digests byte for byte; the LRU
  (entry and byte caps), ``min_hits`` promotion and the lookup and commit
  counters follow JAX ``PrefixCache`` op for op; ``PagePool`` sharing and
  its named errors follow JAX ``PagePool``; ``copy_page`` equals JAX
  ``state_cache.copy_page`` on the same numpy pages (int8 scales too).
* Warm streams are bit-identical to cold ``generate()`` (fp32, sampling
  on) for mamba2, mamba1, hybrid and int8 hybrid stacks; full hits run no
  prefill; a shared-preamble partial hit runs only the suffix chunk, and
  on a hybrid it copies the partial boundary page, with every page that
  has more than one holder unchanged while the sharer runs.
* Concurrent sharers own disjoint pages; cache pins give way under
  admission pressure; a request waiting for pages does not count its
  lookup each step; pages in use equal the cache's pins, 0 after
  ``clear()``.
* ``generate(prefix_cache=)`` reuses its own and an engine's entries,
  greedy streams equal to the JAX package's solo ``generate()``.
* Tick and request records carry the prefix gauges and outcome (absent
  with the cache off), and the port's report gives the JAX
  ``scripts/obs_report.py`` numbers on the same stream.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_distributed_tpu.config import ModelConfig as JaxConfig
from mamba_distributed_tpu.inference import generate as jax_generate
from mamba_distributed_tpu.models import init_lm_params as jax_init
from mamba_distributed_tpu.serving import prefix_cache as jpc
from mamba_distributed_tpu.serving import state_cache as jsc
from mamba_distributed_tpu.serving.prefill import plan_chunks as jax_plan_chunks
from mamba_distributed_tpu_torch import convert
from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.inference.generate import generate
from mamba_distributed_tpu_torch.models.lm import init_lm_params
from mamba_distributed_tpu_torch.obs import load_jsonl
from mamba_distributed_tpu_torch.obs.report import build_report
from mamba_distributed_tpu_torch.serving import GenerationRequest, ServingEngine
from mamba_distributed_tpu_torch.serving import prefix_cache as tpc
from mamba_distributed_tpu_torch.serving import state_cache
from mamba_distributed_tpu_torch.serving.prefill import plan_chunks
from mamba_distributed_tpu_torch.serving.state_cache import PagePool, PagePoolError
from mamba_distributed_tpu_torch.utils.metrics import ServingMetrics

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
from obs_report import build_report as jax_build_report  # noqa: E402

pytestmark = pytest.mark.torch

CHUNK = 16
TINY = dict(d_model=32, n_layer=2, vocab_size=64, headdim=8, chunk_size=16, d_state=16,
            compute_dtype="float32", prefill_chunk_tokens=CHUNK,
            prefill_tokens_per_tick=CHUNK)
HYBRID = dict(TINY, attn_layer_idx=(1,), attn_num_heads=4, attn_num_kv_heads=2,
              kv_page_tokens=8, kv_slot_tokens=96)
LAYERS = {
    "mamba2": TINY,
    "mamba1": dict(TINY, ssm_layer="mamba1"),
    "hybrid": HYBRID,
    "int8": dict(HYBRID, kv_page_dtype="int8", serving_weight_dtype="int8"),
}


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, kw in LAYERS.items():
        cfg = ModelConfig(**kw, prefix_cache_entries=64)
        out[name] = (cfg, init_lm_params(cfg, torch.Generator().manual_seed(0)))
    return out


def _prompt(seed, t):
    return np.random.default_rng(seed).integers(0, 64, t).astype(np.int64)


def _cold(params, cfg, prompt, seed, new, rows):
    """The cold stream: solo ``generate()`` at the engine's row count."""
    cold_cfg = dataclasses.replace(cfg, prefix_cache_entries=0)
    out = generate(params, cold_cfg, torch.from_numpy(prompt)[None], seed=seed,
                   max_new_tokens=new, top_k=5, decode_rows=rows)
    return out[0, len(prompt):].tolist()


def _engine(params, cfg, capacity=2, **kw):
    return ServingEngine(params, cfg, capacity=capacity, max_top_k=5, tokens_per_tick=2,
                         device="cpu", **kw)


def _req(prompt, seed, new=5, **kw):
    return GenerationRequest(prompt_ids=prompt.copy(), max_new_tokens=new, top_k=5,
                             seed=seed, **kw)


def _pinned(eng) -> set:
    return {p for e in eng.prefix_cache._entries.values() for p in (e.kv_pages or ())}


def _page_bytes(eng, page: int) -> list:
    return [t[:, page].clone() for t in eng.pool["state"]["attn_blocks"]]


# ---------------------------------------------------- keys, LRU, pages


@pytest.mark.parametrize("t", [9, 40, 48, 77])
def test_keys_equal_jax_digests(t):
    ids = _prompt(t, t)
    plan, jplan = plan_chunks(t, CHUNK, force=True), jax_plan_chunks(t, CHUNK, force=True)
    for salt in (b"", b"tenant"):
        assert tpc.layout_keys(ids, plan, salt) == jpc.layout_keys(ids.astype(np.int32), jplan,
                                                                    salt)
        assert tpc.full_key(ids, CHUNK, salt) == jpc.full_key(ids, CHUNK, salt)
        assert tpc.oneshot_key(ids, salt) == jpc.oneshot_key(ids, salt)
        for i in range(plan.n_chunks):
            assert tpc.boundary_key(ids, plan, i, salt) == jpc.boundary_key(ids, jplan, i, salt)


def _drive_cache(mod, max_entries, max_bytes, min_hits):
    """One script of puts, gets, misses, lookups and commits; returns
    what an observer sees of the cache."""
    evicted = []
    pc = mod.PrefixCache(max_entries=max_entries, max_bytes=max_bytes, min_hits=min_hits,
                         evict_hook=lambda e: evicted.append(e.tokens))
    ids = _prompt(3, 40)
    plan = (plan_chunks if mod is tpc else jax_plan_chunks)(40, CHUNK)
    seen = []
    for step in range(3):
        seen.append((pc.lookup(ids, plan, peek=True) is None, pc.wants(f"k{step}")))
        pc.commit_lookup(ids, plan, None)
        bkeys, fkey = mod.layout_keys(ids, plan)
        for i, key in enumerate(bkeys + [fkey]):
            if pc.wants(key):
                pc.put(key, mod.PrefixEntry(state={}, tokens=10 * i + step, chunks=i + 1,
                                            nbytes=100 + 10 * i, kv_pages=(i,) if i else None))
        pc.note_miss(f"k{step}")
    hit = pc.lookup(ids, plan)
    pc.get(bkeys[0])
    for i in range(5):
        if pc.wants(f"x{i}"):
            pc.put(f"x{i}", mod.PrefixEntry(state={}, tokens=100 + i, chunks=1, nbytes=120))
    pinned = pc.evict_one_pinned()
    return (seen, None if hit is None else (hit[0].tokens, hit[1]), evicted, pinned,
            list(pc._entries), pc.nbytes, pc.hits, pc.misses, pc.saved_tokens, pc.evictions,
            dict(pc._seen))


@pytest.mark.parametrize("caps", [(4, 0, 1), (10, 350, 1), (6, 0, 2)])
def test_lru_caps_and_promotion_follow_jax(caps):
    """Entry cap, byte cap (one oversized entry kept) and ``min_hits``
    promotion: the port's cache evicts, promotes and counts as JAX's."""
    assert _drive_cache(tpc, *caps) == _drive_cache(jpc, *caps)
    big = tpc.PrefixCache(max_entries=10, max_bytes=50)
    big.put("big", tpc.PrefixEntry(state={}, tokens=1, chunks=1, nbytes=500))
    assert len(big) == 1
    with pytest.raises(KeyError, match="already cached"):
        big.put("big", tpc.PrefixEntry(state={}, tokens=1, chunks=1, nbytes=5))
    st = {"blocks": (torch.zeros(2, 1, 3), torch.zeros(2, 1, 4, dtype=torch.bfloat16))}
    assert tpc.state_nbytes(st) == 2 * 3 * 4 + 2 * 4 * 2


def test_page_pool_sharing_and_errors_follow_jax():
    ours, ref = PagePool(8), jsc.PagePool(8)
    for pool in (ours, ref):
        a = pool.alloc(3)
        pool.incref(a[:2])
        pool.free(a)
        pool.incref([a[0]])
    assert [ours.refcount(p) for p in range(9)] == [ref.refcount(p) for p in range(9)]
    assert (ours.pages_in_use, ours.free_pages) == (ref.pages_in_use, ref.free_pages) == (2, 6)
    for pool, err in ((ours, PagePoolError), (ref, jsc.PagePoolError)):
        pool.free([1, 1])
        assert pool.refcount(1) == 0 and pool.pages_in_use == 1
        with pytest.raises(err, match="double free"):
            pool.free([1])
    with pytest.raises(PagePoolError, match="trash page"):
        ours.free([0])
    with pytest.raises(PagePoolError, match="outside the pool"):
        ours.free([99])
    with pytest.raises(PagePoolError, match="not allocated"):
        ours.incref([5])


@pytest.mark.parametrize("int8", [False, True])
def test_copy_page_matches_jax(int8):
    rng = np.random.default_rng(7)
    leaves = [rng.standard_normal((2, 6, 2, 8, 4)).astype(np.float32) for _ in range(2)]
    if int8:
        leaves = [(x * 20).astype(np.int8) for x in leaves]
        leaves += [rng.uniform(0.1, 2, (2, 6, 2)).astype(np.float32) for _ in range(2)]
    want = jsc.copy_page(tuple(jnp.asarray(x) for x in leaves), 4, 2)
    ours = tuple(torch.from_numpy(x.copy()) for x in leaves)
    assert state_cache.copy_page(ours, 4, 2) is ours
    for a, b in zip(ours, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------- warm vs cold


@pytest.mark.parametrize("layer", list(LAYERS))
def test_warm_streams_bit_identical_to_cold(models, layer):
    """A mixed workload twice on one cache-enabled engine: every stream
    of both runs equals cold ``generate()``; the second run's full hits
    run no chunk step and no prefill; at the end the pages in use are
    the cache's pins, and 0 after ``clear()``."""
    cfg, params = models[layer]
    prompts = [_prompt(2, 9), _prompt(3, 3 * CHUNK + 5), _prompt(4, 7)]
    eng = _engine(params, cfg)

    def run_once():
        return [r.new_tokens.tolist() for r in
                eng.run([_req(p, 40 + i, 4 + i) for i, p in enumerate(prompts)])]

    first = run_once()
    chunks0, prefills0 = eng.metrics.prefill_chunks, eng.metrics.prefills
    second = run_once()
    assert (eng.metrics.prefill_chunks, eng.metrics.prefills) == (chunks0, prefills0)
    assert eng.metrics.prefix_full_hits == len(prompts)
    for i, p in enumerate(prompts):
        want = _cold(params, cfg, p, 40 + i, 4 + i, rows=2)
        assert first[i] == want and second[i] == want, (layer, i)
    if eng.hybrid:
        assert eng.page_pool.pages_in_use == len(_pinned(eng)) > 0
        eng.prefix_cache.clear()
        assert eng.page_pool.pages_in_use == 0


@pytest.mark.parametrize("layer", ["mamba2", "hybrid", "int8"])
def test_shared_preamble_partial_hit_and_cow(models, layer):
    """Two prompts of one length sharing a 35-token preamble (the
    boundary after chunk 3 ends 3 tokens into a page): the second seeds
    the cached carry, runs only its suffix chunk and, on a hybrid, copies
    the boundary page; every page with more than one holder keeps its
    bytes while it runs; both streams equal cold ``generate()``."""
    cfg, params = models[layer]
    pre = _prompt(5, 2 * CHUNK + 3)
    sa = np.concatenate([pre, _prompt(6, CHUNK)])
    sb = np.concatenate([pre, _prompt(7, CHUNK)])
    eng = _engine(params, cfg)
    assert eng.prefix_hit_fraction(sb) == 0.0
    ra = eng.run([_req(sa, 50)])[0]
    # a probe: the preamble's 35 tokens of 51 are cached; nothing counted
    lookups = (eng.prefix_cache.hits, eng.prefix_cache.misses)
    assert eng.prefix_hit_fraction(sb) == 35 / 51 and eng.prefix_hit_fraction(sa) == 1.0
    assert (eng.prefix_cache.hits, eng.prefix_cache.misses) == lookups
    chunks0 = eng.metrics.prefill_chunks
    rid = eng.submit(_req(sb, 51))
    frozen = {}
    while eng.pending:
        if eng.hybrid:
            shared = [p for p in range(1, eng.page_pool.num_pages + 1)
                      if eng.page_pool.refcount(p) > 1 or p in _pinned(eng)]
            for p in shared:
                frozen.setdefault(p, _page_bytes(eng, p))
        eng.step()
    assert eng.metrics.prefill_chunks - chunks0 == 1
    assert eng.metrics.prefix_partial_hits == 1
    assert eng.cow_copies == (1 if eng.hybrid else 0)
    for p, before in frozen.items():
        if p in _pinned(eng):
            for a, b in zip(_page_bytes(eng, p), before):
                assert torch.equal(a, b), f"shared page {p} was written"
    assert ra.new_tokens.tolist() == _cold(params, cfg, sa, 50, 5, rows=2)
    assert eng.results[rid].new_tokens.tolist() == _cold(params, cfg, sb, 51, 5, rows=2)


def test_concurrent_sharers_disjoint_writes(models):
    """Two slots on one cached prefix at once: their owned (refcount 1)
    pages never overlap and both streams equal cold ``generate()``."""
    cfg, params = models["hybrid"]
    prompt = _prompt(31, 43)
    eng = _engine(params, cfg)
    eng.run([_req(prompt, 90, 4)])
    ra, rb = eng.submit(_req(prompt, 91, 6)), eng.submit(_req(prompt, 92, 6))
    eng.step()
    owned = [{p for p in t.pages if eng.page_pool.refcount(p) == 1}
             for t in eng._slots.values()]
    assert len(owned) == 2 and owned[0] and not owned[0] & owned[1]
    while eng.pending:
        eng.step()
    assert eng.cow_copies == 2
    for rid, seed in ((ra, 91), (rb, 92)):
        assert eng.results[rid].new_tokens.tolist() == _cold(params, cfg, prompt, seed, 6, 2)


def test_cache_pins_released_under_admission_pressure(models):
    """A warm cache pinning most of a 12-page pool must not starve
    admission: page-pinning entries are evicted until the request fits."""
    cfg, params = models["hybrid"]
    cfg = dataclasses.replace(cfg, kv_pool_pages=12)
    eng = _engine(params, cfg)
    eng.run([_req(_prompt(80, 40), 160, 4)])
    assert eng.page_pool.pages_in_use > 0
    pb = _prompt(81, 60)
    rid = eng.submit(_req(pb, 161, 4))
    for _ in range(100):
        eng.step()
        if not eng.pending:
            break
    assert not eng.pending and eng.prefix_cache.evictions > 0
    assert eng.results[rid].new_tokens.tolist() == _cold(params, cfg, pb, 161, 4, 2)
    assert eng.page_pool.pages_in_use == len(_pinned(eng))


def test_stalled_admission_does_not_drift_stats(models):
    """A request retrying its admission every step (waiting for pages)
    counts its lookup once, when it is admitted."""
    cfg, params = models["hybrid"]
    cfg = dataclasses.replace(cfg, kv_pool_pages=8)
    eng = ServingEngine(params, cfg, capacity=2, max_top_k=5, tokens_per_tick=1,
                        device="cpu")
    r1 = eng.submit(_req(_prompt(82, 40), 170, 8))
    eng.step()
    r2 = eng.submit(_req(_prompt(83, 30), 171, 4))
    eng.step()
    misses0 = eng.prefix_cache.misses
    eng.step()
    eng.step()
    assert eng.prefix_cache.misses == misses0 == 1
    while eng.pending:
        eng.step()
    assert {r1, r2} <= set(eng.results)
    assert eng.prefix_cache.misses == 2


def test_byte_capped_cache_churns_and_stays_exact(models):
    cfg, params = models["mamba2"]
    cfg = dataclasses.replace(cfg, prefix_cache_bytes=40_000)
    eng = _engine(params, cfg)
    for i in range(5):
        p = _prompt(20 + i, 2 * CHUNK + i)
        assert eng.run([_req(p, 70 + i, 3)])[0].new_tokens.tolist() == \
            _cold(params, cfg, p, 70 + i, 3, 2)
    assert eng.prefix_cache.nbytes <= 40_000 and eng.prefix_cache.evictions > 0


def test_min_hits_promotion_in_the_engine(models):
    cfg, params = models["mamba2"]
    eng = _engine(params, dataclasses.replace(cfg, prefix_min_chunk_hits=2))
    p = _prompt(71, 2 * CHUNK + 1)
    eng.run([_req(p, 130, 3)])
    assert len(eng.prefix_cache) == 0
    eng.run([_req(p, 130, 3)])
    assert len(eng.prefix_cache) > 0 and eng.metrics.prefix_full_hits == 0
    eng.run([_req(p, 130, 3)])
    assert eng.metrics.prefix_full_hits == 1


# --------------------------------------------------------- generate()


def test_generate_prefix_cache_reuse():
    """``generate(prefix_cache=)`` warms its own cache and hits on
    repeats; an engine-warmed cache serves it too (one-shot and chunked
    entries); greedy streams equal the JAX package's solo ``generate()``."""
    jcfg = JaxConfig(**TINY)
    jparams = jax_init(jax.random.PRNGKey(3), jcfg)
    cfg = ModelConfig(**TINY, prefix_cache_entries=32)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    long, short = _prompt(72, 2 * CHUNK + 5), _prompt(73, 9)

    def solo(p, pc=None):
        out = generate(params, cfg, torch.from_numpy(p)[None], max_new_tokens=6, top_k=1,
                       decode_rows=2, prefix_cache=pc)
        return out[0, len(p):].tolist()

    want = {len(p): np.asarray(jax_generate(
        jparams, jcfg, jnp.asarray(p[None].astype(np.int32)), jax.random.PRNGKey(0),
        max_new_tokens=6, top_k=1))[0, len(p):].tolist() for p in (long, short)}
    pc = tpc.PrefixCache(max_entries=32)
    assert solo(long) == want[len(long)]
    assert solo(long, pc) == want[len(long)] and len(pc) > 0
    hits0 = pc.hits
    assert solo(long, pc) == want[len(long)] and pc.hits == hits0 + 1
    eng = ServingEngine(params, cfg, capacity=2, max_top_k=1, tokens_per_tick=2, device="cpu")
    eng.run([GenerationRequest(prompt_ids=p, max_new_tokens=6, top_k=1) for p in (short, long)])
    ehits0 = eng.prefix_cache.hits
    assert solo(short, eng.prefix_cache) == want[len(short)]
    assert solo(long, eng.prefix_cache) == want[len(long)]
    assert eng.prefix_cache.hits == ehits0 + 2


# ---------------------------------------------------------- telemetry


def test_records_carry_prefix_gauges_and_report_matches_jax(models, tmp_path):
    cfg, params = models["mamba2"]
    path = tmp_path / "pc.jsonl"
    metrics = ServingMetrics(2, jsonl_path=str(path))
    eng = _engine(params, cfg, metrics=metrics)
    for _ in range(2):
        eng.run([_req(_prompt(70, 9), 120, 3)])
    lines = load_jsonl(str(path))
    ticks = [r for r in lines if r["kind"] == "serving_tick"]
    assert all("prefix_hits" in t and "prefix_cache_bytes" in t for t in ticks)
    assert (sum(t["prefix_hits"] for t in ticks), sum(t["prefix_misses"] for t in ticks),
            sum(t["prefix_saved_tokens"] for t in ticks)) == (1, 1, 9)
    assert [r["prefix_hit"] for r in lines if r["kind"] == "request"] == [None, "full"]
    s = metrics.summary()["prefix_cache"]
    assert (s["full_hits"], s["hit_rate"], s["saved_prefill_tokens"]) == (1, 0.5, 9)
    assert s["ttft_hit_ms"]["count"] == s["ttft_miss_ms"]["count"] == 1
    ours, ref = build_report(lines), jax_build_report(lines)
    assert ours["serving"]["prefix_cache"] == ref["serving"]["prefix_cache"]
    assert ours["serving"]["prefix_cache"]["hits"] == 1
    for key in ("ttft_hit_ms", "ttft_miss_ms"):
        assert ours["requests"][key] == ref["requests"][key]
    # cache off: no prefix field anywhere, the summary's section None
    off = tmp_path / "off.jsonl"
    m2 = ServingMetrics(2, jsonl_path=str(off))
    _engine(params, dataclasses.replace(cfg, prefix_cache_entries=0), metrics=m2).run(
        [_req(_prompt(70, 9), 120, 3)])
    for ln in off.read_text().splitlines():
        assert not any(k.startswith("prefix") for k in json.loads(ln))
    assert m2.summary()["prefix_cache"] is None
    assert "ttft_hit_ms" not in build_report(load_jsonl(str(off)))["requests"]
