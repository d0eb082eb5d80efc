"""The port's multi-tenant LoRA serving against the JAX package, on the CPU.

* The registry derives the same targets, validation, versions and merged
  weights as JAX's; ``register_random`` draws JAX's factors; the ``.npz``
  adapter file written by either package reads in the other.
* ``AdapterCache``: the same acquire/release sequence gives the same
  rows and hit, miss and eviction counts, and the same named errors.
* ``linear`` with a bound LoRA delta (mixed ids, row 0 among them) is
  within 1e-4 of JAX's ``linear``.
* Engine streams of a heterogeneous batch (two adapters and none, short
  and chunked prompts) equal JAX ``generate()`` on the merged weights,
  greedy, fp32, for mamba2, mamba1 and hybrid stacks; also across prefix
  hits (keys carry the adapter), preemption, speculation at K = 2,
  compacted ticks, a cache that waits, the tenant quota and a hot swap.
* A no-adapter stream on a LoRA engine is bit-identical to a LoRA-less
  engine's; LoRA off adds no record field and no summary section.
* A/B routing picks JAX's arms; the quota check and the tick-record,
  summary and report fields are JAX's.
"""

import dataclasses
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_distributed_tpu.config import ModelConfig as JaxConfig
from mamba_distributed_tpu.inference import generate as jax_generate
from mamba_distributed_tpu.models import init_lm_params as jax_init_params
from mamba_distributed_tpu.models.common import linear as jax_linear
from mamba_distributed_tpu.serving import adapters as jad
from mamba_distributed_tpu.serving.engine import ServingEngine as JaxEngine
from mamba_distributed_tpu.serving.scheduler import GenerationRequest as JaxRequest
from mamba_distributed_tpu.serving.scheduler import check_tenant_quota as jax_quota
from mamba_distributed_tpu.utils.metrics import ServingMetrics as JaxMetrics
from mamba_distributed_tpu_torch import convert
from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.models.common import linear
from mamba_distributed_tpu_torch.obs import load_jsonl
from mamba_distributed_tpu_torch.obs.report import build_report
from mamba_distributed_tpu_torch.serving import GenerationRequest, ServingEngine
from mamba_distributed_tpu_torch.serving import adapters as ad
from mamba_distributed_tpu_torch.serving.scheduler import (
    TenantQuotaExceeded,
    check_tenant_quota,
)
from mamba_distributed_tpu_torch.utils.metrics import ServingMetrics

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
from obs_report import build_report as jax_build_report  # noqa: E402

pytestmark = pytest.mark.torch

CHUNK = 16
SHORT, LONG = 9, 2 * CHUNK + 5  # one JAX trace per prompt length
# register_random's factor scale: at this size the default 0.05 leaves
# most greedy streams unchanged, which would make the parity vacuous
SCALE = 0.5
TINY = dict(d_model=32, n_layer=2, vocab_size=64, headdim=8, chunk_size=16, d_state=16,
            compute_dtype="float32", prefill_chunk_tokens=CHUNK,
            prefill_tokens_per_tick=CHUNK, lora_max_adapters=4, lora_rank=4,
            lora_alpha=8.0)
KINDS = {
    "mamba2": dict(TINY),
    "mamba1": dict(TINY, ssm_layer="mamba1"),
    "hybrid": dict(TINY, attn_layer_idx=(1,), attn_num_heads=4, attn_num_kv_heads=2,
                   kv_page_tokens=8, kv_slot_tokens=64),
}


@pytest.fixture(scope="module")
def models():
    """kind -> (port cfg, JAX cfg, port params, JAX params): one seeded
    JAX init, converted key for key."""
    out = {}
    for kind, kw in KINDS.items():
        jcfg = JaxConfig(**kw)
        jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
        out[kind] = (ModelConfig(**kw), jcfg,
                     convert.params_from_jax(jax.tree.map(np.asarray, jparams)), jparams)
    return out


def _registries(cfg, jcfg, params, jparams, names=("alice", "bob")):
    reg, jreg = ad.AdapterRegistry(cfg, params), jad.AdapterRegistry(jcfg, jparams)
    for i, name in enumerate(names):
        reg.register_random(name, seed=10 + i, scale=SCALE)
        jreg.register_random(name, seed=10 + i, scale=SCALE)
    return reg, jreg


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 64, n).astype(np.int64)


def _want(jparams, jreg, jcfg, name, prompt, new):
    """The reference: JAX greedy generate() on the merged weights."""
    out = jax_generate(jad.merge_adapter_params(jparams, jreg, name), jcfg,
                       jnp.asarray(prompt, jnp.int32)[None], jax.random.PRNGKey(0),
                       max_new_tokens=new, top_k=1)
    return np.asarray(out)[0, len(prompt):].tolist()


def _tenant_requests(names=("alice", "bob", None), new=4):
    """One short and one chunked long prompt per adapter, greedy."""
    reqs = []
    for i, name in enumerate(names):
        reqs.append(GenerationRequest(prompt_ids=_prompt(10 + i, SHORT), max_new_tokens=new,
                                      top_k=1, seed=100 + i, adapter=name))
        reqs.append(GenerationRequest(prompt_ids=_prompt(50 + i, LONG), max_new_tokens=new,
                                      top_k=1, seed=200 + i, adapter=name))
    return reqs


def _engine(params, cfg, reg=None, capacity=6, **kw):
    kw.setdefault("tokens_per_tick", 2)
    return ServingEngine(params, cfg, capacity=capacity, max_top_k=1, device="cpu",
                         adapters=reg, **kw)


def _assert_parity(jparams, jreg, jcfg, requests, results):
    for r, res in zip(requests, results):
        want = _want(jparams, jreg, jcfg, r.adapter, r.prompt_ids, r.max_new_tokens)
        assert res.new_tokens.tolist() == want, f"adapter={r.adapter}"


# ------------------------------------------------------------- registry


@pytest.mark.parametrize("kind", list(KINDS))
def test_registry_targets_versions_and_merge_match_jax(models, kind):
    """Targets, registered names, version resolution, register_random's
    factors and the merged kernels are JAX's; both refuse the same bad
    registrations."""
    cfg, jcfg, params, jparams = models[kind]
    reg, jreg = _registries(cfg, jcfg, params, jparams)
    assert dict(reg.targets) == {k: tuple(v) for k, v in jreg.targets.items()}
    if kind == "mamba1":
        assert "blocks/mixer/x_proj" in reg.targets
    if kind == "hybrid":
        assert "attn_blocks/mixer/wqkv" in reg.targets
    for name in ("alice", "bob"):
        for path, fac in reg.factors(name).items():
            for part in ("A", "B"):
                np.testing.assert_array_equal(fac[part], jreg.factors(name)[path][part])
    for r in (reg, jreg):
        with pytest.raises(ValueError, match="unknown target"):
            r.register("x", {"blocks/mixer/nope": {"A": np.zeros(1), "B": np.zeros(1)}})
        with pytest.raises(ValueError, match="A shape"):
            path, (n, d_in, d_out) = next(iter(r.targets.items()))
            r.register("x", {path: {"A": np.zeros((n, d_in, 3)), "B": np.zeros((n, 3, d_out))}})
        r.register_random("alice", seed=3)  # alice@v2
        r.register_random("carol@v3", seed=4, targets=[next(iter(r.targets))])
    assert reg.names() == jreg.names()
    for q in ("alice", "alice@v1", "alice@v2", "carol", "carol@v3", "zed@v2", "x@y"):
        assert reg.resolve(q) == jreg.resolve(q)
        assert reg.version_of(q) == jreg.version_of(q)
    assert reg.latest("alice@v1") == jreg.latest("alice") == "alice@v2"
    for r, err in ((reg, ad), (jreg, jad)):
        with pytest.raises(err.AdapterVersionError, match="roll it back"):
            r.register_random("alice@v1")
        with pytest.raises(err.UnknownAdapterError):
            r.factors("zelda")
        with pytest.raises(ValueError, match="registry full"):
            r.register_random("dave")
    for name in ("alice@v2", "carol@v3"):
        merged, jmerged = reg.merge(params, name), jreg.merge(jparams, name)
        for path in reg.targets:
            keys = path.split("/")
            got, want = merged, jmerged
            for k in keys:
                got, want = got[k], want[k]
            np.testing.assert_array_equal(got["kernel"].numpy(), np.asarray(want["kernel"]))
    assert ad.merge_adapter_params(params, reg, None) is params


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_adapter_file_reads_across_packages(models, tmp_path, writer):
    """The ``.npz`` one package writes, the other reads, and both
    register the same scaled factors from it."""
    cfg, jcfg, params, jparams = models["mamba2"]
    reg, jreg = ad.AdapterRegistry(cfg, params), jad.AdapterRegistry(jcfg, jparams)
    rng = np.random.default_rng(0)
    factors = {path: {"A": rng.normal(size=(n, d_in, cfg.lora_rank)),
                      "B": rng.normal(size=(n, cfg.lora_rank, d_out))}
               for path, (n, d_in, d_out) in reg.targets.items()}
    path = str(tmp_path / "alice.npz")
    (ad if writer == "port" else jad).save_adapter_file(path, factors)
    loaded = (jad if writer == "port" else ad).load_adapter_file(path)
    assert set(loaded) == set(factors)
    reg.register("alice", ad.load_adapter_file(path))
    jreg.register("alice", loaded)
    for tpath in factors:
        for part in ("A", "B"):
            np.testing.assert_array_equal(reg.factors("alice")[tpath][part],
                                          jreg.factors("alice")[tpath][part])
    with pytest.raises(ValueError, match="missing A or B"):
        np.savez(str(tmp_path / "bad.npz"), **{"blocks/mixer/in_proj::A": np.zeros(1)})
        ad.load_adapter_file(str(tmp_path / "bad.npz"))


# ----------------------------------------------------------------- cache


def test_adapter_cache_matches_jax(models):
    """One acquire/release sequence on both caches: the same rows, hit,
    miss and eviction counts, residents, named errors and pool rows."""
    cfg, jcfg, params, jparams = models["hybrid"]
    reg, jreg = _registries(cfg, jcfg, params, jparams, names=("a", "b", "c"))
    reg.register_random("d", seed=3, targets=["attn_blocks/mixer/wqkv"])
    jreg.register_random("d", seed=3, targets=["attn_blocks/mixer/wqkv"])
    cache = ad.AdapterCache(reg, 2, compute_dtype=torch.float32)
    jcache = jad.AdapterCache(jreg, 2, compute_dtype=jnp.float32)
    ops = [("acq", "a"), ("acq", "b"), ("acq", "c"), ("rel", "a"), ("acq", "c"),
           ("acq", "b"), ("rel", "b"), ("rel", "b"), ("rel", "b"), ("rel", "a"),
           ("acq", "zelda"), ("rel", "c"), ("acq", "d"), ("acq", "b")]
    for op, name in ops:
        outs = []
        for c, errs in ((cache, ad), (jcache, jad)):
            try:
                outs.append(c.acquire(name) if op == "acq" else c.release(name))
            except errs.AdapterCacheError:
                outs.append("cache-error")
            except errs.UnknownAdapterError:
                outs.append("unknown")
            outs.append((c.hits, c.misses, c.evictions, c.resident_names(),
                         [c.refcount(n) for n in "abcd"]))
        assert outs[:2] == outs[2:], (op, name)
    # "d" covers wqkv only: its row elsewhere holds the zeros the
    # upload wrote over the evicted tenant's factors; row 0 stays zero
    for path, pool in cache.pools.items():
        for part in ("A", "B"):
            np.testing.assert_array_equal(pool[part].numpy(),
                                          np.asarray(jcache.pools[path][part]))
            assert not pool[part][:, 0].any()
    assert cache.version == jcache.version
    assert cache.nbytes_per_adapter == sum(
        (n * d_in * 4 + n * 4 * d_out) * 4 for n, d_in, d_out in reg.targets.values())


# ---------------------------------------------------------------- linear


@pytest.mark.parametrize("case", ["decode", "chunk", "bias"])
def test_lora_linear_matches_jax(case):
    """``linear`` with bound pools and mixed row ids (0 among them)
    against JAX's, fp32 at 1e-4; an id-0 row equals the plain product."""
    rng = np.random.default_rng(1)
    b, d_in, d_out, r, n_pool = 4, 24, 40, 4, 3
    shape = (b, d_in) if case == "decode" else (b, 5, d_in)
    x = rng.normal(size=shape).astype(np.float32)
    p = {"kernel": rng.normal(size=(d_in, d_out)).astype(np.float32) / 5}
    if case == "bias":
        p["bias"] = rng.normal(size=(d_out,)).astype(np.float32)
    A = rng.normal(size=(n_pool, d_in, r)).astype(np.float32)
    B = rng.normal(size=(n_pool, r, d_out)).astype(np.float32)
    A[0], B[0] = 0.0, 0.0
    ids = np.array([2, 0, 1, 2], np.int32)
    lora = {"A": A, "B": B, "ids": ids}
    want = np.asarray(jax_linear({**{k: jnp.asarray(v) for k, v in p.items()},
                                  "lora": {k: jnp.asarray(v) for k, v in lora.items()}},
                                 jnp.asarray(x), jnp.float32))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = linear({**tp, "lora": {k: torch.from_numpy(v) for k, v in lora.items()}},
                 torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    plain = linear(tp, torch.from_numpy(x), torch.float32)
    assert torch.equal(got[1], plain[1])
    # pools attached but no ids bound: the plain product
    assert torch.equal(linear({**tp, "lora": {"A": torch.from_numpy(A),
                                              "B": torch.from_numpy(B)}},
                              torch.from_numpy(x), torch.float32), plain)


# ------------------------------------------------------- engine parity


@pytest.mark.parametrize("kind", list(KINDS))
def test_hetero_batch_streams_match_jax_merged_generate(models, kind):
    """Two adapters and no adapter share the engine's launches (short
    and chunked long prompts): every stream equals JAX greedy generate()
    on its merged weights.  Tick records carry the adapter gauges and
    request records the adapter name."""
    cfg, jcfg, params, jparams = models[kind]
    reg, jreg = _registries(cfg, jcfg, params, jparams)
    eng = _engine(params, cfg, reg)
    reqs = _tenant_requests()
    results = eng.run(reqs)
    _assert_parity(jparams, jreg, jcfg, reqs, results)
    # the adapters move the streams: each differs from the base model's
    for r, res in zip(reqs[:4], results):
        assert res.new_tokens.tolist() != _want(jparams, jreg, jcfg, None, r.prompt_ids,
                                                r.max_new_tokens)
    s = eng.metrics.summary()["adapters"]
    assert (s["resident"], s["cache_misses"]) == (2, 2)
    # a hybrid prefills every prompt chunk by chunk, so its streams
    # decode at different times
    assert s["peak_live"] == (1 if kind == "hybrid" else 2)
    assert all(eng.adapter_cache.refcount(n) == 0 for n in ("alice", "bob"))
    assert eng.adapter_resident("alice") and not eng.adapter_resident("carol")
    if kind == "hybrid":
        assert eng.page_pool.free_pages == eng.page_pool.num_pages


def test_prefix_keys_carry_the_adapter(models):
    """The same chunked prompt under alice, then bob, then alice: bob
    never seeds from alice's entries (its stream is merged-bob's) and
    alice's repeat is a full hit equal to the cold stream."""
    cfg, jcfg, params, jparams = models["mamba2"]
    cfg = dataclasses.replace(cfg, prefix_cache_entries=32)
    reg, jreg = _registries(cfg, jcfg, params, jparams)
    eng = _engine(params, cfg, reg, capacity=2)
    prompt = _prompt(7, LONG)

    def run(name):
        r = GenerationRequest(prompt_ids=prompt.copy(), max_new_tokens=4, top_k=1,
                              adapter=name)
        return eng.run([r])[0].new_tokens.tolist()

    first = run("alice")
    assert first == _want(jparams, jreg, jcfg, "alice", prompt, 4)
    assert eng.prefix_hit_fraction(prompt, adapter="alice") == 1.0
    assert eng.prefix_hit_fraction(prompt, adapter="bob") == 0.0
    assert run("bob") == _want(jparams, jreg, jcfg, "bob", prompt, 4)
    assert eng.metrics.prefix_full_hits == 0
    assert run("alice") == first
    assert eng.metrics.prefix_full_hits == 1


def test_preempt_resume_keeps_the_adapter(models):
    """A higher-priority bob request preempts an alice stream mid-decode;
    the resumed stream goes on under alice with no second upload."""
    cfg, jcfg, params, jparams = models["mamba2"]
    reg, jreg = _registries(cfg, jcfg, params, jparams)
    eng = _engine(params, cfg, reg, capacity=1, tokens_per_tick=1)
    low = GenerationRequest(prompt_ids=_prompt(1, SHORT), max_new_tokens=8, top_k=1,
                            adapter="alice", priority=0)
    high = GenerationRequest(prompt_ids=_prompt(2, SHORT), max_new_tokens=3, top_k=1,
                             adapter="bob", priority=5)
    eng.submit(low)
    for _ in range(3):
        eng.step()
    eng.submit(high)
    while eng.pending:
        eng.step()
    assert eng.metrics.preemptions == 1
    assert eng.adapter_cache.misses == 2
    _assert_parity(jparams, jreg, jcfg, [low, high],
                   [eng.results[low.request_id], eng.results[high.request_id]])


def test_spec_decode_streams_match_jax(models):
    """K = 2 speculation on a LoRA engine: the verify binds the same
    rows, and the streams equal JAX plain greedy generate() on the merged
    weights."""
    cfg, jcfg, params, jparams = models["mamba2"]
    cfg = dataclasses.replace(cfg, spec_tokens=2)
    reg, jreg = _registries(cfg, jcfg, params, jparams)
    eng = _engine(params, cfg, reg, capacity=3)
    reqs = [GenerationRequest(prompt_ids=_prompt(i, SHORT), max_new_tokens=6, top_k=1,
                              adapter=name) for i, name in enumerate(["alice", "bob", None])]
    _assert_parity(jparams, jreg, jcfg, reqs, eng.run(reqs))


def test_compacted_ticks_equal_full_ticks(models):
    """Compacted ticks gather the adapter-id meta row with the rest: the
    streams equal the merged references and the uncompacted engine's."""
    cfg, jcfg, params, jparams = models["mamba2"]
    reg, jreg = _registries(cfg, jcfg, params, jparams)
    on = _engine(params, dataclasses.replace(cfg, tick_compaction=True), reg, capacity=16)
    reqs = _tenant_requests(names=("alice", "bob"))
    results = on.run(reqs)
    _assert_parity(jparams, jreg, jcfg, reqs, results)
    assert on.metrics.summary()["compaction"]["ticks_compacted"] > 0
    off = _engine(params, cfg, reg, capacity=16).run(_tenant_requests(names=("alice", "bob")))
    assert [r.new_tokens.tolist() for r in results] == [r.new_tokens.tolist() for r in off]


@pytest.mark.parametrize("kind", ["mamba2", "hybrid"])
def test_no_adapter_rows_are_an_exact_noop(models, kind):
    """A request without an adapter on a LoRA engine (beside adapter
    streams) is bit-identical to a LoRA-less engine's."""
    cfg, jcfg, params, jparams = models[kind]
    reg, _ = _registries(cfg, jcfg, params, jparams)

    def reqs():
        return [GenerationRequest(prompt_ids=_prompt(4, SHORT), max_new_tokens=6, top_k=1,
                                  adapter=name) for name in (None, "alice")]

    on = _engine(params, cfg, reg, capacity=2).run(reqs())[0]
    off_cfg = dataclasses.replace(cfg, lora_max_adapters=0)
    off = _engine(params, off_cfg, capacity=2).run(reqs()[:1])[0]
    assert on.new_tokens.tolist() == off.new_tokens.tolist()


def test_lora_off_is_byte_stable(models, tmp_path):
    """The default engine stamps nothing: no adapter field on any record,
    no adapters or tuning section, and naming an adapter is refused."""
    cfg, *_ = models["mamba2"]
    cfg = dataclasses.replace(cfg, lora_max_adapters=0)
    params = models["mamba2"][2]
    path = str(tmp_path / "ticks.jsonl")
    eng = _engine(params, cfg, capacity=2, metrics=ServingMetrics(2, jsonl_path=path))
    eng.run([GenerationRequest(prompt_ids=_prompt(0, 6), top_k=1, max_new_tokens=3)])
    s = eng.metrics.summary()
    assert s["adapters"] is None and s["tuning"] is None
    assert "adapter_id" in eng.pool["meta"] and not eng.pool["meta"]["adapter_id"].any()
    for rec in load_jsonl(path):
        assert not any(k.startswith(("adapter", "tenant")) for k in rec)
    with pytest.raises(ValueError, match="lora_max_adapters=0"):
        eng.submit(GenerationRequest(prompt_ids=_prompt(0, 4), top_k=1, adapter="alice"))
    with pytest.raises(ValueError, match="needs multi-tenant LoRA"):
        eng.hot_swap_adapter(0)


def test_unknown_adapter_and_int8_rejections(models):
    """An unknown name raises the named error at submit (a ValueError);
    int8 weights with LoRA, and a registry of another rank, refuse to
    build."""
    cfg, jcfg, params, jparams = models["mamba2"]
    reg, _ = _registries(cfg, jcfg, params, jparams)
    eng = _engine(params, cfg, reg, capacity=2)
    with pytest.raises(ad.UnknownAdapterError, match="zelda"):
        eng.submit(GenerationRequest(prompt_ids=_prompt(0, 4), top_k=1, adapter="zelda"))
    assert issubclass(ad.UnknownAdapterError, ValueError)
    with pytest.raises(ValueError, match="ROADMAP residual"):
        _engine(params, dataclasses.replace(cfg, serving_weight_dtype="int8"), reg)
    with pytest.raises(ValueError, match="one rank per engine"):
        _engine(params, dataclasses.replace(cfg, lora_rank=8), reg)


def test_cache_full_admission_waits_then_serves(models):
    """One factor row, two tenants, capacity 2: bob waits while alice's
    stream pins the row, then evicts idle alice; both streams stay right
    and every ref and page is returned."""
    cfg, jcfg, params, jparams = models["hybrid"]
    cfg = dataclasses.replace(cfg, lora_cache_slots=1)
    reg, jreg = _registries(cfg, jcfg, params, jparams)
    eng = _engine(params, cfg, reg, capacity=2)
    reqs = [GenerationRequest(prompt_ids=_prompt(i, SHORT), max_new_tokens=4, top_k=1,
                              adapter=name) for i, name in enumerate(["alice", "bob"])]
    results = eng.run(reqs)
    _assert_parity(jparams, jreg, jcfg, reqs, results)
    assert eng.adapter_cache.evictions == 1
    assert eng.adapter_cache.refcount("bob") == 0
    assert eng.page_pool.free_pages == eng.page_pool.num_pages


# ------------------------------------------------- quota, A/B, hot swap


@pytest.mark.parametrize("adapter,resident,cap", [
    (None, ["alice", "alice"], 1), ("bob", ["alice", None], 1),
    ("alice", ["alice", "bob"], 2), ("alice@v2", ["bob"], 1),
    ("alice", ["alice"], 1), ("alice@v2", ["alice", "alice@v3"], 2),
    ("alice", ["alice"] * 10, 0)])
def test_tenant_quota_check_matches_jax(adapter, resident, cap):
    """``check_tenant_quota`` raises exactly where JAX's does."""
    outs = []
    for fn in (check_tenant_quota, jax_quota):
        try:
            fn(adapter, iter(resident), cap)
            outs.append("ok")
        except Exception as e:  # the two packages' named errors
            outs.append(type(e).__name__)
    assert outs[0] == outs[1]
    assert outs[0] in ("ok", TenantQuotaExceeded.__name__)


def test_tenant_quota_backpressure(models):
    """With ``tenant_max_slots=1`` the tenant never holds two slots; its
    over-quota admissions wait (counted) and every stream finishes."""
    cfg, jcfg, params, jparams = models["mamba2"]
    cfg = dataclasses.replace(cfg, tenant_max_slots=1)
    reg, jreg = _registries(cfg, jcfg, params, jparams, names=("alice",))
    eng = _engine(params, cfg, reg, capacity=4, tokens_per_tick=1)
    reqs = [GenerationRequest(prompt_ids=_prompt(20 + i, SHORT), max_new_tokens=4, top_k=1,
                              adapter="alice" if i < 3 else None) for i in range(4)]
    for r in reqs:
        eng.submit(r)
    peak = 0
    while eng.pending:
        eng.step()
        peak = max(peak, sum(t.request.adapter == "alice" for t in eng._slots.values()))
    assert peak == 1
    _assert_parity(jparams, jreg, jcfg, reqs, [eng.results[r.request_id] for r in reqs])
    assert eng.metrics.summary()["tuning"]["quota_stalls"] >= 2


def test_ab_routing_picks_jax_arms(models):
    """``lora_ab_fraction=0.5`` over two versions: each bare-name request
    pins the arm JAX's ``_ab_resolve`` picks for the same seed and
    prompt (both arms take traffic); explicit versions bypass."""
    cfg, jcfg, params, jparams = models["mamba2"]
    cfg, jcfg = (dataclasses.replace(c, lora_ab_fraction=0.5) for c in (cfg, jcfg))
    reg, jreg = _registries(cfg, jcfg, params, jparams, names=("alice", "alice"))
    eng = _engine(params, cfg, reg, capacity=2)
    jeng = types.SimpleNamespace(cfg=jcfg, adapters=jreg)
    arms = []
    for i in range(24):
        prompt = _prompt(100 + i, 6 + i % 5)
        for name in ("alice", "alice@v1"):
            r = GenerationRequest(prompt_ids=prompt, top_k=1, seed=i, adapter=name)
            eng.submit(r)
            jr = JaxRequest(prompt_ids=prompt.astype(np.int32), seed=i)
            assert r.adapter == JaxEngine._ab_resolve(jeng, jr, name)
            arms.append(r.adapter)
    assert set(arms) == {"alice", "alice@v2"}


def test_hot_swap_mid_stream(models):
    """A live alice stream swaps to alice@v2 after two tokens: no token
    is lost, the prefix is merged-v1's stream and the suffix merged-v2's
    continuation; the stream cannot swap twice while it re-prefills."""
    cfg, jcfg, params, jparams = models["hybrid"]
    reg, jreg = _registries(cfg, jcfg, params, jparams, names=("alice",))
    eng = _engine(params, cfg, reg, capacity=2, tokens_per_tick=1)
    prompt = _prompt(5, SHORT)
    rid = eng.submit(GenerationRequest(prompt_ids=prompt.copy(), max_new_tokens=8, top_k=1,
                                       adapter="alice"))
    while True:
        eng.step()
        t = next(tr for tr in eng._slots.values() if tr.request_id == rid)
        if len(t.new_tokens) >= 2:
            break
    pre = list(t.new_tokens)
    for r in (reg, jreg):
        r.register_random("alice", seed=2, scale=SCALE)
    assert eng.hot_swap_adapter(rid) == "alice@v2"
    with pytest.raises(ValueError, match="not swappable"):
        eng.hot_swap_adapter(rid)
    for _ in eng.serve():
        pass
    res = eng.results[rid]
    final = res.new_tokens.tolist()
    assert len(final) == 8 and final[:len(pre)] == pre
    assert res.prompt_ids.tolist() == prompt.tolist()
    assert pre == _want(jparams, jreg, jcfg, "alice@v1", prompt, len(pre))
    cont = np.concatenate([prompt, np.asarray(pre)])
    assert final[len(pre):] == _want(jparams, jreg, jcfg, "alice@v2", cont, 8 - len(pre))
    assert eng.metrics.summary()["tuning"]["hot_swaps"] == 1
    assert eng.adapter_cache.refcount("alice") == 0
    assert eng.page_pool.free_pages == eng.page_pool.num_pages


# -------------------------------------------------------------- records


def test_records_summary_and_report_match_jax(models, tmp_path):
    """The same tick and request calls on the port's and JAX's
    ``ServingMetrics``: equal records and summary sections; the port's
    report and JAX's ``scripts/obs_report.py`` agree on the adapters
    section.  The engine's records carry the same fields."""
    path, jpath = str(tmp_path / "p.jsonl"), str(tmp_path / "j.jsonl")
    m, jm = ServingMetrics(4, jsonl_path=path), JaxMetrics(4, jsonl_path=jpath)
    for x in (m, jm):
        x.configure_adapters(4, 8, 2)
        x.record_quota_stall()
        x.record_hot_swap()
        x.record_tick(occupied=2, queue_depth=1, tokens_emitted=3, dt_s=0.01,
                      tenant_quota_stalls=1, adapter_hot_swaps=1, adapters_resident=2,
                      adapter_cache_hits=1, adapter_cache_misses=2, adapters_live=2)
        x.record_tick(occupied=1, queue_depth=0, tokens_emitted=2, dt_s=0.01,
                      adapters_resident=1, adapter_cache_evictions=1, adapters_live=1)
    recs, jrecs = load_jsonl(path), load_jsonl(jpath)
    assert [sorted(r) for r in recs] == [sorted(r) for r in jrecs]
    for key in ("adapters", "tuning"):
        assert m.summary()[key] == jm.summary()[key]
    assert build_report(recs)["serving"]["adapters"] == \
        jax_build_report(jrecs)["serving"]["adapters"]
    # the engine's own records
    cfg, jcfg, params, jparams = models["mamba2"]
    reg, _ = _registries(cfg, jcfg, params, jparams)
    epath = str(tmp_path / "e.jsonl")
    eng = _engine(params, cfg, reg, metrics=ServingMetrics(6, jsonl_path=epath))
    eng.run(_tenant_requests())
    ticks = [r for r in load_jsonl(epath) if r["kind"] == "serving_tick"]
    assert ticks and all(k in ticks[0] for k in ("adapters_resident", "adapters_live",
                                                 "adapter_cache_misses"))
    reqs = [r for r in load_jsonl(epath) if r["kind"] == "request"]
    assert sorted(r.get("adapter") or "" for r in reqs) == ["", "", "alice", "alice",
                                                            "bob", "bob"]
    json.dumps(eng.metrics.summary())
