"""The port's speculative decoding against the JAX package's, on the CPU
(2 layers, d_model 32, fp32, greedy).

* ``models/lm.lm_verify_chunk`` equals JAX's on the same numpy inputs and
  converted params (logits and new state at 1e-4: mamba2, mamba1,
  hybrid), and leaves its input carries as they were.
* ``spec_generate`` equals JAX's ``spec_generate`` token for token with
  the n-gram drafter (mamba2, mamba1, hybrid, a chunked long prompt);
  the JAX hybrid ENGINE is not the reference (its tests flake), its solo
  ``spec_generate`` is.
* The spec engine equals the non-spec engine (mamba2, mamba1, hybrid,
  int8 hybrid), with EOS, a prefix-cache warm hit, a preemption and
  resume, and compaction on (the JAX compaction spec test's traffic);
  and the engine equals the port's ``spec_generate`` at its row count.
* A rejected tick restores the carries bit for bit and leaves every live
  KV cell as it was, recycled pages included; every tick commits a token.
* ``verify_greedy``, ``build_feed`` and ``NGramDrafter`` equal JAX's;
  ``ModelDrafter`` streams, the ``"model"``-without-instance message.
* The refusal of sampled requests, the chunk budget debit, byte-stable
  records with speculation off, ``summary()["speculation"]`` and the
  report's section against the JAX ``ServingMetrics`` and
  ``scripts/obs_report.py``, the config's ``spec_*`` fields.
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
from mamba_distributed_tpu.models import lm as jlm
from mamba_distributed_tpu.serving import spec_decode as jsd
from mamba_distributed_tpu.utils.metrics import ServingMetrics as JaxMetrics
from mamba_distributed_tpu_torch import convert
from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.inference import generate
from mamba_distributed_tpu_torch.models import lm
from mamba_distributed_tpu_torch.models.lm import init_lm_params
from mamba_distributed_tpu_torch.obs import load_jsonl
from mamba_distributed_tpu_torch.obs.report import build_report
from mamba_distributed_tpu_torch.serving import (
    GenerationRequest,
    ModelDrafter,
    NGramDrafter,
    ServingEngine,
)
from mamba_distributed_tpu_torch.serving import spec_decode as sd
from mamba_distributed_tpu_torch.utils.metrics import ServingMetrics

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
from obs_report import build_report as jax_build_report  # noqa: E402

pytestmark = pytest.mark.torch

CHUNK = 16
K = 3  # draft tokens; verify width K+1
TINY = dict(d_model=32, n_layer=2, vocab_size=64, headdim=8, chunk_size=16, d_state=16,
            compute_dtype="float32", prefill_chunk_tokens=CHUNK,
            prefill_tokens_per_tick=CHUNK)
HYBRID = dict(TINY, attn_layer_idx=(1,), attn_num_heads=4, attn_num_kv_heads=2,
              kv_page_tokens=8, kv_slot_tokens=64)
LAYERS = {
    "mamba2": TINY,
    "mamba1": dict(TINY, ssm_layer="mamba1"),
    "hybrid": HYBRID,
    "int8": dict(HYBRID, kv_page_dtype="int8", serving_weight_dtype="int8"),
}


@pytest.fixture(scope="module")
def models():
    """Each layer kind's port config and params, converted from the JAX
    package's seeded params (so the JAX references run on the same)."""
    out = {}
    for name, kw in LAYERS.items():
        jcfg = JaxConfig(**kw, remat=False)
        jparams = jlm.init_lm_params(jax.random.PRNGKey(0), jcfg)
        out[name] = (ModelConfig(**kw), convert.params_from_jax(
            jax.tree.map(np.asarray, jparams)), jcfg, jparams)
    return out


def spec(cfg, k=K, **kw):
    return dataclasses.replace(cfg, spec_tokens=k, **kw)


def mixed_prompts(n=4, lo=4, hi=40, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, size=int(rng.integers(lo, hi + 1))) for _ in range(n)]


def tiled_prompts(n=3, seed=1, reps=4):
    """Repetitive prompts (a short pattern tiled), where the n-gram drafter
    is accepted often."""
    rng = np.random.default_rng(seed)
    return [np.tile(rng.integers(0, 64, size=4 + i), reps) for i in range(n)]


def greedy_requests(prompts, max_new=12, eos_id=None):
    return [GenerationRequest(prompt_ids=p.copy(), max_new_tokens=max_new, top_k=1,
                              seed=100 + i, eos_id=eos_id) for i, p in enumerate(prompts)]


def _engine(params, cfg, capacity=3, **kw):
    return ServingEngine(params, cfg, capacity=capacity, tokens_per_tick=2, max_top_k=8,
                         device="cpu", **kw)


def run_engine(params, cfg, reqs, capacity=3, **kw):
    eng = _engine(params, cfg, capacity, **kw)
    return [r.new_tokens.tolist() for r in eng.run(reqs)], eng


class WrongDrafter(sd.Drafter):
    """Drafts a token the model never emits here: every tick rejects at
    its first draft (the largest rollback)."""

    def observe(self, stream, tokens):
        pass

    def draft(self, stream, n):
        return [1] * n

    def forget(self, stream):
        pass


# ------------------------------------------------------------- config


def test_config_spec_fields_equal_jax():
    ours, ref = ModelConfig(), JaxConfig()
    for f in ("spec_tokens", "spec_drafter", "spec_ngram_order"):
        assert getattr(ours, f) == getattr(ref, f)
    for kw in (dict(spec_tokens=-1), dict(spec_drafter="oracle"), dict(spec_ngram_order=0)):
        with pytest.raises(ValueError) as a:
            ModelConfig(**kw)
        with pytest.raises(ValueError) as b:
            JaxConfig(**kw)
        assert str(a.value) == str(b.value)


# ------------------------------------------------------- lm_verify_chunk


def _close(ours, ref, tol=1e-4):
    ref = np.asarray(ref, np.float32)
    ours = ours.detach().float().numpy()
    scale = max(1.0, float(np.abs(ref).max()))
    assert np.abs(ours - ref).max() <= tol * scale


@pytest.mark.parametrize("layer", ["mamba2", "mamba1", "hybrid"])
def test_lm_verify_chunk_matches_jax(models, layer):
    cfg, params, jcfg, jparams = models[layer]
    b, W = 2, K + 1
    rng = np.random.default_rng(7)
    sj = jlm.init_lm_state(jcfg, b, max_len=48)
    st = lm.init_lm_state(cfg, b, max_len=48)
    ids = rng.integers(0, 64, (b, CHUNK))
    _, sj = jlm.lm_prefill_chunk(jparams, jcfg, jnp.asarray(ids), sj)
    _, st = lm.lm_prefill_chunk(params, cfg, torch.from_numpy(ids), st)
    feed = rng.integers(0, 64, (b, W))
    mask = np.ones((b, W), np.float32)
    before = [t.clone() for t in st["blocks"]]
    lj, nj = jlm.lm_verify_chunk(jparams, jcfg, jnp.asarray(feed), sj,
                                 token_mask=jnp.asarray(mask))
    lt, nt = lm.lm_verify_chunk(params, cfg, torch.from_numpy(feed), st,
                                token_mask=torch.from_numpy(mask))
    assert lt.shape == (b, W, cfg.vocab_size_padded) and lt.dtype == torch.float32
    _close(lt, lj)
    for a, r in zip(nt["blocks"], nj["blocks"]):
        _close(a, r)
    # the verify leaves its input carries untouched (the rollback's premise)
    assert all(torch.equal(a, c) for a, c in zip(st["blocks"], before))
    if cfg.attn_layer_idx:
        for a, r in zip(nt["attn_blocks"], nj["attn_blocks"]):
            _close(a[:, 1:], np.asarray(r)[:, 1:])  # page 0 is the trash page
        assert nt["attn_meta"][1].tolist() == np.asarray(nj["attn_meta"][1]).tolist()


# -------------------------------------------------------- spec_generate


@pytest.mark.parametrize("layer,long", [("mamba2", False), ("mamba1", False),
                                        ("hybrid", False), ("mamba2", True)])
def test_spec_generate_matches_jax(models, layer, long):
    cfg, params, jcfg, jparams = models[layer]
    prompts = tiled_prompts(2, reps=12 if long else 4)
    if long:
        assert len(prompts[0]) > CHUNK  # the chunked prefill path
    for p in prompts:
        ref = jsd.spec_generate(jparams, spec(jcfg), p.astype(np.int32), max_new_tokens=14)
        got = sd.spec_generate(params, spec(cfg), p, max_new_tokens=14)
        assert got[0].tolist() == np.asarray(ref)[0].tolist()


def test_generate_routes_greedy_batch1_to_spec(models):
    cfg, params, jcfg, jparams = models["mamba2"]
    p = tiled_prompts(1)[0]
    got = generate(params, spec(cfg), torch.from_numpy(p)[None], max_new_tokens=10, top_k=1)
    want = sd.spec_generate(params, spec(cfg), p, max_new_tokens=10)
    assert got.tolist() == want.tolist()
    n0 = sd.TRACE_COUNTS["verify"]
    generate(params, spec(cfg), torch.from_numpy(p)[None], max_new_tokens=4, top_k=3)
    assert sd.TRACE_COUNTS["verify"] == n0  # sampled calls take the normal path


# ------------------------------------------------------- engine parity


@pytest.mark.parametrize("layer", list(LAYERS))
def test_spec_engine_matches_nonspec(models, layer):
    cfg, params, _, _ = models[layer]
    prompts = mixed_prompts() + tiled_prompts(2)
    if cfg.attn_layer_idx:
        prompts[1] = np.random.default_rng(4).integers(0, 64, 3 * CHUNK + 5)  # chunked
    base, _ = run_engine(params, cfg, greedy_requests(prompts, max_new=10))
    out, eng = run_engine(params, spec(cfg), greedy_requests(prompts, max_new=10))
    assert out == base
    sp = eng.metrics.summary()["speculation"]
    assert sp["spec_tokens"] == K and sp["drafter"] == "ngram" and sp["accepted"] > 0
    if eng.hybrid:
        assert eng.page_pool.pages_in_use == 0
        assert eng._page_tbl.shape[1] == cfg.kv_pages_per_slot + 1


@pytest.mark.parametrize("layer", ["mamba2", "hybrid"])
def test_spec_engine_matches_spec_generate(models, layer):
    cfg, params, _, _ = models[layer]
    prompts = tiled_prompts(3) if layer == "mamba2" else mixed_prompts(3, seed=3)
    out, _ = run_engine(params, spec(cfg), greedy_requests(prompts))
    for p, stream in zip(prompts, out):
        g = sd.spec_generate(params, spec(cfg), p, max_new_tokens=12, decode_rows=3)
        assert g[0, len(p):].tolist() == stream


def test_spec_eos_parity(models):
    cfg, params, _, _ = models["mamba2"]
    prompts = mixed_prompts(3, seed=5)
    base, _ = run_engine(params, cfg, greedy_requests(prompts, max_new=16))
    eos = base[0][4]  # a token the first stream emits

    def reqs():
        return greedy_requests(prompts, max_new=16, eos_id=eos)

    b, _ = run_engine(params, cfg, reqs())
    s, eng = run_engine(params, spec(cfg), reqs())
    assert b == s and any(len(x) < 16 for x in s)
    assert {r.finish_reason for r in eng.results.values()} >= {"eos"}
    g = sd.spec_generate(params, spec(cfg), prompts[0], max_new_tokens=16, eos_id=eos)
    assert g[0, len(prompts[0]):].tolist() == b[0] + [eos] * (16 - len(b[0]))


def test_spec_prefix_cache_warm_parity(models):
    cfg, params, _, _ = models["mamba2"]
    rng = np.random.default_rng(7)
    preamble = rng.integers(0, 64, 2 * CHUNK)
    prompts = [np.concatenate([preamble, rng.integers(0, 64, 6)]) for _ in range(4)]
    base, _ = run_engine(params, cfg, greedy_requests(prompts, max_new=8))
    eng = _engine(params, spec(cfg, prefix_cache_entries=32))
    cold = [r.new_tokens.tolist() for r in eng.run(greedy_requests(prompts[:3], max_new=8))]
    # three exact repeats (full hits) and a new suffix (a partial hit)
    warm = [r.new_tokens.tolist() for r in eng.run(greedy_requests(prompts, max_new=8))]
    assert cold == base[:3] and warm == base
    assert eng.metrics.prefix_full_hits == 3 and eng.metrics.prefix_partial_hits > 0


@pytest.mark.parametrize("layer", ["mamba2", "hybrid"])
def test_spec_preempt_resume_parity(models, layer):
    cfg, params, _, _ = models[layer]

    def drive(run_cfg, priority):
        eng = _engine(params, run_cfg, capacity=2)
        lo = [eng.submit(GenerationRequest(prompt_ids=np.tile(np.arange(1 + i, 5 + i), 3),
                                           max_new_tokens=12 + 4 * i, top_k=1, seed=1 + i))
              for i in range(2)]
        for _ in range(2):
            eng.step()
        hi = eng.submit(GenerationRequest(prompt_ids=np.arange(2, 10), max_new_tokens=6,
                                          top_k=1, seed=9, priority=priority))
        while eng.pending:
            eng.step()
        return [eng.results[i].new_tokens.tolist() for i in lo + [hi]], eng

    base, _ = drive(cfg, None)
    out, eng = drive(spec(cfg), 5)
    assert eng.metrics.preemptions == 1
    assert out == base


def test_spec_compaction_parity(models):
    """The JAX compaction spec test's traffic: three requests of a tiled
    4-token pattern; the compacted spec engine equals the uncompacted one
    and the non-spec engine, with verify launches below capacity."""
    cfg, params, _, _ = models["mamba2"]
    pat = np.random.default_rng(1).integers(0, 64, size=4)

    def reqs():
        return [GenerationRequest(prompt_ids=np.tile(pat, 4), max_new_tokens=18, top_k=1,
                                  seed=7 + i) for i in range(3)]

    base, _ = run_engine(params, cfg, reqs(), capacity=8)
    off, _ = run_engine(params, spec(cfg), reqs(), capacity=8)
    on, eng = run_engine(params, spec(cfg, tick_compaction=True), reqs(), capacity=8)
    assert on == off == base
    assert eng.metrics.summary()["compaction"]["ticks_compacted"] > 0


def test_spec_compaction_parity_hybrid(models):
    cfg, params, _, _ = models["hybrid"]
    prompts = mixed_prompts(4, seed=11) + tiled_prompts(1)
    reqs = [greedy_requests(prompts, max_new=n)[i] for i, n in enumerate((14, 4, 8, 4, 10))]
    off, _ = run_engine(params, spec(cfg), [dataclasses.replace(r) for r in reqs],
                        capacity=8)
    on, eng = run_engine(params, spec(cfg, tick_compaction=True),
                         [dataclasses.replace(r) for r in reqs], capacity=8)
    assert on == off
    assert eng.metrics.summary()["compaction"]["ticks_compacted"] > 0
    assert eng.page_pool.pages_in_use == 0


# ---------------------------------------------------------------- rollback


def test_rejection_rollback_restores_carries_bitexact(models):
    cfg, params, _, _ = models["mamba2"]
    eng = _engine(params, spec(cfg), capacity=2, drafter=WrongDrafter())
    # short prompts admit one-shot in the first step, so the second step
    # is a pure all-reject verify tick, and the pending queues (2 < K+1
    # trusted tokens) cannot catch up to a full accept
    for r in greedy_requests(mixed_prompts(2, lo=4, hi=8), max_new=16):
        eng.submit(r)
    eng.step()
    before = [t.clone() for t in eng.pool["state"]["blocks"]]
    logits = eng.pool["logits"].clone()
    accepted, drafted = eng.metrics.spec_accepted, eng.metrics.spec_drafted
    events = eng.step()
    assert len({e.request_id for e in events}) == 2  # every stream still commits
    for b, a in zip(before, eng.pool["state"]["blocks"]):
        assert torch.equal(b, a)
    assert torch.equal(logits, eng.pool["logits"])
    # the tick's window: drafts fed, none accepted
    assert eng.metrics.spec_accepted == accepted and eng.metrics.spec_drafted > drafted


def test_rejection_rollback_preserves_live_kv_pages(models):
    cfg, params, _, _ = models["hybrid"]
    eng = _engine(params, spec(cfg), capacity=2, drafter=WrongDrafter())
    # a first tenant finishes, so its pages recycle to the next admissions
    first = eng.run(greedy_requests(mixed_prompts(1, seed=2), max_new=4))
    assert first and eng.page_pool.pages_in_use == 0
    for r in greedy_requests(mixed_prompts(2, seed=3), max_new=16):
        eng.submit(r)
    while len(eng._slots) < 2 or eng._prefill_queue:
        eng.step()
    held = [p for t in eng._slots.values() if t.pages for p in t.pages]
    assert held and min(held) == 1  # a recycled page is live again
    kv_len, tbl = eng._kv_len.copy(), eng._page_tbl.copy()
    before = [t.clone() for t in eng.pool["state"]["attn_blocks"]]
    eng.step()  # one all-reject verify tick
    after = eng.pool["state"]["attn_blocks"]
    assert (eng._kv_len == kv_len).all()  # rejected rows keep their lengths
    pg = cfg.kv_page_tokens
    checked = 0
    for slot in range(eng.capacity):
        for j in range(tbl.shape[1]):
            phys = int(tbl[slot, j])
            live = int(min(max(kv_len[slot] - j * pg, 0), pg))
            if phys == 0 or not live:
                continue
            for b, a in zip(before, after):
                assert torch.equal(b[:, phys, :, :live], a[:, phys, :, :live])
            checked += 1
    assert checked


def test_pending_catchup_commits_every_tick(models):
    cfg, params, _, _ = models["mamba2"]
    prompts = mixed_prompts(2, seed=9)
    base, _ = run_engine(params, cfg, greedy_requests(prompts))
    out, eng = run_engine(params, spec(cfg), greedy_requests(prompts),
                          drafter=WrongDrafter())
    assert out == base
    assert eng.metrics.spec_accepted == 0


# ------------------------------------------------------------ host rules


def test_verify_greedy_and_build_feed_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(300):
        W = int(rng.integers(2, 6))
        nt = int(rng.integers(1, W + 1))
        greedy = rng.integers(0, 4, W)
        fed = rng.integers(0, 4, W)
        fed[1:] = np.where(rng.random(W - 1) < 0.6, greedy[:-1], fed[1:])
        assert (sd.verify_greedy(fed.tolist(), greedy.tolist(), nt)
                == jsd.verify_greedy(fed.tolist(), greedy.tolist(), nt))
        pending = rng.integers(0, 9, int(rng.integers(1, W + 1))).tolist()
        drafts = rng.integers(0, 9, int(rng.integers(0, W + 2))).tolist()
        assert sd.build_feed(pending, drafts, W) == jsd.build_feed(pending, drafts, W)
    logits = rng.standard_normal(72).astype(np.float32)
    logits[64:] = 99.0  # padding columns never win
    assert sd.greedy_token(torch.from_numpy(logits), 64) == jsd.greedy_token(logits, 64)


@pytest.mark.parametrize("order", [1, 2, 3, 5])
def test_ngram_drafter_equals_jax(order):
    rng = np.random.default_rng(order)
    ours, ref = NGramDrafter(order), jsd.NGramDrafter(order)
    for step in range(60):
        toks = rng.integers(0, 5, int(rng.integers(1, 4))).tolist()
        ours.observe("s", toks)
        ref.observe("s", toks)
        n = int(rng.integers(0, 6))
        assert ours.draft("s", n) == ref.draft("s", n)
    ours.forget("s")
    assert ours.draft("s", 3) == []
    with pytest.raises(ValueError, match="order must be >= 1"):
        NGramDrafter(0)


def test_ngram_drafter_prefers_full_continuation():
    d = NGramDrafter(order=3)
    d.observe("s", [7] * 12)
    assert d.draft("s", 4) == [7, 7, 7, 7]
    d2 = NGramDrafter(order=2)
    d2.observe("s", [1, 2, 1, 2, 1, 2, 1, 2])
    assert d2.draft("s", 4) == [1, 2, 1, 2]


def test_model_drafter_parity_and_errors(models):
    cfg, params, _, _ = models["mamba2"]
    draft_cfg = dataclasses.replace(cfg, n_layer=1, d_model=16)
    draft_params = init_lm_params(draft_cfg, torch.Generator().manual_seed(5))
    prompts = mixed_prompts(2, seed=13) + tiled_prompts(1)
    base, _ = run_engine(params, cfg, greedy_requests(prompts))
    mcfg = spec(cfg, spec_drafter="model")
    drafter = ModelDrafter(draft_params, draft_cfg)
    out, eng = run_engine(params, mcfg, greedy_requests(prompts), drafter=drafter)
    assert out == base
    assert eng.metrics.summary()["speculation"]["drafter"] == "model"
    assert not drafter._streams  # every finished stream was forgotten
    g = sd.spec_generate(params, mcfg, prompts[2], max_new_tokens=12,
                         drafter=ModelDrafter(draft_params, draft_cfg))
    assert g[0, len(prompts[2]):].tolist() == base[2]
    # a rollout never writes the stored state
    d = ModelDrafter(draft_params, draft_cfg)
    d.observe("s", prompts[0].tolist())
    st = [t.clone() for t in d._streams["s"]["state"]["blocks"]]
    assert d.draft("s", 4) == d.draft("s", 4)
    assert all(torch.equal(a, b) for a, b in zip(st, d._streams["s"]["state"]["blocks"]))
    with pytest.raises(ValueError) as ours:
        _engine(params, mcfg)
    with pytest.raises(ValueError) as ref:
        jsd.make_drafter(JaxConfig(**TINY, spec_tokens=K, spec_drafter="model"))
    assert str(ours.value) == str(ref.value) and "explicit drafter instance" in str(ours.value)
    with pytest.raises(ValueError, match="pure-SSM"):
        ModelDrafter(models["hybrid"][1], models["hybrid"][0])


# ------------------------------------------------------------ knobs


def test_spec_rejects_non_greedy_submit(models):
    cfg, params, _, _ = models["mamba2"]
    eng = _engine(params, spec(cfg), capacity=2)
    with pytest.raises(ValueError, match="greedy-only"):
        eng.submit(GenerationRequest(prompt_ids=np.arange(4), top_k=5))


def test_spec_budget_debit(models):
    """A live verify tick's K+1 lanes come off the next step's chunk
    budget: with the budget just past one chunk, the next step runs the
    one guaranteed chunk instead of two."""
    cfg, params, _, _ = models["mamba2"]
    eng = _engine(params, spec(cfg, prefill_tokens_per_tick=CHUNK + 2))
    rng = np.random.default_rng(21)
    eng.submit(greedy_requests([rng.integers(0, 64, size=4)], max_new=24)[0])
    eng.step()
    assert eng._spec_budget_debt == K + 1
    for r in greedy_requests([rng.integers(0, 64, size=3 * CHUNK) for _ in range(2)],
                             max_new=4):
        eng.submit(r)
    chunks0 = eng.metrics.prefill_chunks
    eng.step()
    assert eng.metrics.prefill_chunks - chunks0 == 1


def test_spec_off_is_byte_stable(models, tmp_path):
    """K = 0: no drafter, no stamps, the summary's section None, and each
    tick record has exactly the keys, in order, of an engine before the
    feature."""
    cfg, params, _, _ = models["hybrid"]
    path = tmp_path / "off.jsonl"
    metrics = ServingMetrics(2, jsonl_path=str(path))
    eng = _engine(params, cfg, 2, metrics=metrics)
    eng.run(greedy_requests(mixed_prompts(2), max_new=4))
    assert eng.drafter is None and not eng.spec
    assert eng._page_tbl.shape[1] == cfg.kv_pages_per_slot
    assert metrics.summary()["speculation"] is None
    keys = ["kind", "tick", "occupied", "capacity", "queue_depth", "tokens_emitted", "tick_ms",
            "prefill_stall_ms", "prefill_chunk_tokens", "prefill_chunk_ms",
            "prefill_oneshot_tokens", "useful_tokens", "wasted_token_lanes",
            "goodput_tokens_per_sec", "serving_mfu", "traces", "kv_pages_used",
            "kv_pages_capacity", "kv_page_allocs", "kv_page_frees"]
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        if rec["kind"] == "serving_tick":
            assert list(rec) == keys


# --------------------------------------------------------------- telemetry


def _feed_spec(m):
    rng = np.random.default_rng(8)
    m.configure_goodput(2.5e6, 3.1e6, 1e12)
    m.configure_speculation(K, "ngram")
    m.configure_compaction()
    for i in range(6):
        drafted = int(rng.integers(0, 9))
        m.record_tick(occupied=2, queue_depth=1, tokens_emitted=int(rng.integers(1, 9)),
                      dt_s=float(rng.uniform(0.002, 0.01)), slot_lanes=8,
                      traces=["a", "b"], spec_drafted=drafted,
                      spec_accepted=int(rng.integers(0, drafted + 1)), spec_streams=2,
                      compaction_width=2 if i % 2 else 4)


def test_speculation_summary_records_and_report_equal_jax(tmp_path):
    ours = ServingMetrics(4, jsonl_path=str(tmp_path / "p.jsonl"))
    ref = JaxMetrics(4, jsonl_path=str(tmp_path / "j.jsonl"))
    _feed_spec(ours)
    _feed_spec(ref)
    assert ours.summary()["speculation"] == ref.summary()["speculation"]
    assert json.dumps(ours.summary(), sort_keys=True) == json.dumps(ref.summary(), sort_keys=True)
    assert list(ours.summary()) == list(ref.summary())
    assert (tmp_path / "p.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()
    lines = load_jsonl(str(tmp_path / "p.jsonl"))
    assert build_report(lines)["serving"]["speculation"] == \
        jax_build_report(lines)["serving"]["speculation"]


def test_spec_engine_telemetry(models, tmp_path):
    cfg, params, _, _ = models["mamba2"]
    path = tmp_path / "spec.jsonl"
    metrics = ServingMetrics(2, jsonl_path=str(path))
    eng = _engine(params, spec(cfg), 2, metrics=metrics)
    n0 = sd.TRACE_COUNTS["verify"]
    eng.run(greedy_requests(tiled_prompts(2), max_new=8))
    lines = load_jsonl(str(path))
    ticks = [r for r in lines if r["kind"] == "serving_tick"]
    assert ticks and sd.TRACE_COUNTS["verify"] - n0 == len(ticks)
    for t in ticks:
        assert list(t)[-3:] == ["spec_drafted", "spec_accepted", "spec_streams"]
        # lanes are billed at capacity x the verify width
        assert t["useful_tokens"] + t["wasted_token_lanes"] >= 2 * (K + 1)
    sp = metrics.summary()["speculation"]
    assert sp["drafted"] == sum(t["spec_drafted"] for t in ticks)
    assert sp["accepted_tokens_per_tick"] > 1.0
    assert sp["acceptance_rate_pct_hist"]["count"] == len([t for t in ticks
                                                           if t["spec_drafted"]])
    ours, ref = build_report(lines), jax_build_report(lines)
    assert ours["serving"]["speculation"] == ref["serving"]["speculation"]
    assert ours["serving"]["goodput"] == ref["serving"]["goodput"]
