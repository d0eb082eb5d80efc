"""The port's priorities, preemption and SRPT prefill grants, on the CPU.

* The priority queue pops, peeks, requeues and resumes in the JAX
  ``FCFSScheduler``'s order; the config refuses what JAX's refuses.
* Equal priorities never preempt; a higher priority admits ahead of
  earlier lower-priority requests.
* A higher-priority arrival preempts a decoding slot mid-stream (carry
  and logits to host memory, page refs kept); the resumed stream is
  bit-identical to ``generate()`` (fp32, sampling on) for mamba2 and
  hybrid stacks, with no re-prefill and no page leaked; a page-stalled
  head lets a preempted request resume first.
* ``state_cache.restore`` writes what JAX ``state_cache.restore`` writes
  on the same numpy pool.
* ``prefill_schedule="srpt"`` grants the nearly-done prompt first and the
  starvation guard hands a passed-over prompt the next grant (JAX
  ``tests/test_prefill.py``'s two cases); streams stay exact.
* Request and tick records carry the priority and preemption stamps, and
  the port's report counts preemptions as the JAX script does.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_distributed_tpu.config import ModelConfig as JaxConfig
from mamba_distributed_tpu.serving import state_cache as jsc
from mamba_distributed_tpu.serving.scheduler import FCFSScheduler as JaxScheduler
from mamba_distributed_tpu.serving.scheduler import GenerationRequest as JaxRequest
from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.inference.generate import generate
from mamba_distributed_tpu_torch.models.lm import init_lm_params
from mamba_distributed_tpu_torch.obs import SpanTracer, load_jsonl
from mamba_distributed_tpu_torch.obs.report import build_report
from mamba_distributed_tpu_torch.serving import GenerationRequest, ServingEngine
from mamba_distributed_tpu_torch.serving import state_cache
from mamba_distributed_tpu_torch.serving.scheduler import FCFSScheduler
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


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, kw in (("mamba2", TINY), ("hybrid", HYBRID)):
        cfg = ModelConfig(**kw)
        out[name] = (cfg, init_lm_params(cfg, torch.Generator().manual_seed(0)))
    return out


def _prompt(seed, t):
    return np.random.default_rng(seed).integers(0, 64, t).astype(np.int64)


def _solo(params, cfg, prompt, seed, new, rows):
    out = generate(params, cfg, torch.from_numpy(prompt)[None], seed=seed,
                   max_new_tokens=new, top_k=5, decode_rows=rows)
    return out[0, len(prompt):].tolist()


def _engine(params, cfg, capacity=1, **kw):
    return ServingEngine(params, cfg, capacity=capacity, max_top_k=5, tokens_per_tick=2,
                         device="cpu", **kw)


def _req(prompt, seed, new, priority=None):
    return GenerationRequest(prompt_ids=prompt.copy(), max_new_tokens=new, top_k=5, seed=seed,
                             priority=priority)


# ------------------------------------------------------------ the queue


@pytest.mark.parametrize("default", [0, 2])
def test_priority_queue_order_matches_jax(default):
    """Submits of mixed priorities (None takes the default), pops,
    peeks, requeues of popped requests and of one holding a snapshot:
    the port's queue yields the JAX queue's request ids in order."""
    prios = [None, 1, 3, None, 3, 0, 5, 1, None, 2]

    def drive(sched, make):
        out = []
        for i, p in enumerate(prios):
            sched.submit(make(np.arange(1, 3 + i), priority=p))
            if i % 3 == 2:
                out.append(("pop", sched.pop().request_id))
                out.append(("peek", sched.peek().request_id))
        t = sched.pop()
        t.snapshot = {"step": 1}
        sched.requeue(t)
        u = sched.pop()
        sched.requeue(u)
        out.append(("preempted", sched.pop_preempted().request_id))
        while sched.depth:
            t = sched.pop()
            out.append(("pop", t.request_id, t.priority))
        out.append(("empty", sched.pop(), sched.peek(), sched.pop_preempted()))
        return out

    ours = drive(FCFSScheduler(default), GenerationRequest)
    ref = drive(JaxScheduler(default), JaxRequest)
    assert ours == ref


@pytest.mark.parametrize("field, value, match", [
    ("prefill_schedule", "fifo", "prefill_schedule must be"),
    ("prefix_cache_entries", -1, "prefix_cache_entries must be"),
    ("prefix_cache_bytes", -1, "prefix_cache_bytes must be"),
    ("prefix_min_chunk_hits", 0, "prefix_min_chunk_hits must be"),
    ("compaction_hysteresis_ticks", -1, "compaction_hysteresis_ticks must be"),
])
def test_config_refuses_what_jax_refuses(field, value, match):
    kw = dict(TINY, **{field: value})
    with pytest.raises(ValueError) as ours:
        ModelConfig(**kw)
    with pytest.raises(ValueError) as ref:
        JaxConfig(**kw)
    assert str(ours.value) == str(ref.value) and match in str(ours.value)
    ok = dict(prefill_schedule="srpt", prefix_cache_entries=4, prefix_cache_bytes=10,
              prefix_min_chunk_hits=2, serving_default_priority=-1, tick_compaction=True,
              compaction_hysteresis_ticks=0)
    assert all(getattr(ModelConfig(**TINY, **ok), k) == getattr(JaxConfig(**TINY, **ok), k)
               for k in ok)


def test_equal_priorities_never_preempt(models):
    cfg, params = models["mamba2"]
    eng = _engine(params, cfg)
    eng.run([_req(_prompt(50 + i, 5 + i), i, 4) for i in range(3)])
    assert eng.metrics.preemptions == 0


def test_priority_pops_ahead_of_fcfs(models):
    cfg, params = models["mamba2"]
    eng = _engine(params, cfg)
    order = []

    def record(events):
        for ev in events:
            if ev.request_id not in order:
                order.append(ev.request_id)

    r0 = eng.submit(_req(_prompt(60, 5), 110, 3))
    record(eng.step())
    r1 = eng.submit(_req(_prompt(61, 6), 111, 3))
    r2 = eng.submit(_req(_prompt(62, 7), 112, 3, priority=3))
    while eng.pending:
        record(eng.step())
    assert order[0] == r0 and order.index(r2) < order.index(r1)


# ----------------------------------------------------- preempt and resume


@pytest.mark.parametrize("layer", ["mamba2", "hybrid"])
def test_preempt_resume_mid_decode_parity(models, layer):
    """A priority-5 arrival preempts the decoding priority-0 request; both
    streams equal ``generate()`` and the victim never prefills again."""
    cfg, params = models[layer]
    tracer = SpanTracer(ring_len=256)
    eng = _engine(params, cfg, tracer=tracer)
    plo, phi = _prompt(40, 9), _prompt(41, 7)
    rlo = eng.submit(_req(plo, 100, 12, priority=0))
    eng.step()
    eng.step()
    assert len(eng._slots[0].new_tokens) == 4
    prefill0 = eng.metrics.prefills + eng.metrics.prefill_chunks
    rhi = eng.submit(_req(phi, 101, 4, priority=5))
    while eng.pending:
        eng.step()
    assert eng.metrics.preemptions == 1
    assert eng.results[rlo].new_tokens.tolist() == _solo(params, cfg, plo, 100, 12, 1)
    assert eng.results[rhi].new_tokens.tolist() == _solo(params, cfg, phi, 101, 4, 1)
    # the only prefill after the preemption is the arrival's own
    assert eng.metrics.prefills + eng.metrics.prefill_chunks - prefill0 == (
        2 if eng.hybrid else 1)
    names = [r.get("name") for r in tracer.ring_pull()["records"]]
    assert names.count("serving_preempt") == names.count("serving_resume") == 1
    if eng.hybrid:
        assert eng.page_pool.pages_in_use == 0


def test_page_stalled_head_lets_a_preempted_request_resume(models):
    """An 11-page pool, 2 slots: A (4 pages) and X (3) decode at priority
    0; a priority-5 B (4 pages) preempts one of them, whose pages stay
    with it; a priority-5 C needs 5.  When the other finishes, C still
    waits for pages with a slot free, so the preempted request resumes
    ahead of it (a swap-in needs no pages), finishes and frees its
    pages; then C admits.  Every stream equals ``generate()`` and no page
    leaks."""
    cfg, params = models["hybrid"]
    cfg = dataclasses.replace(cfg, kv_pool_pages=11)
    eng = _engine(params, cfg, capacity=2)
    spec = {"a": (20, 12, 0), "x": (9, 10, 0), "b": (9, 20, 5), "c": (30, 6, 5)}
    prompts = {k: _prompt(42 + i, t) for i, (k, (t, _, _)) in enumerate(spec.items())}
    rid = {}
    for k in ("a", "x"):
        rid[k] = eng.submit(_req(prompts[k], 1 + len(rid), spec[k][1], priority=0))
    while any(t.status.value != "decode" for t in eng._slots.values()) or len(eng._slots) < 2:
        eng.step()
    for k in ("b", "c"):
        rid[k] = eng.submit(_req(prompts[k], 1 + len(rid), spec[k][1], priority=5))
    trackers = {t.request_id: t for t in eng._slots.values()}
    resumed_before_c = False
    while eng.pending:
        eng.step()
        resident = {t.request_id for t in eng._slots.values()}
        queued = {t.request_id for t in eng.scheduler}
        resumed_before_c |= any(t.preempted and t.request_id in resident
                                for t in trackers.values()) and rid["c"] in queued
    assert eng.metrics.preemptions == 1 and resumed_before_c
    for i, k in enumerate(spec):
        want = _solo(params, cfg, prompts[k], 1 + i, spec[k][1], 2)
        assert eng.results[rid[k]].new_tokens.tolist() == want, k
    assert eng.page_pool.pages_in_use == 0


def test_restore_matches_jax():
    cfg = ModelConfig(**TINY)
    jcfg = JaxConfig(**TINY)
    rng = np.random.default_rng(9)
    pool, jpool = state_cache.init_pool(cfg, 3), jsc.init_pool(jcfg, 3)
    blocks = [rng.standard_normal(t[:, :1].shape).astype(np.float32)
              for t in pool["state"]["blocks"]]
    logits = rng.standard_normal((1, cfg.vocab_size_padded)).astype(np.float32)
    state_cache.restore(pool, 1, {"blocks": tuple(torch.from_numpy(b) for b in blocks)},
                        torch.from_numpy(logits), 7, max_new=12, top_k=3, temperature=0.5,
                        eos_id=4)
    jpool = jsc.restore(jpool, jnp.int32(1), {"blocks": tuple(jnp.asarray(b) for b in blocks)},
                        jnp.asarray(logits), jnp.zeros((2,), jnp.uint32), 7, 12, 3, 0.5, 4)
    for a, b in zip(pool["state"]["blocks"], jpool["state"]["blocks"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(pool["logits"].numpy(), np.asarray(jpool["logits"]))
    for k, v in pool["meta"].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jpool["meta"][k]), err_msg=k)


# ------------------------------------------------------------------ SRPT


def test_srpt_nearly_done_prompt_finishes_before_fresh_long(models):
    """A prompt with two chunks left takes the grants ahead of a fresh
    8-chunk prompt, and streams its first token before that one has run
    a chunk."""
    cfg, params = models["mamba2"]
    cfg = dataclasses.replace(cfg, prefill_schedule="srpt")
    eng = ServingEngine(params, cfg, capacity=2, max_top_k=5, tokens_per_tick=1,
                        device="cpu")
    pa, pb = _prompt(1, 53), _prompt(2, 128)
    ra = eng.submit(_req(pa, 0, 3))
    eng.step()
    eng.step()
    by_rid = {t.request_id: t for t in eng._slots.values()}
    assert by_rid[ra].chunks_done == 2
    rb = eng.submit(_req(pb, 1, 3))
    events = []
    while not any(ev.request_id == ra for ev in events):
        events = eng.step()
        by_rid.update({t.request_id: t for t in eng._slots.values()})
    assert by_rid[rb].chunks_done == 0
    while eng.pending:
        eng.step()
    assert eng.results[ra].new_tokens.tolist() == _solo(params, cfg, pa, 0, 3, 2)
    assert eng.results[rb].new_tokens.tolist() == _solo(params, cfg, pb, 1, 3, 2)


def test_srpt_starvation_guard_grants_passed_over_prompt(models):
    cfg, params = models["mamba2"]
    cfg = dataclasses.replace(cfg, prefill_schedule="srpt")
    eng = ServingEngine(params, cfg, capacity=4, max_top_k=5, tokens_per_tick=1,
                        device="cpu")
    assert eng.SRPT_STARVATION_GRANTS == 4
    pa = _prompt(1, 128)
    ra = eng.submit(_req(pa, 0, 2))
    eng.step()
    shorts = [eng.submit(_req(_prompt(10 + i, 21), 10 + i, 2)) for i in range(2)]
    by_rid = {t.request_id: t for t in eng._slots.values()}
    for _ in range(4):
        eng.step()
        by_rid.update({t.request_id: t for t in eng._slots.values()})
    assert by_rid[ra].chunks_done == 1 and by_rid[ra].prefill_skipped == 4
    assert all(by_rid[s].chunks_done == 2 for s in shorts)
    rc = eng.submit(_req(_prompt(30, 21), 30, 2))
    eng.step()
    by_rid.update({t.request_id: t for t in eng._slots.values()})
    assert (by_rid[ra].chunks_done, by_rid[ra].prefill_skipped) == (2, 0)
    assert by_rid[rc].chunks_done == 0
    while eng.pending:
        eng.step()
    assert eng.results[ra].new_tokens.tolist() == _solo(params, cfg, pa, 0, 2, 4)


# ------------------------------------------------------------ telemetry


def test_records_stamp_priority_and_preemptions(models, tmp_path):
    cfg, params = models["mamba2"]
    path = tmp_path / "p.jsonl"
    metrics = ServingMetrics(1, jsonl_path=str(path))
    eng = _engine(params, cfg, metrics=metrics)
    eng.submit(_req(_prompt(40, 9), 100, 8))
    eng.step()
    eng.submit(_req(_prompt(41, 7), 101, 3, priority=2))
    while eng.pending:
        eng.step()
    lines = load_jsonl(str(path))
    reqs = {r["request_id"]: r for r in lines if r["kind"] == "request"}
    assert reqs[0]["preemptions"] == 1 and "priority" not in reqs[0]
    assert reqs[1]["priority"] == 2 and "preemptions" not in reqs[1]
    ticks = [r for r in lines if r["kind"] == "serving_tick"]
    assert sum(t.get("preemptions", 0) for t in ticks) == 1
    assert sum("preemptions" in t for t in ticks) == 1
    assert metrics.summary()["preemptions"] == 1
    assert build_report(lines)["serving"]["preemptions"] == \
        jax_build_report(lines)["serving"]["preemptions"] == 1
