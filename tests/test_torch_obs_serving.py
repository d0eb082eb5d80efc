"""The serving engine's telemetry against the JAX package's, on the CPU
(2 layers, d_model 32, fp32).

* ``ServingMetrics`` fed the same ``record_*`` calls as the JAX
  ``ServingMetrics`` writes the same jsonl records, byte for byte, and
  gives the same ``summary()`` and ``histogram_dicts()``: plain, hybrid
  (page gauges), int8 (the memory stamp) and unpriced (no peak).
* The port's Mamba-2 engine and the JAX Mamba-2 engine on the same
  weights and greedy requests write tick and request records that agree
  in everything but times: occupancy, queue depth, ``tokens_emitted``,
  the chunk and one-shot prefill tokens, useful tokens and wasted lanes,
  the live trace count, the per-request token counts and ITL sample
  counts, and the summary's counts.
* The hybrid engine's page gauges balance and no page leaks; the int8
  engine stamps every tick with its dtype pair, ``ops/quant.param_bytes``
  of its weights and its KV pool's bytes; a bf16 or pure-SSM engine's
  records carry none of these fields.
* Streams are the same with telemetry on and off; spans carry the
  request trace ids; the Chrome trace links them.
* The JAX ``scripts/obs_report.py`` reads the port's files and reports
  the request percentiles of the port's own report and histograms.
* ``ops/quant.assert_stream_close`` reports a greedy disagreement to the
  port's sentinel and ``ServingMetrics`` as the JAX checker does.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from mamba_distributed_tpu.config import ModelConfig as JaxConfig
from mamba_distributed_tpu.models import init_lm_params as jax_init
from mamba_distributed_tpu.serving import GenerationRequest as JaxRequest
from mamba_distributed_tpu.serving import ServingEngine as JaxEngine
from mamba_distributed_tpu.utils.metrics import ServingMetrics as JaxMetrics
from mamba_distributed_tpu_torch import convert
from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.models.lm import init_lm_params
from mamba_distributed_tpu_torch.obs import (
    SLOMonitor,
    SpanTracer,
    TickRegressionDetector,
    export_chrome_trace,
    load_jsonl,
)
from mamba_distributed_tpu_torch.obs.report import build_report
from mamba_distributed_tpu_torch.ops.quant import param_bytes
from mamba_distributed_tpu_torch.serving import GenerationRequest, ServingEngine
from mamba_distributed_tpu_torch.utils.metrics import ServingMetrics, emit_bench_record

pytestmark = pytest.mark.torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

from obs_report import build_report as jax_build_report  # noqa: E402

TINY = dict(d_model=32, n_layer=2, vocab_size=64, headdim=8, chunk_size=16, d_state=16,
            compute_dtype="float32", prefill_chunk_tokens=16)
HYBRID = dict(TINY, attn_layer_idx=(1,), attn_num_heads=4, attn_num_kv_heads=2,
              kv_page_tokens=8, kv_slot_tokens=64, prefill_tokens_per_tick=16)
INT8 = dict(HYBRID, kv_page_dtype="int8", serving_weight_dtype="int8")


def _prompt(seed, t):
    return np.random.default_rng(seed).integers(0, 64, t).astype(np.int64)


# ------------------------------------------------------ the counters alone

def _feed(m, kind):
    rng = np.random.default_rng(5)
    if kind != "unpriced":
        m.configure_goodput(2.5e6, 3.1e6, 1e12)
    if kind == "int8":
        m.configure_memory(12345, 6789, "int8", "int8")
        m.record_greedy_disagreement(2)
    for i in range(7):
        m.record_prefill(10 + i, 0.002 * (i + 1))
        m.record_prefill_chunk(16, 0.001 * (i + 2))
        m.record_prefill_stall(float(rng.uniform(0.001, 0.01)))
        m.record_queue_wait(float(rng.uniform(0, 0.02)))
        m.record_ttft(float(rng.uniform(0.01, 0.05)))
        m.record_itl(float(rng.uniform(0.001, 0.004)), int(rng.integers(1, 4)))
        tick = dict(occupied=1 + i % 3, queue_depth=3 - i // 3,
                    tokens_emitted=int(rng.integers(0, 9)),
                    dt_s=float(rng.uniform(0.002, 0.01)),
                    prefill_stall_ms=float(rng.uniform(0, 3)) if i % 2 else 0.0,
                    prefill_chunk_tokens=16 * (i % 2), prefill_chunk_ms=1.25 * (i % 2),
                    prefill_real_tokens=11 * (i % 2), prefill_oneshot_tokens=5 * (i % 3 == 0),
                    prefill_oneshot_lanes=8 * (i % 3 == 0), slot_lanes=8,
                    traces=[f"t-{j}" for j in range(1 + i % 3)])
        if kind in ("hybrid", "int8"):
            tick.update(kv_pages_used=3 + i, kv_pages_capacity=32,
                        kv_page_allocs=2 * (i % 2), kv_page_frees=i % 3)
        if kind == "int8":
            tick.update(quantized={"weights": "int8", "kv": "int8"}, weight_bytes=12345,
                        page_pool_bytes=6789)
        m.record_tick(**tick)
        if i % 2:
            m.record_request({"request_id": i, "trace_id": f"t-{i}", "prompt_tokens": 9,
                              "new_tokens": 4, "finish_reason": "length",
                              "queue_wait_ms": 1.5, "ttft_ms": 12.25, "e2e_ms": 30.0,
                              "itl_hist": m.itl_ms.to_dict()})


@pytest.mark.parametrize("kind", ["plain", "hybrid", "int8", "unpriced"])
def test_serving_metrics_equal_jax(tmp_path, kind):
    ours = ServingMetrics(4, jsonl_path=str(tmp_path / "p.jsonl"))
    ref = JaxMetrics(4, jsonl_path=str(tmp_path / "j.jsonl"))
    _feed(ours, kind)
    _feed(ref, kind)
    assert ours.summary() == ref.summary()
    assert json.dumps(ours.summary(), sort_keys=True) == json.dumps(ref.summary(), sort_keys=True)
    assert ours.histogram_dicts() == ref.histogram_dicts()
    assert (tmp_path / "p.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()
    recs = load_jsonl(str(tmp_path / "p.jsonl"))
    ticks = [r for r in recs if r["kind"] == "serving_tick"]
    # a feature that is off leaves its fields out of the record (not null)
    assert all(("kv_pages_used" in r) == (kind in ("hybrid", "int8")) for r in ticks)
    assert all(("quantized" in r) == (kind == "int8") for r in ticks)
    assert all((r["serving_mfu"] is None) == (kind == "unpriced") for r in ticks)


def test_metrics_preserve_history_and_bench_record(tmp_path, capsys):
    path = str(tmp_path / "s.jsonl")
    ServingMetrics(2, jsonl_path=path).record_request({"request_id": 0})
    again = ServingMetrics(2, jsonl_path=path)
    again.preserve_history()
    again.record_request({"request_id": 1})
    assert [r["request_id"] for r in load_jsonl(path)] == [0, 1]
    fresh = ServingMetrics(2, jsonl_path=path)  # truncates on its first write
    fresh.record_request({"request_id": 2})
    assert [r["request_id"] for r in load_jsonl(path)] == [2]
    emit_bench_record({"a": 1}, str(tmp_path / "b.json"))
    assert capsys.readouterr().out == '{"a": 1}\n'
    assert (tmp_path / "b.json").read_text() == '{"a": 1}\n'


# ------------------------------------------- the engines against each other

_TIME_FREE_TICK = ("tick", "occupied", "capacity", "queue_depth", "tokens_emitted",
                   "prefill_chunk_tokens", "prefill_oneshot_tokens", "useful_tokens",
                   "wasted_token_lanes")


def test_mamba2_engine_records_equal_the_jax_engine(tmp_path):
    jcfg = JaxConfig(**TINY)
    jparams = jax_init(jax.random.PRNGKey(3), jcfg)
    cfg = ModelConfig(**TINY)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    spec = [(5, 9), (12, 4), (40, 7), (33, 5), (3, 6)]  # one-shot and chunked
    prompts = [_prompt(10 + i, t) for i, (t, _) in enumerate(spec)]
    jm = JaxMetrics(2, jsonl_path=str(tmp_path / "j.jsonl"))
    jeng = JaxEngine(jparams, jcfg, capacity=2, max_top_k=1, tokens_per_tick=4, metrics=jm)
    jres = jeng.run([JaxRequest(prompt_ids=p.astype(np.int32), max_new_tokens=n, top_k=1)
                     for p, (_, n) in zip(prompts, spec)])
    pm = ServingMetrics(2, jsonl_path=str(tmp_path / "p.jsonl"))
    eng = ServingEngine(params, cfg, capacity=2, max_top_k=1, tokens_per_tick=4,
                        device="cpu", metrics=pm)
    res = eng.run([GenerationRequest(prompt_ids=p, max_new_tokens=n, top_k=1)
                   for p, (_, n) in zip(prompts, spec)])
    assert [r.new_tokens.tolist() for r in res] == [np.asarray(r.new_tokens).tolist()
                                                    for r in jres]
    ours, ref = load_jsonl(str(tmp_path / "p.jsonl")), load_jsonl(str(tmp_path / "j.jsonl"))
    pt, jt = ([r for r in x if r["kind"] == "serving_tick"] for x in (ours, ref))
    assert len(pt) == len(jt) > 3
    for a, b in zip(pt, jt):
        assert {k: a[k] for k in _TIME_FREE_TICK} == {k: b[k] for k in _TIME_FREE_TICK}
        assert set(a) == set(b) and len(a["traces"]) == len(b["traces"])
    pr, jr = ([r for r in x if r["kind"] == "request"] for x in (ours, ref))
    assert [(r["request_id"], r["prompt_tokens"], r["new_tokens"], r["finish_reason"],
             r["itl_hist"]["count"]) for r in pr] == [
        (r["request_id"], r["prompt_tokens"], r["new_tokens"], r["finish_reason"],
         r["itl_hist"]["count"]) for r in jr]
    assert [set(r) for r in pr] == [set(r) for r in jr]
    s, j = pm.summary(), jm.summary()
    for key in ("ticks", "decode_tokens", "prefills", "prefill_tokens", "prefill_chunks",
                "prefill_chunk_tokens", "finished_requests", "peak_queue_depth",
                "mean_slot_occupancy", "mean_queue_depth", "memory", "kv_pages"):
        assert s[key] == j[key], key
    for key in ("useful_tokens", "wasted_token_lanes", "useful_fraction"):
        assert s["goodput"][key] == j["goodput"][key], key
    for key in ("queue_wait_ms", "ttft_ms", "itl_ms"):
        assert s["latency"][key]["count"] == j["latency"][key]["count"], key
    assert s["goodput"]["serving_mfu"] is None  # no card, no peak
    assert set(s) == set(j)


@pytest.fixture(scope="module", params=["bf16", "int8"])
def hybrid_run(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    cfg = ModelConfig(**(INT8 if request.param == "int8" else HYBRID))
    params = init_lm_params(cfg, torch.Generator().manual_seed(3))
    reqs = lambda: [GenerationRequest(prompt_ids=_prompt(80 + i, t), max_new_tokens=n,
                                      top_k=5, temperature=0.8, seed=20 + i)
                    for i, (t, n) in enumerate(((9, 6), (27, 5), (53, 7), (4, 3)))]
    plain = ServingEngine(params, cfg, capacity=2, max_top_k=5, tokens_per_tick=2,
                          device="cpu").run(reqs())
    metrics = ServingMetrics(2, jsonl_path=str(tmp / "s.jsonl"))
    eng = ServingEngine(params, cfg, capacity=2, max_top_k=5, tokens_per_tick=2, device="cpu",
                        metrics=metrics, tracer=SpanTracer(str(tmp / "e.jsonl")))
    traced = eng.run(reqs())
    return request.param, eng, plain, traced, load_jsonl(str(tmp / "s.jsonl"))


def test_hybrid_page_gauges_and_int8_stamps(hybrid_run):
    kind, eng, plain, traced, recs = hybrid_run
    assert [r.new_tokens.tolist() for r in traced] == [r.new_tokens.tolist() for r in plain]
    ticks = [r for r in recs if r["kind"] == "serving_tick"]
    assert eng.page_pool.pages_in_use == 0
    assert sum(r["kv_page_allocs"] for r in ticks) == sum(r["kv_page_frees"] for r in ticks) > 0
    assert all(r["kv_pages_capacity"] == eng.page_pool.num_pages for r in ticks)
    assert max(r["kv_pages_used"] for r in ticks) == eng.metrics.peak_kv_pages_used > 0
    pool = sum(t.numel() * t.element_size() for t in eng.pool["state"]["attn_blocks"])
    s = eng.metrics.summary()
    if kind == "int8":
        for r in ticks:
            assert r["quantized"] == {"weights": "int8", "kv": "int8"}
            assert r["weight_bytes"] == param_bytes(eng._params)
            assert r["page_pool_bytes"] == pool
        assert s["memory"] == {"weight_bytes": param_bytes(eng._params), "page_pool_bytes": pool,
                               "weight_dtype": "int8", "kv_dtype": "int8",
                               "greedy_token_disagreements": 0}
    else:
        assert not any(k in r for r in ticks for k in ("quantized", "weight_bytes",
                                                        "page_pool_bytes"))
        assert s["memory"] is None
    assert s["kv_pages"]["allocs"] == s["kv_pages"]["frees"]
    assert sum(r["tokens_emitted"] for r in ticks) == sum(len(r.new_tokens) for r in traced)


def test_streams_equal_with_telemetry_on_and_off(tmp_path):
    cfg = ModelConfig(**TINY)
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))
    spec = [(5, 9, None), (40, 6, None), (12, 3, None), (70, 7, None), (3, 11, 17)]
    reqs = lambda: [GenerationRequest(prompt_ids=_prompt(i, t), max_new_tokens=n, top_k=5,
                                      temperature=0.8, eos_id=eos, seed=100 + i,
                                      trace_id="given-trace" if i == 2 else None)
                    for i, (t, n, eos) in enumerate(spec)]
    kw = dict(capacity=3, max_top_k=5, tokens_per_tick=2, prefill_tokens_per_tick=16,
              device="cpu")
    plain = ServingEngine(params, cfg, **kw).run(reqs())
    tracer = SpanTracer(str(tmp_path / "e.jsonl"))
    slo = SLOMonitor(ttft_p95_ms=1e-3, itl_p95_ms=1e6, window=2, tracer=tracer)
    det = TickRegressionDetector(factor=1.5, warmup=1, tracer=tracer)
    metrics = ServingMetrics(3, jsonl_path=str(tmp_path / "s.jsonl"))
    eng = ServingEngine(params, cfg, metrics=metrics, tracer=tracer, slo=slo,
                        tick_regression=det, **kw)
    submitted = reqs()
    ids = [eng.submit(r) for r in submitted]
    traces = {t.request_id: t.trace_id for t in eng.scheduler}
    n_events = sum(len(eng.step()) for _ in iter(lambda: eng.pending, 0))
    assert [eng.results[i].new_tokens.tolist() for i in ids] == [r.new_tokens.tolist()
                                                                 for r in plain]
    assert traces[ids[2]] == "given-trace" and len(set(traces.values())) == 5
    recs = load_jsonl(str(tmp_path / "s.jsonl"))
    ticks = [r for r in recs if r["kind"] == "serving_tick"]
    assert sum(r["tokens_emitted"] for r in ticks) == n_events == sum(n for _, n, _ in spec) - (
        spec[4][1] - len(plain[4].new_tokens))
    assert sorted((r["request_id"], r["trace_id"]) for r in recs if r["kind"] == "request") == \
        sorted(traces.items())
    assert all("kv_pages_used" not in r and "quantized" not in r for r in ticks)
    events = load_jsonl(str(tmp_path / "e.jsonl"))
    spans = [r for r in events if r["kind"] == "span"]
    names = {r["name"] for r in spans}
    assert {"serving_admit", "serving_prefill", "serving_prefill_chunk", "serving_tick"} <= names
    chunked = {r["trace"] for r in spans if r["name"] == "serving_prefill_chunk"}
    assert chunked == {traces[ids[1]], traces[ids[3]]}
    assert all(r["traces"] == sorted(r["traces"]) for r in spans if r["name"] == "serving_tick")
    evs = [r["name"] for r in events if r["kind"] == "event"]
    assert evs[0] == "slo_config" and "slo_breach" in evs
    assert slo.summary()["metrics"]["ttft_ms"]["requests"] == 5 and det.ticks == len(ticks)
    meta = export_chrome_trace([str(tmp_path / "e.jsonl"), str(tmp_path / "s.jsonl")],
                               str(tmp_path / "trace.json"))
    assert meta["linked_requests"] == 5 and meta["unaligned_streams"] == 0


def test_jax_obs_report_reads_the_port_files(tmp_path):
    cfg = ModelConfig(**HYBRID)
    params = init_lm_params(cfg, torch.Generator().manual_seed(1))
    tracer = SpanTracer(str(tmp_path / "e.jsonl"))
    metrics = ServingMetrics(2, jsonl_path=str(tmp_path / "s.jsonl"))
    eng = ServingEngine(params, cfg, capacity=2, max_top_k=5, tokens_per_tick=2, device="cpu",
                        metrics=metrics, tracer=tracer,
                        slo=SLOMonitor(ttft_p95_ms=50.0, window=4, tracer=tracer))
    eng.run([GenerationRequest(prompt_ids=_prompt(i, t), max_new_tokens=n, top_k=5, seed=i)
             for i, (t, n) in enumerate(((9, 6), (27, 5), (53, 7), (4, 3), (17, 4)))])
    paths = [str(tmp_path / "e.jsonl"), str(tmp_path / "s.jsonl")]
    events = [r for p in paths for r in load_jsonl(p)]
    ref, ours = jax_build_report(events), build_report(events)
    for section in ("spans", "serving", "requests"):
        for key, val in ours[section].items():
            assert val == ref[section][key], (section, key)
    # the merged per-request ITL histograms are the engine's own histogram
    h = metrics.itl_ms.summary()
    for q in ("count", "p50", "p95", "p99", "max"):
        assert ref["requests"]["itl_ms"][q] == h[q], q
    assert ref["requests"]["count"] == metrics.finished_requests == 5
    assert ref["serving"]["kv_pages"]["allocs"] == ref["serving"]["kv_pages"]["frees"]
    assert ref["slo"]["metrics"]["ttft_ms"]["requests"] == 5


def test_quant_stream_check_feeds_the_sentinel_and_metrics(tmp_path):
    """``ops/quant.assert_stream_close`` reports a disagreement to the
    port's sentinel and ServingMetrics as the JAX checker does to JAX's."""
    from mamba_distributed_tpu.obs import DivergenceSentinel as JaxSentinel
    from mamba_distributed_tpu.ops.quant import assert_stream_close as jax_check
    from mamba_distributed_tpu_torch.obs import DivergenceSentinel
    from mamba_distributed_tpu_torch.ops.quant import assert_stream_close

    got, want = [3, 4, 5, 9, 9], [3, 4, 5, 6, 7]
    out = []
    for check, sentinel, metrics in (
            (assert_stream_close, DivergenceSentinel(None), ServingMetrics(2)),
            (jax_check, JaxSentinel(None), JaxMetrics(2))):
        n = check(got, want, min_token_agreement=0.5, sentinel=sentinel, metrics=metrics,
                  label="int8")
        out.append((n, sentinel.flight.events(), metrics.summary()["goodput"],
                    metrics.greedy_token_disagreements))
    assert out[0] == out[1] and out[0][0] == 2 and out[0][3] == 2
    assert out[0][1] == [{"kind": "quant_token_disagreement", "label": "int8",
                          "first_divergence": 3, "compared": 5, "got": 9, "want": 6}]
