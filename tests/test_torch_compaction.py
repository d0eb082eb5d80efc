"""The port's occupancy-adaptive compacted ticks, on the CPU.

* With ``cfg.tick_compaction`` on, every stream is bit-identical (fp32,
  sampling on) to the compaction-off engine: mamba2, mamba1, a hybrid
  with a chunked long prompt, an int8 hybrid, with prefix-cache warm
  hits and with a preemption and resume.
* The lane bucket grows at once and shrinks only after
  ``compaction_hysteresis_ticks``; a launch takes at least
  ``COMPACT_MIN_LANES`` lanes.
* Off by default: no ``compaction_width`` stamp, the summary's section
  None, and the records' bytes those of an engine built before the
  feature (the same keys in the same order).
* Records bill ``slot_lanes`` at the launched width; the summary's
  histogram and lanes saved, and the port's report against the JAX
  ``scripts/obs_report.py`` on the same stream.
* ``gather_slots``/``scatter_slots`` equal JAX's on the same numpy rows,
  pad lanes repeating a slot included.
"""

import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_distributed_tpu.serving import state_cache as jsc
from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.models.lm import init_lm_params
from mamba_distributed_tpu_torch.obs import load_jsonl
from mamba_distributed_tpu_torch.obs.report import build_report
from mamba_distributed_tpu_torch.serving import GenerationRequest, ServingEngine
from mamba_distributed_tpu_torch.serving import state_cache
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
              kv_page_tokens=8, kv_slot_tokens=128)
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
        cfg = ModelConfig(**kw)
        out[name] = (cfg, init_lm_params(cfg, torch.Generator().manual_seed(0)))
    return out


def mixed_requests(n=5, seed=0, long_len=None):
    """Mixed lengths and budgets, so occupancy falls as streams finish;
    optionally one chunked long prompt."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = long_len if long_len is not None and i == 1 else int(rng.integers(5, 30))
        reqs.append(GenerationRequest(prompt_ids=rng.integers(0, 64, plen),
                                      max_new_tokens=int(rng.integers(6, 20)), top_k=5,
                                      seed=100 + i))
    return reqs


def _engine(params, cfg, capacity=8, **kw):
    kw.setdefault("tokens_per_tick", 2)
    return ServingEngine(params, cfg, capacity=capacity, max_top_k=5, device="cpu", **kw)


def streams(results):
    return [r.new_tokens.tolist() for r in results]


def run_pair(params, cfg, make_reqs, capacity=8):
    off = streams(_engine(params, cfg, capacity).run(make_reqs()))
    eng = _engine(params, dataclasses.replace(cfg, tick_compaction=True), capacity)
    return off, streams(eng.run(make_reqs())), eng


# ---------------------------------------------------------------- parity


@pytest.mark.parametrize("layer", list(LAYERS))
def test_compaction_parity(models, layer):
    cfg, params = models[layer]
    long_len = 3 * CHUNK + 5 if layer in ("hybrid", "int8") else None
    off, on, eng = run_pair(params, cfg, lambda: mixed_requests(5, long_len=long_len))
    assert on == off
    hist = eng.metrics.summary()["compaction"]["bucket_histogram"]
    assert any(int(w) < 8 for w in hist), hist
    if eng.hybrid:
        assert eng.page_pool.pages_in_use == 0


def test_compaction_parity_prefix_warm(models):
    """Full and partial prefix hits on a compacted engine: the streams of
    a cold and a warm run equal the cache-off, compaction-off engine's."""
    cfg, params = models["mamba2"]
    preamble = np.arange(1, 1 + 2 * CHUNK) % 64

    def reqs():
        return [GenerationRequest(prompt_ids=np.concatenate([preamble, np.full(4, 3 + i)]),
                                  max_new_tokens=10, top_k=5, seed=50 + i) for i in range(3)]

    baseline = streams(_engine(params, cfg, 4).run(reqs()))
    eng = _engine(params, dataclasses.replace(cfg, tick_compaction=True,
                                              prefix_cache_entries=64), 4)
    assert streams(eng.run(reqs())) == baseline
    assert streams(eng.run(reqs())) == baseline
    assert eng.metrics.prefix_full_hits > 0
    assert eng.metrics.summary()["compaction"]["ticks_compacted"] > 0


@pytest.mark.parametrize("layer", ["mamba2", "hybrid"])
def test_compaction_preempt_resume_parity(models, layer):
    cfg, params = models[layer]

    def drive(run_cfg):
        eng = _engine(params, run_cfg, capacity=4)
        lo = [eng.submit(GenerationRequest(prompt_ids=np.arange(1 + i, 9 + i),
                                           max_new_tokens=6 + 8 * i, top_k=5, seed=1 + i))
              for i in range(4)]
        for _ in range(2):
            eng.step()
        hi = eng.submit(GenerationRequest(prompt_ids=np.arange(2, 10), max_new_tokens=6,
                                          top_k=5, seed=9, priority=5))
        while eng.pending:
            eng.step()
        return [eng.results[i].new_tokens.tolist() for i in lo + [hi]], eng

    off, off_eng = drive(cfg)
    on, on_eng = drive(dataclasses.replace(cfg, tick_compaction=True))
    assert off_eng.metrics.preemptions == on_eng.metrics.preemptions == 1
    assert on == off
    assert on_eng.metrics.summary()["compaction"]["ticks_compacted"] > 0


# ------------------------------------------------------------ buckets


def test_bucket_grows_immediately_shrinks_with_hysteresis(models):
    cfg, params = models["mamba2"]
    cfg = dataclasses.replace(cfg, tick_compaction=True, compaction_hysteresis_ticks=3)
    eng = _engine(params, cfg, tokens_per_tick=8)
    eng.submit(GenerationRequest(prompt_ids=np.arange(1, 9), max_new_tokens=40, top_k=5,
                                 seed=1))
    eng.step()
    assert eng._compact_bucket == 1
    for i in range(2):
        eng.submit(GenerationRequest(prompt_ids=np.arange(2, 10), max_new_tokens=2, top_k=5,
                                     seed=2 + i))
    eng.step()
    assert eng._compact_bucket == 4
    widths = []
    while eng.pending:
        eng.step()
        widths.append(eng._compact_bucket)
    assert widths[:2] == [4, 4] and 1 in widths, widths
    off = _engine(params, dataclasses.replace(cfg, tick_compaction=False), tokens_per_tick=8)
    got = off.run([GenerationRequest(prompt_ids=np.arange(1, 9), max_new_tokens=40, top_k=5,
                                     seed=1)])
    assert eng.results[0].new_tokens.tolist() == got[0].new_tokens.tolist()


def test_off_by_default_byte_stable(models, tmp_path):
    """Compaction off (the default): no stamp, the summary's section None,
    and each tick record has exactly the keys, in order, of an engine
    before the feature."""
    cfg, params = models["hybrid"]
    assert cfg.tick_compaction is False and cfg.compaction_hysteresis_ticks == 4
    path = tmp_path / "off.jsonl"
    metrics = ServingMetrics(4, jsonl_path=str(path))
    _engine(params, cfg, 4, metrics=metrics).run(mixed_requests(3))
    assert metrics.summary()["compaction"] is None
    keys = ["kind", "tick", "occupied", "capacity", "queue_depth", "tokens_emitted", "tick_ms",
            "prefill_stall_ms", "prefill_chunk_tokens", "prefill_chunk_ms",
            "prefill_oneshot_tokens", "useful_tokens", "wasted_token_lanes",
            "goodput_tokens_per_sec", "serving_mfu", "traces", "kv_pages_used",
            "kv_pages_capacity", "kv_page_allocs", "kv_page_frees"]
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        if rec["kind"] == "serving_tick":
            assert list(rec) == keys


def test_goodput_bills_launched_lanes_and_report_matches_jax(models, tmp_path):
    """One live slot in 8: every tick launches ``COMPACT_MIN_LANES``
    lanes and bills 2 lanes x 4 sub-steps; the summary's histogram and
    lanes saved follow; the report equals the JAX script's."""
    cfg, params = models["mamba2"]
    cfg = dataclasses.replace(cfg, tick_compaction=True)
    path = tmp_path / "on.jsonl"
    metrics = ServingMetrics(8, jsonl_path=str(path))
    eng = _engine(params, cfg, metrics=metrics, tokens_per_tick=4)
    assert eng.COMPACT_MIN_LANES == 2
    eng.run([GenerationRequest(prompt_ids=np.arange(1, 9), max_new_tokens=12, top_k=5,
                               seed=1)])
    lines = load_jsonl(str(path))
    ticks = [r for r in lines if r["kind"] == "serving_tick"]
    assert ticks and all(t["compaction_width"] == 2 for t in ticks)
    steady = [t for t in ticks if not t["prefill_oneshot_tokens"]
              and not t["prefill_chunk_tokens"]]
    assert steady and all(t["useful_tokens"] + t["wasted_token_lanes"] == 8 for t in steady)
    comp = metrics.summary()["compaction"]
    assert comp == {"ticks_compacted": len(ticks), "recompiles": 1,
                    "bucket_histogram": {"2": len(ticks)},
                    "lanes_saved": len(ticks) * (8 - 2) * 4}
    ours, ref = build_report(lines), jax_build_report(lines)
    assert ours["serving"]["compaction"] == ref["serving"]["compaction"]
    assert ours["serving"]["goodput"] == ref["serving"]["goodput"]
    assert ours["serving"]["compaction"]["min_width"] == 2


# ------------------------------------------------------- gather, scatter


def test_gather_scatter_match_jax():
    cfg = ModelConfig(**TINY)
    rng = np.random.default_rng(3)
    pool = state_cache.init_pool(cfg, 6)
    rows = {"blocks": tuple(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
                            for t in pool["state"]["blocks"]),
            "logits": torch.from_numpy(rng.standard_normal(pool["logits"].shape)
                                       .astype(np.float32)),
            "meta": {k: torch.from_numpy(rng.integers(0, 5, v.shape).astype(
                v.numpy().dtype)) for k, v in pool["meta"].items()}}
    jrows = {"blocks": tuple(jnp.asarray(t.numpy()) for t in rows["blocks"]),
             "logits": jnp.asarray(rows["logits"].numpy()),
             "meta": {k: jnp.asarray(v.numpy()) for k, v in rows["meta"].items()}}
    idx = np.array([1, 4, 5, 1])  # lane 3 pads with a repeat of slot 1
    compact = state_cache.gather_slots(rows, torch.from_numpy(idx))
    jcompact = jsc.gather_slots(jrows, jnp.asarray(idx))
    for a, b in zip(jax_leaves(compact), jax_leaves(jcompact)):
        np.testing.assert_array_equal(a, b)
    # the tick's output: every lane changed; slots 1, 4, 5 live
    out = {"blocks": tuple(t * 2 + 1 for t in compact["blocks"]),
           "logits": compact["logits"] - 3,
           "meta": {k: ~v if v.dtype == torch.bool else v + 1
                    for k, v in compact["meta"].items()}}
    jout = {"blocks": tuple(jnp.asarray(t.numpy()) for t in out["blocks"]),
            "logits": jnp.asarray(out["logits"].numpy()),
            "meta": {k: jnp.asarray(v.numpy()) for k, v in out["meta"].items()}}
    inv = np.array([0, 0, 0, 0, 1, 2])
    touched = np.array([False, True, False, False, True, True])
    assert state_cache.scatter_slots(rows, out, torch.from_numpy(inv),
                                     torch.from_numpy(touched)) is rows
    jres = jsc.scatter_slots(jrows, jout, jnp.asarray(inv), jnp.asarray(touched))
    for a, b in zip(jax_leaves(rows), jax_leaves(jres)):
        np.testing.assert_array_equal(a, b)


def jax_leaves(tree) -> list:
    """The leaves of a {"blocks", "logits", "meta"} tree as numpy arrays."""
    return ([np.asarray(t) for t in tree["blocks"]] + [np.asarray(tree["logits"])]
            + [np.asarray(tree["meta"][k]) for k in sorted(tree["meta"])])
