"""The port's serving meshes (``parallel/mesh.serving_mesh``: tensor-parallel
weights over ``model``, data-sharded slot and page pools over ``data``, the
layer stacks over ``stage``) against the JAX package, on the CPU.

In the main process, with no engine:

* ``serving_param_specs`` (plain, int8 and LoRA-attached trees, model 2
  and 4, stage 2), ``slot_pool_specs`` (with and without a stage axis),
  ``page_shard_ranges``, ``hybrid_pool_pages`` and both validators equal
  the JAX functions leaf for leaf and message for message; the sharded
  ``PagePool`` confines each shard to its pages; ``serving_mesh``'s
  refusals; a serving shard's int8 quantization equals the cut of the
  whole tree's; ``pipelined_decode_layers``' two refusals; an engine with
  every shard count at 1 writes no mesh stamp and no pipeline section.

One module fixture spawns ONE gloo world of four processes (this file is
its worker) that runs every mesh case, while the main process computes
the JAX references on one device:

* (2,2) on mamba2, mamba1 and hybrid, (1,4) on mamba2, (1,2,1) on mamba2
  with compaction and the microbatched decode clock (two replicas of the
  two-rank mesh), (2,2,1) on mamba2 and (1,2,2) on the hybrid, and at
  (2,2) speculation (K = 2), int8 hybrid, a warm prefix hit on a
  compacted hybrid and LoRA with two adapters, and (1,2,1) on a hybrid
  whose layer plan crosses the stage boundary three times (axes written (data,
  model) or (data, stage, model)): every engine stream equals
  ``generate(mesh=, decode_rows=capacity)`` bit for bit with sampling on
  (greedy under speculation, whose ``generate`` path is the engine's);
  the LoRA streams equal a one-process LoRA engine's; no page is left in
  use; the greedy streams equal the JAX package's one-device
  ``generate`` on the same seeded params (merged weights under LoRA) and
  the first-step logits its ``lm_prefill`` at rtol 1e-4 (the (2,2),
  (1,4) and stage cases); the records carry the ``model_shards``,
  ``stage_shards`` and ``bubble_lanes`` stamps, and the clock's bubbles
  are billed;
* ``pipelined_decode_layers`` (through ``lm_step(pipeline=)``) equals the
  layer walk bit for bit at n_micro 1, 2 and 4, logits and carries, and
  the clock's shift hands stage 0 zeros (it is not cyclic).

The worker: ``python -m tests.test_torch_serving_mesh all RANK WORLD DIR``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mamba_distributed_tpu_torch.config import ModelConfig

pytestmark = pytest.mark.torch

TINY = dict(d_model=32, n_layer=2, vocab_size=64, headdim=8, chunk_size=16, d_state=16,
            compute_dtype="float32", prefill_chunk_tokens=16, prefill_tokens_per_tick=16)
HYBRID = dict(n_layer=4, attn_layer_idx=(1, 3), attn_num_heads=4, attn_num_kv_heads=2,
              kv_page_tokens=8, kv_slot_tokens=64)
KINDS = {"mamba2": {}, "mamba1": dict(ssm_layer="mamba1"), "hybrid": HYBRID,
         "mamba2-4": dict(n_layer=4),
         # attention at 2 and 3: over two stages the plan runs stage 0, 1, 0, 1
         "hybrid-zigzag": dict(HYBRID, attn_layer_idx=(2, 3))}
# (kind, (data, stage, model), config overrides)
CASES = {
    "mamba2-d2m2": ("mamba2", (2, 1, 2), {}),
    "mamba1-d2m2": ("mamba1", (2, 1, 2), {}),
    "hybrid-d2m2": ("hybrid", (2, 1, 2), {}),
    "mamba2-m4": ("mamba2", (1, 1, 4), {}),
    "mamba2-s2-compact": ("mamba2", (1, 2, 1), dict(tick_compaction=True)),
    "mamba2-d2s2": ("mamba2-4", (2, 2, 1), {}),
    "hybrid-s2m2": ("hybrid", (1, 2, 2), {}),
    "hybrid-zigzag-s2": ("hybrid-zigzag", (1, 2, 1), {}),
    "mamba2-d2m2-spec": ("mamba2", (2, 1, 2), dict(spec_tokens=2)),
    "hybrid-d2m2-int8": ("hybrid", (2, 1, 2), dict(serving_weight_dtype="int8",
                                                   kv_page_dtype="int8")),
    "hybrid-d2m2-prefix": ("hybrid", (2, 1, 2), dict(tick_compaction=True,
                                                     prefix_cache_entries=8)),
}
LORA = dict(lora_max_adapters=4, lora_rank=4, lora_alpha=8.0)
LORA_SCALE = 0.5  # register_random's factor scale: a visible delta at this size
CAPACITY, NEW = 4, 6
GREEDY_LENS = (5, 37)  # one-shot and three-chunk prompts: one JAX trace each
SAMPLED_LENS = (20, 9, 50)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 64, n).astype(np.int64)


def _requests(spec: bool):
    """Two greedy requests (held against JAX) and three sampled ones
    (greedy too under speculation)."""
    from mamba_distributed_tpu_torch.serving import GenerationRequest

    reqs = [GenerationRequest(prompt_ids=_prompt(10 + i, t), max_new_tokens=NEW, top_k=1,
                              seed=20 + i) for i, t in enumerate(GREEDY_LENS)]
    reqs += [GenerationRequest(prompt_ids=_prompt(30 + i, t), max_new_tokens=NEW,
                               top_k=1 if spec else 5, temperature=0.8, seed=40 + i)
             for i, t in enumerate(SAMPLED_LENS)]
    return reqs


def _cfg(kind: str, **over) -> ModelConfig:
    return ModelConfig(**{**TINY, **KINDS[kind], **over})


def _params(work: Path | None = None):
    """kind -> seeded params as a numpy tree (the JAX package's layout,
    which the port's mirrors key for key), saved for the workers when
    ``work`` is given."""
    from mamba_distributed_tpu_torch import convert
    from mamba_distributed_tpu_torch.models.lm import init_lm_params

    out = {kind: convert.params_to_numpy(init_lm_params(
        _cfg(kind), torch.Generator().manual_seed(7 + i))) for i, kind in enumerate(KINDS)}
    if work is not None:
        torch.save(out, work / "params.pt")
    return out


# ------------------------------------------------------------------ worker


def _records(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()
            if json.loads(line)["kind"] == "serving_tick"] if path.exists() else []


def _run_case(name: str, params_np: dict, rank: int, world: int, work: Path) -> dict:
    from mamba_distributed_tpu_torch import convert
    from mamba_distributed_tpu_torch.inference.generate import generate
    from mamba_distributed_tpu_torch.models.lm import lm_prefill
    from mamba_distributed_tpu_torch.parallel.mesh import serving_mesh
    from mamba_distributed_tpu_torch.serving import ServingEngine
    from mamba_distributed_tpu_torch.serving.prefill import serving_shard
    from mamba_distributed_tpu_torch.utils.metrics import ServingMetrics

    kind, (D, S, M), over = CASES[name]
    cfg = _cfg(kind, **over)
    mesh = serving_mesh(D, M, S, replicas=world // (D * S * M))
    params = convert.params_from_jax(params_np[kind])
    path = work / f"{name}_{rank}.jsonl"
    eng = ServingEngine(params, cfg, capacity=CAPACITY, max_top_k=5, tokens_per_tick=2,
                        device="cpu", mesh=mesh,
                        metrics=ServingMetrics(CAPACITY, jsonl_path=str(path)))
    reqs = _requests(cfg.spec_tokens > 0)
    res = eng.run(reqs)
    if name.endswith("prefix"):
        # a warm hit on the 37-token prompt, with every slot free again
        reqs.append(dataclasses.replace(reqs[1], seed=99))
        res += eng.run(reqs[-1:])
    got = [r.new_tokens.tolist() for r in res]
    want = [generate(params, cfg, torch.from_numpy(q.prompt_ids)[None], seed=q.seed,
                     max_new_tokens=NEW, top_k=q.top_k, temperature=q.temperature,
                     decode_rows=CAPACITY, mesh=mesh)[0, len(q.prompt_ids):].tolist()
            for q in reqs]
    # a stage-only mesh computes every layer as one device does: its greedy
    # streams are one device's, bit for bit
    one = ([generate(params, cfg, torch.from_numpy(q.prompt_ids)[None], max_new_tokens=NEW,
                     top_k=1, decode_rows=CAPACITY)[0, len(q.prompt_ids):].tolist()
            for q in reqs[:2]] if D == M == 1 else None)
    if eng.prefix_cache is not None:
        hits = eng.prefix_cache.hits
        eng.prefix_cache.clear()
    pages = eng.page_pool.pages_in_use if eng.hybrid else 0
    # the first-step logits of the greedy one-shot prompt on the mesh
    ids = torch.from_numpy(_prompt(10, GREEDY_LENS[0]))[None]
    shard = serving_shard(params, cfg, mesh)
    kw = dict(tp=mesh.tp, stage=mesh.stage_ctx)
    logits0 = (lm_prefill(shard, cfg, ids, max_len=ids.shape[1] + 1, **kw)[0]
               if cfg.attn_layer_idx else lm_prefill(shard, cfg, ids, **kw)[0])
    return dict(got=got, want=want, one=one, pages=pages, logits0=logits0,
                records=_records(path), summary=eng.metrics.summary(),
                hits=hits if eng.prefix_cache is not None else None,
                weight_bytes=eng.weight_bytes)


def _run_lora(params_np: dict, rank: int, world: int) -> dict:
    """(2,2) LoRA with two adapters: the mesh engine's greedy streams and
    a one-process engine's on the whole tree."""
    from mamba_distributed_tpu_torch import convert
    from mamba_distributed_tpu_torch.parallel.mesh import serving_mesh
    from mamba_distributed_tpu_torch.serving import GenerationRequest, ServingEngine
    from mamba_distributed_tpu_torch.serving import adapters as ad

    cfg = _cfg("mamba2", **LORA)
    params = convert.params_from_jax(params_np["mamba2"])
    mesh = serving_mesh(2, 2, 1)
    out = []
    for m in (mesh, None):
        reg = ad.AdapterRegistry(cfg, params)
        for i, name in enumerate(("alice", "bob")):
            reg.register_random(name, seed=10 + i, scale=LORA_SCALE)
        eng = ServingEngine(params, cfg, capacity=CAPACITY, max_top_k=1, tokens_per_tick=2,
                            device="cpu", mesh=m, adapters=reg)
        reqs = [GenerationRequest(prompt_ids=_prompt(10 + i, t), max_new_tokens=NEW, top_k=1,
                                  adapter=a)
                for i, (t, a) in enumerate(zip(GREEDY_LENS * 2, ("alice", "alice", "bob",
                                                                 None)))]
        out.append([r.new_tokens.tolist() for r in eng.run(reqs)])
    return dict(mesh=out[0], solo=out[1])


def _run_clock(params_np: dict, world: int) -> dict:
    """``lm_step(pipeline=n)`` against the layer walk on a stage-2 mesh
    (two replicas), from the same random 16-lane state: logits and
    carries after two steps, for n_micro 1, 2 and 4.  Sixteen lanes keep
    the smallest microbatch at 4 lanes x 8 heads: on the CPU the softplus
    of a 16-element (2 x 8) tensor rounds its scalar tail otherwise than
    the vector body of a longer one (the row-count effect the engine's
    ``_compact_tick`` documents), which no schedule can undo."""
    from mamba_distributed_tpu_torch import convert
    from mamba_distributed_tpu_torch.models.lm import init_lm_state, lm_step
    from mamba_distributed_tpu_torch.parallel.collectives import stage_shift
    from mamba_distributed_tpu_torch.parallel.mesh import serving_mesh
    from mamba_distributed_tpu_torch.serving.prefill import serving_shard

    cfg = _cfg("mamba2-4")
    mesh = serving_mesh(1, 1, 2, replicas=world // 2)
    shard = serving_shard(convert.params_from_jax(params_np["mamba2-4"]), cfg, mesh)
    gen = torch.Generator().manual_seed(3)
    base = init_lm_state(cfg, 16, stages=2)["blocks"]
    base = tuple(torch.randn(t.shape, generator=gen).to(t.dtype) for t in base)
    toks = torch.randint(0, 64, (2, 16), generator=gen)

    def run(n_micro):
        state = {"blocks": tuple(t.clone() for t in base)}
        for tok in toks:
            logits, state = lm_step(shard, cfg, state, tok, tp=None, stage=mesh.stage_ctx,
                                    pipeline=n_micro)
        return logits, state["blocks"]

    walk = run(None)
    out = {}
    for n in (1, 2, 4):
        logits, blocks = run(n)
        out[n] = (torch.equal(logits, walk[0])
                  and all(torch.equal(a, b) for a, b in zip(blocks, walk[1])))
    # the clock's shift is not cyclic: stage 0 receives zeros
    out["shift"] = stage_shift(torch.full((3,), float(mesh.stage_rank + 1)),
                               mesh.stage_ctx).tolist()
    return out


def _worker(rank: int, world: int, work: Path) -> dict:
    from tests.test_torch_parallel import join_group

    join_group(world, work)
    params_np = torch.load(work / "params.pt", weights_only=False)
    out = {name: _run_case(name, params_np, rank, world, work) for name in CASES}
    out["lora"] = _run_lora(params_np, rank, world)
    out["clock"] = _run_clock(params_np, world)
    return out


# ------------------------------------------------------------ the world


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The four ranks' results and the JAX references: the world runs
    while the main process computes the references."""
    import jax
    import jax.numpy as jnp

    from mamba_distributed_tpu.config import ModelConfig as JaxConfig
    from mamba_distributed_tpu.inference import generate as jax_generate
    from mamba_distributed_tpu.models.lm import lm_prefill as jax_prefill
    from mamba_distributed_tpu.serving import adapters as jad
    from tests.test_torch_parallel import start

    work = tmp_path_factory.mktemp("serving_mesh")
    params_np = _params(work)
    wait = start("tests.test_torch_serving_mesh", "all", 4, work, timeout=240)
    refs = {}
    for kind in ("mamba2", "mamba1", "hybrid"):
        for dtype in (("bf16", "int8") if kind == "hybrid" else ("bf16",)):
            kw = {**TINY, **KINDS[kind]}
            if dtype == "int8":
                kw.update(serving_weight_dtype="int8", kv_page_dtype="int8")
            jcfg = JaxConfig(**kw, remat=False)
            jp = jax.tree.map(jnp.asarray, params_np[kind])
            refs[kind, dtype] = [np.asarray(jax_generate(
                jp, jcfg, jnp.asarray(_prompt(10 + i, t)[None].astype(np.int32)),
                jax.random.PRNGKey(0), max_new_tokens=NEW, top_k=1))[0, t:].tolist()
                for i, t in enumerate(GREEDY_LENS)]
            if dtype == "bf16":
                ids = jnp.asarray(_prompt(10, GREEDY_LENS[0])[None].astype(np.int32))
                extra = dict(max_len=GREEDY_LENS[0] + 1) if kind.startswith("hybrid") else {}
                refs[kind, "logits0"] = np.asarray(jax_prefill(jp, jcfg, ids, **extra)[0])
    jcfg = JaxConfig(**{**TINY, **LORA}, remat=False)
    jp = jax.tree.map(jnp.asarray, params_np["mamba2"])
    jreg = jad.AdapterRegistry(jcfg, jp)
    for i, name in enumerate(("alice", "bob")):
        jreg.register_random(name, seed=10 + i, scale=LORA_SCALE)
    refs["lora"] = []
    for i, (t, a) in enumerate(zip(GREEDY_LENS * 2, ("alice", "alice", "bob", None))):
        merged = jad.merge_adapter_params(jp, jreg, a) if a else jp
        refs["lora"].append(np.asarray(jax_generate(
            merged, jcfg, jnp.asarray(_prompt(10 + i, t)[None].astype(np.int32)),
            jax.random.PRNGKey(0), max_new_tokens=NEW, top_k=1))[0, t:].tolist())
    return wait(), refs


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_engine_equals_generate_and_jax(world, name):
    outs, refs = world
    kind, (D, S, M), over = CASES[name]
    dtype = over.get("serving_weight_dtype", "bf16")
    for r, out in enumerate(outs):
        case = out[name]
        assert case["got"] == case["want"], f"rank {r}"
        assert case["pages"] == 0
        if case["one"] is not None:
            assert case["got"][:2] == case["one"], f"rank {r} against one device"
        if (kind, dtype) in refs:
            assert case["got"][:2] == refs[kind, dtype], f"rank {r} against JAX"
            if (kind, "logits0") in refs and dtype == "bf16":
                np.testing.assert_allclose(case["logits0"].numpy(), refs[kind, "logits0"],
                                           rtol=1e-4, atol=1e-5)
    # every rank of a mesh took the same decisions: the same streams
    assert all(out[name]["got"] == outs[0][name]["got"] for out in outs)
    if name.endswith("prefix"):
        assert outs[0][name]["hits"] >= 1


def test_mesh_lora_matches_one_process_and_jax(world):
    outs, refs = world
    for out in outs:
        assert out["lora"]["mesh"] == out["lora"]["solo"] == refs["lora"]


def test_mesh_records_carry_stamps_and_bill_bubbles(world):
    outs, _ = world
    recs = outs[0]["mamba2-d2m2"]["records"]
    assert recs and all(r["model_shards"] == 2 and "stage_shards" not in r for r in recs)
    assert outs[0]["mamba2-d2m2"]["summary"]["pipeline"] is None
    recs = outs[0]["mamba2-s2-compact"]["records"]
    assert recs and all(r["stage_shards"] == 2 and "model_shards" not in r for r in recs)
    # the microbatched clock ran (a pure-SSM stage-only mesh), and each of
    # its ticks billed (stages - 1) x microbatch lanes x sub-steps
    piped = [r for r in recs if r["bubble_lanes"]]
    assert piped
    for r in piped:
        assert r["bubble_lanes"] == (2 - 1) * (r["compaction_width"] // 2) * 2
        assert r["wasted_token_lanes"] >= r["bubble_lanes"]
    pipe = outs[0]["mamba2-s2-compact"]["summary"]["pipeline"]
    assert pipe["stage_shards"] == 2 and pipe["pipelined_ticks"] == len(piped)
    assert pipe["bubble_lanes"] == sum(r["bubble_lanes"] for r in piped)
    # the hybrid's stage mesh walks its layers: stamped, nothing billed
    recs = outs[0]["hybrid-s2m2"]["records"]
    assert all(r["bubble_lanes"] == 0 and r["model_shards"] == 2 for r in recs)
    # at model 4 a rank holds about a quarter of the weights
    w4, w1 = outs[0]["mamba2-m4"]["weight_bytes"], outs[0]["mamba2-d2m2"]["weight_bytes"]
    assert w4 < w1


def test_pipelined_decode_clock_equals_the_layer_walk(world):
    outs, _ = world
    for r, out in enumerate(outs):
        shift = out["clock"].pop("shift")
        assert out["clock"] == {1: True, 2: True, 4: True}
        assert shift == ([0.0] * 3 if r % 2 == 0 else [1.0] * 3)


# ----------------------------------------------------- the main process


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return (tree.detach().float() if tree.dtype == torch.bfloat16 else tree.detach()).numpy()
    return np.asarray(tree)


def _specs_equal(port, jax_specs):
    def walk(p, j, path):
        if isinstance(p, dict):
            for k in p:
                if k in j:
                    walk(p[k], j[k], f"{path}/{k}")
            return
        if isinstance(p, (tuple, list)) and p and not isinstance(p[0], (str, type(None))):
            for i, (a, b) in enumerate(zip(p, j)):
                walk(a, b, f"{path}/{i}")
            return
        assert tuple(p) == tuple(j), f"{path}: port {p}, JAX {tuple(j)}"

    walk(port, jax_specs, "")


def _lora_tree(params, cfg):
    from mamba_distributed_tpu_torch.serving import adapters as ad

    cache = ad.AdapterCache(ad.AdapterRegistry(cfg, params), 2, compute_dtype=torch.float32)
    return ad.attach_adapter_pools(params, cache.pools)


@pytest.mark.parametrize("kind", ["mamba2", "mamba1", "hybrid"])
def test_serving_param_specs_match_jax(kind):
    from mamba_distributed_tpu.parallel import sharding as jsh
    from mamba_distributed_tpu_torch.models.lm import init_lm_params
    from mamba_distributed_tpu_torch.ops.quant import quantize_serving_params
    from mamba_distributed_tpu_torch.parallel.sharding import serving_param_specs

    cfg = _cfg(kind, **LORA, tie_embeddings=kind != "mamba1")
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))
    trees = [params, quantize_serving_params(params), _lora_tree(params, cfg)]
    for tree in trees:
        tree = _np_tree(tree)
        for model, stage in ((2, 1), (4, 1), (1, 2), (2, 2)):
            _specs_equal(serving_param_specs(tree, model, stage),
                         jsh.serving_param_specs(tree, model, stage))


@pytest.mark.parametrize("kind", ["mamba2", "hybrid"])
def test_slot_pool_specs_match_jax(kind):
    from mamba_distributed_tpu.config import ModelConfig as JaxConfig
    from mamba_distributed_tpu.parallel import sharding as jsh
    from mamba_distributed_tpu.serving import state_cache as jsc
    from mamba_distributed_tpu_torch.parallel.sharding import slot_pool_specs
    from mamba_distributed_tpu_torch.serving import state_cache

    kw = {**TINY, **KINDS[kind]}
    pool = _np_tree(state_cache.init_pool(ModelConfig(**kw), 4))
    jpool = jsc.init_pool(JaxConfig(**kw, remat=False), 4)
    for shards, stage in ((2, 1), (4, 1), (2, 2), (3, 1)):
        _specs_equal(slot_pool_specs(pool, shards, stage),
                     jsh.slot_pool_specs(jpool, shards, stage))


def test_page_ranges_pool_pages_and_sharded_pool_match_jax():
    from mamba_distributed_tpu.config import ModelConfig as JaxConfig
    from mamba_distributed_tpu.serving import state_cache as jsc
    from mamba_distributed_tpu_torch.serving import state_cache as sc

    for pages, shards in ((7, 2), (15, 4), (11, 3), (5, 1)):
        assert sc.page_shard_ranges(pages, shards) == jsc.page_shard_ranges(pages, shards)
    for pages, shards in ((6, 2), (1, 2)):
        with pytest.raises(ValueError) as got:
            sc.page_shard_ranges(pages, shards)
        with pytest.raises(ValueError) as want:
            jsc.page_shard_ranges(pages, shards)
        assert str(got.value) == str(want.value)
    kw = {**TINY, **HYBRID}
    for cap, shards, pool in ((4, 2, 0), (4, 4, 0), (6, 2, 9), (3, 1, 0)):
        cfg, jcfg = ModelConfig(**kw, kv_pool_pages=pool), JaxConfig(**kw, kv_pool_pages=pool)
        assert (sc.hybrid_pool_pages(cfg, cap, shards)
                == jsc.hybrid_pool_pages(jcfg, cap, shards))
    pp, jp = sc.PagePool(7, 2), jsc.PagePool(7, 2)
    a, ja = pp.alloc(2, 1), jp.alloc(2, 1)
    assert a == ja == [4, 5] and pp.free_pages_in(1) == jp.free_pages_in(1) == 2
    assert pp.shard_capacity(0) == jp.shard_capacity(0) == 3
    with pytest.raises(RuntimeError, match="shard 0 has 3"):
        pp.alloc(4, 0)
    pp.free(a)
    assert pp._free == sorted(jp._free + ja) == [1, 2, 3, 4, 5, 6, 7]
    # a shard's rows: its own pages from row 1, every other id the local trash row 0
    ids = np.array([0, 1, 3, 4, 7], np.int32)
    assert pp.local_rows(ids, 0).tolist() == [0, 1, 3, 0, 0]
    assert pp.local_rows(ids, 1).tolist() == [0, 0, 0, 1, 4]
    assert sc.PagePool(7).local_rows(ids, 0).tolist() == ids.tolist()


def test_validators_match_jax_messages():
    from mamba_distributed_tpu.config import ModelConfig as JaxConfig
    from mamba_distributed_tpu.parallel import sharding as jsh
    from mamba_distributed_tpu_torch.parallel import sharding as sh

    cases = [
        ("model", dict(HYBRID), 4), ("model", {}, 5), ("model", {}, 3),
        ("model", dict(d_model=24, headdim=16), 2), ("model", {}, 2),
        ("stage", dict(n_layer=3), 2), ("stage", dict(n_layer=4, attn_layer_idx=(1,),
                                                      attn_num_heads=4, attn_num_kv_heads=2), 2),
        ("stage", dict(HYBRID), 2), ("stage", {}, 1),
    ]
    raised = 0
    for axis, over, n in cases:
        kw = {**TINY, **over}
        fn, jfn = ((sh.validate_serving_model_shards, jsh.validate_serving_model_shards)
                   if axis == "model" else
                   (sh.validate_serving_stage_shards, jsh.validate_serving_stage_shards))
        try:
            jfn(JaxConfig(**kw, remat=False), n)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                fn(ModelConfig(**kw), n)
            assert str(got.value) == str(e)
            raised += 1
        else:
            fn(ModelConfig(**kw), n)
    assert raised == 6
    for field in ("serving_replicas", "serving_data_shards", "serving_model_shards",
                  "serving_stage_shards"):
        with pytest.raises(ValueError) as got:
            ModelConfig(**{field: 0})
        with pytest.raises(ValueError) as want:
            JaxConfig(**{field: 0})
        assert str(got.value) == str(want.value)


def test_serving_mesh_refusals_and_engine_checks():
    from mamba_distributed_tpu_torch.models.lm import init_lm_params
    from mamba_distributed_tpu_torch.parallel.mesh import serving_mesh
    from mamba_distributed_tpu_torch.serving import ServingEngine

    solo = serving_mesh(1)
    assert (solo.shape, tuple(solo.shape), solo.tp, solo.data_ctx) == (
        {"data": 1, "model": 1}, ("data", "model"), None, None)
    assert serving_mesh(1, stage_shards=1).shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="= 4 devices, have 1"):
        serving_mesh(2, model_shards=2)
    with pytest.raises(ValueError, match="stage_shards must be >= 1"):
        serving_mesh(1, stage_shards=0)
    cfg = _cfg("mamba2")
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="devices, have 1"):
        ServingEngine(params, dataclasses.replace(cfg, serving_model_shards=2), device="cpu")
    with pytest.raises(ValueError, match="layer stack"):
        ServingEngine(params, dataclasses.replace(cfg, n_layer=3), device="cpu",
                      mesh=dataclasses.replace(solo, stage=2))


def test_serving_shard_quantizes_as_the_cut_of_the_whole_tree():
    """The int8 scales shard with their kernels and the quantized
    embedding keeps its vocab cut: quantizing a rank's packed shard
    equals cutting the quantized whole tree, leaf for leaf."""
    from mamba_distributed_tpu_torch.models.lm import init_lm_params
    from mamba_distributed_tpu_torch.ops.quant import quantize_serving_params
    from mamba_distributed_tpu_torch.parallel.tp_layout import pack_tp, serving_plan

    for kind in ("mamba2", "hybrid"):
        cfg = _cfg(kind)
        params = init_lm_params(cfg, torch.Generator().manual_seed(1))
        plan = serving_plan(cfg, 2)
        for rank in (0, 1):
            a = _np_tree(quantize_serving_params(pack_tp(params, plan, rank)))
            b = _np_tree(pack_tp(quantize_serving_params(params), plan, rank))
            from tests.test_torch_parallel import flat

            fa, fb = flat(a), flat(b)
            assert fa.keys() == fb.keys()
            for k in fa:
                np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
        assert b["embedding"]["kernel"].shape[0] == cfg.vocab_size_padded // 2


def test_serving_shard_equals_the_cut_of_the_cast_tree():
    """``serving_shard`` cuts the fp32 masters, then casts (and
    quantizes): the same leaves as cutting the whole cast tree, bf16 and
    int8, at model 2 x stage 2."""
    from mamba_distributed_tpu_torch.inference.generate import _decode_params
    from mamba_distributed_tpu_torch.models.lm import init_lm_params
    from mamba_distributed_tpu_torch.parallel.mesh import ServingMesh
    from mamba_distributed_tpu_torch.parallel.tp_layout import pack_tp, serving_plan, stage_cut
    from mamba_distributed_tpu_torch.serving.prefill import serving_shard
    from tests.test_torch_parallel import flat

    for over in ({"compute_dtype": "bfloat16"}, {"serving_weight_dtype": "int8"}):
        cfg = _cfg("hybrid", **over)
        params = init_lm_params(cfg, torch.Generator().manual_seed(2))
        for m, s in ((0, 1), (1, 0)):
            mesh = ServingMesh(1, 2, 2, 0, s, m, None, None, None)
            got = flat(_np_tree(serving_shard(params, cfg, mesh)))
            want = flat(_np_tree(stage_cut(pack_tp(_decode_params(params, cfg),
                                                   serving_plan(cfg, 2), m), 2, s)))
            assert got.keys() == want.keys()
            for k in got:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_gated_out_proj_equals_the_whole_row_norm_and_product():
    """The gated norm fused into the row-parallel out_proj
    (``models/common.gated_out_proj``, two model ranks' halves: each
    part's unnormalised product and its sum of squares summed in one
    reduction, then 1/rms) equals the JAX package's gated norm of the
    whole row times the whole kernel at 1e-5, with a bias and a bound
    LoRA; the sum-of-squares kernel's wrapper refuses a CPU tensor and
    its C entry is in the source."""
    import jax.numpy as jnp

    from mamba_distributed_tpu.ops import norm as jnorm
    from mamba_distributed_tpu_torch.models import common
    from mamba_distributed_tpu_torch.ops.cuda import build
    from mamba_distributed_tpu_torch.ops.cuda import norm_kernels as nk
    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
    from mamba_distributed_tpu_torch.parallel.tp_layout import TPContext

    rng = np.random.default_rng(0)
    x, z = (rng.standard_normal((3, 5, 64)).astype(np.float32) for _ in range(2))
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    k, bias = rng.standard_normal((64, 16)).astype(np.float32), rng.standard_normal(16)
    A, B = (0.1 * rng.standard_normal(s).astype(np.float32) for s in ((2, 64, 4), (2, 4, 16)))
    ids = torch.tensor([1, 0, 1])
    normed = np.asarray(jnorm.rms_norm_gated(jnp.asarray(x), jnp.asarray(z), jnp.asarray(w),
                                             1e-5))
    want = normed @ k + bias + np.einsum("btr,bro->bto", np.einsum(
        "bti,bir->btr", normed, A[ids.numpy()]), B[ids.numpy()])
    halves = [slice(0, 32), slice(32, 64)]
    sent = []  # each half's one reduction buffer

    def run(h):
        out = {"kernel": torch.from_numpy(k[h]), "bias": torch.from_numpy(bias),
               "lora": {"A": torch.from_numpy(A[:, h]), "B": torch.from_numpy(B), "ids": ids}}
        return common.gated_out_proj(torch.from_numpy(x[..., h]), torch.from_numpy(z[..., h]),
                                     torch.from_numpy(w[h]), out, 1e-5, torch.float32,
                                     TPContext(None, 2, 0, serving=True))

    real = common.serve_all_reduce_
    try:
        common.serve_all_reduce_ = lambda t, group, kind: sent.append(t.clone()) or t
        for h in halves:
            run(h)
        assert len(sent) == 2  # the norm's sum and the product's: one reduction
        total = sent[0] + sent[1]
        common.serve_all_reduce_ = lambda t, group, kind: t.copy_(total)
        got = run(halves[0])
    finally:
        common.serve_all_reduce_ = real
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="CUDA kernel"):
        nk.rms_norm_gated_sumsq_kernel(torch.from_numpy(x), torch.from_numpy(z))
    assert LAUNCHES == before
    assert "mdt_rms_norm_gated_sumsq" in build.SOURCES["rms_norm"].read_text()


def test_pipelined_decode_layers_refusals():
    from mamba_distributed_tpu_torch.parallel.mesh import GroupContext
    from mamba_distributed_tpu_torch.parallel.pipeline import pipelined_decode_layers

    stage = GroupContext(None, 2, 0, (0, 1))
    act = (torch.zeros(6, 4), torch.zeros(6, 4))
    with pytest.raises(ValueError, match=r"n_layer \(3\) must divide evenly over the 2 "
                                         r"pipeline stages of mesh axis 'stage'"):
        pipelined_decode_layers(None, [{}], (), act, stage, n_layer=3)
    with pytest.raises(ValueError, match=r"lane count \(6\) must divide over n_micro \(4\)"):
        pipelined_decode_layers(None, [{}], (), act, stage, n_micro=4)


def test_records_without_a_mesh_keep_their_bytes(tmp_path):
    from mamba_distributed_tpu_torch.models.lm import init_lm_params
    from mamba_distributed_tpu_torch.serving import ServingEngine
    from mamba_distributed_tpu_torch.utils.metrics import ServingMetrics

    cfg = _cfg("mamba2", tick_compaction=True)
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))
    path = tmp_path / "m.jsonl"
    eng = ServingEngine(params, cfg, capacity=CAPACITY, max_top_k=5, device="cpu",
                        metrics=ServingMetrics(CAPACITY, jsonl_path=str(path)))
    eng.run(_requests(False)[:2])
    recs = _records(path)
    assert recs and not any({"model_shards", "stage_shards", "bubble_lanes"} & r.keys()
                            for r in recs)
    assert eng.metrics.summary()["pipeline"] is None


if __name__ == "__main__":
    case, rank, world, work = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    result = _worker(rank, world, work)
    torch.save(result, work / f"out_{rank}.pt")
    import torch.distributed as dist

    dist.destroy_process_group()



def test_matmul_rows_runs_the_product_at_the_pinned_row_count():
    """``common.matmul(rows=)`` (the compacted decode's GEMMs over the
    model axis): the library call sees the pinned row count, zero rows
    appended, and the caller gets its own rows' products unchanged."""
    from mamba_distributed_tpu_torch.models.common import matmul, mm_f32

    gen = torch.Generator().manual_seed(0)
    a = torch.randn((3, 1, 8), generator=gen)
    b = torch.randn((8, 5), generator=gen)
    seen = []

    def fn(x, y):
        seen.append(x.shape[0])
        return x @ y

    assert torch.equal(matmul(a, b, fn, rows=8), matmul(a, b, fn))
    assert seen == [8, 3]
    assert matmul(a, b, rows=2).shape == (3, 1, 5)  # fewer pinned rows: as they come
    assert torch.equal(mm_f32(a.bfloat16(), b.bfloat16(), rows=8),
                       mm_f32(a.bfloat16(), b.bfloat16()))
