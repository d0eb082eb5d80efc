"""The port's data-parallel and FSDP training (``parallel/``, the mesh
train step) against the JAX package's, on the CPU.

* ``param_specs`` equals the JAX ``param_specs`` leaf for leaf on tiny
  Mamba-2, Mamba-1, hybrid-with-gated-MLP and MoE trees, over fsdp 2, 4
  and 8, tensor 2, expert 2, pipe 2 and a mix; the layer axis of a
  stacked leaf is never fsdp's;
* the config's checks raise the JAX messages, ``data_parallel_size``,
  ``grad_accum_steps`` and the mesh presets equal JAX's, and the seq,
  tensor, pipe and expert axes are taken as JAX takes them;
* the collectives: shard/gather round trips, the reduce-scatter mean,
  the bucketed all-reduce against one all-reduce a leaf, and
  ``sharded_global_norm`` against the full norm;
* two gloo processes run the port's train step (2 steps, accum 2) at
  ``data=2`` and at ``fsdp=2`` with ``shard_params``, on the JAX params
  and global batch, rows split as the JAX batch sharding splits them:
  losses and grad norms equal the JAX mesh step's at rtol 2e-4 and the
  gathered params at atol 1e-5; under FSDP every rank holds 1/2 of each
  sharded leaf and of its moments;
* four processes at ``data=2 x fsdp=2``, Mamba-1 at ``data=2`` and the
  hybrid at ``fsdp=2`` equal the port's one-device step on the whole
  batch at the same tolerances.

The file is its own worker (``python -m tests.test_torch_parallel CASE
RANK WORLD DIR``): rendezvous through a ``file://`` in the test's
``tmp_path``, one thread a worker, logs to files, a timeout on each
wait and every worker killed on a hang.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mamba_distributed_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
# JAX's tests/test_parallel.py TINY_MODEL
TINY_MODEL = dict(d_model=64, n_layer=2, vocab_size=256, ssm_layer="mamba2", headdim=16,
                  chunk_size=32, d_state=32, compute_dtype="float32")
HYBRID_OVER = dict(n_layer=4, attn_layer_idx=(1, 3), attn_num_heads=4, attn_num_kv_heads=2,
                   d_intermediate=48)
MOE_OVER = dict(d_intermediate=32, moe_num_experts=4, moe_top_k=2)
WAIT_S = 150


# ------------------------------------------------------------------ launcher


def start(module: str, case: str, world: int, work: Path, timeout: float = WAIT_S):
    """Start ``python -m module case rank world work`` in ``world``
    processes over a gloo group (``file://`` rendezvous in ``work``) and
    return a function that waits for them and returns each rank's
    ``out_{rank}.pt`` (the caller may work meanwhile).  Logs go to
    ``work/log_{rank}.txt``; a hang kills every worker."""
    work.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "WORLD_SIZE": str(world)}
    logs = [work / f"log_{r}.txt" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as lf:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, case, str(r), str(world), str(work)],
                cwd=ROOT, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                stdout=lf, stderr=subprocess.STDOUT))

    def wait() -> list:
        timed_out = False
        try:
            for p in procs:
                p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            timed_out = True
        finally:
            for p in procs:  # one dead worker leaves the others blocked in a collective
                if p.poll() is None:
                    p.kill()
                    p.wait()
        text = [f.read_text() for f in logs]
        assert not timed_out, "worker hang; logs:\n" + "\n---\n".join(t[-3000:] for t in text)
        for p, t in zip(procs, text):
            assert p.returncode == 0, t[-3000:]
        return [torch.load(work / f"out_{r}.pt", weights_only=True) for r in range(world)]

    return wait


def spawn(module: str, case: str, world: int, work: Path, timeout: float = WAIT_S) -> list:
    """``start`` the workers and wait for them: each rank's ``out_{rank}.pt``."""
    return start(module, case, world, work, timeout)()


def join_group(world: int, work: Path, tag: str = "pg") -> None:
    """The worker's side: one thread, the gloo group over ``file://``."""
    from mamba_distributed_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    init_distributed("cpu", init_method=f"file://{work / tag}")


def flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


# --------------------------------------------------------------- the specs


def _jax_port_trees(over: dict):
    import jax

    from mamba_distributed_tpu.config import ModelConfig as JaxConfig
    from mamba_distributed_tpu.models import init_lm_params as jax_init
    from mamba_distributed_tpu_torch.models.lm import init_lm_params

    kw = {**TINY_MODEL, **over}
    shapes = jax.eval_shape(lambda k: jax_init(k, JaxConfig(**kw)), jax.random.PRNGKey(0))
    params = init_lm_params(ModelConfig(**kw), torch.Generator().manual_seed(0))
    return shapes, params


TREES = {"mamba2": {}, "mamba1": dict(ssm_layer="mamba1", d_state=16), "hybrid": HYBRID_OVER,
         "moe": {**HYBRID_OVER, **MOE_OVER}}
AXES = {"fsdp2": dict(fsdp_size=2), "fsdp4": dict(fsdp_size=4), "fsdp8": dict(fsdp_size=8),
        "tensor2": dict(fsdp_size=1, tensor_size=2), "expert2": dict(fsdp_size=1, expert_size=2),
        "fsdp2-tensor2-expert2": dict(fsdp_size=2, tensor_size=2, expert_size=2),
        "pipe2-fsdp2": dict(fsdp_size=2, pipe_size=2)}


@pytest.mark.parametrize("axes", sorted(AXES))
@pytest.mark.parametrize("tree", sorted(TREES))
def test_param_specs_match_jax(tree, axes):
    import jax
    from jax.sharding import PartitionSpec as P

    from mamba_distributed_tpu.parallel.sharding import param_specs as jax_specs
    from mamba_distributed_tpu_torch.parallel.sharding import param_specs

    shapes, params = _jax_port_trees(TREES[tree])
    kw = AXES[axes]
    jspec = jax_specs(shapes, True, **kw)
    want = {jax.tree_util.keystr(path).replace("']['", ".").strip("[']"): tuple(s)
            for path, s in jax.tree_util.tree_flatten_with_path(
                jspec, is_leaf=lambda s: isinstance(s, P))[0]}
    got = flat(param_specs(params, True, **kw))
    assert got == want
    assert any("fsdp" in s for s in got.values()) or kw["fsdp_size"] == 1
    for name, s in got.items():  # the layer axis of a stacked leaf is never fsdp's
        if name.startswith(("blocks.", "attn_blocks.")) and s:
            assert s[0] != "fsdp", name
    # shard=False turns fsdp off and nothing else
    off = flat(param_specs(params, False, **kw))
    assert all("fsdp" not in s for s in off.values())


# --------------------------------------------------------------- the config

JAX_REFUSALS = [
    (dict(mesh=dict(pipe=2, seq=2)), {}),
    (dict(mesh=dict(pipe=2)), MOE_OVER),
    (dict(mesh=dict(expert=2)), {}),
    (dict(mesh=dict(expert=3)), MOE_OVER),
    (dict(mesh=dict(pipe=2), shard_params=True), {}),
    (dict(mesh=dict(pipe=2)), dict(n_layer=4, attn_layer_idx=(1, 2))),
    (dict(mesh=dict(pipe=3)), dict(n_layer=6, attn_layer_idx=(1, 4))),
    (dict(mesh=dict(pipe=3)), dict(n_layer=4)),
]


def _both_cfgs(train: dict, model: dict, micro: int = 2, T: int = 64):
    from mamba_distributed_tpu.config import MeshConfig as JaxMesh
    from mamba_distributed_tpu.config import ModelConfig as JaxConfig
    from mamba_distributed_tpu.config import TrainConfig as JaxTrainConfig

    train = dict(train)
    mesh = train.pop("mesh", {})
    kw = dict(micro_batch_size=micro, seq_len=T, total_batch_size=micro * T * 64, **train)
    mk = {**TINY_MODEL, **model}
    return (lambda: JaxTrainConfig(model=JaxConfig(**mk), mesh=JaxMesh(**mesh), **kw),
            lambda: TrainConfig(model=ModelConfig(**mk), mesh=MeshConfig(**mesh), **kw))


@pytest.mark.parametrize("case", range(len(JAX_REFUSALS)))
def test_config_checks_raise_the_jax_messages(case):
    jax_cfg, port_cfg = _both_cfgs(*JAX_REFUSALS[case])
    with pytest.raises(ValueError) as jerr:
        jax_cfg()
    with pytest.raises(ValueError) as perr:
        port_cfg()
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("axis", ["seq", "tensor", "pipe", "expert"])
def test_config_refuses_later_axes_by_name(axis):
    model = MOE_OVER if axis == "expert" else {}
    jax_cfg, port_cfg = _both_cfgs(dict(mesh={axis: 2}), model)
    jax_cfg()  # the JAX package takes it
    # every axis is trained since its slice: taken as JAX takes it
    port, jax_ = port_cfg(), jax_cfg()
    assert port.grad_accum_steps == jax_.grad_accum_steps
    assert port.data_parallel_size == jax_.data_parallel_size
    assert dataclasses.asdict(port.mesh) == dataclasses.asdict(jax_.mesh)


@pytest.mark.parametrize("mesh", [dict(), dict(data=2), dict(fsdp=4), dict(data=2, fsdp=2),
                                  dict(data=8)])
def test_data_parallel_size_and_accum_match_jax(mesh):
    jax_cfg, port_cfg = _both_cfgs(dict(mesh=mesh), {})
    j, t = jax_cfg(), port_cfg()
    assert (t.data_parallel_size, t.grad_accum_steps) == (j.data_parallel_size,
                                                           j.grad_accum_steps)
    assert t.mesh.num_devices == j.mesh.num_devices
    assert t.mesh.shape == j.mesh.shape and t.mesh.axis_names == j.mesh.axis_names
    # a total the data-parallel rows do not divide: the JAX assert's message
    j = dataclasses.replace(j, total_batch_size=j.total_batch_size + 64)
    with pytest.raises(AssertionError, match="B \\* T \\* dp_size") as jerr:
        j.grad_accum_steps
    with pytest.raises(ValueError, match="divisible") as perr:
        dataclasses.replace(t, total_batch_size=t.total_batch_size + 64)
    assert str(jerr.value) in str(perr.value)


@pytest.mark.parametrize("name", ["mamba2-280m-dp8", "mamba2-1.3b-fsdp16", "mamba2-2.8b-sp32",
                                  "hybrid-7b"])
def test_data_parallel_presets_match_jax(name):
    """The mesh presets (data parallel, FSDP, and the two that train over
    seq) equal the JAX package's field for field: every field the two
    configs share, the mesh whole."""
    from mamba_distributed_tpu.config import get_preset as jax_preset
    from mamba_distributed_tpu_torch.config import get_train_preset

    j, t = jax_preset(name), get_train_preset(name)
    for f in ("seq_len", "micro_batch_size", "total_batch_size", "shard_params",
              "grad_accum_steps", "data_parallel_size", "max_steps", "warmup_steps"):
        assert getattr(t, f) == getattr(j, f), f
    assert dataclasses.asdict(t.mesh) == dataclasses.asdict(j.mesh)
    for f in ("d_model", "n_layer", "ssm_layer", "d_state", "headdim", "vocab_size_padded"):
        assert getattr(t.model, f) == getattr(j.model, f), f
    for cfg_t, cfg_j in ((t, j), (t.model, j.model)):
        shared = ({x.name for x in dataclasses.fields(cfg_t)}
                  & {x.name for x in dataclasses.fields(cfg_j)}) - {"model", "mesh", "data",
                                                                    "telemetry"}
        assert shared
        for f in sorted(shared):
            assert getattr(cfg_t, f) == getattr(cfg_j, f), f


# -------------------------------------------------------------- the workers


def _case_collectives(rank: int, world: int, work: Path) -> dict:
    import torch.distributed as dist

    from mamba_distributed_tpu_torch.parallel.collectives import (
        all_gather_leaf,
        all_reduce_mean_,
        buckets,
        reduce_scatter_leaf,
        sharded_global_norm,
    )
    from mamba_distributed_tpu_torch.parallel.sharding import (
        gather_params,
        param_specs,
        shard_params,
    )
    from mamba_distributed_tpu_torch.training.optimizer import global_norm, tree_map

    join_group(world, work)
    out = {}
    # the same full tree on every rank, each rank's gradients its own
    gen = torch.Generator().manual_seed(0)
    full = {"a": torch.randn(6, 8, generator=gen), "b": {"c": torch.randn(3, 4, 10, generator=gen),
                                                         "d": torch.randn(5, generator=gen)}}
    specs = {"a": (None, "fsdp"), "b": {"c": (None, None, "fsdp"), "d": ()}}
    shards = shard_params(full, specs)
    out["shard_shapes"] = [list(shards["a"].shape), list(shards["b"]["c"].shape),
                           list(shards["b"]["d"].shape)]
    back = gather_params(shards, specs)
    out["round_trip"] = all(torch.equal(x, y) for x, y in zip(flat(back).values(),
                                                                flat(full).values()))
    # along axis 0 and a middle axis too
    t = torch.arange(4 * 6 * 2, dtype=torch.float32).reshape(4, 6, 2)
    out["gather_axes"] = all(
        torch.equal(all_gather_leaf(t.chunk(world, ax)[rank].contiguous(), ax), t)
        for ax in range(3))
    # the reduce-scatter mean: every rank's own full tensor
    mine = t * (rank + 1)
    mean = sum(t * (r + 1) for r in range(world)) / world
    out["reduce_scatter"] = all(
        torch.allclose(reduce_scatter_leaf(mine, ax), mean.chunk(world, ax)[rank])
        for ax in range(3))
    # the bucketed all-reduce against one all_reduce a leaf: fp32 and
    # bf16 leaves, a non-contiguous view, a 0-d loss, 64-byte buckets
    g = torch.Generator().manual_seed(10 + rank)
    leaves = [torch.randn(3, 5, generator=g), torch.randn(7, generator=g),
              torch.randn(4, 6, generator=g).t(), torch.randn(9, generator=g).bfloat16(),
              torch.randn(2, generator=g).bfloat16(), torch.randn((), generator=g)]
    ref = [x.clone() for x in leaves]
    for x in ref:
        dist.all_reduce(x, op=dist.ReduceOp.AVG)
    sizes = all_reduce_mean_(leaves, bucket_bytes=64)
    out["bucket_plan"] = buckets(leaves, 64)
    out["bucket_bytes"] = sizes
    out["bucketed_equal"] = all(torch.equal(a, b) for a, b in zip(leaves, ref))
    out["strided_kept"] = not leaves[2].is_contiguous()
    # the global norm from shards against the full gradients' norm
    grads = tree_map(lambda x: x * (1.0 + rank), full)
    for x in flat(grads).values():
        dist.all_reduce(x, op=dist.ReduceOp.AVG)
    shard_g = shard_params(grads, specs)
    out["norm"] = (float(sharded_global_norm(shard_g, specs)), float(global_norm(grads)))
    out["specs_of_tree"] = flat(param_specs(full, True, world)) == {
        "a": (None, "fsdp"), "b.c": (None, None, "fsdp"), "b.d": ()}
    return out


def test_collectives(tmp_path):
    outs = spawn("tests.test_torch_parallel", "collectives", 2, tmp_path)
    for o in outs:
        assert o["shard_shapes"] == [[6, 4], [3, 4, 5], [5]]
        assert o["round_trip"] and o["gather_axes"] and o["reduce_scatter"]
        assert o["bucketed_equal"] and o["strided_kept"] and o["specs_of_tree"]
        # dtype changes and the 64-byte limit cut the buckets
        assert o["bucket_plan"] == [[0], [1], [2], [3, 4], [5]]
        assert sum(o["bucket_bytes"]) == 4 * (15 + 7 + 24 + 1) + 2 * (9 + 2)
        np.testing.assert_allclose(o["norm"][0], o["norm"][1], rtol=1e-6)
    assert outs[0]["norm"] == outs[1]["norm"]


def _case_step(rank: int, world: int, work: Path) -> dict:
    from mamba_distributed_tpu_torch.parallel.mesh import build_mesh
    from mamba_distributed_tpu_torch.parallel.sharding import (
        batch_coordinate,
        gather_params,
        param_specs,
        shard_params,
    )
    from mamba_distributed_tpu_torch.training.optimizer import AdamW, tree_map
    from mamba_distributed_tpu_torch.training.train_step import is_fsdp, make_train_step

    join_group(world, work)
    inp = torch.load(work / "inputs.pt", weights_only=True)
    cfg = step_cfg(inp["model"], inp["mesh"], inp["shard"], inp["micro"], inp["T"],
                   inp["accum"])
    mesh = build_mesh(cfg.mesh, "cpu")
    params = inp["params"]
    m = cfg.mesh
    specs = param_specs(params, cfg.shard_params, m.fsdp, m.tensor, m.pipe, m.expert)
    fsdp = is_fsdp(cfg)
    group = mesh.get_group("fsdp")
    if fsdp:
        params = shard_params(params, specs, group)
    params = tree_map(lambda t: t.requires_grad_(), params)
    opt = AdamW(cfg, params)
    step = make_train_step(cfg, opt, mesh, specs)
    c, B = batch_coordinate(mesh), cfg.micro_batch_size
    losses, norms = [], []
    for x, y in zip(inp["x"], inp["y"]):
        loss, norm = step(params, x[:, c * B:(c + 1) * B], y[:, c * B:(c + 1) * B])
        losses.append(float(loss))
        norms.append(float(norm))
    full = gather_params(params, specs, group) if fsdp else params
    return {"losses": losses, "norms": norms, "coordinate": c,
            "params": {k: v.detach() for k, v in flat(full).items()},
            "local": {k: v.numel() for k, v in flat(params).items()},
            "moments": {k: v.numel() for k, v in flat(opt.mu).items()},
            "full": {k: v.numel() for k, v in flat(full).items()},
            "comm": step.comm}


def step_cfg(model: dict, mesh: dict, shard: bool, micro: int, T: int, accum: int):
    dp = mesh.get("data", 1) * mesh.get("fsdp", 1)
    return TrainConfig(model=ModelConfig(**model), mesh=MeshConfig(**mesh), shard_params=shard,
                       micro_batch_size=micro, seq_len=T, total_batch_size=micro * T * dp * accum,
                       warmup_steps=2, max_steps=10)


def batches(seed: int, steps: int, accum: int, rows: int, T: int, vocab: int):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (steps, accum, rows, T)).astype(np.int64)
    y = rng.integers(0, vocab, (steps, accum, rows, T)).astype(np.int64)
    return x, y


def run_step_case(work: Path, model: dict, mesh: dict, shard: bool, params: dict, x, y,
                  micro: int = 2, T: int = 64, accum: int = 2) -> list:
    world = mesh.get("data", 1) * mesh.get("fsdp", 1)
    work.mkdir(parents=True, exist_ok=True)
    torch.save({"model": model, "mesh": mesh, "shard": shard, "micro": micro, "T": T,
                "accum": accum, "params": params, "x": torch.from_numpy(x),
                "y": torch.from_numpy(y)}, work / "inputs.pt")
    return spawn("tests.test_torch_parallel", "step", world, work)


def port_single(model: dict, params: dict, x, y, micro: int, T: int = 64, accum: int = 2):
    """The port's one-device step on the whole batch (no mesh)."""
    from mamba_distributed_tpu_torch.training.optimizer import AdamW, tree_map
    from mamba_distributed_tpu_torch.training.train_step import make_train_step

    cfg = step_cfg(model, {}, False, micro, T, accum)
    p = tree_map(lambda t: t.clone().requires_grad_(), params)
    step = make_train_step(cfg, AdamW(cfg, p))
    losses, norms = [], []
    for xs, ys in zip(x, y):
        loss, norm = step(p, torch.from_numpy(xs), torch.from_numpy(ys))
        losses.append(float(loss))
        norms.append(float(norm))
    return losses, norms, {k: v.detach() for k, v in flat(p).items()}


def jax_steps(model: dict, mesh: dict, shard: bool, x, y, micro: int = 2, T: int = 64,
              accum: int = 2):
    """The JAX package's mesh train step on the conftest's CPU devices:
    (losses, norms, final params as numpy by port name, initial params as
    the port's tree)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mamba_distributed_tpu.config import MeshConfig as JaxMesh
    from mamba_distributed_tpu.config import ModelConfig as JaxConfig
    from mamba_distributed_tpu.config import TrainConfig as JaxTrainConfig
    from mamba_distributed_tpu.models import init_lm_params as jax_init
    from mamba_distributed_tpu.parallel.mesh import build_mesh
    from mamba_distributed_tpu.parallel.sharding import opt_state_shardings, param_shardings
    from mamba_distributed_tpu.training.optimizer import make_optimizer
    from mamba_distributed_tpu.training.train_step import make_train_step
    from mamba_distributed_tpu_torch import convert

    dp = mesh.get("data", 1) * mesh.get("fsdp", 1)
    jcfg = JaxTrainConfig(model=JaxConfig(**model), mesh=JaxMesh(**mesh), shard_params=shard,
                          micro_batch_size=micro, seq_len=T,
                          total_batch_size=micro * T * dp * accum, warmup_steps=2,
                          max_steps=10)
    jmesh = build_mesh(jcfg.mesh, jax.devices()[:dp])
    params = jax_init(jax.random.PRNGKey(0), jcfg.model)
    start = convert.params_from_jax(jax.tree.map(np.asarray, params))
    pshard = param_shardings(params, jmesh, shard)
    p = jax.device_put(jax.tree.map(jnp.copy, params), pshard)
    optimizer = make_optimizer(jcfg)
    oshard = opt_state_shardings(jax.eval_shape(optimizer.init, p), params, pshard, jmesh)
    state = jax.jit(optimizer.init, out_shardings=oshard)(p)
    step = make_train_step(jcfg, optimizer, jmesh, p, state)
    ashard = NamedSharding(jmesh, P(None, ("data", "fsdp")))
    losses, norms = [], []
    for xs, ys in zip(x, y):
        p, state, loss, norm = step(p, state, jax.device_put(xs.astype(np.int32), ashard),
                                    jax.device_put(ys.astype(np.int32), ashard))
        losses.append(float(loss))
        norms.append(float(norm))
    final = flat(convert.params_from_jax(jax.tree.map(np.asarray, p)))
    return losses, norms, final, start


@pytest.mark.parametrize("mesh,shard", [(dict(data=2), False), (dict(fsdp=2), True)],
                         ids=["ddp-data2", "fsdp2"])
def test_two_rank_step_matches_jax_mesh_step(tmp_path, mesh, shard):
    x, y = batches(1, 2, 2, 4, 64, TINY_MODEL["vocab_size"])
    jl, jn, jparams, start = jax_steps(TINY_MODEL, mesh, shard, x, y)
    outs = run_step_case(tmp_path, TINY_MODEL, mesh, shard, start, x, y)
    assert sorted(o["coordinate"] for o in outs) == [0, 1]
    for o in outs:
        np.testing.assert_allclose(o["losses"], jl, rtol=2e-4)
        np.testing.assert_allclose(o["norms"], jn, rtol=2e-4)
        assert set(o["params"]) == set(jparams)
        for k, v in o["params"].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jparams[k]), atol=1e-5, rtol=0,
                                       err_msg=k)
    assert outs[0]["losses"] == outs[1]["losses"] and outs[0]["norms"] == outs[1]["norms"]
    if shard:  # every sharded leaf and its moments hold 1/2 a rank
        for o in outs:
            halved = [k for k in o["full"] if o["local"][k] * 2 == o["full"][k]]
            assert len(halved) >= len(o["full"]) - 3, o["local"]
            for k in o["full"]:
                assert o["local"][k] in (o["full"][k], o["full"][k] // 2), k
                assert o["moments"][k] == o["local"][k], k
            assert 2 * sum(o["local"].values()) < 1.1 * sum(o["full"].values())
    else:
        for o in outs:
            assert o["local"] == o["full"] and o["comm"]["buckets"] >= 1
            assert o["comm"]["bytes"] == 4 * (sum(o["full"].values()) + 1)


def _single_case(tmp_path, model: dict, mesh: dict, shard: bool, micro: int = 2):
    from mamba_distributed_tpu_torch.models.lm import init_lm_params

    dp = mesh.get("data", 1) * mesh.get("fsdp", 1)
    params = init_lm_params(ModelConfig(**model), torch.Generator().manual_seed(0))
    x, y = batches(2, 2, 2, micro * dp, 64, model["vocab_size"])
    sl, sn, sp = port_single(model, params, x, y, micro * dp)
    outs = run_step_case(tmp_path, model, mesh, shard, params, x, y, micro=micro)
    assert sorted(o["coordinate"] for o in outs) == list(range(dp))
    for o in outs:
        np.testing.assert_allclose(o["losses"], sl, rtol=2e-4)
        np.testing.assert_allclose(o["norms"], sn, rtol=2e-4)
        for k, v in o["params"].items():
            np.testing.assert_allclose(v.numpy(), sp[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
    return outs


def test_four_ranks_data2_fsdp2_match_single_device(tmp_path):
    outs = _single_case(tmp_path, TINY_MODEL, dict(data=2, fsdp=2), True)
    for o in outs:
        assert 2 * sum(o["local"].values()) < 1.1 * sum(o["full"].values())


def test_mamba1_data2_matches_single_device(tmp_path):
    _single_case(tmp_path, {**TINY_MODEL, "ssm_layer": "mamba1", "d_state": 16}, dict(data=2),
                 False)


def test_hybrid_fsdp2_matches_single_device(tmp_path):
    outs = _single_case(tmp_path, {**TINY_MODEL, **HYBRID_OVER}, dict(fsdp=2), True)
    for o in outs:
        assert 2 * sum(o["local"].values()) < 1.1 * sum(o["full"].values())


CASES = {"collectives": _case_collectives, "step": _case_step}

if __name__ == "__main__":
    case, rank, world, work = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    result = CASES[case](rank, world, work)
    torch.save(result, work / f"out_{rank}.pt")
    import torch.distributed as dist

    dist.destroy_process_group()
