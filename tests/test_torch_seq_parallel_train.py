"""The port's train step, ``Trainer``, checkpoints and CLI over seq and
pipe meshes, alone and composed, on the CPU (gloo processes, the
launcher of ``tests/test_torch_parallel.py``).

Each step case trains 2 steps (accum 2) from the JAX params on the
global batch, each rank on its rows, its block of their tokens (seq),
its packed heads (tensor), its experts (expert) or its stage (pipe):

* against the JAX mesh step at the same mesh (with its ``SeqContext``
  under seq): ``data=2 x seq=2`` (the hybrid, ring attention, rotary
  on); ``seq=2 x tensor=2``: the hybrid with ring attention, with
  Ulysses (1 KV head a tensor rank, so the heads are gathered over
  tensor first) and Mamba-1; a MoE hybrid (capacity factor 1.0, so
  choices drop) at ``data=2 x seq=2`` and at ``seq=2 x expert=2``;
  ``pipe=2`` and ``pipe=2 x data=2``, a uniform Mamba-2 stack and a
  periodic hybrid: losses and pre-clip grad norms at rtol 1e-4, the
  params after the steps at atol 1e-5;
* ``fsdp=2 x seq=2`` with ``shard_params`` against the port's
  one-device step on the whole batch at the same tolerances, each rank
  holding half of every sharded leaf;
* a world-2 ``Trainer`` at ``seq=2``: both ranks read the same rows
  (batch coordinate 0) and log the same history; its checkpoint resumes
  bit for bit at ``seq=2`` and loads on one device, whose next step
  equals the ``seq=2`` run's at rtol 2e-4; the same for ``pipe=2``,
  each stage holding its half of the layers;
* ``torchrun --nproc_per_node=2 -m mamba_distributed_tpu_torch.train
  --mesh-seq 2 --attn-sp-impl ulysses --device cpu`` exits 0 and prints
  each reference line once;
* the refusals: a seq_len the seq size does not divide, and a shard
  shorter than the conv halo; the pipeline refuses the blocked loss with
  JAX's message.

The 4-rank cases run in one spawn, one mesh after another over one gloo
group; the 2-rank pipe steps and both trainers in another.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mamba_distributed_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from tests.test_torch_parallel import (
    HYBRID_OVER,
    MOE_OVER,
    ROOT,
    TINY_MODEL,
    batches,
    flat,
    join_group,
    port_single,
    start,
)
from tests.test_torch_parallel_train import trainer_cfg

pytestmark = pytest.mark.torch

MODULE = "tests.test_torch_seq_parallel_train"
HYBRID = {**TINY_MODEL, **HYBRID_OVER}
# the composed meshes' hybrid: a Mamba-2 block, then attention
HYBRID_2 = {**HYBRID, "n_layer": 2, "attn_layer_idx": (1,)}
MAMBA1 = {**TINY_MODEL, "ssm_layer": "mamba1", "d_state": 16}
# a MoE after every mixer, routed at capacity factor 1.0 so that choices drop
MOE = {**HYBRID_2, **MOE_OVER, "moe_capacity_factor": 1.0}
# the step cases: (model, mesh, shard_params); a mesh with fsdp is held
# against the port's one-device step, every other against the JAX mesh step
STEPS = {"data2-seq2": (HYBRID, dict(data=2, seq=2), False),
         "fsdp2-seq2": (TINY_MODEL, dict(fsdp=2, seq=2), True),
         "seq2-tensor2-ring": (HYBRID_2, dict(seq=2, tensor=2), False),
         "seq2-tensor2-ulysses": ({**HYBRID_2, "attn_sp_impl": "ulysses"},
                                  dict(seq=2, tensor=2), False),
         "seq2-tensor2-mamba1": (MAMBA1, dict(seq=2, tensor=2), False),
         "data2-seq2-moe": (MOE, dict(data=2, seq=2), False),
         "seq2-expert2": (MOE, dict(seq=2, expert=2), False),
         "pipe2-data2-mamba2": (TINY_MODEL, dict(pipe=2, data=2), False),
         "pipe2-data2-hybrid": (HYBRID, dict(pipe=2, data=2), False),
         "pipe2-mamba2": (TINY_MODEL, dict(pipe=2), False),
         "pipe2-hybrid": (HYBRID, dict(pipe=2), False)}
TWO = ("pipe2-mamba2", "pipe2-hybrid")
FOUR = tuple(n for n in STEPS if n not in TWO)
MICRO, T, ACCUM = 2, 64, 2


def accum(mesh: dict) -> int:
    """The micro-batches a step: a pipeline streams 4 through its 2 stages
    (more microbatches than stages, as the JAX package's pipeline tests)."""
    return 4 if "pipe" in mesh else ACCUM


def batch_ranks(mesh: dict) -> int:
    return mesh.get("data", 1) * mesh.get("fsdp", 1) * mesh.get("expert", 1)


def step_cfg(model: dict, mesh: dict, shard: bool) -> TrainConfig:
    return TrainConfig(model=ModelConfig(**model), mesh=MeshConfig(**mesh), shard_params=shard,
                       micro_batch_size=MICRO, seq_len=T,
                       total_batch_size=MICRO * T * batch_ranks(mesh) * accum(mesh),
                       warmup_steps=2,
                       max_steps=10)


# -------------------------------------------------------------- the workers


def _mesh_step(name: str, case: dict) -> dict:
    """The port's mesh train step at ``STEPS[name]``: this rank's stage,
    experts, packed tensor shard and fsdp block, its rows and its block
    of their tokens, 2 steps, then the gathered params."""
    from mamba_distributed_tpu_torch.parallel.collectives import EP_COMM, PP_COMM, SP_COMM
    from mamba_distributed_tpu_torch.parallel.mesh import (
        build_mesh,
        expert_context,
        pipe_context,
        seq_context,
        tensor_context,
    )
    from mamba_distributed_tpu_torch.parallel.sharding import (
        batch_coordinate,
        executed_specs,
        expert_shard,
        gather_params,
        param_specs,
        shard_params,
        stage_block,
    )
    from mamba_distributed_tpu_torch.parallel.tp_layout import pack_tp, tp_plan
    from mamba_distributed_tpu_torch.training.optimizer import AdamW, tree_map
    from mamba_distributed_tpu_torch.training.train_step import make_train_step

    model, mesh_kw, shard = STEPS[name]
    cfg = step_cfg(model, mesh_kw, shard)
    m = cfg.mesh
    mesh = build_mesh(m, "cpu")
    seq, tp = seq_context(mesh), tensor_context(mesh)
    ep, pipe = expert_context(mesh), pipe_context(mesh)
    plan = tp_plan(cfg.model, tp.size) if tp is not None else None
    specs = param_specs(case["params"], shard, m.fsdp, m.tensor, m.pipe, m.expert)
    params = case["params"]
    if pipe is not None:
        params = stage_block(params, specs, pipe)
    if ep is not None:
        params = expert_shard(params, specs, ep)
    if tp is not None:
        params = pack_tp(params, plan, tp.rank)
        specs = executed_specs(specs, params, m.fsdp, plan)
    group = mesh.get_group("fsdp") if shard else None
    if shard:
        params = shard_params(params, specs, group)
    params = tree_map(lambda t: t.clone().requires_grad_(), params)
    step = make_train_step(cfg, AdamW(cfg, params), mesh, specs)
    c = batch_coordinate(mesh)
    rows = slice(c * MICRO, (c + 1) * MICRO)
    s, n = (0, 1) if seq is None else (seq.rank, seq.size)
    cols = slice(s * T // n, (s + 1) * T // n)
    out = {"coordinate": c, "seq_rank": s, "losses": [], "norms": []}
    for comm in (SP_COMM, PP_COMM):
        comm.update(calls=0, bytes=0)
    EP_COMM.update(calls=0, bytes=0, route_calls=0, route_bytes=0)
    for x, y in zip(case["x"], case["y"]):
        loss, norm = step(params, x[:, rows, cols], y[:, rows, cols])
        out["losses"].append(float(loss))
        out["norms"].append(float(norm))
    out.update(sp_comm=dict(SP_COMM), pp_comm=dict(PP_COMM), ep_comm=dict(EP_COMM))
    full = gather_params(params, specs, group, tp, plan, ep, pipe)
    out["params"] = {k: v.detach() for k, v in flat(full).items()}
    out["local"] = {k: v.numel() for k, v in flat(params).items()}
    return out


def _case_steps(rank: int, world: int, work: Path) -> dict:
    join_group(world, work)
    inp = torch.load(work / "inputs.pt", weights_only=True)
    return {name: _mesh_step(name, inp[name]) for name in FOUR}


def _trainer_run(work: Path, mesh: dict, tag: str) -> dict:
    """A world-2 ``Trainer`` at ``mesh``: 4 steps with a checkpoint at
    step 2, then a fresh trainer resumed from it to step 4."""
    from mamba_distributed_tpu_torch.training import Trainer

    work.mkdir(exist_ok=True)
    cfg = trainer_cfg(work, mesh, 2, checkpoint_every=2)
    join_group(2, work, f"{tag}1")
    a = Trainer(cfg, device="cpu")
    a.run(max_steps=4, checkpoint_dir=str(work / "ck"))
    ran = [a.history[s] for s in range(4)]
    out = {"master": a.master, "batch_rank": a.batch_rank,
           "seq_rank": a.seq.rank if a.seq is not None else None,
           "stage": a.pipe.rank if a.pipe is not None else None,
           "local": {k: v.numel() for k, v in flat(a.params).items()}}
    a.finish()
    join_group(2, work, f"{tag}2")  # finish() destroyed the first group
    b = Trainer(cfg, device="cpu", verbose=False)
    b.restore_checkpoint(str(work / "ck"))
    start_step = b.step
    b.run(max_steps=4)
    resumed = [b.history[s] for s in range(start_step, 4)]
    b.finish()
    return {**out, "ran": ran, "resumed": resumed, "start": start_step}


def _case_trainer(rank: int, world: int, work: Path) -> dict:
    import torch.distributed as dist

    join_group(world, work, "steps")
    inp = torch.load(work / "inputs.pt", weights_only=True)
    steps = {name: _mesh_step(name, inp[name]) for name in TWO}
    dist.destroy_process_group()
    return {"steps": steps, "seq": _trainer_run(work / "seq", dict(seq=2), "pg"),
            "pipe": _trainer_run(work / "pipe", dict(pipe=2), "pg")}


# --------------------------------------------------------- the references


def jax_mesh_steps(model: dict, mesh: dict, params, x, y):
    """The JAX package's mesh train step at ``mesh`` on the conftest's CPU
    devices (with its ``SeqContext`` under seq, over the batch axes of
    its batch spec), from the JAX ``params``: (losses, norms, final params
    by port name)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mamba_distributed_tpu.config import MeshConfig as JaxMesh
    from mamba_distributed_tpu.config import ModelConfig as JaxConfig
    from mamba_distributed_tpu.config import TrainConfig as JaxTrainConfig
    from mamba_distributed_tpu.parallel.mesh import build_mesh
    from mamba_distributed_tpu.parallel.seq_parallel import SeqContext
    from mamba_distributed_tpu.parallel.sharding import (
        batch_spec,
        opt_state_shardings,
        param_shardings,
    )
    from mamba_distributed_tpu.training.optimizer import make_optimizer
    from mamba_distributed_tpu.training.train_step import make_train_step
    from mamba_distributed_tpu_torch import convert

    jcfg = JaxTrainConfig(model=JaxConfig(**model), mesh=JaxMesh(**mesh),
                          micro_batch_size=MICRO, seq_len=T,
                          total_batch_size=MICRO * T * batch_ranks(mesh) * accum(mesh),
                          warmup_steps=2, max_steps=10)
    jmesh = build_mesh(jcfg.mesh, jax.devices()[:jcfg.mesh.num_devices])
    pshard = param_shardings(params, jmesh, False)
    p = jax.device_put(jax.tree.map(jnp.copy, params), pshard)
    optimizer = make_optimizer(jcfg)
    oshard = opt_state_shardings(jax.eval_shape(optimizer.init, p), params, pshard, jmesh)
    state = jax.jit(optimizer.init, out_shardings=oshard)(p)
    sp = jcfg.mesh.seq > 1
    seq_ctx = SeqContext(jmesh, "seq", tuple(batch_spec(jmesh)[0])) if sp else None
    step = make_train_step(jcfg, optimizer, jmesh, p, state, seq_ctx=seq_ctx)
    ashard = NamedSharding(jmesh, P(None, *batch_spec(jmesh, seq_sharded=sp)))
    batch = [[jax.device_put(v.astype(np.int32), ashard) for v in xy] for xy in zip(x, y)]
    # compiled without LLVM's optimizations: these steps are tiny, so the
    # compile is most of a reference's time (the results agree to fp32)
    step = step.lower(p, state, *batch[0]).compile({"xla_backend_optimization_level": 0})
    losses, norms = [], []
    for xs, ys in batch:
        p, state, loss, norm = step(p, state, xs, ys)
        losses.append(float(loss))
        norms.append(float(norm))
    final = flat(convert.params_from_jax(jax.tree.map(np.asarray, p)))
    return losses, norms, final


def _cli(tmp_path: Path):
    """Start the torchrun CLI at ``--mesh-seq 2``; returns its waiter."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
           "-m", "mamba_distributed_tpu_torch.train", "--preset", "hybrid-tiny",
           "--mesh-seq", "2", "--attn-sp-impl", "ulysses", "--device", "cpu",
           "--max-steps", "2", "--seq-len", "64", "--micro-batch-size", "2",
           "--total-batch-size", "128", "--data-dir", str(tmp_path / "d"),
           "--log-dir", str(tmp_path / "l")]
    log = tmp_path / "torchrun.txt"
    lf = open(log, "w")
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=lf, stderr=subprocess.STDOUT)

    def wait():
        try:
            proc.wait(timeout=150)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            lf.close()
        return proc.returncode, log.read_text()

    return wait


# ---------------------------------------------------------------- fixtures


def _inputs() -> dict:
    """Each step case's global batches and initial params (the JAX init,
    through ``convert.params_from_jax``, where the JAX mesh step is the
    reference, kept under "jax" too; the port's init otherwise)."""
    import jax

    from mamba_distributed_tpu.config import ModelConfig as JaxConfig
    from mamba_distributed_tpu.models import init_lm_params as jax_init
    from mamba_distributed_tpu_torch import convert
    from mamba_distributed_tpu_torch.models.lm import init_lm_params

    inp, jparams = {}, {}
    for name, (model, mesh, shard) in STEPS.items():
        x, y = batches(5, 2, accum(mesh), MICRO * batch_ranks(mesh), T, model["vocab_size"])
        inp[name] = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
        if shard:
            inp[name]["params"] = init_lm_params(ModelConfig(**model),
                                                 torch.Generator().manual_seed(0))
            continue
        key = tuple(sorted((k, v) for k, v in model.items() if k != "attn_sp_impl"))
        if key not in jparams:
            jparams[key] = jax.jit(jax_init, static_argnums=1)(jax.random.PRNGKey(0),
                                                               JaxConfig(**model))
        inp[name]["jax"] = jparams[key]
        inp[name]["params"] = convert.params_from_jax(jax.tree.map(np.asarray, jparams[key]))
    return inp


def _ref(inp: dict, name: str) -> dict:
    model, mesh, shard = STEPS[name]
    x, y = inp[name]["x"].numpy(), inp[name]["y"].numpy()
    if shard:
        got = port_single(model, inp[name]["params"], x, y, MICRO * batch_ranks(mesh), T,
                          accum(mesh))
    else:
        got = jax_mesh_steps(model, mesh, inp[name]["jax"], x, y)
    return dict(zip(("losses", "norms", "params"), got))


def _refs(inp: dict, names) -> dict:
    """Every case's reference, three at a time (XLA compiles outside the
    GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(3) as pool:
        return dict(zip(names, pool.map(lambda n: _ref(inp, n), names)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank step cases, the 2-rank pipe steps and trainers, and the
    CLI, started together; the JAX and one-device references computed
    while they run."""
    inp = _inputs()
    ported = {n: {k: v for k, v in case.items() if k != "jax"} for n, case in inp.items()}
    work = tmp_path_factory.mktemp("sp_steps")
    torch.save(ported, work / "inputs.pt")
    steps = start(MODULE, "steps", 4, work)
    trainer_dir = tmp_path_factory.mktemp("sp_trainer")
    torch.save({n: ported[n] for n in TWO}, trainer_dir / "inputs.pt")
    trainer = start(MODULE, "trainer", 2, trainer_dir)
    cli_dir = tmp_path_factory.mktemp("sp_cli")
    cli = _cli(cli_dir)
    refs = _refs(inp, STEPS)
    two = trainer()
    outs = {n: [o[n] for o in steps()] for n in FOUR}
    outs.update({n: [o["steps"][n] for o in two] for n in TWO})
    return {"steps": outs, "refs": refs, "trainer": two, "trainer_dir": trainer_dir,
            "cli": cli(), "cli_dir": cli_dir}


# -------------------------------------------------------------------- tests


@pytest.mark.parametrize("name", list(STEPS))
def test_seq_mesh_step_matches_its_reference(runs, name):
    """Every step case against the JAX mesh step at its mesh (fsdp
    against the one-device port)."""
    outs, ref = runs["steps"][name], runs["refs"][name]
    model, mesh, _ = STEPS[name]
    seq = mesh.get("seq", 1)
    got = sorted((o["coordinate"], o["seq_rank"]) for o in outs)
    per_block = len(outs) // (batch_ranks(mesh) * seq)  # tensor or pipe ranks
    assert got == sorted((c, s) for c in range(batch_ranks(mesh)) for s in range(seq)
                         for _ in range(per_block))
    for o in outs:
        np.testing.assert_allclose(o["losses"], ref["losses"], rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(o["norms"], ref["norms"], rtol=1e-4, err_msg=name)
        assert set(o["params"]) == set(ref["params"])
        for k, v in o["params"].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(ref["params"][k]), atol=1e-5,
                                       rtol=0, err_msg=f"{name} {k}")
        assert (o["sp_comm"]["calls"] > 0) == (seq > 1)
        if "moe_num_experts" in model:  # routed over the batch and seq ranks
            assert o["ep_comm"]["route_calls"] > 0
            assert (o["ep_comm"]["calls"] > 0) == ("expert" in mesh)
    full = {k: v.numel() for k, v in outs[0]["params"].items()}
    if name.startswith("fsdp"):  # half of each sharded leaf a rank
        for o in outs:
            assert 2 * sum(o["local"].values()) < 1.1 * sum(full.values())
    if "pipe" in mesh:  # half of every stacked leaf a stage, the schedule's shifts
        ticks = accum(mesh) + mesh["pipe"] - 1
        for o in outs:
            for k, n in o["local"].items():
                assert n * (2 if "blocks." in k else 1) == full[k], k
            # forward and backward, each step
            assert o["pp_comm"]["calls"] == 2 * 2 * (ticks - 1), o["pp_comm"]


def _check_trainer(out: list, work: Path, mesh: dict):
    from mamba_distributed_tpu_torch.training import Trainer
    from mamba_distributed_tpu_torch.training.checkpoint import restore_checkpoint

    assert [o["master"] for o in out] == [True, False]
    assert [o["batch_rank"] for o in out] == [0, 0]  # one seq or pipe group reads one block
    assert out[0]["ran"] == out[1]["ran"]
    assert np.isfinite(np.array(out[0]["ran"])).all()
    for o in out:
        assert o["start"] == 2 and o["resumed"] == o["ran"][2:]  # bit for bit
    ck = restore_checkpoint(str(work / "ck"))
    assert ck["step"] == 2 and len(ck["loaders"]) == 1
    one = Trainer(trainer_cfg(work, {}, 2), device="cpu", verbose=False)
    one.restore_checkpoint(str(work / "ck"))
    assert one.step == 2
    for k, v in flat(ck["params"]).items():
        assert torch.equal(flat(one.params)[k].detach(), v), k
    one.run(max_steps=3)
    np.testing.assert_allclose(one.history[2], out[0]["ran"][2], rtol=2e-4)
    one.finish()
    lines = (work / "log" / "log.txt").read_text().splitlines()
    assert [ln.split()[:2] for ln in lines][:3] == [["0", "val"], ["0", "train"],
                                                    ["1", "train"]]


def test_seq2_trainer_resumes_bit_for_bit_and_loads_on_one_device(runs):
    out = [o["seq"] for o in runs["trainer"]]
    assert [o["seq_rank"] for o in out] == [0, 1]
    _check_trainer(out, runs["trainer_dir"] / "seq", dict(seq=2))


def test_pipe2_trainer_resumes_bit_for_bit_and_loads_on_one_device(runs):
    from mamba_distributed_tpu_torch.training.checkpoint import restore_checkpoint

    out = [o["pipe"] for o in runs["trainer"]]
    assert [o["stage"] for o in out] == [0, 1]
    full = flat(restore_checkpoint(str(runs["trainer_dir"] / "pipe" / "ck"))["params"])
    for o in out:  # each stage half the layers, the rest whole
        for k, n in o["local"].items():
            assert n * (2 if k.startswith("blocks.") else 1) == full[k].numel(), k
    _check_trainer(out, runs["trainer_dir"] / "pipe", dict(pipe=2))


def test_torchrun_cli_seq2_on_the_cpu(runs):
    rc, out = runs["cli"]
    assert rc == 0, out[-3000:]
    for line in ("step     0 |", "step     1 |", "model params:"):
        assert out.count(line) == 1, (line, out[-3000:])
    lines = (runs["cli_dir"] / "l" / "log.txt").read_text().splitlines()
    assert [ln.split()[:2] for ln in lines] == [["0", "val"], ["0", "train"], ["1", "val"],
                                                ["1", "train"]]


REFUSALS = {
    "indivisible": (dict(seq=3), {}, 64, "seq_len=64 does not split over mesh.seq=3"),
    "halo": (dict(seq=32), {}, 64, "local sequence shard \\(2 tokens.*shorter than the "
             "conv halo \\(3\\)"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_seq_mesh_refusals(case):
    mesh, over, t, msg = REFUSALS[case]
    with pytest.raises(ValueError, match=msg):
        TrainConfig(model=ModelConfig(**{**TINY_MODEL, **over}), mesh=MeshConfig(**mesh),
                    micro_batch_size=2, seq_len=t, total_batch_size=2 * t * 64)


def test_pipeline_refuses_the_blocked_loss():
    from mamba_distributed_tpu_torch.training.optimizer import AdamW
    from mamba_distributed_tpu_torch.training.train_step import make_train_step

    cfg = step_cfg({**TINY_MODEL, "loss_impl": "blocked", "loss_vocab_blocks": 4},
                   dict(pipe=2), False)
    with pytest.raises(NotImplementedError, match="loss_impl='blocked' is not implemented "
                       "for pipeline parallelism"):
        make_train_step(cfg, AdamW(cfg, {"w": torch.zeros(1, requires_grad=True)}))


def test_sp_conv_refuses_a_shard_shorter_than_the_halo():
    from mamba_distributed_tpu_torch.parallel.seq_parallel import SeqContext, sp_conv1d

    with pytest.raises(ValueError, match="shorter than the conv halo \\(3\\)"):
        sp_conv1d(SeqContext(None, 2, 0), torch.zeros(1, 2, 4), torch.zeros(4, 4), None)


CASES = {"steps": _case_steps, "trainer": _case_trainer}

if __name__ == "__main__":
    case, rank, world, work = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    result = CASES[case](rank, world, work)
    torch.save(result, work / f"out_{rank}.pt")
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
