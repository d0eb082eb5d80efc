"""The port's train step, ``Trainer``, checkpoints and CLI over a seq
mesh, on the CPU (gloo processes, the launcher of
``tests/test_torch_parallel.py``).

* ``data=2 x seq=2`` (4 ranks) trains the hybrid (ring attention, rotary
  on) 2 steps (accum 2) on the JAX params and global batch, each rank on
  its rows' block of tokens: losses and pre-clip grad norms equal the JAX
  mesh step's at ``data=2, seq=2`` (with its ``SeqContext``) at rtol
  1e-4, and the params after the steps at atol 1e-5;
* ``fsdp=2 x seq=2`` with ``shard_params`` equals the port's one-device
  step on the whole batch at the same tolerances, each rank holding half
  of every sharded leaf;
* a world-2 ``Trainer`` at ``seq=2``: both ranks read the same rows
  (batch coordinate 0) and log the same history; its checkpoint resumes
  bit for bit at ``seq=2`` and loads on one device, whose next step
  equals the ``seq=2`` run's at rtol 2e-4;
* ``torchrun --nproc_per_node=2 -m mamba_distributed_tpu_torch.train
  --mesh-seq 2 --attn-sp-impl ulysses --device cpu`` exits 0 and prints
  each reference line once;
* the refusals: seq with tensor, with expert (a MoE), a seq_len the seq
  size does not divide, and a shard shorter than the conv halo.
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
# the step cases: (model, mesh, shard_params)
STEPS = {"data2-seq2": (HYBRID, dict(data=2, seq=2), False),
         "fsdp2-seq2": (TINY_MODEL, dict(fsdp=2, seq=2), True)}
MICRO, T, ACCUM = 2, 64, 2


def step_cfg(model: dict, mesh: dict, shard: bool) -> TrainConfig:
    dp = mesh.get("data", 1) * mesh.get("fsdp", 1)
    return TrainConfig(model=ModelConfig(**model), mesh=MeshConfig(**mesh), shard_params=shard,
                       micro_batch_size=MICRO, seq_len=T,
                       total_batch_size=MICRO * T * dp * ACCUM, warmup_steps=2, max_steps=10)


# -------------------------------------------------------------- the workers


def _mesh_step(name: str, case: dict) -> dict:
    """The port's mesh train step at ``STEPS[name]``: this rank's fsdp
    block, its rows and its block of their tokens, 2 steps, then the
    gathered params."""
    from mamba_distributed_tpu_torch.parallel.collectives import SP_COMM
    from mamba_distributed_tpu_torch.parallel.mesh import build_mesh, seq_context
    from mamba_distributed_tpu_torch.parallel.sharding import (
        batch_coordinate,
        gather_params,
        param_specs,
        shard_params,
    )
    from mamba_distributed_tpu_torch.training.optimizer import AdamW, tree_map
    from mamba_distributed_tpu_torch.training.train_step import make_train_step

    model, mesh_kw, shard = STEPS[name]
    cfg = step_cfg(model, mesh_kw, shard)
    m = cfg.mesh
    mesh = build_mesh(m, "cpu")
    seq = seq_context(mesh)
    specs = param_specs(case["params"], shard, m.fsdp, m.tensor, m.pipe, m.expert)
    group = mesh.get_group("fsdp") if shard else None
    params = shard_params(case["params"], specs, group) if shard else case["params"]
    params = tree_map(lambda t: t.clone().requires_grad_(), params)
    step = make_train_step(cfg, AdamW(cfg, params), mesh, specs)
    c = batch_coordinate(mesh)
    rows = slice(c * MICRO, (c + 1) * MICRO)
    cols = slice(seq.rank * T // seq.size, (seq.rank + 1) * T // seq.size)
    out = {"coordinate": c, "seq_rank": seq.rank, "losses": [], "norms": []}
    SP_COMM.update(calls=0, bytes=0)
    for x, y in zip(case["x"], case["y"]):
        loss, norm = step(params, x[:, rows, cols], y[:, rows, cols])
        out["losses"].append(float(loss))
        out["norms"].append(float(norm))
    out["sp_comm"] = dict(SP_COMM)
    full = gather_params(params, specs, group) if shard else params
    out["params"] = {k: v.detach() for k, v in flat(full).items()}
    out["local"] = {k: v.numel() for k, v in flat(params).items()}
    return out


def _case_steps(rank: int, world: int, work: Path) -> dict:
    join_group(world, work)
    inp = torch.load(work / "inputs.pt", weights_only=True)
    return {name: _mesh_step(name, inp[name]) for name in STEPS}


def _case_trainer(rank: int, world: int, work: Path) -> dict:
    from mamba_distributed_tpu_torch.training import Trainer

    cfg = trainer_cfg(work, dict(seq=2), 2, checkpoint_every=2)
    join_group(world, work, "pg1")
    a = Trainer(cfg, device="cpu")
    a.run(max_steps=4, checkpoint_dir=str(work / "ck"))
    ran = [a.history[s] for s in range(4)]
    out = {"master": a.master, "batch_rank": a.batch_rank, "seq_rank": a.seq.rank}
    a.finish()
    join_group(world, work, "pg2")  # finish() destroyed the first group
    b = Trainer(cfg, device="cpu", verbose=False)
    b.restore_checkpoint(str(work / "ck"))
    start_step = b.step
    b.run(max_steps=4)
    resumed = [b.history[s] for s in range(start_step, 4)]
    b.finish()
    return {**out, "ran": ran, "resumed": resumed, "start": start_step}


# --------------------------------------------------------- the references


def jax_seq_steps(model: dict, mesh: dict, params, x, y):
    """The JAX package's mesh train step at ``mesh`` with its seq context
    on the conftest's CPU devices, from the JAX ``params``: (losses,
    norms, final params by port name)."""
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

    dp = mesh.get("data", 1) * mesh.get("fsdp", 1)
    jcfg = JaxTrainConfig(model=JaxConfig(**model), mesh=JaxMesh(**mesh),
                          micro_batch_size=MICRO, seq_len=T,
                          total_batch_size=MICRO * T * dp * ACCUM, warmup_steps=2,
                          max_steps=10)
    jmesh = build_mesh(jcfg.mesh, jax.devices()[:jcfg.mesh.num_devices])
    pshard = param_shardings(params, jmesh, False)
    p = jax.device_put(jax.tree.map(jnp.copy, params), pshard)
    optimizer = make_optimizer(jcfg)
    oshard = opt_state_shardings(jax.eval_shape(optimizer.init, p), params, pshard, jmesh)
    state = jax.jit(optimizer.init, out_shardings=oshard)(p)
    step = make_train_step(jcfg, optimizer, jmesh, p, state,
                           seq_ctx=SeqContext(jmesh, "seq", ("data", "fsdp")))
    ashard = NamedSharding(jmesh, P(None, *batch_spec(jmesh, seq_sharded=True)))
    losses, norms = [], []
    for xs, ys in zip(x, y):
        p, state, loss, norm = step(p, state, jax.device_put(xs.astype(np.int32), ashard),
                                    jax.device_put(ys.astype(np.int32), ashard))
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank step cases, the 2-rank trainer and the CLI, started
    together; the JAX and one-device references computed while they run."""
    import jax

    from mamba_distributed_tpu.config import ModelConfig as JaxConfig
    from mamba_distributed_tpu.models import init_lm_params as jax_init
    from mamba_distributed_tpu_torch import convert
    from mamba_distributed_tpu_torch.models.lm import init_lm_params

    work = tmp_path_factory.mktemp("sp_steps")
    x, y = batches(5, 2, ACCUM, MICRO * 2, T, HYBRID["vocab_size"])
    inp = {name: {"x": torch.from_numpy(x), "y": torch.from_numpy(y)} for name in STEPS}
    jp = jax.jit(jax_init, static_argnums=1)(jax.random.PRNGKey(0), JaxConfig(**HYBRID))
    inp["data2-seq2"]["params"] = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    inp["fsdp2-seq2"]["params"] = init_lm_params(ModelConfig(**TINY_MODEL),
                                                 torch.Generator().manual_seed(0))
    torch.save(inp, work / "inputs.pt")
    steps = start(MODULE, "steps", 4, work)
    trainer_dir = tmp_path_factory.mktemp("sp_trainer")
    trainer = start(MODULE, "trainer", 2, trainer_dir)
    cli_dir = tmp_path_factory.mktemp("sp_cli")
    cli = _cli(cli_dir)
    refs = {}
    jl, jn, final = jax_seq_steps(HYBRID, dict(data=2, seq=2), jp, x, y)
    refs["data2-seq2"] = {"losses": jl, "norms": jn, "params": final}
    sl, sn, sp = port_single(TINY_MODEL, inp["fsdp2-seq2"]["params"], x, y, MICRO * 2, T,
                             ACCUM)
    refs["fsdp2-seq2"] = {"losses": sl, "norms": sn, "params": sp}
    return {"steps": steps(), "refs": refs, "trainer": trainer(), "trainer_dir": trainer_dir,
            "cli": cli(), "cli_dir": cli_dir}


# -------------------------------------------------------------------- tests


@pytest.mark.parametrize("name", list(STEPS))
def test_seq_mesh_step_matches_its_reference(runs, name):
    """data=2 x seq=2 against the JAX mesh step at that mesh, fsdp=2 x
    seq=2 against the one-device port."""
    outs, ref = runs["steps"], runs["refs"][name]
    got = sorted((o[name]["coordinate"], o[name]["seq_rank"]) for o in outs)
    assert got == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for o in outs:
        r = o[name]
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(r["norms"], ref["norms"], rtol=1e-4, err_msg=name)
        assert set(r["params"]) == set(ref["params"])
        for k, v in r["params"].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(ref["params"][k]), atol=1e-5,
                                       rtol=0, err_msg=f"{name} {k}")
        assert r["sp_comm"]["calls"] > 0 and r["sp_comm"]["bytes"] > 0
    if name.startswith("fsdp"):  # half of each sharded leaf a rank
        full = {k: v.numel() for k, v in outs[0][name]["params"].items()}
        for o in outs:
            assert 2 * sum(o[name]["local"].values()) < 1.1 * sum(full.values())


def test_seq2_trainer_resumes_bit_for_bit_and_loads_on_one_device(runs):
    from mamba_distributed_tpu_torch.training import Trainer
    from mamba_distributed_tpu_torch.training.checkpoint import restore_checkpoint

    outs, work = runs["trainer"], runs["trainer_dir"]
    assert [o["master"] for o in outs] == [True, False]
    assert [o["batch_rank"] for o in outs] == [0, 0]  # one seq group reads one block
    assert [o["seq_rank"] for o in outs] == [0, 1]
    assert outs[0]["ran"] == outs[1]["ran"]
    assert np.isfinite(np.array(outs[0]["ran"])).all()
    for o in outs:
        assert o["start"] == 2 and o["resumed"] == o["ran"][2:]  # bit for bit
    ck = restore_checkpoint(str(work / "ck"))
    assert ck["step"] == 2 and len(ck["loaders"]) == 1
    one = Trainer(trainer_cfg(work, {}, 2), device="cpu", verbose=False)
    one.restore_checkpoint(str(work / "ck"))
    assert one.step == 2
    for k, v in flat(ck["params"]).items():
        assert torch.equal(flat(one.params)[k].detach(), v), k
    one.run(max_steps=3)
    np.testing.assert_allclose(one.history[2], outs[0]["ran"][2], rtol=2e-4)
    one.finish()
    lines = (work / "log" / "log.txt").read_text().splitlines()
    assert [ln.split()[:2] for ln in lines][:3] == [["0", "val"], ["0", "train"],
                                                    ["1", "train"]]


def test_torchrun_cli_seq2_on_the_cpu(runs):
    rc, out = runs["cli"]
    assert rc == 0, out[-3000:]
    for line in ("step     0 |", "step     1 |", "model params:"):
        assert out.count(line) == 1, (line, out[-3000:])
    lines = (runs["cli_dir"] / "l" / "log.txt").read_text().splitlines()
    assert [ln.split()[:2] for ln in lines] == [["0", "val"], ["0", "train"], ["1", "val"],
                                                ["1", "train"]]


REFUSALS = {
    "tensor": (dict(seq=2, tensor=2), {}, 64, "seq with tensor comes with seq x tensor"),
    "expert": (dict(seq=2, expert=2), dict(d_intermediate=32, moe_num_experts=4), 64,
               "seq with expert comes with seq x expert"),
    "moe": (dict(seq=2, data=2), dict(d_intermediate=32, moe_num_experts=4), 64,
            "and a MoE model.*seq with expert comes with"),
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
