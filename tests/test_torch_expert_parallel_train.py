"""The port's ``Trainer``, checkpoints and CLI over an expert mesh, on the
CPU (gloo processes, the launcher of ``tests/test_torch_parallel.py``).

* a world-2 ``Trainer`` at ``expert=2`` on a MoE model (capacity factor
  1.0): both ranks log the same losses and grad norms, equal to the
  one-device ``Trainer`` at twice the micro-batch within rtol 1e-4; the
  two ranks read the two halves of the rows (batch coordinates 0 and 1),
  and each holds half of every expert stack;
* its checkpoint (the logical tree, gathered over expert) resumes bit
  for bit at ``expert=2``, and its params, moments and cursor load into
  a one-device trainer, whose next loss and grad norm equal the
  expert-2 run's within rtol 1e-4;
* ``torchrun --nproc_per_node=2 -m mamba_distributed_tpu_torch.train
  --moe-num-experts 4 --mesh-expert 2 --device cpu`` exits 0 and prints
  each reference line once; an expert mesh with no process group and a
  pipelined expert mesh raise.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mamba_distributed_tpu_torch.config import DataConfig, MeshConfig, ModelConfig, TrainConfig
from tests.test_torch_expert_parallel import MOE_MODEL, batch_ranks
from tests.test_torch_parallel import ROOT, flat, join_group, spawn

pytestmark = pytest.mark.torch

MODULE = "tests.test_torch_expert_parallel_train"


def moe_trainer_cfg(root: Path, mesh: dict, micro: int, **kw) -> TrainConfig:
    return TrainConfig(
        model=ModelConfig(**MOE_MODEL), mesh=MeshConfig(**mesh),
        data=DataConfig(data_dir=str(root / "data"), synthetic_tokens_per_shard=50_000),
        micro_batch_size=micro, seq_len=64, total_batch_size=micro * 64 * batch_ranks(mesh) * 2,
        warmup_steps=2, max_steps=100, val_every=1000, val_steps=2,
        log_dir=str(root / "log"), **kw)


def _case_ckpt(rank: int, world: int, work: Path) -> dict:
    from mamba_distributed_tpu_torch.training import Trainer

    cfg = moe_trainer_cfg(work, dict(expert=2), 2, checkpoint_every=2)
    join_group(world, work, "pg1")
    a = Trainer(cfg, device="cpu", verbose=False)
    a.run(max_steps=4, checkpoint_dir=str(work / "ck"))
    ran = [a.history[s] for s in range(4)]
    out = {"ran": ran, "batch_rank": a.batch_rank, "ep_rank": a.ep.rank,
           "local": {k: v.numel() for k, v in flat(a.params).items()}}
    a.finish()
    join_group(world, work, "pg2")  # finish() destroyed the first group
    b = Trainer(cfg, device="cpu", verbose=False)
    b.restore_checkpoint(str(work / "ck"))
    out["start"] = b.step
    b.run(max_steps=4)
    out["resumed"] = [b.history[s] for s in range(out["start"], 4)]
    b.finish()
    return out


def test_expert2_trainer_checkpoint_resumes_and_loads_on_one_device(tmp_path):
    from mamba_distributed_tpu_torch.training import Trainer
    from mamba_distributed_tpu_torch.training.checkpoint import restore_checkpoint

    outs = spawn(MODULE, "ckpt", 2, tmp_path)
    assert [o["batch_rank"] for o in outs] == [0, 1]
    assert [o["ep_rank"] for o in outs] == [0, 1]
    h0, h1 = (np.array(o["ran"]) for o in outs)
    np.testing.assert_array_equal(h0, h1)
    for o in outs:
        assert o["start"] == 2
        assert o["resumed"] == o["ran"][2:]  # bit for bit
    # the one-device trainer at twice the micro-batch reads the same rows
    single = Trainer(moe_trainer_cfg(tmp_path / "single", {}, 4), device="cpu", verbose=False)
    single.run(max_steps=2)
    np.testing.assert_allclose(h0[:2], np.array([single.history[s] for s in range(2)]),
                               rtol=1e-4)
    full = {k: v.numel() for k, v in flat(single.params).items()}
    single.finish()
    for o in outs:
        assert o["local"]["blocks.moe.w1"] * 2 == full["blocks.moe.w1"]
        assert o["local"]["blocks.moe.router.kernel"] == full["blocks.moe.router.kernel"]
    # the logical tree: the one-device shapes, and it loads there
    ck = restore_checkpoint(str(tmp_path / "ck"))
    assert ck["step"] == 2 and len(ck["loaders"]) == 2
    one = Trainer(moe_trainer_cfg(tmp_path, {}, 4), device="cpu", verbose=False)
    for k, v in flat(one.params).items():
        assert flat(ck["params"])[k].shape == v.shape, k
        assert flat(ck["opt_state"]["nu"])[k].shape == v.shape, k
    one.restore_checkpoint(str(tmp_path / "ck"))
    assert one.step == 2 and one.optimizer.count == 2
    for k, v in flat(ck["params"]).items():
        assert torch.equal(flat(one.params)[k].detach(), v), k
    one.run(max_steps=3)
    np.testing.assert_allclose(one.history[2], h0[2], rtol=1e-4)
    one.finish()


def test_torchrun_cli_expert2_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
           "-m", "mamba_distributed_tpu_torch.train", "--preset", "mamba2-tiny",
           "--d-intermediate", "64", "--moe-num-experts", "4", "--moe-capacity-factor", "1.0",
           "--mesh-expert", "2", "--device", "cpu", "--max-steps", "2", "--seq-len", "64",
           "--micro-batch-size", "2", "--total-batch-size", "256", "--n-layer", "2",
           "--data-dir", str(tmp_path / "d"), "--log-dir", str(tmp_path / "l")]
    log = tmp_path / "torchrun.txt"
    with open(log, "w") as lf:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=lf, stderr=subprocess.STDOUT)
        try:
            proc.wait(timeout=150)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = log.read_text()
    assert proc.returncode == 0, out[-3000:]
    for line in ("step     0 |", "step     1 |", "model params:"):
        assert out.count(line) == 1, (line, out[-3000:])
    lines = (tmp_path / "l" / "log.txt").read_text().splitlines()
    assert [ln.split()[:2] for ln in lines] == [["0", "val"], ["0", "train"], ["1", "val"],
                                                ["1", "train"]]


def test_expert_mesh_refusals(tmp_path):
    from mamba_distributed_tpu_torch.training import Trainer

    with pytest.raises(RuntimeError, match="no process group is up"):
        Trainer(moe_trainer_cfg(tmp_path, dict(expert=2), 2), device="cpu", verbose=False)
    with pytest.raises(ValueError, match="composes with data/fsdp only"):
        moe_trainer_cfg(tmp_path, dict(pipe=2, expert=2), 2)


CASES = {"ckpt": _case_ckpt}

if __name__ == "__main__":
    case, rank, world, work = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    torch.save(CASES[case](rank, world, work), work / f"out_{rank}.pt")
