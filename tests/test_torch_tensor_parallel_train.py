"""The port's ``Trainer``, checkpoints and CLI over a tensor mesh, on the
CPU (gloo processes, the launcher of ``tests/test_torch_parallel.py``).

* a world-2 ``Trainer`` at ``tensor=2``: both ranks log the same losses
  and grad norms, equal to the one-device ``Trainer`` at the same
  micro-batch within rtol 2e-4; both ranks read the same rows (batch
  coordinate 0); only rank 0 writes the log; ``sample()`` gathers the
  full params on both ranks and generates on rank 0;
* a tensor=2 checkpoint (the logical tree, gathered over tensor and
  unpacked) resumes bit for bit at tensor=2, and its params, moments
  and cursor load into a one-device trainer, whose next loss equals the
  tensor-2 run's within rtol 2e-4;
* ``torchrun --nproc_per_node=2 -m mamba_distributed_tpu_torch.train
  --mesh-tensor 2 --device cpu`` exits 0 and prints each reference line
  once; a tensor mesh with no process group, NCCL on the CPU and an
  unknown backend raise.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import ROOT, flat, join_group, spawn
from tests.test_torch_parallel_train import trainer_cfg

pytestmark = pytest.mark.torch

MODULE = "tests.test_torch_tensor_parallel_train"


def _case_trainer(rank: int, world: int, work: Path) -> dict:
    from mamba_distributed_tpu_torch.training import Trainer

    join_group(world, work)
    t = Trainer(trainer_cfg(work, dict(tensor=2), 2), device="cpu",
                sample_prompt_ids=[5, 17, 30])
    t.run(max_steps=3)
    sample = t.sample(num_return=2, max_new_tokens=4)
    local = {k: v.numel() for k, v in flat(t.params).items()}
    out = {"history": [t.history[s] for s in range(3)], "master": t.master,
           "batch_rank": t.batch_rank, "tp_rank": t.tp.rank, "local": local,
           "sample": None if sample is None else sample.tolist()}
    t.finish()
    return out


def _case_ckpt(rank: int, world: int, work: Path) -> dict:
    from mamba_distributed_tpu_torch.training import Trainer

    cfg = trainer_cfg(work, dict(tensor=2), 2, checkpoint_every=2)
    join_group(world, work, "pg1")
    a = Trainer(cfg, device="cpu", verbose=False)
    a.run(max_steps=4, checkpoint_dir=str(work / "ck"))
    ran = [a.history[s] for s in range(4)]
    a.finish()
    join_group(world, work, "pg2")  # finish() destroyed the first group
    b = Trainer(cfg, device="cpu", verbose=False)
    b.restore_checkpoint(str(work / "ck"))
    start = b.step
    b.run(max_steps=4)
    resumed = [b.history[s] for s in range(start, 4)]
    b.finish()
    return {"ran": ran, "resumed": resumed, "start": start}


def test_tensor2_trainer_equal_ranks_and_single_device(tmp_path):
    from mamba_distributed_tpu_torch.training import Trainer

    outs = spawn(MODULE, "trainer", 2, tmp_path)
    assert [o["master"] for o in outs] == [True, False]
    assert [o["batch_rank"] for o in outs] == [0, 0]  # one tensor group reads one block
    assert [o["tp_rank"] for o in outs] == [0, 1]
    h0, h1 = (np.array(o["history"]) for o in outs)
    np.testing.assert_array_equal(h0, h1)
    assert np.isfinite(h0).all()
    single = Trainer(trainer_cfg(tmp_path / "single", {}, 2), device="cpu", verbose=False)
    single.run(max_steps=3)
    np.testing.assert_allclose(h0, np.array([single.history[s] for s in range(3)]), rtol=2e-4)
    full = {k: v.numel() for k, v in flat(single.params).items()}
    single.finish()
    # the mixer's split leaves hold half of each, the replicated ones all
    for o in outs:
        assert o["local"]["blocks.mixer.out_proj.kernel"] * 2 == full[
            "blocks.mixer.out_proj.kernel"]
        assert o["local"]["embedding"] == full["embedding"]
    assert np.array(outs[0]["sample"]).shape == (2, 7) and outs[1]["sample"] is None
    lines = (tmp_path / "log" / "log.txt").read_text().splitlines()
    assert [ln.split()[:2] for ln in lines] == [["0", "val"], ["0", "train"], ["1", "train"],
                                                ["2", "val"], ["2", "train"]]


def test_tensor2_checkpoint_resumes_and_loads_on_one_device(tmp_path):
    from mamba_distributed_tpu_torch.training import Trainer
    from mamba_distributed_tpu_torch.training.checkpoint import restore_checkpoint

    outs = spawn(MODULE, "ckpt", 2, tmp_path)
    for o in outs:
        assert o["start"] == 2
        assert o["resumed"] == o["ran"][2:]  # bit for bit
    assert outs[0]["ran"] == outs[1]["ran"]
    ck = restore_checkpoint(str(tmp_path / "ck"))
    assert ck["step"] == 2 and len(ck["loaders"]) == 1
    # the logical tree: the one-device trainer's shapes, and it loads there
    one = Trainer(trainer_cfg(tmp_path, {}, 2), device="cpu", verbose=False)
    for k, v in flat(one.params).items():
        assert flat(ck["params"])[k].shape == v.shape, k
        assert flat(ck["opt_state"]["mu"])[k].shape == v.shape, k
    one.restore_checkpoint(str(tmp_path / "ck"))
    assert one.step == 2 and one.optimizer.count == 2
    for k, v in flat(ck["params"]).items():
        assert torch.equal(flat(one.params)[k].detach(), v), k
    one.run(max_steps=3)
    np.testing.assert_allclose(one.history[2], outs[0]["ran"][2], rtol=2e-4)
    one.finish()


def test_torchrun_cli_tensor2_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
           "-m", "mamba_distributed_tpu_torch.train", "--preset", "mamba2-tiny",
           "--mesh-tensor", "2", "--device", "cpu", "--max-steps", "2", "--seq-len", "64",
           "--micro-batch-size", "2", "--total-batch-size", "128",
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


def test_tensor_mesh_refusals(tmp_path, monkeypatch):
    from mamba_distributed_tpu_torch.parallel.mesh import init_distributed
    from mamba_distributed_tpu_torch.training import Trainer

    with pytest.raises(RuntimeError, match="no process group is up"):
        Trainer(trainer_cfg(tmp_path, dict(tensor=2), 2), device="cpu", verbose=False)
    for k in ("RANK", "LOCAL_RANK"):
        monkeypatch.setenv(k, "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="NCCL runs on cards"):
        init_distributed("cpu", backend="nccl")
    with pytest.raises(ValueError, match="backend must be"):
        init_distributed("cpu", backend="mpi")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no card"):
            init_distributed("cuda:0", backend="gloo")


CASES = {"trainer": _case_trainer, "ckpt": _case_ckpt}

if __name__ == "__main__":
    case, rank, world, work = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    torch.save(CASES[case](rank, world, work), work / f"out_{rank}.pt")
