"""The port's ``Trainer``, checkpoints and CLI over a mesh, on the CPU
(gloo processes, the launcher of ``tests/test_torch_parallel.py``).

* the rank-strided loaders of two batch ranks read exactly the rows of
  one loader of twice the rows while their windows stay in a shard; at
  a shard's end the reference's rule (the JAX package's loader too)
  moves a rank to the next shard one window before rank 0 when the
  shard's length leaves less than a window a rank, and the port's
  rank loaders then equal the JAX package's, step for step;
* a world-2 ``Trainer`` at ``data=2``: both ranks see the same losses
  and grad norms (rtol 1e-6, as ``tests/test_multihost.py`` asks), equal
  to the one-device ``Trainer`` at twice the micro-batch within rtol
  2e-4; only rank 0 writes the log;
* a world-2 FSDP checkpoint resumes bit for bit at world 2, and its
  params, moments and rank-0 cursor load into a one-device trainer,
  whose next loss equals the world-2 run's within rtol 2e-4;
* ``torchrun --nproc_per_node=2 -m mamba_distributed_tpu_torch.train
  --mesh-data 2 --device cpu`` exits 0 and prints each reference line
  once; ``--auto-restart`` at a world of 2 is refused by name; a mesh
  with no process group, and ``init_distributed`` outside torchrun or
  on a CUDA device with no card, raise.
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
from mamba_distributed_tpu_torch.data import ShardedTokenLoader, ensure_synthetic_shards
from tests.test_torch_parallel import ROOT, TINY_MODEL, flat, join_group, spawn

pytestmark = pytest.mark.torch


# -------------------------------------------------------------- the loaders


def _rows(loader, n):
    return [loader.next_batch()[0] for _ in range(n)]


def _single_and_ranks(d, B, T, W):
    kw = dict(T=T, data_dir=d, master_process=False, backend="numpy")
    single = ShardedTokenLoader(B=B * W, **kw)
    ranks = [ShardedTokenLoader(B=B, process_rank=r, num_processes=W, **kw) for r in range(W)]
    return single, ranks


def test_rank_loaders_read_the_single_loaders_rows(tmp_path):
    d = str(tmp_path / "data")
    ensure_synthetic_shards(d, vocab_size=256, tokens_per_shard=50_000, num_shards=2, seed=1)
    B, T, W = 2, 64, 2
    single, ranks = _single_and_ranks(d, B, T, W)
    # 50,000 tokens hold 195 windows of 2 x 2 x 64 + 1: stay inside shard 0
    for step, (whole, *parts) in enumerate(zip(_rows(single, 150),
                                               *(_rows(r, 150) for r in ranks))):
        np.testing.assert_array_equal(np.concatenate(parts), whole, err_msg=str(step))
    for ld in (single, *ranks):
        ld.close()


@pytest.mark.parametrize("length", [8192, 8224])
def test_rank_loaders_at_a_shard_end_follow_the_reference_rule(tmp_path, length):
    from mamba_distributed_tpu.data.loader import ShardedTokenLoader as JaxLoader

    rng = np.random.default_rng(0)
    for i in range(2):
        np.save(tmp_path / f"tok_train_{i:03d}.npy", rng.integers(0, 500, length).astype(np.uint16))
    B, T, W = 2, 32, 2
    bt, btw = B * T, B * T * W
    single, ranks = _single_and_ranks(str(tmp_path), B, T, W)
    jax_ranks = [JaxLoader(B, T, str(tmp_path), process_rank=r, num_processes=W,
                           master_process=False, backend="numpy") for r in range(W)]
    n = 2 * length // btw + 4  # past both shard ends
    whole, parts = _rows(single, n), [_rows(r, n) for r in ranks]
    for r in range(W):  # the port's rank loaders are the JAX package's
        for step, (a, b) in enumerate(zip(parts[r], _rows(jax_ranks[r], n))):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r} step {step}")
    # rank 0 leaves shard 0 after step k0, rank 1 after step k1 (the
    # first k whose next strided window would overrun the shard)
    k0 = next(k for k in range(n) if (k + 2) * btw + 1 > length)
    k1 = next(k for k in range(n) if (k + 2) * btw + bt + 1 > length)
    equal = [np.array_equal(np.concatenate([p[s] for p in parts]), whole[s]) for s in range(n)]
    if (length - 1) % btw >= (W - 1) * bt:  # the shard ends on a whole window a rank
        assert k1 == k0 and all(equal)
    else:  # rank 1 moves on a window early and the global batch parts from the single one
        assert k1 == k0 - 1
        assert all(equal[:k1 + 1]) and not equal[k1 + 1]
        np.testing.assert_array_equal(parts[1][k1 + 1], np.load(tmp_path / "tok_train_001.npy")[
            bt:2 * bt].astype(np.int32).reshape(B, T))
    for ld in (single, *ranks, *jax_ranks):
        ld.close()


# -------------------------------------------------------------- the trainer


def trainer_cfg(root: Path, mesh: dict, micro: int, shard: bool = False, **kw) -> TrainConfig:
    dp = mesh.get("data", 1) * mesh.get("fsdp", 1)
    return TrainConfig(
        model=ModelConfig(**TINY_MODEL), mesh=MeshConfig(**mesh), shard_params=shard,
        data=DataConfig(data_dir=str(root / "data"), synthetic_tokens_per_shard=50_000),
        micro_batch_size=micro, seq_len=64, total_batch_size=micro * 64 * dp * 2,
        warmup_steps=2, max_steps=100, val_every=1000, val_steps=2,
        log_dir=str(root / "log"), **kw)


def _case_trainer(rank: int, world: int, work: Path) -> dict:
    from mamba_distributed_tpu_torch.training import Trainer

    join_group(world, work)
    t = Trainer(trainer_cfg(work, dict(data=2), 2), device="cpu")
    t.run(max_steps=3)
    out = {"history": [t.history[s] for s in range(3)], "master": t.master,
           "verbose": t.verbose, "batch_rank": t.batch_rank}
    t.finish()
    return out


def _case_ckpt(rank: int, world: int, work: Path) -> dict:
    from mamba_distributed_tpu_torch.training import Trainer

    cfg = trainer_cfg(work, dict(fsdp=2), 2, shard=True, checkpoint_every=2)
    join_group(world, work, "pg1")
    a = Trainer(cfg, device="cpu", verbose=False)
    a.run(max_steps=4, checkpoint_dir=str(work / "ck"))
    local = {k: v.numel() for k, v in flat(a.params).items()}
    ran = [a.history[s] for s in range(4)]
    a.finish()
    join_group(world, work, "pg2")  # finish() destroyed the first group
    b = Trainer(cfg, device="cpu", verbose=False)
    b.restore_checkpoint(str(work / "ck"))
    start = b.step
    b.run(max_steps=4)
    resumed = [b.history[s] for s in range(start, 4)]
    b.finish()
    return {"ran": ran, "resumed": resumed, "start": start, "local": local}


def test_world2_trainer_equal_ranks_and_single_device(tmp_path):
    from mamba_distributed_tpu_torch.training import Trainer

    outs = spawn("tests.test_torch_parallel_train", "trainer", 2, tmp_path)
    assert [(o["master"], o["verbose"]) for o in outs] == [(True, True), (False, False)]
    assert [o["batch_rank"] for o in outs] == [0, 1]
    h0, h1 = (np.array(o["history"]) for o in outs)
    np.testing.assert_allclose(h0, h1, rtol=1e-6)
    assert np.isfinite(h0).all()
    single = Trainer(trainer_cfg(tmp_path / "single", {}, 4), device="cpu", verbose=False)
    single.run(max_steps=3)
    np.testing.assert_allclose(h0, np.array([single.history[s] for s in range(3)]), rtol=2e-4)
    single.finish()
    # records from the master only: one line a step and a validation
    lines = (tmp_path / "log" / "log.txt").read_text().splitlines()
    assert [ln.split()[:2] for ln in lines] == [["0", "val"], ["0", "train"], ["1", "train"],
                                                ["2", "val"], ["2", "train"]]


def test_world2_fsdp_checkpoint_resumes_and_loads_on_one_device(tmp_path):
    from mamba_distributed_tpu_torch.training import Trainer
    from mamba_distributed_tpu_torch.training.checkpoint import restore_checkpoint

    outs = spawn("tests.test_torch_parallel_train", "ckpt", 2, tmp_path)
    for o in outs:
        assert o["start"] == 2
        assert o["resumed"] == o["ran"][2:]  # bit for bit
    assert outs[0]["ran"] == outs[1]["ran"]
    ck = restore_checkpoint(str(tmp_path / "ck"))
    assert ck["step"] == 2 and len(ck["loaders"]) == 2
    full = {k: v.numel() for k, v in flat(ck["params"]).items()}
    assert 2 * sum(outs[0]["local"].values()) < 1.1 * sum(full.values())
    # the full params, moments and rank 0's cursor load into one device
    one = Trainer(trainer_cfg(tmp_path, {}, 4), device="cpu", verbose=False)
    one.restore_checkpoint(str(tmp_path / "ck"))
    assert one.step == 2 and one.optimizer.count == 2
    for k, v in flat(ck["params"]).items():
        assert torch.equal(flat(one.params)[k].detach(), v), k
    one.run(max_steps=3)
    np.testing.assert_allclose(one.history[2], outs[0]["ran"][2], rtol=2e-4)
    one.finish()


# ------------------------------------------------------------------ the CLI


def test_torchrun_cli_two_ranks_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
           "-m", "mamba_distributed_tpu_torch.train", "--preset", "mamba2-tiny",
           "--mesh-data", "2", "--device", "cpu", "--max-steps", "2", "--seq-len", "64",
           "--micro-batch-size", "2", "--total-batch-size", "256",
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
    assert out.count("validation loss:") == 2
    lines = (tmp_path / "l" / "log.txt").read_text().splitlines()
    assert [ln.split()[:2] for ln in lines] == [["0", "val"], ["0", "train"], ["1", "val"],
                                                ["1", "train"]]


def test_no_group_no_fallback(tmp_path, monkeypatch):
    from mamba_distributed_tpu_torch import train as cli
    from mamba_distributed_tpu_torch.parallel.mesh import init_distributed
    from mamba_distributed_tpu_torch.training import Trainer

    # a mesh of two ranks with no process group up
    with pytest.raises(RuntimeError, match="no process group is up"):
        Trainer(trainer_cfg(tmp_path, dict(data=2), 2), device="cpu", verbose=False)
    for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        init_distributed("cpu")
    for k in ("RANK", "LOCAL_RANK"):
        monkeypatch.setenv(k, "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no card"):
            init_distributed("cuda")
    with pytest.raises(SystemExit, match="max-restarts"):
        cli.main(["--preset", "mamba2-tiny", "--device", "cpu", "--auto-restart", "1",
                  "--checkpoint-dir", str(tmp_path / "ck")])


CASES = {"trainer": _case_trainer, "ckpt": _case_ckpt}

if __name__ == "__main__":
    case, rank, world, work = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    torch.save(CASES[case](rank, world, work), work / f"out_{rank}.pt")
