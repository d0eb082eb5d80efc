"""The port's training telemetry and recovery against the JAX trainer's,
on the CPU, on a cut-down ``mamba2-tiny`` (2 layers, d_model 32, fp32).

* Spans, sentinel and the overflow flag on or off give the same losses
  and grad norms bit for bit; the spans cover ``data_load``,
  ``train_step`` and ``eval`` (and ``checkpoint_save``).
* Started from the JAX trainer's weights on the same shards, the port's
  overflow flags equal the JAX step's at the same threshold (a threshold
  between two of the run's grad norms; the norms agree to 1e-4), and a
  non-finite step halts both with the same ``DivergenceError`` text and a
  flight record with the same reason and the same events.
* A crash out of ``run()`` dumps a flight record ("crash: ...").
* The CLI: ``--auto-restart`` rebuilds from the newest checkpoint after a
  crash at step 3 ("restart 1/1", "resumed from step 2"), with the
  crashed trainer collected before the rebuild, and reproduces an
  uninterrupted run's losses exactly; a ``DivergenceError`` is never
  restarted; a crash before the first checkpoint is not restarted from
  step 0; the telemetry flags build JAX's ``TelemetryConfig``.
"""

import dataclasses
import json
import os
import sys
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_distributed_tpu.config import DataConfig as JaxDataConfig
from mamba_distributed_tpu.config import ModelConfig as JaxConfig
from mamba_distributed_tpu.config import TelemetryConfig as JaxTelemetry
from mamba_distributed_tpu.config import TrainConfig as JaxTrainConfig
from mamba_distributed_tpu.obs import DivergenceError as JaxDivergenceError
from mamba_distributed_tpu.training import Trainer as JaxTrainer
from mamba_distributed_tpu_torch import convert
from mamba_distributed_tpu_torch import train as cli
from mamba_distributed_tpu_torch.config import (
    DataConfig,
    ModelConfig,
    TelemetryConfig,
    TrainConfig,
)
from mamba_distributed_tpu_torch.obs import DivergenceError, load_jsonl
from mamba_distributed_tpu_torch.training import Trainer
from mamba_distributed_tpu_torch.training import trainer as trainer_mod
from mamba_distributed_tpu_torch.training.optimizer import tree_map

pytestmark = pytest.mark.torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(d_model=32, n_layer=2, vocab_size=64, headdim=8, chunk_size=16, d_state=16,
            compute_dtype="float32", remat=False)


def _kw(tmp, log):
    return dict(micro_batch_size=2, seq_len=32, total_batch_size=64, warmup_steps=2,
                max_steps=20, val_every=3, val_steps=1, checkpoint_every=2,
                log_dir=os.path.join(str(tmp), log))


def _data(tmp):
    return dict(data_dir=os.path.join(str(tmp), "data"), synthetic_tokens_per_shard=20_000)


def port_cfg(tmp, log="log", **tele):
    return TrainConfig(model=ModelConfig(**TINY), data=DataConfig(**_data(tmp)),
                       telemetry=TelemetryConfig(**tele), **_kw(tmp, log))


def jax_cfg(tmp, log="jlog", **tele):
    return JaxTrainConfig(model=JaxConfig(**TINY), data=JaxDataConfig(**_data(tmp)),
                          telemetry=JaxTelemetry(**tele), **_kw(tmp, log))


# ----------------------------------------------------------- on and off

def test_telemetry_on_and_off_give_the_same_losses(tmp_path):
    off = Trainer(port_cfg(tmp_path, "off", sentinel=False), device="cpu", verbose=False)
    off.run(max_steps=5, checkpoint_dir=str(tmp_path / "ck_off"))
    on = Trainer(port_cfg(tmp_path, "on", spans=True, overflow_threshold=1e-9),
                 device="cpu", verbose=False)
    on.run(max_steps=5, checkpoint_dir=str(tmp_path / "ck_on"))
    for t in (on, off):
        t.finish()
    assert on.history == off.history  # bit for bit
    assert off.sentinel is None and on.sentinel.overflow_count == 5
    assert on.sentinel.dumped_to is None
    assert not (tmp_path / "on" / "flight_record.json").exists()
    spans = [r for r in load_jsonl(str(tmp_path / "on" / "events.jsonl")) if r["kind"] == "span"]
    names = {r["name"] for r in spans}
    assert {"data_load", "train_step", "eval", "checkpoint_save"} <= names
    assert [r["step"] for r in spans if r["name"] == "train_step"] == list(range(5))
    assert not (tmp_path / "off" / "events.jsonl").exists()
    kinds = [e["kind"] for e in on.sentinel.flight.events()]
    assert kinds.count("train_step") == 5 and kinds.count("val") == 3  # steps 0, 3, 4
    assert "checkpoint_save" in kinds


def test_train_step_overflow_flag_rides_the_outputs(tmp_path):
    t = Trainer(port_cfg(tmp_path, overflow_threshold=1e9), device="cpu", verbose=False)
    x, y = t._batch(1, t.train_loader)
    out = t.train_step(t.params, x, y)
    t.finish()
    assert len(out) == 3 and all(o.dtype == torch.float32 and o.dim() == 0 for o in out)
    assert float(out[2]) == 0.0  # the norm is far below 1e9


# ------------------------------------------------------- against JAX

def test_overflow_and_divergence_match_the_jax_trainer(tmp_path):
    # the port trainer starts from the JAX trainer's weights, on the same shards
    jt = JaxTrainer(jax_cfg(tmp_path, "jprobe"), verbose=False)
    start = convert.params_from_jax(jax.tree.map(np.asarray, jt.params))

    def port_trainer(log, **tele):
        t = Trainer(port_cfg(tmp_path, log, **tele), device="cpu", verbose=False)
        with torch.no_grad():
            tree_map(lambda dst, src: dst.copy_(src), t.params, start)
        return t

    probe = port_trainer("probe", sentinel=False)
    probe.run(max_steps=4)
    probe.finish()
    norms = [probe.history[s][1] for s in range(4)]
    # a threshold in the widest gap between two of the run's norms
    s = sorted(norms)
    gap, i = max((s[i + 1] / s[i], i) for i in range(len(s) - 1))
    assert gap > 1.001, s
    thr = (s[i] + s[i + 1]) / 2

    jt = JaxTrainer(jax_cfg(tmp_path, "jlog", overflow_threshold=thr), verbose=False)
    jt.run(max_steps=4)
    pt = port_trainer("log", overflow_threshold=thr)
    pt.run(max_steps=4)
    jflags = [e.get("overflow", 0) for e in jt.sentinel.flight.events() if e["kind"] == "train_step"]
    pflags = [e.get("overflow", 0) for e in pt.sentinel.flight.events() if e["kind"] == "train_step"]
    assert pflags == jflags and pt.sentinel.overflow_count == jt.sentinel.overflow_count
    assert 0 < pt.sentinel.overflow_count < 4
    for e_p, e_j in zip(pt.sentinel.flight.events(), jt.sentinel.flight.events()):
        assert e_p["kind"] == e_j["kind"] and e_p["step"] == e_j["step"]
        if e_p["kind"] == "train_step":  # fp32 on both sides: 1e-4 relative
            assert abs(e_p["grad_norm"] - e_j["grad_norm"]) <= 1e-4 * e_j["grad_norm"]

    # step 4 goes non-finite on both: the JAX step returns NaN loss and
    # norm, the port's weights are NaN
    real = jt.train_step

    def nan_step(params, opt_state, x, y):
        params, opt_state, _, _, flag = real(params, opt_state, x, y)
        return params, opt_state, jnp.float32(np.nan), jnp.float32(np.nan), flag

    jt.train_step = nan_step
    with pytest.raises(JaxDivergenceError) as jerr:
        jt.run(max_steps=6)
    with torch.no_grad():
        pt.params["norm_f"]["weight"].fill_(float("nan"))
    with pytest.raises(DivergenceError) as perr:
        pt.run(max_steps=6)
    pt.finish()
    jdoc = json.loads((tmp_path / "jlog" / "flight_record.json").read_text())
    pdoc = json.loads((tmp_path / "log" / "flight_record.json").read_text())
    assert pdoc["reason"] == jdoc["reason"] == (
        "non-finite loss/grad_norm at step 4 (loss=nan, grad_norm=nan)")
    assert str(perr.value).replace(str(tmp_path / "log"), "D") == \
        str(jerr.value).replace(str(tmp_path / "jlog"), "D")
    assert [(e["kind"], e["step"]) for e in pdoc["events"]] == \
        [(e["kind"], e["step"]) for e in jdoc["events"]]
    assert pdoc["capacity"] == jdoc["capacity"] == 64


def test_crash_dumps_a_flight_record(tmp_path):
    t = Trainer(port_cfg(tmp_path), device="cpu", verbose=False)
    t.run(max_steps=1)  # one clean step feeds the ring

    def boom(*a, **k):
        raise RuntimeError("loader died")

    t._batch = boom
    with pytest.raises(RuntimeError, match="loader died"):
        t.run(max_steps=2)
    t.finish()
    doc = json.loads((tmp_path / "log" / "flight_record.json").read_text())
    assert doc["reason"] == "crash: RuntimeError: loader died"
    assert [e["kind"] for e in doc["events"]] == ["val", "train_step", "val"]


def test_no_halt_keeps_training_through_a_nan(tmp_path):
    t = Trainer(port_cfg(tmp_path, halt_on_divergence=False), device="cpu", verbose=False)
    with torch.no_grad():
        t.params["norm_f"]["weight"].fill_(float("nan"))
    t.run(max_steps=3)
    t.finish()
    assert sorted(t.history) == [0, 1, 2] and all(np.isnan(t.history[s][0]) for s in range(3))
    doc = json.loads((tmp_path / "log" / "flight_record.json").read_text())
    assert doc["reason"].startswith("non-finite loss/grad_norm at step 0")


# ------------------------------------------------------------------- CLI

def _cli_cfg(tmp, **tele):
    return dataclasses.replace(port_cfg(tmp, **tele), checkpoint_every=2, max_steps=5)


def _fault_at(monkeypatch, step_index: int):
    """Make the trainer module's train steps raise once, at the given
    call (the first trainer's step ``step_index``)."""
    real = trainer_mod.make_train_step
    calls = [0]

    def faulty(*a, **k):
        step = real(*a, **k)

        def run_step(*xs):
            out = step(*xs)
            calls[0] += 1
            if calls[0] == step_index + 1:
                raise RuntimeError("injected chip failure")
            return out

        return run_step

    monkeypatch.setattr(trainer_mod, "make_train_step", faulty)


def test_cli_auto_restart_recovers_exactly(tmp_path, capsys, monkeypatch):
    cfg = _cli_cfg(tmp_path)
    monkeypatch.setattr(cli, "build_config", lambda args: cfg)
    whole = cli.main(["--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck0")])
    capsys.readouterr()

    built = []
    real_init = Trainer.__init__

    def tracked_init(self, *a, **k):
        # the crashed trainer is collected before the next one is built
        assert all(ref() is None for ref in built)
        real_init(self, *a, **k)
        built.append(weakref.ref(self))

    monkeypatch.setattr(Trainer, "__init__", tracked_init)
    _fault_at(monkeypatch, 3)
    hist = cli.main(["--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck"),
                     "--auto-restart", "1"])
    out = capsys.readouterr().out
    assert "run crashed (RuntimeError: injected chip failure); restart 1/1 from the " \
        "latest checkpoint" in out, out
    assert "resumed from step 2" in out, out
    assert len(built) == 2 and sorted(hist) == [2, 3, 4]
    assert [hist[s] for s in (2, 3, 4)] == [whole[s] for s in (2, 3, 4)]  # bit for bit
    log = (tmp_path / "log" / "log.txt").read_text()
    assert "4 train" in log and "1 train" in log  # the history before the crash is kept


def test_cli_never_restarts_a_divergence(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(cli, "build_config", lambda args: _cli_cfg(tmp_path))
    real = trainer_mod.init_lm_params

    def poisoned(*a, **k):
        params = real(*a, **k)
        params["norm_f"]["weight"].fill_(float("nan"))
        return params

    monkeypatch.setattr(trainer_mod, "init_lm_params", poisoned)
    with pytest.raises(DivergenceError, match="at step 0"):
        cli.main(["--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck"),
                  "--auto-restart", "3"])
    out = capsys.readouterr().out
    assert "restart" not in out and "crashed" not in out


def test_cli_refuses_to_restart_from_step_0(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(cli, "build_config", lambda args: _cli_cfg(tmp_path))
    _fault_at(monkeypatch, 1)  # before the first checkpoint (step 2)
    with pytest.raises(SystemExit, match="refusing to silently restart from step 0"):
        cli.main(["--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck"),
                  "--auto-restart", "2"])
    assert "restart 1/2" in capsys.readouterr().out


def test_cli_restart_budget_runs_out(tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "build_config", lambda args: _cli_cfg(tmp_path))
    _fault_at(monkeypatch, 3)
    with pytest.raises(RuntimeError, match="injected chip failure"):
        cli.main(["--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck")])


@pytest.mark.parametrize("argv,needle", [
    (["--auto-restart", "1"], "needs --checkpoint-dir"),
    (["--auto-restart", "-1", "--checkpoint-dir", "x"], "must be >= 0"),
])
def test_cli_auto_restart_argument_errors(argv, needle):
    with pytest.raises(SystemExit, match=needle):
        cli.main(["--preset", "mamba2-tiny", "--device", "cpu"] + argv)


@pytest.mark.parametrize("flags", [
    [], ["--spans"], ["--overflow-threshold", "2.5"], ["--no-halt-on-divergence"],
    ["--spans", "--overflow-threshold", "0", "--no-halt-on-divergence"],
], ids=["none", "spans", "overflow", "no_halt", "all"])
def test_cli_telemetry_flags_build_jax_config(flags, monkeypatch):
    sys.path.insert(0, REPO)
    import train as jax_cli

    monkeypatch.setattr(sys, "argv", ["train.py", "--preset", "mamba2-tiny"] + flags)
    jcfg = jax_cli.build_config(jax_cli.parse_args())
    cfg = cli.build_config(cli.parse_args(["--preset", "mamba2-tiny"] + flags))
    assert dataclasses.asdict(cfg.telemetry) == dataclasses.asdict(jcfg.telemetry)
