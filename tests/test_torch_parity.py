"""The port's loss-curve parity harness (``utils/parity.py``, the
``compare_parity`` CLI and the ``mamba2-mini`` preset) against the JAX
package's ``utils/parity.py``, on synthesized logs and on
``log_parity_cpu/log.txt`` (the JAX package's committed 1,001-step
``mamba2-mini`` run): every ``ParityResult`` is equal field for field,
the JAX harness's negative cases included.
"""

import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import pytest

from mamba_distributed_tpu.config import get_preset as jax_get_preset
from mamba_distributed_tpu.utils import parity as jparity
from mamba_distributed_tpu_torch.config import get_preset, get_train_preset
from mamba_distributed_tpu_torch.utils import parity

pytestmark = pytest.mark.torch

REPO = Path(__file__).resolve().parents[1]
REF_LOG = REPO / "log_parity_cpu" / "log.txt"


def _ref_like(n=30, init=10.9911, floor=8.9):
    lines = [f"0 val {init:.4f}"]
    for s in range(n):
        lines.append(f"{s} train {floor + (init - floor) * math.exp(-s / 9.0):.6f}")
    return "\n".join(lines)


def _long_like(n=260, init=10.99, floor=6.0, val250=None):
    lines = [f"0 val {init:.4f}"]
    for s in range(n):
        loss = floor + (init - floor) * math.exp(-s / 40.0)
        lines.append(f"{s} train {loss:.6f}")
        if s == 250:
            lines.append(f"250 val {val250 if val250 is not None else loss:.4f}")
    return "\n".join(lines)


REF = REF_LOG.read_text()
NOISY = "\n".join(f"{s} train {loss + 0.05 * (-1) ** s:.6f}"
                  for s, loss in parity.parse_log(_ref_like())["train"])
NO_VAL = "\n".join(["0 val 10.99"] + [f"{s} train {10.99 - s * 0.015:.6f}"
                                      for s in range(260)])
FLAT = "\n".join(f"{s} train 10.8300" for s in range(30))
SHIFTED = "\n".join(
    line if not line.startswith("250 val") else f"250 val {float(line.split()[2]) + 1.0:.4f}"
    for line in REF.splitlines())
# (ours, ref, mode, steps, extra kwargs)
CASES = {
    "self_strict_30": (REF, REF, "strict", 30, {}),
    "self_strict_260": (REF, REF, "strict", 260, {}),
    "self_fingerprint_1001": (REF, REF, "fingerprint", 1001, {}),
    "strict_divergence": (_ref_like(init=10.99, floor=10.9), _ref_like(), "strict", 30, {}),
    "strict_noise": (NOISY, _ref_like(), "strict", 30, {}),
    "strict_tol": (NOISY, _ref_like(), "strict", 30, {"tol": 0.01}),
    "strict_shifted_val250": (SHIFTED, REF, "strict", 260, {}),
    "fingerprint_healthy": (_ref_like(init=10.83, floor=7.5), REF, "fingerprint", 30, {}),
    "fingerprint_wrong_init": (_ref_like(init=9.0, floor=7.5), REF, "fingerprint", 30, {}),
    "fingerprint_flat": (FLAT, REF, "fingerprint", 30, {}),
    "fingerprint_val250": (_long_like(val250=6.0), REF, "fingerprint", 260, {}),
    "fingerprint_val250_barely_fell": (_long_like(val250=10.5), REF, "fingerprint", 260, {}),
    "fingerprint_no_val": (NO_VAL, REF, "fingerprint", 260, {}),
    "fingerprint_short": (_ref_like(n=5), REF, "fingerprint", 30, {}),
    "fingerprint_vocab": (_ref_like(init=8.3, floor=5.0), REF, "fingerprint", 30,
                          {"vocab_size": 4096}),
}


def _fields(res) -> tuple:
    return (res.ok, res.mode, res.steps_compared, [tuple(c) for c in res.checks],
            res.report())


@pytest.mark.parametrize("name", sorted(CASES))
def test_results_equal_jax(name):
    ours, ref, mode, steps, kw = CASES[name]
    got = parity.compare(parity.parse_log(ours), parity.parse_log(ref), mode=mode,
                         steps=steps, **kw)
    want = jparity.compare(jparity.parse_log(ours), jparity.parse_log(ref), mode=mode,
                           steps=steps, **kw)
    assert _fields(got) == _fields(want)


def test_negative_cases_fail_where_jax_fails():
    """The harness's own verdicts: the negative cases fail, the healthy
    ones pass (as the JAX tests/test_parity_harness.py asserts)."""
    ok = {name: parity.compare(parity.parse_log(o), parity.parse_log(r), mode=m, steps=s,
                               **kw).ok
          for name, (o, r, m, s, kw) in CASES.items()}
    assert {n for n, v in ok.items() if not v} == {
        "strict_divergence", "strict_tol", "strict_shifted_val250", "fingerprint_wrong_init",
        "fingerprint_flat", "fingerprint_val250_barely_fell", "fingerprint_no_val",
        "fingerprint_short"}


def test_parse_log_equals_jax():
    text = ("0 val 10.9911\n0 train 10.991953\n1 train 10.963361\ngarbage line\n"
            "250 val 9.1234\n 3 train 2.5e-1 \n4 train inf\n")
    assert parity.parse_log(text) == jparity.parse_log(text)
    assert parity.parse_log_file(str(REF_LOG)) == jparity.parse_log_file(str(REF_LOG))
    assert parity.parse_log_file(str(REF_LOG))["val"][:2] == [(0, 10.8889), (250, 5.2031)]
    with pytest.raises(ValueError, match="mode"):
        parity.compare({}, {}, mode="loose")


def test_mamba2_mini_preset_equals_jax():
    jax_cfg = jax_get_preset("mamba2-mini")
    cfg = get_train_preset("mamba2-mini")
    assert cfg.model == get_preset("mamba2-mini")
    for part, jpart in ((cfg.model, jax_cfg.model), (cfg, jax_cfg), (cfg.data, jax_cfg.data),
                        (cfg.telemetry, jax_cfg.telemetry)):
        names = {f.name for f in dataclasses.fields(part)} & {
            f.name for f in dataclasses.fields(jpart)}
        for name in names - {"model", "mesh", "data", "telemetry"}:
            assert getattr(part, name) == getattr(jpart, name), name
    assert (cfg.grad_accum_steps, cfg.model.vocab_size_padded) == (1, 50304)


@pytest.mark.parametrize("args,rc,needle", [
    ([str(REF_LOG), "--mode", "strict"], 0, "=> OK"),
    ([str(REF_LOG), "--steps", "251"], 0, "val@250"),
    (["OURS", "--mode", "strict", "--tol", "0.01"], 1, "=> FAIL"),
], ids=["self_strict", "self_fingerprint_default_ref", "noisy_tight_tol"])
def test_compare_parity_cli(tmp_path, args, rc, needle):
    ours = tmp_path / "ours.txt"
    ours.write_text(NOISY)
    args = [str(ours) if a == "OURS" else a for a in args]
    if args[0] == str(ours):
        args += ["--ref", str(tmp_path / "ref.txt")]
        (tmp_path / "ref.txt").write_text(_ref_like())
    p = subprocess.run([sys.executable, "-m", "mamba_distributed_tpu_torch.compare_parity",
                        *args], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode == rc, p.stdout + p.stderr
    assert needle in p.stdout
