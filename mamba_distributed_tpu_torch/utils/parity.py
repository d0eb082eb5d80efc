"""Early-loss-curve parity checking against a logged reference run
(counterpart of the JAX package's ``utils/parity.py``).

A run's log holds ``"{step} train {loss:.6f}"`` / ``"{step} val
{loss:.4f}"`` lines (the reference trainer's format, which
``utils/metrics.MetricsLogger`` writes too), so two runs can be diffed
directly.  Two comparison modes, because comparability depends on the
data:

- ``strict``: same data -- per-step losses must match within a tolerance
  covering bf16 noise and per-device data order.  On the reference's
  FineWeb-Edu run this is the real parity claim (the first ~30 steps
  track 10.99 -> ~9.0).
- ``fingerprint``: synthetic stand-in data -- only data-independent
  fingerprints are compared: the t=0 loss must sit at the uniform-logits
  value ln(vocab) (both runs start there regardless of data), the curve
  must fall monotonically after smoothing, and the early drop must be a
  healthy fraction of the reference's.  This validates the harness
  (init, LR schedule, loss plumbing) without the real data.

``python -m mamba_distributed_tpu_torch.compare_parity`` runs it from
the command line.
"""

from __future__ import annotations

import dataclasses
import math
import re

_LINE = re.compile(r"^(\d+)\s+(train|val)\s+([-+0-9.eEnainf]+)\s*$")


def parse_log(text: str) -> dict[str, list[tuple[int, float]]]:
    """Parse reference-format log text into {"train": [(step, loss)...],
    "val": [...]} keeping file order.  Unparseable lines are skipped (the
    console lines the reference also printed never land in log.txt)."""
    out: dict[str, list[tuple[int, float]]] = {"train": [], "val": []}
    for line in text.splitlines():
        m = _LINE.match(line.strip())
        if m:
            out[m.group(2)].append((int(m.group(1)), float(m.group(3))))
    return out


def parse_log_file(path: str) -> dict[str, list[tuple[int, float]]]:
    with open(path) as f:
        return parse_log(f.read())


@dataclasses.dataclass
class ParityResult:
    ok: bool
    mode: str
    steps_compared: int
    checks: list[tuple[str, bool, str]]  # (name, passed, detail)

    def report(self) -> str:
        lines = [
            f"parity mode={self.mode} steps={self.steps_compared} "
            f"=> {'OK' if self.ok else 'FAIL'}"
        ]
        for name, passed, detail in self.checks:
            lines.append(f"  [{'ok' if passed else 'FAIL'}] {name}: {detail}")
        return "\n".join(lines)


def _first_n_train(log: dict, n: int) -> list[float]:
    seen: dict[int, float] = {}
    for step, loss in log["train"]:
        if step < n and step not in seen:
            seen[step] = loss
    return [seen[s] for s in sorted(seen)]


def _val_at(log: dict, step: int) -> float | None:
    for s, loss in log["val"]:
        if s == step:
            return loss
    return None


def _val_checkpoint_check(
    ours: dict, ref: dict, step: int, mode: str, tol: float,
    min_drop_frac: float,
) -> tuple[str, bool, str] | None:
    """Score a shared val checkpoint (the reference logs val every 250
    steps: ``250 val 5.4865`` is the first in its log).  Returns None
    when the reference has no val point at ``step`` (nothing to score
    against)."""
    ref_v = _val_at(ref, step)
    if ref_v is None:
        return None
    our_v = _val_at(ours, step)
    name = f"val@{step}"
    if our_v is None or not math.isfinite(our_v):
        return (name, False, f"ours has no finite val point at step {step} "
                f"(ref {ref_v:.4f})")
    if mode == "strict":
        ok = abs(our_v - ref_v) <= tol
        return (name, ok, f"ours {our_v:.4f} vs ref {ref_v:.4f} "
                f"(|diff| {abs(our_v - ref_v):.4f} <= {tol})")
    # fingerprint: data/scale differ, so score the *relative* fall from
    # the t=0 val loss against the reference's fall.  A log without the
    # val@0 anchor cannot be scored — fail loud rather than degrade to a
    # near-no-op magnitude bound.
    ref0, our0 = _val_at(ref, 0), _val_at(ours, 0)
    if ref0 is None or our0 is None:
        return (name, False,
                f"ours {our_v:.4f} vs ref {ref_v:.4f} — missing the val@0 "
                "anchor needed to normalize the fall (run with val_every "
                "covering step 0)")
    ref_drop = ref0 - ref_v
    our_drop = our0 - our_v
    frac = our_drop / ref_drop if ref_drop > 0 else float("nan")
    ok = frac >= min_drop_frac
    return (name, ok,
            f"ours fell {our_drop:.3f} ({our0:.3f}->{our_v:.3f}) vs ref "
            f"{ref_drop:.3f} ({ref0:.3f}->{ref_v:.3f}): {frac:.0%} >= "
            f"{min_drop_frac:.0%}; data/scale differ so the relative "
            "fall is the comparable quantity")


def compare_strict(
    ours: dict, ref: dict, steps: int = 30, tol: float = 0.35
) -> ParityResult:
    """Per-step loss diff over the first ``steps`` train steps.

    ``tol`` covers bf16 compute noise, data-order differences across
    device counts, and the reference's A100 vs TPU numerics — 0.35 is
    tight enough to catch a wrong init/schedule/loss (those diverge by
    >1 within 10 steps) and loose enough for hardware noise.
    """
    a = _first_n_train(ours, steps)
    b = _first_n_train(ref, steps)
    n = min(len(a), len(b))
    checks = []
    have = n >= min(steps, 10)
    checks.append(("coverage", have, f"{n} comparable steps (need >= {min(steps, 10)})"))
    if n:
        diffs = [abs(x - y) for x, y in zip(a[:n], b[:n])]
        worst = max(diffs)
        at = diffs.index(worst)
        ok = worst <= tol
        checks.append(
            ("per-step |loss diff|", ok,
             f"max {worst:.4f} at step {at} (tol {tol})")
        )
    # inclusive endpoint: --steps 250 must score the val@250 checkpoint
    for ckpt in range(250, steps + 1, 250):
        c = _val_checkpoint_check(ours, ref, ckpt, "strict", tol, 0.0)
        if c:
            checks.append(c)
    ok_all = all(p for _, p, _ in checks)
    return ParityResult(ok_all, "strict", n, checks)


def compare_fingerprint(
    ours: dict,
    ref: dict,
    steps: int = 30,
    vocab_size: int = 50304,
    init_tol: float = 0.25,
    min_drop_frac: float = 0.35,
    smooth: int = 5,
) -> ParityResult:
    """Data-independent fingerprints of a healthy reference-recipe run."""
    a = _first_n_train(ours, steps)
    b = _first_n_train(ref, steps)
    checks = []
    n = min(len(a), len(b))
    have = n >= min(steps, 10)
    checks.append(("coverage", have, f"{n} comparable steps"))
    if not have:
        return ParityResult(False, "fingerprint", n, checks)

    ln_v = math.log(vocab_size)
    init_err = abs(a[0] - ln_v)
    ref_init_err = abs(b[0] - ln_v)
    checks.append(
        ("t=0 loss ~ ln(vocab)", init_err <= init_tol,
         f"ours {a[0]:.4f} vs ln({vocab_size})={ln_v:.4f} "
         f"(|err| {init_err:.4f} <= {init_tol}; reference's was "
         f"{ref_init_err:.4f})")
    )

    # smoothed-monotonic over the EARLY curve only (first 30 steps, the
    # SURVEY §4 fingerprint window): late in training the loss bounces
    # around its floor, so long windows would fail on healthy runs
    n_early = min(n, 30)
    means = [
        sum(a[i:i + smooth]) / len(a[i:i + smooth])
        for i in range(0, n_early, smooth)
    ]
    mono = all(x > y for x, y in zip(means, means[1:]))
    checks.append(
        ("smoothed early curve falls", mono,
         f"{smooth}-step means over first {n_early}: "
         f"{['%.3f' % m for m in means]}")
    )

    # the early window alone would pass a run that falls for 30 steps
    # then blows up: every loss must be finite, and the last
    # smoothed window must sit at or below the first
    finite = all(math.isfinite(v) for v in a)
    first_mean = sum(a[:smooth]) / len(a[:smooth])
    last_mean = sum(a[-smooth:]) / len(a[-smooth:])
    healthy = finite and last_mean <= first_mean
    checks.append(
        ("losses finite, no late blow-up", healthy,
         f"finite={finite}; last {smooth}-mean {last_mean:.3f} <= first "
         f"{first_mean:.3f}")
    )

    ref_drop = b[0] - min(b)
    our_drop = a[0] - min(a)
    frac = our_drop / ref_drop if ref_drop > 0 else float("nan")
    checks.append(
        (f"early drop >= {min_drop_frac:.0%} of reference's",
         frac >= min_drop_frac,
         f"ours {our_drop:.3f} vs ref {ref_drop:.3f} ({frac:.0%}); data "
         "differs (synthetic zipf vs FineWeb) so only the order of "
         "magnitude is comparable")
    )
    # score every val checkpoint inside the compared window, endpoint
    # inclusive (the reference's cadence is 250: first ``250 val 5.4865``)
    for ckpt in range(250, steps + 1, 250):
        c = _val_checkpoint_check(
            ours, ref, ckpt, "fingerprint", 0.0, min_drop_frac
        )
        if c:
            checks.append(c)
    ok_all = all(p for _, p, _ in checks)
    return ParityResult(ok_all, "fingerprint", n, checks)


def compare(
    ours: dict, ref: dict, mode: str = "fingerprint", steps: int = 30, **kw
) -> ParityResult:
    if mode == "strict":
        return compare_strict(ours, ref, steps, **kw)
    if mode == "fingerprint":
        return compare_fingerprint(ours, ref, steps, **kw)
    raise ValueError(f"unknown parity mode {mode!r}")
