"""Compare a training log against a reference run's logged loss curve
(counterpart of the JAX package's ``scripts/compare_parity.py``).

    python -m mamba_distributed_tpu_torch.compare_parity log/log.txt   # fingerprint
    python -m mamba_distributed_tpu_torch.compare_parity ours.txt --ref theirs.txt \\
        --mode strict --steps 30

Exit code 0 iff the comparison passes; the report goes to stdout.  The
reference log defaults to ``log_parity_cpu/log.txt``, the JAX package's
committed 1,001-step ``mamba2-mini`` run on synthetic shards.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from mamba_distributed_tpu_torch.utils.parity import compare, parse_log_file

REF_LOG = str(Path(__file__).resolve().parents[1] / "log_parity_cpu" / "log.txt")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ours", help="path to our reference-format log")
    ap.add_argument("--ref", default=REF_LOG)
    ap.add_argument("--mode", choices=("strict", "fingerprint"), default="fingerprint",
                    help="strict: same training data; fingerprint: synthetic "
                         "stand-in data (default)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--tol", type=float, default=None,
                    help="strict-mode per-step tolerance (default 0.35)")
    args = ap.parse_args(argv)

    kw = {}
    if args.mode == "strict" and args.tol is not None:
        kw["tol"] = args.tol
    res = compare(parse_log_file(args.ours), parse_log_file(args.ref),
                  mode=args.mode, steps=args.steps, **kw)
    print(res.report())
    return 0 if res.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
