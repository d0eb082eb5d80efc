"""Training metrics log (the JAX package's ``MetricsLogger``).

``log.txt`` carries the reference's 3-field lines (``"{step} train
{loss:.6f}"`` / ``"{step} val {loss:.4f}"``), so its plot tooling
parses them unchanged; ``metrics.jsonl`` one JSON object per step (step,
loss, lr, grad norm, step time, tokens/s, MFU).  The console line shows
both.  MFU is None where no card peak applies (a CPU run).
"""

from __future__ import annotations

import json
import os


class MetricsLogger:
    def __init__(self, log_dir: str, master_process: bool = True,
                 filename: str = "log.txt", jsonl_filename: str = "metrics.jsonl"):
        self.master = master_process
        self.log_file = None
        self.jsonl_file = None
        # truncation is deferred to the first write, so a checkpoint
        # resume can keep the history written before it
        self._truncate_pending = True
        if master_process:
            os.makedirs(log_dir, exist_ok=True)
            self.log_file = os.path.join(log_dir, filename)
            self.jsonl_file = os.path.join(log_dir, jsonl_filename)

    def preserve_history(self) -> None:
        """Keep the existing log files (called on checkpoint resume)."""
        self._truncate_pending = False

    def _append(self, line: str, record: dict) -> None:
        if not self.log_file:
            return
        mode = "w" if self._truncate_pending else "a"
        self._truncate_pending = False
        with open(self.log_file, mode) as f:
            f.write(line + "\n")
        with open(self.jsonl_file, mode) as f:
            f.write(json.dumps(record) + "\n")

    def train_step(self, step: int, loss: float, lr: float, grad_norm: float,
                   dt_s: float, tokens_per_sec: float, mfu: float | None,
                   mfu_hw: float | None = None) -> None:
        """``mfu`` is the model-FLOPs convention; ``mfu_hw`` also counts
        the chunked algorithm's extra arithmetic (utils/flops.py)."""
        if not self.master:
            return
        mfu_s = "n/a" if mfu is None else f"{mfu * 100:.1f}%"
        print(f"step {step:5d} | loss: {loss:.6f} | lr {lr:.4e} | "
              f"norm: {grad_norm:.4f} | dt: {dt_s * 1000:.2f}ms | "
              f"tok/sec: {tokens_per_sec:.2f} | mfu: {mfu_s}")
        record = {
            "step": step, "kind": "train", "loss": round(loss, 6), "lr": lr,
            "grad_norm": round(grad_norm, 4), "step_ms": round(dt_s * 1000, 2),
            "tokens_per_sec": round(tokens_per_sec, 1),
            "mfu": None if mfu is None else round(mfu, 4),
        }
        if mfu_hw is not None:
            record["mfu_hw"] = round(mfu_hw, 4)
        self._append(f"{step} train {loss:.6f}", record)

    def val(self, step: int, loss: float) -> None:
        if not self.master:
            return
        print(f"validation loss: {loss:.4f}")
        self._append(f"{step} val {loss:.4f}",
                     {"step": step, "kind": "val", "loss": round(loss, 4)})
