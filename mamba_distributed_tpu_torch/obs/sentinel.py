"""Divergence sentinel and crash-time flight recorder.

A diverged run's most valuable artifact is the last N steps before the
loss went non-finite: after it, every record is NaN noise.  So the
trainer feeds each step's host scalars (loss, grad norm, fetched anyway
for logging, so the sentinel adds no device sync) into a bounded ring,
and the moment a non-finite value appears, or the loop dies on any
exception, the ring dumps to ``flight_record.json``.

The opt-in on-device counterpart (``TelemetryConfig.overflow_threshold``)
lives in ``training/train_step.py``: the step also computes an overflow
flag from the pre-clip global grad norm, on the card, and returns it in
the one host fetch the step already makes.

The dump's document and its ``reason`` strings are the JAX package's
``obs/sentinel.py``, word for word.
"""

from __future__ import annotations

import json
import math
import os
from collections import deque

from mamba_distributed_tpu_torch.obs.tracer import NULL_TRACER, jsonable


class DivergenceError(RuntimeError):
    """Raised by the trainer when the sentinel sees a non-finite loss or
    grad norm and ``telemetry.halt_on_divergence`` is set."""


class FlightRecorder:
    """Bounded ring buffer of recent telemetry events.

    ``record()`` is O(1) and allocation-light; ``dump()`` writes the
    whole ring plus the dump reason as one JSON document.  Capacity is
    small by design — the point is the last-moments picture, not a log.
    """

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._events: deque[dict] = deque(maxlen=capacity)

    def record(self, kind: str, **fields) -> None:
        self._events.append({"kind": kind, **fields})

    def events(self) -> list[dict]:
        return list(self._events)

    def __len__(self) -> int:
        return len(self._events)

    def dump(self, path: str, reason: str) -> str:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        doc = {
            "reason": reason,
            "capacity": self.capacity,
            "events": [jsonable(e) for e in self._events],
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return path


class DivergenceSentinel:
    """Host-side non-finite watchdog feeding a FlightRecorder.

    ``observe_step`` takes scalars the trainer has already fetched to
    the host; it must never be handed a tensor, whose read would sync.
    Returns True when the step is non-finite, after dumping the flight
    record (first trigger only; a crashed run dumps once).

    ``dump_path=None`` watches without writing.
    """

    def __init__(self, dump_path: str | None, capacity: int = 64,
                 tracer=NULL_TRACER):
        self.dump_path = dump_path
        self.flight = FlightRecorder(capacity)
        self.tracer = tracer
        self.overflow_count = 0  # host accumulator of on-device flags
        self.dumped_to: str | None = None

    def observe_step(self, step: int, loss: float, grad_norm: float,
                     overflow: int | None = None, **extra) -> bool:
        record = {"step": step, "loss": loss, "grad_norm": grad_norm}
        record.update(extra)
        if overflow is not None and overflow:
            self.overflow_count += int(overflow)
            record["overflow"] = int(overflow)
            record["overflow_total"] = self.overflow_count
        self.flight.record("train_step", **record)
        diverged = not (math.isfinite(loss) and math.isfinite(grad_norm))
        if diverged:
            self.tracer.event("divergence", step=step, loss=loss,
                              grad_norm=grad_norm)
            self.dump(f"non-finite loss/grad_norm at step {step} "
                      f"(loss={loss}, grad_norm={grad_norm})")
        return diverged

    def record_event(self, kind: str, **fields) -> None:
        """Feed a non-step event (val loss, checkpoint save, ...) into
        the ring so the dump shows the run's recent shape, not just the
        train steps."""
        self.flight.record(kind, **fields)

    def on_crash(self, exc: BaseException) -> None:
        """Dump on any loop-killing exception (unless divergence already
        dumped — the DivergenceError path would otherwise overwrite the
        reason with its own traceback)."""
        self.dump(f"crash: {type(exc).__name__}: {exc}")

    def dump(self, reason: str) -> str | None:
        if self.dump_path is not None and self.dumped_to is None:
            self.dumped_to = self.flight.dump(self.dump_path, reason)
        return self.dumped_to
