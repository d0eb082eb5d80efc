"""Rolling-window SLO monitor and tick-latency regression detector.

Latency SLOs are attained or breached over recent traffic, not the whole
run: a p95 over a million requests hides an hour-long brownout.
``SLOMonitor`` watches every finished request's host-side latency
scalars (the ``"request"`` record the engine already builds: TTFT,
queue-wait, and the per-request ITL histogram) and keeps a rolling
window of the last N per targeted metric:

  * the rolling p95 is recomputed on each arrival (N is small);
  * crossing a target emits ONE ``slo_breach`` event record through the
    tracer (and ``slo_recovered`` on the way back): a state transition,
    not a per-request alarm flood;
  * per-request attainment (did this request meet the target) is
    counted for the run-level attainment table.

Targets live on ``TelemetryConfig`` (``slo_ttft_p95_ms`` /
``slo_itl_p95_ms`` / ``slo_queue_wait_p95_ms``, 0 = not targeted;
``slo_window_requests`` sizes the window); ``from_config`` builds the
monitor, and a ``slo_config`` event stamps the targets into the stream
so a report can compute attainment offline.

Host-side only: the inputs are scalars the engine already fetched.  The
events and their fields are the JAX package's ``obs/slo.py``.
"""

from __future__ import annotations

import math
from collections import deque

from mamba_distributed_tpu_torch.obs.histogram import StreamingHistogram
from mamba_distributed_tpu_torch.obs.tracer import NULL_TRACER

# metric key in the request record -> the target's name on TelemetryConfig
_METRICS = ("ttft_ms", "itl_ms", "queue_wait_ms")


def _p95(window) -> float:
    xs = sorted(window)
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


class SLOMonitor:
    """Rolling-window p95 targets over finished-request latency.

    Args:
      ttft_p95_ms / itl_p95_ms / queue_wait_p95_ms: targets in
        milliseconds; 0 leaves a metric untargeted.
      window: rolling window length in requests (the last N finished
        requests; one monitor may be shared by several engines).
      tracer: where ``slo_config``/``slo_breach``/``slo_recovered``
        event records land (an ``obs.SpanTracer``; default off).
    """

    def __init__(self, *, ttft_p95_ms: float = 0.0, itl_p95_ms: float = 0.0,
                 queue_wait_p95_ms: float = 0.0, window: int = 64,
                 tracer=NULL_TRACER):
        targets = {"ttft_ms": ttft_p95_ms, "itl_ms": itl_p95_ms,
                   "queue_wait_ms": queue_wait_p95_ms}
        for name, t in targets.items():
            if t < 0:
                raise ValueError(f"{name} p95 target must be >= 0 "
                                 f"(0 disables), got {t}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = window
        self.tracer = tracer
        self.targets = {m: t for m, t in targets.items() if t > 0}
        self._windows = {m: deque(maxlen=window) for m in self.targets}
        self._met = {m: 0 for m in self.targets}
        self._seen = {m: 0 for m in self.targets}
        self._in_breach = {m: False for m in self.targets}
        self.breaches = {m: 0 for m in self.targets}
        if self.targets:
            # stamp the targets into the stream so obs_report.py can
            # compute attainment from the request records offline
            tracer.event(
                "slo_config", window=window,
                **{f"{m}_p95_target": t for m, t in self.targets.items()},
            )

    @classmethod
    def from_config(cls, telemetry, tracer=NULL_TRACER) -> "SLOMonitor | None":
        """Build from a ``TelemetryConfig``; None when nothing is
        targeted (the monitor-off fast path costs literally nothing)."""
        if not (telemetry.slo_ttft_p95_ms or telemetry.slo_itl_p95_ms
                or telemetry.slo_queue_wait_p95_ms):
            return None
        return cls(
            ttft_p95_ms=telemetry.slo_ttft_p95_ms,
            itl_p95_ms=telemetry.slo_itl_p95_ms,
            queue_wait_p95_ms=telemetry.slo_queue_wait_p95_ms,
            window=telemetry.slo_window_requests,
            tracer=tracer,
        )

    # --------------------------------------------------------------- feed

    def observe_request(self, record: dict, replica=None) -> None:
        """One finished request (the engine's ``"request"`` record dict).
        ITL is judged on the request's own p95 (from its streaming
        histogram — the record already carries it)."""
        values = {
            "ttft_ms": record.get("ttft_ms"),
            "queue_wait_ms": record.get("queue_wait_ms"),
        }
        if "itl_ms" in self.targets:
            hist = record.get("itl_hist")
            if hist:
                if isinstance(hist, dict):
                    hist = StreamingHistogram.from_dict(hist)
                values["itl_ms"] = hist.percentile(95)
        for metric, target in self.targets.items():
            value = values.get(metric)
            if value is None:
                continue  # e.g. a 1-token request has no ITL
            self._seen[metric] += 1
            if value <= target:
                self._met[metric] += 1
            win = self._windows[metric]
            win.append(value)
            rolling = _p95(win)
            breached = rolling > target
            if breached != self._in_breach[metric]:
                self._in_breach[metric] = breached
                attrs = dict(metric=metric, target=target,
                             p95=round(rolling, 3), window=len(win))
                if replica is not None:
                    attrs["replica"] = replica
                if breached:
                    self.breaches[metric] += 1
                    self.tracer.event("slo_breach", **attrs)
                else:
                    self.tracer.event("slo_recovered", **attrs)

    def any_breach(self) -> bool:
        """True while any targeted metric's rolling p95 is in breach (a
        bool read, no recompute)."""
        return any(self._in_breach.values())

    # ------------------------------------------------------------ roll-up

    def summary(self) -> dict:
        """Attainment + breach state per targeted metric."""
        return {
            "window": self.window,
            "metrics": {
                m: {
                    "target_p95_ms": t,
                    "requests": self._seen[m],
                    "met": self._met[m],
                    "attainment": (
                        round(self._met[m] / self._seen[m], 4)
                        if self._seen[m] else None
                    ),
                    "breaches": self.breaches[m],
                    "in_breach": self._in_breach[m],
                    "rolling_p95_ms": (
                        round(_p95(self._windows[m]), 3)
                        if self._windows[m] else None
                    ),
                }
                for m, t in self.targets.items()
            },
        }


class TickRegressionDetector:
    """EWMA-baseline regression sentinel over engine tick latency.

    The SLOMonitor above judges ABSOLUTE targets the operator set; this
    detector needs no target at all — it learns the engine's own
    steady-state tick latency as an exponentially-weighted moving
    average and raises when ticks run a configured factor slower than
    that baseline.  An ITL degradation (a recompile storm, a noisy
    neighbor, a fragmenting page pool) becomes an *event* the moment it
    starts, not a bump discovered in a histogram after the run.

    Same transition discipline as the SLO monitor: one
    ``tick_regression`` event record when the smoothed latency crosses
    ``factor x baseline``, one ``tick_recovered`` when it comes back —
    never a per-tick alarm flood.  The baseline FREEZES while in
    breach (a regression must not teach the baseline that slow is
    normal); it resumes adapting on recovery.

    Args:
      factor: breach when smoothed tick ms > factor * baseline (must
        be > 1; ``from_config`` returns None when the config's factor
        is 0 = off).
      alpha: EWMA weight of the newest tick for the FAST signal.
      baseline_alpha: EWMA weight for the (out-of-breach) baseline;
        must be meaningfully smaller than ``alpha`` or the baseline
        tracks the fast signal and a breach can never open.  Defaults
        to ``alpha / 10``.
      warmup: ticks observed before judging starts — the first ticks
        pay compiles and cache fills and would poison the baseline.
      tracer: where the event records land.
    """

    def __init__(self, *, factor: float = 2.0, alpha: float = 0.1,
                 baseline_alpha: float | None = None,
                 warmup: int = 32, tracer=NULL_TRACER):
        if factor <= 1.0:
            raise ValueError(
                f"regression factor must be > 1 (breach = factor x "
                f"baseline), got {factor}"
            )
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if baseline_alpha is None:
            baseline_alpha = alpha / 10.0
        if not 0.0 < baseline_alpha < alpha:
            raise ValueError(
                f"baseline_alpha must be in (0, alpha={alpha}) so the "
                f"baseline lags the fast signal, got {baseline_alpha}"
            )
        if warmup < 1:
            raise ValueError(f"warmup must be >= 1, got {warmup}")
        self.factor = factor
        self.alpha = alpha
        self.baseline_alpha = baseline_alpha
        self.warmup = warmup
        self.tracer = tracer
        self.baseline_ms: float | None = None
        self.smoothed_ms: float | None = None
        self.ticks = 0
        self.breaches = 0
        self.in_breach = False

    @classmethod
    def from_config(cls, telemetry,
                    tracer=NULL_TRACER) -> "TickRegressionDetector | None":
        """Build from a ``TelemetryConfig``; None when
        ``tick_regression_factor`` is 0 (off — costs nothing)."""
        if not telemetry.tick_regression_factor:
            return None
        return cls(
            factor=telemetry.tick_regression_factor,
            alpha=telemetry.tick_ewma_alpha,
            warmup=telemetry.tick_regression_warmup,
            tracer=tracer,
        )

    def observe_tick(self, tick_ms: float, replica=None) -> None:
        """One engine tick's wall milliseconds."""
        if not math.isfinite(tick_ms) or tick_ms < 0:
            return  # telemetry never throws on a bad input
        self.ticks += 1
        a = self.alpha
        if self.smoothed_ms is None:
            self.smoothed_ms = tick_ms
        else:
            self.smoothed_ms = (1 - a) * self.smoothed_ms + a * tick_ms
        if self.ticks <= self.warmup:
            self.baseline_ms = self.smoothed_ms
            return
        if not self.in_breach:
            b = self.baseline_alpha
            self.baseline_ms = (1 - b) * self.baseline_ms + b * tick_ms
        breached = self.smoothed_ms > self.factor * self.baseline_ms
        if breached != self.in_breach:
            self.in_breach = breached
            attrs = dict(metric="tick_ms", factor=self.factor,
                         baseline_ms=round(self.baseline_ms, 3),
                         smoothed_ms=round(self.smoothed_ms, 3))
            if replica is not None:
                attrs["replica"] = replica
            if breached:
                self.breaches += 1
                self.tracer.event("tick_regression", **attrs)
            else:
                self.tracer.event("tick_recovered", **attrs)

    def summary(self) -> dict:
        r = lambda v: None if v is None else round(v, 3)
        return {
            "ticks": self.ticks,
            "baseline_ms": r(self.baseline_ms),
            "smoothed_ms": r(self.smoothed_ms),
            "factor": self.factor,
            "breaches": self.breaches,
            "in_breach": self.in_breach,
        }
