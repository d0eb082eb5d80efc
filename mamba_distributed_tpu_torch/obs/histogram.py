"""Streaming bounded-bucket histogram: percentiles without storing samples.

Latency percentiles (p50/p95/p99 of queue-wait, time to first token,
inter-token latency) must survive millions of requests, so samples are
not kept.  ``StreamingHistogram`` keeps a fixed array of geometrically
spaced bucket counts: with growth factor ``g`` every recorded value lands
in a bucket whose edges are within a factor ``g`` of it, so any
percentile is reported with relative error at most ``g - 1`` (and
exactly at the observed min/max, which are tracked and clamp the
estimate).

Histograms with the same bucket geometry merge by adding counts.
``to_dict``/``from_dict`` round-trip the sparse bucket counts through
JSON so a per-request histogram can ride in a jsonl record.  The
geometry, the percentile walk and the dict form are the JAX package's
``obs/histogram.py``, so a histogram written by either package merges
with one written by the other.
"""

from __future__ import annotations

import math


class StreamingHistogram:
    """Fixed-memory histogram over ``[lo, hi)`` with geometric buckets.

    Defaults cover 1 microsecond to ~17 minutes when recording
    milliseconds, at <= ~19% relative error (growth 2**0.25), in 100
    buckets.  Values below ``lo`` / at or above ``hi`` land in underflow/
    overflow buckets and are still reported exactly at the stream min/max.
    """

    def __init__(self, lo: float = 1e-3, hi: float = 1e6,
                 growth: float = 2 ** 0.25):
        if not (lo > 0 and hi > lo and growth > 1):
            raise ValueError(f"need 0 < lo < hi and growth > 1, got "
                             f"lo={lo}, hi={hi}, growth={growth}")
        self.lo, self.hi, self.growth = lo, hi, growth
        self._log_g = math.log(growth)
        self.n_buckets = int(math.ceil(math.log(hi / lo) / self._log_g))
        # [underflow] + n_buckets geometric + [overflow]
        self.counts = [0] * (self.n_buckets + 2)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    # ------------------------------------------------------------- recording

    def record(self, value: float, n: int = 1) -> None:
        """Add ``n`` observations of ``value``.  Non-finite values are
        dropped (a telemetry path must never throw on a diverged input)."""
        if n < 1 or not math.isfinite(value):
            return
        self.counts[self._index(value)] += n
        self.count += n
        self.total += value * n
        self.vmin = min(self.vmin, value)
        self.vmax = max(self.vmax, value)

    def _index(self, value: float) -> int:
        if value < self.lo:
            return 0
        if value >= self.hi:
            return self.n_buckets + 1
        i = int(math.log(value / self.lo) / self._log_g)
        return 1 + min(max(i, 0), self.n_buckets - 1)

    def _edges(self, index: int) -> tuple[float, float]:
        """(low, high) value edges of a slot in ``counts``."""
        if index == 0:
            return (0.0, self.lo)
        if index == self.n_buckets + 1:
            return (self.hi, self.hi)
        return (self.lo * self.growth ** (index - 1),
                self.lo * self.growth ** index)

    # ----------------------------------------------------------- percentiles

    def percentile(self, q: float) -> float | None:
        """Estimate the q-th percentile (q in [0, 100]); None when empty.

        Nearest-rank bucket walk with linear interpolation inside the
        bucket, clamped to the observed [min, max] — so a single-sample
        histogram reports that sample exactly at every q."""
        if self.count == 0:
            return None
        if not 0 <= q <= 100:
            raise ValueError(f"q must be in [0, 100], got {q}")
        target = max(1, math.ceil(q / 100 * self.count))
        seen = 0
        for index, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= target:
                if index == 0:
                    # below-lo values have no bucket resolution; the
                    # observed min is the only honest point estimate
                    return self.vmin
                if index == self.n_buckets + 1:
                    return self.vmax
                b_lo, b_hi = self._edges(index)
                frac = (target - seen) / c
                value = b_lo + frac * (b_hi - b_lo)
                return min(max(value, self.vmin), self.vmax)
            seen += c
        return self.vmax  # unreachable unless float drift; be safe

    @property
    def mean(self) -> float | None:
        return self.total / self.count if self.count else None

    # -------------------------------------------------------- merge / io

    def _same_geometry(self, other: "StreamingHistogram") -> bool:
        return (self.lo == other.lo and self.hi == other.hi
                and self.growth == other.growth)

    def merge(self, other: "StreamingHistogram") -> "StreamingHistogram":
        """Fold ``other``'s observations into self (in place)."""
        if not self._same_geometry(other):
            raise ValueError(
                f"cannot merge histograms with different bucket geometry: "
                f"({self.lo}, {self.hi}, {self.growth}) vs "
                f"({other.lo}, {other.hi}, {other.growth})"
            )
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    def to_dict(self) -> dict:
        """JSON-ready sparse form (bucket index -> count)."""
        return {
            "lo": self.lo, "hi": self.hi, "growth": self.growth,
            "count": self.count, "total": round(self.total, 6),
            "min": self.vmin if self.count else None,
            "max": self.vmax if self.count else None,
            "counts": {str(i): c for i, c in enumerate(self.counts) if c},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "StreamingHistogram":
        h = cls(lo=d["lo"], hi=d["hi"], growth=d["growth"])
        for i, c in d["counts"].items():
            h.counts[int(i)] = int(c)
        h.count = int(d["count"])
        h.total = float(d["total"])
        if d.get("min") is not None:
            h.vmin = float(d["min"])
        if d.get("max") is not None:
            h.vmax = float(d["max"])
        return h

    def summary(self) -> dict:
        """The roll-up ServingMetrics.summary() embeds per metric."""
        r = lambda v: None if v is None else round(v, 3)
        return {
            "count": self.count,
            "mean": r(self.mean),
            "p50": r(self.percentile(50)),
            "p95": r(self.percentile(95)),
            "p99": r(self.percentile(99)),
            "max": r(self.vmax if self.count else None),
        }
