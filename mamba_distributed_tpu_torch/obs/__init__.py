"""Host-side telemetry of the port: spans, latency histograms, sentinels.

One event vocabulary, a jsonl stream of one-object-per-line records
tagged by ``"kind"``, written by the trainer and the serving engine; the
records are the JAX package's ``obs/`` records key for key, so the JAX
package's ``scripts/obs_report.py`` reads either package's files:

  kind="span"          tracer.py     timed host-side phase (data_load,
                                     train_step, serving_tick, ...)
  kind="event"         tracer.py     point-in-time marker (divergence,
                                     slo_breach, ...)
  kind="trace_header"  tracer.py     wall-clock epoch of a stream's t=0
                                     (what lets export.py merge streams)
  kind="train"/"val"   utils/metrics MetricsLogger step records
  kind="serving_tick"  utils/metrics ServingMetrics per-tick records
                                     (+ goodput/MFU + live trace ids)
  kind="request"       utils/metrics per-request latency record
                                     (queue-wait, TTFT, ITL histogram,
                                     trace_id)

``context.py`` mints one trace id per request, ``export.py`` merges
streams into one Perfetto trace with flow arrows per request, and
``slo.py`` watches rolling-window p95 targets over finished requests.

Everything here is host-side: no tensor is read, so turning telemetry
on adds no kernel launch and no device sync (``chip_smoke.py`` counts
both with telemetry on and off).  The JAX package's XLA compile watchdog
(``obs/watchdog.py``) has no counterpart here.
"""

from mamba_distributed_tpu_torch.obs.context import mint_trace_id
from mamba_distributed_tpu_torch.obs.export import (
    export_chrome_trace,
    load_jsonl,
    split_pulled_stream,
    to_chrome_trace,
)
from mamba_distributed_tpu_torch.obs.histogram import StreamingHistogram
from mamba_distributed_tpu_torch.obs.sentinel import (
    DivergenceError,
    DivergenceSentinel,
    FlightRecorder,
)
from mamba_distributed_tpu_torch.obs.slo import SLOMonitor, TickRegressionDetector
from mamba_distributed_tpu_torch.obs.tracer import (
    NULL_TRACER,
    SpanTracer,
    append_jsonl,
    jsonable,
)

__all__ = [
    "DivergenceError",
    "DivergenceSentinel",
    "FlightRecorder",
    "NULL_TRACER",
    "SLOMonitor",
    "SpanTracer",
    "StreamingHistogram",
    "TickRegressionDetector",
    "append_jsonl",
    "export_chrome_trace",
    "jsonable",
    "load_jsonl",
    "mint_trace_id",
    "split_pulled_stream",
    "to_chrome_trace",
]
