"""The port's telemetry core (``mamba_distributed_tpu_torch/obs/``)
against the JAX package's ``obs/``, on the same inputs, exactly.

* ``StreamingHistogram``: buckets, percentiles, merges and the dict form
  equal JAX's over the same numpy-seeded samples (no tolerance: the same
  float operations in the same order), and a port histogram merges with a
  JAX one in either direction.
* ``SpanTracer`` driven by the same deterministic clock writes JAX's
  records byte for byte apart from the header's wall clock and pid:
  nesting, attributes, a span closed by an exception, per-thread ``tid``s,
  the ring and its cursor and ``dropped`` count, rotation, resumed
  history; ``NULL_TRACER`` writes nothing.
* ``DivergenceSentinel``/``FlightRecorder``: the ring, the dump (once,
  with JAX's reason text), the no-path sentinel and the overflow count.
* ``SLOMonitor`` and ``TickRegressionDetector``: the same event records
  for the same latency sequences.
* ``load_jsonl``/``split_pulled_stream``/``to_chrome_trace``/
  ``export_chrome_trace`` equal JAX's on the same records and files.
* ``TelemetryConfig`` accepts and refuses what JAX's does, and refuses
  the compile watchdog, which the port does not have.
* ``obs/report.build_report`` equals the JAX ``scripts/obs_report.py``
  sections it covers.
"""

import dataclasses
import json
import os
import sys
import threading
import warnings

import numpy as np
import pytest

from mamba_distributed_tpu.config import TelemetryConfig as JaxTelemetry
from mamba_distributed_tpu.obs import export as jexport
from mamba_distributed_tpu.obs import histogram as jhist
from mamba_distributed_tpu.obs import sentinel as jsentinel
from mamba_distributed_tpu.obs import slo as jslo
from mamba_distributed_tpu.obs import tracer as jtracer
from mamba_distributed_tpu_torch.config import TelemetryConfig
from mamba_distributed_tpu_torch.obs import (
    NULL_TRACER,
    DivergenceError,
    DivergenceSentinel,
    FlightRecorder,
    SLOMonitor,
    SpanTracer,
    StreamingHistogram,
    TickRegressionDetector,
    append_jsonl,
    export_chrome_trace,
    jsonable,
    load_jsonl,
    mint_trace_id,
    split_pulled_stream,
    to_chrome_trace,
)
from mamba_distributed_tpu_torch.obs.report import build_report

pytestmark = pytest.mark.torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

from obs_report import build_report as jax_build_report  # noqa: E402


# -------------------------------------------------------------- histogram

def _samples(seed, n=500):
    rng = np.random.default_rng(seed)
    # log-uniform over 1e-4 .. 1e7: underflow, buckets and overflow
    return list(10 ** rng.uniform(-4, 7, n))


GEOMETRIES = [dict(), dict(lo=1e-2, hi=200.0), dict(lo=0.5, hi=4e3, growth=1.5)]


@pytest.mark.parametrize("geom", GEOMETRIES, ids=["default", "percent", "coarse"])
@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_equals_jax(geom, seed):
    ours, ref = StreamingHistogram(**geom), jhist.StreamingHistogram(**geom)
    weights = np.random.default_rng(seed + 10).integers(1, 4, 500)
    for v, w in zip(_samples(seed), weights):
        ours.record(float(v), int(w))
        ref.record(float(v), int(w))
    for h in (ours, ref):
        h.record(float("nan"))  # dropped, never raises
        h.record(float("inf"))
    assert ours.n_buckets == ref.n_buckets and ours.counts == ref.counts
    for q in (0, 1, 10, 25, 50, 75, 90, 95, 99, 99.9, 100):
        assert ours.percentile(q) == ref.percentile(q), q
    assert ours.mean == ref.mean and ours.summary() == ref.summary()
    assert ours.to_dict() == ref.to_dict()
    assert json.dumps(ours.to_dict()) == json.dumps(ref.to_dict())
    back = StreamingHistogram.from_dict(json.loads(json.dumps(ours.to_dict())))
    assert back.to_dict() == ours.to_dict() and back.percentile(95) == ours.percentile(95)


def test_histogram_empty_single_and_errors_equal_jax():
    for cls in (StreamingHistogram, jhist.StreamingHistogram):
        h = cls()
        assert h.percentile(50) is None and h.mean is None
        h.record(3.7)
        assert all(h.percentile(q) == 3.7 for q in (0, 50, 100))
        with pytest.raises(ValueError, match="q must be"):
            h.percentile(101)
        with pytest.raises(ValueError, match="lo < hi"):
            cls(lo=2.0, hi=1.0)
    assert StreamingHistogram().summary() == jhist.StreamingHistogram().summary()


@pytest.mark.parametrize("direction", ["port_into_jax", "jax_into_port"])
def test_histogram_merges_across_packages(direction):
    a, b = _samples(3, 300), _samples(4, 200)
    ours, ref = StreamingHistogram(), jhist.StreamingHistogram()
    for v in a:
        ours.record(v)
    for v in b:
        ref.record(v)
    both = jhist.StreamingHistogram()
    for v in a + b:
        both.record(v)
    # through the dict form each package writes into its records
    if direction == "port_into_jax":
        merged = jhist.StreamingHistogram.from_dict(ref.to_dict()).merge(
            jhist.StreamingHistogram.from_dict(ours.to_dict()))
    else:
        merged = StreamingHistogram.from_dict(ours.to_dict()).merge(
            StreamingHistogram.from_dict(ref.to_dict()))
    assert merged.counts == both.counts and merged.count == both.count
    for q in (50, 95, 99):
        assert merged.percentile(q) == both.percentile(q)
    with pytest.raises(ValueError, match="geometry"):
        StreamingHistogram(lo=1e-2).merge(StreamingHistogram.from_dict(ref.to_dict()))


# ------------------------------------------------------------------ tracer

class Clock:
    """A deterministic perf_counter: 0.0, 0.0015, 0.003, ... per call."""

    def __init__(self):
        self.t = -0.0015

    def __call__(self):
        self.t += 0.0015
        return self.t


def _strip_header(records):
    return [{k: v for k, v in r.items() if k not in ("wall_t0_s", "pid")}
            if r["kind"] == "trace_header" else r for r in records]


def _drive(tracer):
    with tracer.span("outer", step=3):
        with tracer.span("inner", trace="abc-0001", nan=float("nan")):
            tracer.event("marker", where="inner")
    with pytest.raises(RuntimeError):
        with tracer.span("failing"):
            raise RuntimeError("boom")
    tracer.event("divergence", loss=float("inf"))


def test_tracer_records_equal_jax(tmp_path):
    ours = SpanTracer(str(tmp_path / "p" / "e.jsonl"), _clock=Clock())
    ref = jtracer.SpanTracer(str(tmp_path / "j" / "e.jsonl"), _clock=Clock())
    for t in (ours, ref):
        _drive(t)
    a, b = (load_jsonl(str(tmp_path / d / "e.jsonl")) for d in ("p", "j"))
    assert _strip_header(a) == _strip_header(b)
    assert a[0]["kind"] == "trace_header" and a[0]["pid"] == os.getpid()
    assert abs(a[0]["wall_t0_s"] - ours.wall_t0) < 1e-5
    spans = {r["name"]: r for r in a if r["kind"] == "span"}
    assert spans["inner"]["parent"] == "outer" and spans["inner"]["depth"] == 1
    assert spans["inner"]["nan"] is None and spans["outer"]["step"] == 3
    assert spans["failing"]["depth"] == 0  # closed by the exception, stack popped
    # the raw text too: same keys in the same order
    assert [line for line in (tmp_path / "p" / "e.jsonl").read_text().splitlines()[1:]] == \
        [line for line in (tmp_path / "j" / "e.jsonl").read_text().splitlines()[1:]]


def test_tracer_threads_get_their_own_tids(tmp_path):
    # a tid is handed out at a thread's first record: the main thread's
    # event comes first, the worker's span closes before "main" does
    got = []
    for cls, sub in ((SpanTracer, "p"), (jtracer.SpanTracer, "j")):
        t = cls(str(tmp_path / sub / "e.jsonl"))
        t.event("first")
        with t.span("main"):
            th = threading.Thread(target=lambda: t.event("worker"))
            th.start()
            th.join()
        recs = load_jsonl(str(tmp_path / sub / "e.jsonl"))
        got.append({r["name"]: r["tid"] for r in recs if r["kind"] in ("span", "event")})
    assert got[0] == got[1] == {"first": 0, "main": 0, "worker": 1}


@pytest.mark.parametrize("ring_len,pulls", [(4, [0, 0, 3]), (16, [0, 5, 100]), (1, [2])])
def test_tracer_ring_equal_jax(ring_len, pulls):
    ours = SpanTracer(None, _clock=Clock(), ring_len=ring_len)
    ref = jtracer.SpanTracer(None, _clock=Clock(), ring_len=ring_len)
    for t in (ours, ref):
        for i in range(9):
            t.event("e", i=i)
    for cursor in pulls:
        a, b = ours.ring_pull(cursor, limit=3), ref.ring_pull(cursor, limit=3)
        assert _strip_header(a["records"]) == _strip_header(b["records"])
        assert (a["cursor"], a["dropped"]) == (b["cursor"], b["dropped"])
    assert SpanTracer().ring_pull(7) == {"records": [], "cursor": 7, "dropped": 0}
    with pytest.raises(ValueError, match="ring_len"):
        SpanTracer(ring_len=-1)


def test_tracer_rotation_equal_jax(tmp_path):
    paths = [str(tmp_path / d / "e.jsonl") for d in ("p", "j")]
    ours = SpanTracer(paths[0], _clock=Clock(), rotate_bytes=400)
    ref = jtracer.SpanTracer(paths[1], _clock=Clock(), rotate_bytes=400)
    for t in (ours, ref):
        for i in range(20):
            t.event("tick", i=i)
    for p in paths:
        assert os.path.exists(p + ".1") and os.path.getsize(p) <= 400
    a, b = load_jsonl(paths[0]), load_jsonl(paths[1])
    assert _strip_header(a) == _strip_header(b)
    # the rolled pair reads oldest-first; the newest generation re-heads
    assert [r["i"] for r in a if r["kind"] == "event"] == list(range(20))[-len(
        [r for r in a if r["kind"] == "event"]):]
    assert load_jsonl(paths[0])[-1]["i"] == 19
    with pytest.raises(ValueError, match="rotate_bytes"):
        SpanTracer(rotate_bytes=-1)


def test_tracer_resume_preserves_history(tmp_path):
    path = str(tmp_path / "e.jsonl")
    first = SpanTracer(path)
    first.event("before")
    fresh = SpanTracer(path)  # truncates on its first write
    fresh.event("fresh")
    assert [r.get("name") for r in load_jsonl(path)] == [None, "fresh"]
    resumed = SpanTracer(path)
    resumed.preserve_history()
    resumed.event("after")
    recs = load_jsonl(path)
    assert [r["kind"] for r in recs] == ["trace_header", "event", "trace_header", "event"]
    assert [r.get("name") for r in recs] == [None, "fresh", None, "after"]


def test_null_tracer_is_noop(tmp_path):
    with NULL_TRACER.span("x", a=1):
        NULL_TRACER.event("y")
    NULL_TRACER.write({"kind": "span"})
    NULL_TRACER.preserve_history()
    assert not NULL_TRACER.enabled and SpanTracer.enabled
    assert NULL_TRACER.ring_pull(3) == {"records": [], "cursor": 3, "dropped": 0}
    assert NULL_TRACER.span("a") is NULL_TRACER.span("b")
    assert list(tmp_path.iterdir()) == []


def test_jsonable_and_append_jsonl_equal_jax(tmp_path):
    rec = {"a": float("nan"), "b": float("-inf"), "c": 1.5, "d": "x", "e": None}
    assert jsonable(rec) == jtracer.jsonable(rec) == {"a": None, "b": None, "c": 1.5,
                                                       "d": "x", "e": None}
    for fn, name in ((append_jsonl, "p"), (jtracer.append_jsonl, "j")):
        fn(str(tmp_path / name), rec, truncate=True)
        fn(str(tmp_path / name), {"k": 2})
    assert (tmp_path / "p").read_text() == (tmp_path / "j").read_text()


def test_trace_ids_unique_and_fork_safe():
    ids = [mint_trace_id() for _ in range(1000)]
    assert len(set(ids)) == 1000
    pid_hex = f"{os.getpid():x}-"
    assert all(i.startswith(pid_hex) for i in ids)
    r, w = os.pipe()
    with warnings.catch_warnings():
        # the child only mints one id, writes it and exits: it takes no
        # lock another thread of this process could hold
        warnings.simplefilter("ignore", DeprecationWarning)
        pid = os.fork()
    if pid == 0:  # the child mints under a fresh nonce
        os.write(w, mint_trace_id().encode())
        os._exit(0)
    os.waitpid(pid, 0)
    child = os.read(r, 64).decode()
    os.close(r)
    os.close(w)
    assert child.rsplit("-", 1)[0] != ids[0].rsplit("-", 1)[0]


# ---------------------------------------------------------------- sentinel

def _feed(sentinel):
    sentinel.observe_step(0, 5.0, 1.2, overflow=1, step_ms=10.0)
    sentinel.record_event("val", step=0, loss=5.1)
    sentinel.observe_step(1, 4.5, 0.8, overflow=0)
    sentinel.record_event("checkpoint_save", step=2)
    out = [sentinel.observe_step(2, float("nan"), 3.0, overflow=1)]
    out.append(sentinel.observe_step(3, float("nan"), float("inf")))
    sentinel.on_crash(RuntimeError("after the fact"))
    return out


def test_sentinel_dumps_once_with_jax_reason(tmp_path):
    ours = DivergenceSentinel(str(tmp_path / "p" / "flight.json"), capacity=4,
                              tracer=SpanTracer(str(tmp_path / "p" / "e.jsonl"), _clock=Clock()))
    ref = jsentinel.DivergenceSentinel(
        str(tmp_path / "j" / "flight.json"), capacity=4,
        tracer=jtracer.SpanTracer(str(tmp_path / "j" / "e.jsonl"), _clock=Clock()))
    assert _feed(ours) == _feed(ref) == [True, True]
    a, b = (json.loads((tmp_path / d / "flight.json").read_text()) for d in ("p", "j"))
    assert a == b
    assert a["reason"] == "non-finite loss/grad_norm at step 2 (loss=nan, grad_norm=3.0)"
    assert len(a["events"]) == 4 and a["events"][-1]["loss"] is None  # NaN -> null
    assert ours.overflow_count == ref.overflow_count == 2
    assert ours.dumped_to == str(tmp_path / "p" / "flight.json")
    ev = [r for r in load_jsonl(str(tmp_path / "p" / "e.jsonl")) if r["kind"] == "event"]
    assert [r["name"] for r in ev] == ["divergence", "divergence"]
    assert issubclass(DivergenceError, RuntimeError)


def test_sentinel_crash_dump_and_no_path(tmp_path):
    for cls, sub in ((DivergenceSentinel, "p"), (jsentinel.DivergenceSentinel, "j")):
        s = cls(str(tmp_path / sub / "f.json"))
        s.observe_step(0, 3.0, 1.0)
        s.on_crash(ValueError("loader died"))
        s.on_crash(KeyError("second"))  # once-only
    a, b = (json.loads((tmp_path / d / "f.json").read_text()) for d in ("p", "j"))
    assert a == b and a["reason"] == "crash: ValueError: loader died"
    quiet = DivergenceSentinel(None)
    assert quiet.observe_step(0, float("nan"), 1.0) is True
    assert quiet.dumped_to is None and quiet.dump("x") is None


def test_flight_recorder_ring(tmp_path):
    for cls in (FlightRecorder, jsentinel.FlightRecorder):
        with pytest.raises(ValueError, match="capacity"):
            cls(0)
    ours, ref = FlightRecorder(3), jsentinel.FlightRecorder(3)
    for r in (ours, ref):
        for i in range(5):
            r.record("train_step", step=i)
    assert ours.events() == ref.events() == [{"kind": "train_step", "step": i}
                                             for i in (2, 3, 4)]
    assert len(ours) == 3
    ours.dump(str(tmp_path / "p.json"), "why")
    ref.dump(str(tmp_path / "j.json"), "why")
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()


# --------------------------------------------------------------------- SLO

LATENCIES = [20, 30, 25, 200, 300, 250, 260, 40, 30, 20, 25, 22, 21, 500, 20, 20, 20, 20]


def _requests():
    rng = np.random.default_rng(7)
    out = []
    for i, ttft in enumerate(LATENCIES):
        h = StreamingHistogram()
        for v in rng.uniform(5, 5 + ttft / 4, 6):
            h.record(float(v))
        out.append({"request_id": i, "ttft_ms": float(ttft),
                    "queue_wait_ms": float(ttft) / 3, "itl_hist": h.to_dict()})
    return out


@pytest.mark.parametrize("targets", [dict(ttft_p95_ms=100.0),
                                     dict(ttft_p95_ms=100.0, itl_p95_ms=30.0,
                                          queue_wait_p95_ms=50.0)],
                         ids=["ttft", "all"])
def test_slo_monitor_equals_jax(tmp_path, targets):
    paths = [str(tmp_path / f"{d}.jsonl") for d in ("p", "j")]
    ours = SLOMonitor(window=5, tracer=SpanTracer(paths[0], _clock=Clock()), **targets)
    ref = jslo.SLOMonitor(window=5, tracer=jtracer.SpanTracer(paths[1], _clock=Clock()),
                          **targets)
    for rec in _requests():
        ours.observe_request(rec)
        ref.observe_request(rec)
        assert ours.any_breach() == ref.any_breach()
    assert ours.summary() == ref.summary()
    a, b = load_jsonl(paths[0]), load_jsonl(paths[1])
    assert _strip_header(a) == _strip_header(b)
    names = [r["name"] for r in a if r["kind"] == "event"]
    assert names[0] == "slo_config" and "slo_breach" in names and "slo_recovered" in names


def test_slo_from_config_and_validation():
    assert SLOMonitor.from_config(TelemetryConfig()) is None
    m = SLOMonitor.from_config(TelemetryConfig(slo_itl_p95_ms=5.0, slo_window_requests=3))
    assert m.targets == {"itl_ms": 5.0} and m.window == 3
    with pytest.raises(ValueError, match="window"):
        SLOMonitor(ttft_p95_ms=1.0, window=0)
    with pytest.raises(ValueError, match="p95 target"):
        SLOMonitor(ttft_p95_ms=-1.0)


def test_tick_regression_equals_jax(tmp_path):
    ticks = [10.0] * 40 + [35.0] * 15 + [10.0] * 60 + [float("nan"), -1.0]
    paths = [str(tmp_path / f"{d}.jsonl") for d in ("p", "j")]
    ours = TickRegressionDetector(factor=2.0, alpha=0.3, warmup=8,
                                  tracer=SpanTracer(paths[0], _clock=Clock()))
    ref = jslo.TickRegressionDetector(factor=2.0, alpha=0.3, warmup=8,
                                      tracer=jtracer.SpanTracer(paths[1], _clock=Clock()))
    for t in ticks:
        ours.observe_tick(t)
        ref.observe_tick(t)
    assert ours.summary() == ref.summary()
    a = load_jsonl(paths[0])
    assert _strip_header(a) == _strip_header(load_jsonl(paths[1]))
    assert [r["name"] for r in a if r["kind"] == "event"] == ["tick_regression",
                                                              "tick_recovered"]
    assert TickRegressionDetector.from_config(TelemetryConfig()) is None
    det = TickRegressionDetector.from_config(TelemetryConfig(tick_regression_factor=3.0))
    assert (det.factor, det.alpha, det.warmup) == (3.0, 0.1, 32)
    for bad in (dict(factor=1.0), dict(alpha=0.0), dict(baseline_alpha=0.5, alpha=0.1),
                dict(warmup=0)):
        with pytest.raises(ValueError):
            TickRegressionDetector(**bad)


# ------------------------------------------------------------------ export

def _stream(tracer, trace_ids):
    with tracer.span("serving_admit", queued=2):
        for i, t in enumerate(trace_ids):
            with tracer.span("serving_prefill", slot=i, trace=t):
                pass
    for _ in range(3):
        with tracer.span("serving_tick", occupied=2, traces=list(trace_ids)):
            pass
    tracer.event("slo_breach", metric="ttft_ms")


def test_chrome_trace_equals_jax(tmp_path):
    streams = []
    for d, tr in (("a", SpanTracer), ("b", SpanTracer)):
        path = str(tmp_path / f"{d}.jsonl")
        t = tr(path, _clock=Clock())
        _stream(t, [f"{d}-1", f"{d}-2"])
        streams.append(load_jsonl(path))
    streams.append([{"kind": "span", "name": "headerless", "t_ms": 1.0, "dur_ms": 2.0}])
    labels = ["a", "b"]
    ours, ref = to_chrome_trace(streams, labels), jexport.to_chrome_trace(streams, labels)
    assert ours == ref
    assert ours["metadata"]["linked_requests"] == 4 and ours["metadata"]["unaligned_streams"] == 1
    # the file-level export, with a merged pulled stream split by origin
    merged = str(tmp_path / "merged.jsonl")
    for i, recs in enumerate(streams[:2]):
        for r in recs:
            append_jsonl(merged, {**r, "obs_src": i})
    paths = [str(tmp_path / "a.jsonl"), merged]
    assert export_chrome_trace(paths, str(tmp_path / "p.json")) == \
        jexport.export_chrome_trace(paths, str(tmp_path / "j.json"))
    assert json.loads((tmp_path / "p.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())
    recs = load_jsonl(merged)
    assert split_pulled_stream(recs) == jexport.split_pulled_stream(recs)


def test_load_jsonl_survives_torn_lines_and_reads_rolled_first(tmp_path):
    path = tmp_path / "s.jsonl"
    (tmp_path / "s.jsonl.1").write_text('{"i": 0}\n{"i": 1}\n')
    path.write_text('{"i": 2}\n\n[1, 2]\n{"i": 3')
    bad, jbad = [], []
    assert load_jsonl(str(path), bad) == jexport.load_jsonl(str(path), jbad) == [
        {"i": 0}, {"i": 1}, {"i": 2}]
    assert bad == jbad == ['{"i": 3']


# ------------------------------------------------------------------ config

def test_telemetry_config_defaults_equal_jax():
    assert dataclasses.asdict(TelemetryConfig()) == dataclasses.asdict(JaxTelemetry())


@pytest.mark.parametrize("kw", [
    dict(flight_recorder_len=0), dict(overflow_threshold=-1.0),
    dict(overflow_threshold=1.0, sentinel=False), dict(slo_ttft_p95_ms=-1.0),
    dict(slo_itl_p95_ms=-0.5), dict(slo_queue_wait_p95_ms=-2.0),
    dict(slo_window_requests=0), dict(span_rotate_bytes=-1),
    dict(compile_thrash_threshold=-1), dict(compile_thrash_window_s=0.0),
    dict(tick_regression_factor=1.0), dict(tick_ewma_alpha=0.0),
    dict(tick_ewma_alpha=1.5), dict(tick_regression_warmup=0),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_telemetry_config_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError) as ours:
        TelemetryConfig(**kw)
    with pytest.raises(ValueError) as ref:
        JaxTelemetry(**kw)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("kw", [
    dict(spans=True, overflow_threshold=2.5, halt_on_divergence=False),
    dict(sentinel=False, flight_recorder_len=8, span_rotate_bytes=1 << 20),
    dict(slo_ttft_p95_ms=200.0, slo_itl_p95_ms=20.0, slo_window_requests=16),
    dict(tick_regression_factor=1.5, tick_ewma_alpha=1.0, tick_regression_warmup=4),
])
def test_telemetry_config_accepts_what_jax_accepts(kw):
    assert dataclasses.asdict(TelemetryConfig(**kw)) == dataclasses.asdict(JaxTelemetry(**kw))


@pytest.mark.parametrize("kw", [dict(compile_watchdog=True),
                                dict(compile_thrash_threshold=3),
                                dict(compile_thrash_window_s=10.0)])
def test_telemetry_config_refuses_the_compile_watchdog(kw):
    JaxTelemetry(**kw)  # the JAX package takes it
    with pytest.raises(ValueError, match="compile watchdog"):
        TelemetryConfig(**kw)


# ------------------------------------------------------------------ report

def _events():
    rng = np.random.default_rng(11)
    ev = [{"kind": "trace_header", "wall_t0_s": 1.0, "pid": 1}]
    for i, name in enumerate(["data_load", "train_step", "eval", "train_step"]):
        ev.append({"kind": "span", "name": name, "t_ms": float(i), "depth": 0,
                   "dur_ms": float(rng.uniform(1, 100))})
    ev.append({"kind": "span", "name": "inner", "t_ms": 0.5, "depth": 1, "dur_ms": 0.25})
    for s in range(3):
        ev.append({"kind": "train", "step": s, "loss": 5.0 - s, "step_ms": 100.0 + s,
                   "tokens_per_sec": 1e4 + s})
    ev.append({"kind": "val", "step": 2, "loss": 4.5})
    for t in range(6):
        ev.append({"kind": "serving_tick", "tick": t + 1, "occupied": 2 + t % 2,
                   "capacity": 4, "queue_depth": 3 - t // 2, "tokens_emitted": 8,
                   "tick_ms": float(rng.uniform(5, 9)), "prefill_stall_ms": float(t % 3),
                   "prefill_chunk_tokens": 16 * (t % 2), "prefill_chunk_ms": 1.5 * (t % 2),
                   "prefill_oneshot_tokens": 0, "useful_tokens": 8 + 12 * (t % 2),
                   "wasted_token_lanes": 24, "goodput_tokens_per_sec": 1000.0,
                   "serving_mfu": 1e-4 * t, "kv_pages_used": 4 + t,
                   "kv_pages_capacity": 32, "kv_page_allocs": 2, "kv_page_frees": 1,
                   "quantized": {"weights": "int8", "kv": "int8"}, "weight_bytes": 1000,
                   "page_pool_bytes": 2048})
    for i in range(5):
        h = StreamingHistogram()
        for v in rng.uniform(1, 20, 7):
            h.record(float(v))
        ev.append({"kind": "request", "request_id": i, "trace_id": f"t-{i}",
                   "prompt_tokens": 10 + i, "new_tokens": 8, "finish_reason": "length",
                   "queue_wait_ms": float(rng.uniform(0, 5)),
                   "ttft_ms": float(rng.uniform(5, 50)), "e2e_ms": float(rng.uniform(50, 90)),
                   "itl_hist": h.to_dict()})
    return ev


def test_report_equals_jax_obs_report():
    ev = _events()
    ours, ref = build_report(ev), jax_build_report(ev)
    assert set(ours) == {"spans", "train", "val", "serving", "requests"}
    for section, body in ours.items():
        if section in ("serving", "requests"):
            for key, val in body.items():
                assert val == ref[section][key], (section, key)
        else:
            assert body == ref[section], section
