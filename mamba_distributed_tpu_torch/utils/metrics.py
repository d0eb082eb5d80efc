"""Training metrics log (the JAX package's ``MetricsLogger``) and the
serving engine's counters (its ``ServingMetrics``).

``log.txt`` carries the reference's 3-field lines (``"{step} train
{loss:.6f}"`` / ``"{step} val {loss:.4f}"``), so its plot tooling
parses them unchanged; ``metrics.jsonl`` one JSON object per step (step,
loss, lr, grad norm, step time, tokens/s, MFU).  The console line shows
both.  MFU is None where no card peak applies (a CPU run).
"""

from __future__ import annotations

import json
import os

from mamba_distributed_tpu_torch.obs.histogram import StreamingHistogram
from mamba_distributed_tpu_torch.obs.tracer import append_jsonl


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


def emit_bench_record(record: dict, json_path: str | None = None) -> None:
    """Print a bench record as one JSON line and, when ``json_path`` is
    given, write the same line there (the JAX package's
    ``emit_bench_record``)."""
    line = json.dumps(record)
    print(line, flush=True)
    if json_path:
        with open(json_path, "w") as f:
            f.write(line + "\n")


# summary() sections of engine features the port does not have yet
# (pipeline stages, adapters, tuning, admission, sessions, the compile
# watchdog): the JAX package's summary() holds them as None while the
# feature is off, so the port's holds the same keys at None
_OFF_SECTIONS = ("adapters", "tuning", "admission", "sessions")


class ServingMetrics:
    """Serving-engine counters (the JAX package's ``ServingMetrics``, the
    part the port's engine feeds): queue depth, slot occupancy,
    throughput, goodput, per-request latency histograms.

    The engine calls ``record_prefill`` once per finished prefill,
    ``record_prefill_chunk`` per chunk step, ``record_prefill_stall`` per
    engine step with prefill work, ``record_queue_wait``/``record_ttft``/
    ``record_itl`` from each request's host clock stamps,
    ``record_request`` once per finished request and ``record_tick`` once
    per decode tick.  With ``jsonl_path`` set, every tick appends one
    ``"kind": "serving_tick"`` record and every finished request one
    ``"kind": "request"`` record, key for key the JAX package's.  A field
    of a feature that is off is absent from the record, not null (the
    hybrid page gauges, the int8 stamp).

    Latency percentiles come from three streaming histograms
    (``obs/histogram.py``: p50/p95/p99 in fixed memory), rolled up under
    ``summary()["latency"]``.  Goodput: each tick record carries
    ``useful_tokens``/``wasted_token_lanes``/``goodput_tokens_per_sec``/
    ``serving_mfu``, the last from the analytic FLOPs rates and the card's
    peak that the engine installs through ``configure_goodput``
    (``serving_mfu`` stays None where no peak applies, a CPU run).

    The prefix cache (``configure_prefix_cache``, ``record_prefix_
    lookup``, ``record_prefix_ttft``), preemption (``record_preemption``),
    tick compaction (``configure_compaction``) and speculative decoding
    (``configure_speculation``) feed their summary sections and record
    fields only when the engine turns them on: records and summaries with
    them off are the same bytes as without them.  Left out until the port
    has the features that feed them: the migration, pipeline, adapter,
    tuning, session, admission and compile-watchdog methods.
    """

    def __init__(self, capacity: int, jsonl_path: str | None = None):
        self.capacity = capacity
        self.jsonl_path = jsonl_path
        self.ticks = 0
        self.decode_tokens = 0
        self.decode_time_s = 0.0
        self.prefills = 0
        self.prefill_tokens = 0
        self.prefill_time_s = 0.0
        # chunked prefill: per-chunk dispatch counters + the per-step
        # prefill stall (host time spent on prefill work between ticks)
        self.prefill_chunks = 0
        self.prefill_chunk_tokens = 0
        self.prefill_chunk_time_s = 0.0
        self.prefill_stall_s = 0.0
        self.prefill_stall_ms = StreamingHistogram()
        self._occupied_sum = 0
        self._queue_depth_sum = 0
        self.peak_queue_depth = 0
        # hybrid paged-KV gauges: last-seen pool occupancy + cumulative
        # allocator churn; None/0 until a hybrid engine reports them
        self.kv_pages_used: int | None = None
        self.kv_pages_capacity: int | None = None
        self.kv_page_allocs = 0
        self.kv_page_frees = 0
        self.peak_kv_pages_used = 0
        self.finished_requests = 0
        # goodput: useful tokens vs token lanes computed (padded slots +
        # chunk padding), and the FLOPs rates configure_goodput installs
        self.useful_tokens = 0
        self.computed_token_lanes = 0
        self._goodput_window_s = 0.0
        self._goodput_flops = 0.0
        self._fpt_decode: float | None = None
        self._fpt_prefill: float | None = None
        self._peak_flops: float | None = None
        self.queue_wait_ms = StreamingHistogram()
        self.ttft_ms = StreamingHistogram()
        self.itl_ms = StreamingHistogram()
        # the prefix-state cache: configure_prefix_cache() (engine
        # construction, cache on) unlocks summary()["prefix_cache"]: hit
        # counts, saved prefill tokens and the TTFT split hit vs miss
        self._prefix_cache_on = False
        self.prefix_full_hits = 0
        self.prefix_partial_hits = 0
        self.prefix_misses = 0
        self.prefix_saved_tokens = 0
        self.prefix_ttft_hit_ms = StreamingHistogram()
        self.prefix_ttft_miss_ms = StreamingHistogram()
        # compacted ticks: configure_compaction() unlocks
        # summary()["compaction"]: ticks per lane width and the token
        # lanes the narrower launches saved against full capacity
        self._compaction_on = False
        self.compaction_ticks = 0  # ticks narrower than capacity
        self.compaction_hist: dict[int, int] = {}  # lane width -> ticks
        self.compaction_lanes_saved = 0
        # speculative decoding: configure_speculation() unlocks
        # summary()["speculation"]: draft and accept counts, the accept
        # rate histogram (in percent) and tokens per stream per launch
        self._spec_on = False
        self.spec_tokens_cfg: int | None = None
        self.spec_drafter: str | None = None
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_stream_ticks = 0  # live streams summed over verify ticks
        self.spec_accept_rate = StreamingHistogram(lo=1e-2, hi=200.0)
        # priority preemptions (serving/engine._preempt)
        self.preemptions = 0
        # int8 serving: configure_memory() (engine construction, only
        # when weights or KV pages are int8) unlocks summary()["memory"]
        self._memory_on = False
        self.weight_bytes: int | None = None
        self.page_pool_bytes: int | None = None
        self.weight_dtype: str | None = None
        self.kv_dtype: str | None = None
        self.greedy_token_disagreements = 0
        # deferred truncation (the MetricsLogger/SpanTracer contract): a
        # reused path starts fresh on the first write unless
        # preserve_history() ran
        self._truncate_pending = True

    def preserve_history(self) -> None:
        """Keep an existing jsonl stream (append instead of truncating)."""
        self._truncate_pending = False

    def configure_goodput(self, flops_per_decode_token: float,
                          flops_per_prefill_token: float,
                          peak_flops: float | None) -> None:
        """Install the analytic FLOPs rates (utils/flops.py, "model"
        convention) and the card's peak that turn each tick's useful
        tokens into a host-computed ``serving_mfu``; a None peak (the
        CPU) leaves ``serving_mfu`` None."""
        self._fpt_decode = flops_per_decode_token
        self._fpt_prefill = flops_per_prefill_token
        self._peak_flops = peak_flops

    def configure_memory(self, weight_bytes: int, page_pool_bytes: int,
                         weight_dtype: str, kv_dtype: str) -> None:
        """Install the resident-bytes gauges (engine construction, only
        when quantization is on: ``summary()["memory"]`` stays None and
        tick records carry no int8 stamp otherwise)."""
        self._memory_on = True
        self.weight_bytes = int(weight_bytes)
        self.page_pool_bytes = int(page_pool_bytes)
        self.weight_dtype = weight_dtype
        self.kv_dtype = kv_dtype

    def configure_prefix_cache(self) -> None:
        """Mark the prefix-state cache on (engine construction):
        ``summary()`` gains its ``prefix_cache`` section."""
        self._prefix_cache_on = True

    def record_prefix_lookup(self, kind: str | None, saved_tokens: int = 0) -> None:
        """One admission's cache lookup: ``kind`` "full" (prefill
        skipped), "partial" (seeded at a chunk boundary) or None (miss);
        ``saved_tokens`` the prompt tokens the hit's snapshot covers."""
        if kind == "full":
            self.prefix_full_hits += 1
        elif kind == "partial":
            self.prefix_partial_hits += 1
        else:
            self.prefix_misses += 1
        self.prefix_saved_tokens += saved_tokens

    def record_prefix_ttft(self, dt_s: float, hit: bool) -> None:
        """A request's TTFT, split by its cache outcome."""
        (self.prefix_ttft_hit_ms if hit else self.prefix_ttft_miss_ms).record(dt_s * 1000)

    def record_preemption(self) -> None:
        """One priority swap-out (serving/engine._preempt)."""
        self.preemptions += 1

    def configure_compaction(self) -> None:
        """Mark compacted ticks on (engine construction): ``summary()``
        gains its ``compaction`` section and tick records their
        ``compaction_width`` stamp."""
        self._compaction_on = True

    def configure_speculation(self, spec_tokens: int, drafter: str) -> None:
        """Mark speculative decoding on (engine construction): ``summary()``
        gains its ``speculation`` section and tick records their
        ``spec_drafted``/``spec_accepted``/``spec_streams`` stamps."""
        self._spec_on = True
        self.spec_tokens_cfg = spec_tokens
        self.spec_drafter = drafter

    def _write_jsonl(self, record: dict) -> None:
        append_jsonl(self.jsonl_path, record, truncate=self._truncate_pending)
        self._truncate_pending = False

    def record_prefill(self, prompt_tokens: int, dt_s: float) -> None:
        """One finished prefill; ``dt_s`` is host dispatch time (the next
        tick's fetch absorbs device completion), so the derived
        ``prefill_tokens_per_sec`` is a dispatch rate."""
        self.prefills += 1
        self.prefill_tokens += prompt_tokens
        self.prefill_time_s += dt_s

    def record_prefill_chunk(self, chunk_tokens: int, dt_s: float) -> None:
        """One chunk step: ``chunk_tokens`` of prompt in ``dt_s`` host
        seconds (the whole prompt still gets one ``record_prefill``)."""
        self.prefill_chunks += 1
        self.prefill_chunk_tokens += chunk_tokens
        self.prefill_chunk_time_s += dt_s

    def record_prefill_stall(self, dt_s: float) -> None:
        """Host seconds one engine step spent on prefill work (admissions
        + chunk budget) before its tick."""
        self.prefill_stall_s += dt_s
        self.prefill_stall_ms.record(dt_s * 1000)

    def record_greedy_disagreement(self, n: int = 1) -> None:
        """``n`` greedy tokens on which a quantized stream disagreed with
        its reference."""
        self.greedy_token_disagreements += n

    # ------------------------------------------------- per-request latency

    def record_queue_wait(self, dt_s: float) -> None:
        """Submit -> slot granted (admission)."""
        self.queue_wait_ms.record(dt_s * 1000)

    def record_ttft(self, dt_s: float) -> None:
        """Submit -> first generated token on the host."""
        self.ttft_ms.record(dt_s * 1000)

    def record_itl(self, dt_s: float, n: int = 1) -> None:
        """``n`` inter-token gaps of ``dt_s`` each (tokens that arrive in
        one tick share the tick's per-token average: the host sees no
        finer than its own sync points)."""
        self.itl_ms.record(dt_s * 1000, n)

    def record_request(self, record: dict) -> None:
        """One finished request: count it and append its jsonl record
        (``"kind": "request"``) when a stream is configured."""
        self.finished_requests += 1
        if self.jsonl_path:
            self._write_jsonl({"kind": "request", **record})

    def record_tick(
        self, occupied: int, queue_depth: int, tokens_emitted: int,
        dt_s: float, prefill_stall_ms: float = 0.0,
        prefill_chunk_tokens: int = 0, prefill_chunk_ms: float = 0.0,
        prefill_real_tokens: int = 0,
        prefill_oneshot_tokens: int = 0, prefill_oneshot_lanes: int = 0,
        slot_lanes: int = 0,
        traces: list | None = None,
        preemptions: int = 0,
        prefix_hits: int | None = None,
        prefix_misses: int | None = None,
        prefix_saved_tokens: int | None = None,
        prefix_cache_entries: int | None = None,
        prefix_cache_bytes: int | None = None,
        kv_pages_used: int | None = None,
        kv_pages_capacity: int | None = None,
        kv_page_allocs: int = 0, kv_page_frees: int = 0,
        quantized: dict | None = None,
        weight_bytes: int | None = None,
        page_pool_bytes: int | None = None,
        spec_drafted: int | None = None,
        spec_accepted: int | None = None,
        spec_streams: int | None = None,
        compaction_width: int | None = None,
    ) -> None:
        """One decode tick.  ``prefill_stall_ms`` is the host time spent
        on prefill work since the previous tick record (a step that runs
        no tick rolls its work into the next record); ``prefill_chunk_
        tokens``/``prefill_chunk_ms`` the chunk tokens dispatched in that
        window and their dispatch time, ``prefill_real_tokens`` their
        non-pad share; ``prefill_oneshot_tokens``/``prefill_oneshot_
        lanes`` the real tokens and padded bucket lanes of one-shot
        prefills in the window.  ``slot_lanes`` is the token lanes the
        tick computed (its lane width x sub-steps, live or not); with the
        counts above it gives ``useful_tokens``, ``wasted_token_lanes``,
        ``goodput_tokens_per_sec`` and ``serving_mfu``.  ``traces`` is
        the live request trace-id set.  ``preemptions`` counts the
        window's swap-outs (stamped when nonzero); ``prefix_hits``/
        ``prefix_misses``/``prefix_saved_tokens`` are the prefix cache's
        window counters and ``prefix_cache_entries``/``prefix_cache_
        bytes`` its occupancy (cache-on engines only).  ``kv_pages_used``/
        ``kv_pages_capacity`` (hybrid engines) gauge the page pool, with
        ``kv_page_allocs``/``kv_page_frees`` the window's churn.
        ``quantized`` (int8 serving only) is the ``{"weights": dtype,
        "kv": dtype}`` stamp, with ``weight_bytes``/``page_pool_bytes``
        the resident-bytes gauges.  ``spec_drafted``/``spec_accepted``/
        ``spec_streams`` (speculation on) are the window's draft lanes fed,
        drafts accepted and live slot-launches; the window's accept rate
        goes into a histogram in percent.  ``compaction_width`` (compaction on)
        is the lane width the tick launched; ``slot_lanes`` is billed at
        it, and ``lanes_saved`` adds what a full-width launch would have
        computed on top."""
        self.ticks += 1
        self.decode_tokens += tokens_emitted
        self.decode_time_s += dt_s
        self._occupied_sum += occupied
        self._queue_depth_sum += queue_depth
        self.peak_queue_depth = max(self.peak_queue_depth, queue_depth)
        # goodput: useful tokens vs computed lanes over the window (the
        # tick plus the prefill work attributed to it)
        window_s = dt_s + prefill_stall_ms / 1000.0
        useful = tokens_emitted + prefill_real_tokens + prefill_oneshot_tokens
        lanes = slot_lanes + prefill_chunk_tokens + prefill_oneshot_lanes
        self.useful_tokens += useful
        self.computed_token_lanes += lanes
        self._goodput_window_s += window_s
        mfu = None
        if self._fpt_decode is not None and self._peak_flops and window_s > 0:
            flops = (tokens_emitted * self._fpt_decode
                     + (prefill_real_tokens + prefill_oneshot_tokens) * self._fpt_prefill)
            self._goodput_flops += flops
            mfu = flops / (window_s * self._peak_flops)
        record = {
            "kind": "serving_tick", "tick": self.ticks,
            "occupied": occupied, "capacity": self.capacity,
            "queue_depth": queue_depth,
            "tokens_emitted": tokens_emitted,
            "tick_ms": round(dt_s * 1000, 3),
            "prefill_stall_ms": round(prefill_stall_ms, 3),
            "prefill_chunk_tokens": prefill_chunk_tokens,
            "prefill_chunk_ms": round(prefill_chunk_ms, 3),
            "prefill_oneshot_tokens": prefill_oneshot_tokens,
            "useful_tokens": useful,
            "wasted_token_lanes": max(lanes - useful, 0),
            "goodput_tokens_per_sec": (
                round(useful / window_s, 1) if window_s > 0 else None),
            "serving_mfu": None if mfu is None else round(mfu, 6),
        }
        if traces is not None:
            record["traces"] = list(traces)
        if preemptions:
            record["preemptions"] = preemptions
        if prefix_hits is not None:
            record.update({
                "prefix_hits": prefix_hits,
                "prefix_misses": prefix_misses,
                "prefix_saved_tokens": prefix_saved_tokens,
                "prefix_cache_entries": prefix_cache_entries,
                "prefix_cache_bytes": prefix_cache_bytes,
            })
        if kv_pages_used is not None:
            self.kv_pages_used = kv_pages_used
            self.kv_pages_capacity = kv_pages_capacity
            self.kv_page_allocs += kv_page_allocs
            self.kv_page_frees += kv_page_frees
            self.peak_kv_pages_used = max(self.peak_kv_pages_used, kv_pages_used)
            record.update({
                "kv_pages_used": kv_pages_used,
                "kv_pages_capacity": kv_pages_capacity,
                "kv_page_allocs": kv_page_allocs,
                "kv_page_frees": kv_page_frees,
            })
        if quantized is not None:
            record["quantized"] = quantized
            record["weight_bytes"] = weight_bytes
            if page_pool_bytes is not None:
                record["page_pool_bytes"] = page_pool_bytes
        if spec_drafted is not None:
            self.spec_drafted += spec_drafted
            self.spec_accepted += spec_accepted or 0
            if spec_drafted:
                self.spec_accept_rate.record(100.0 * (spec_accepted or 0) / spec_drafted)
            self.spec_stream_ticks += spec_streams or 0
            record["spec_drafted"] = spec_drafted
            record["spec_accepted"] = spec_accepted
            record["spec_streams"] = spec_streams
        if compaction_width is not None:
            record["compaction_width"] = compaction_width
            self.compaction_hist[compaction_width] = (
                self.compaction_hist.get(compaction_width, 0) + 1)
            if compaction_width < self.capacity:
                self.compaction_ticks += 1
                self.compaction_lanes_saved += (
                    slot_lanes * self.capacity // compaction_width - slot_lanes)
        if self.jsonl_path:
            self._write_jsonl(record)

    def summary(self) -> dict:
        """The JAX package's ``summary()``: the same keys and rounding
        (the sections of features the port lacks, or that are off, are
        None, their counters 0)."""
        looked = self.prefix_full_hits + self.prefix_partial_hits + self.prefix_misses
        return {
            "ticks": self.ticks,
            "decode_tokens": self.decode_tokens,
            "decode_tokens_per_sec": (
                round(self.decode_tokens / self.decode_time_s, 1)
                if self.decode_time_s else None),
            "mean_tick_ms": (
                round(self.decode_time_s / self.ticks * 1000, 3) if self.ticks else None),
            "mean_slot_occupancy": (
                round(self._occupied_sum / (self.ticks * self.capacity), 4)
                if self.ticks else 0.0),
            "mean_queue_depth": (
                round(self._queue_depth_sum / self.ticks, 2) if self.ticks else 0.0),
            "peak_queue_depth": self.peak_queue_depth,
            "prefills": self.prefills,
            "prefill_tokens": self.prefill_tokens,
            "prefill_time_s": round(self.prefill_time_s, 4),
            "prefill_tokens_per_sec": (
                round(self.prefill_tokens / self.prefill_time_s, 1)
                if self.prefill_time_s else None),
            "prefill_chunks": self.prefill_chunks,
            "prefill_chunk_tokens": self.prefill_chunk_tokens,
            "prefill_chunk_tokens_per_sec": (
                round(self.prefill_chunk_tokens / self.prefill_chunk_time_s, 1)
                if self.prefill_chunk_time_s else None),
            "prefill_stall_s": round(self.prefill_stall_s, 4),
            "prefill_stall_ms": self.prefill_stall_ms.summary(),
            "finished_requests": self.finished_requests,
            "preemptions": self.preemptions,
            "migrations": {"out": 0, "in": 0,
                           "migration_ms": StreamingHistogram().summary()},
            "prefix_cache": (None if not self._prefix_cache_on else {
                "full_hits": self.prefix_full_hits,
                "partial_hits": self.prefix_partial_hits,
                "misses": self.prefix_misses,
                "hit_rate": (round((self.prefix_full_hits + self.prefix_partial_hits)
                                   / looked, 4) if looked else None),
                "saved_prefill_tokens": self.prefix_saved_tokens,
                "ttft_hit_ms": self.prefix_ttft_hit_ms.summary(),
                "ttft_miss_ms": self.prefix_ttft_miss_ms.summary(),
            }),
            "goodput": {
                "useful_tokens": self.useful_tokens,
                "wasted_token_lanes": max(self.computed_token_lanes - self.useful_tokens, 0),
                "useful_fraction": (
                    round(self.useful_tokens / self.computed_token_lanes, 4)
                    if self.computed_token_lanes else None),
                "goodput_tokens_per_sec": (
                    round(self.useful_tokens / self._goodput_window_s, 1)
                    if self._goodput_window_s else None),
                "serving_mfu": (
                    round(self._goodput_flops / (self._goodput_window_s * self._peak_flops), 6)
                    if (self._peak_flops and self._goodput_window_s
                        and self._fpt_decode is not None) else None),
            },
            "compaction": (None if not self._compaction_on else {
                "ticks_compacted": self.compaction_ticks,
                # one launch shape per distinct narrow width
                "recompiles": sum(1 for w in self.compaction_hist if w < self.capacity),
                "bucket_histogram": {str(w): n for w, n in
                                     sorted(self.compaction_hist.items())},
                "lanes_saved": self.compaction_lanes_saved,
            }),
            "pipeline": None,
            "speculation": (None if not self._spec_on else {
                "spec_tokens": self.spec_tokens_cfg,
                "drafter": self.spec_drafter,
                "drafted": self.spec_drafted,
                "accepted": self.spec_accepted,
                "acceptance_rate": (round(self.spec_accepted / self.spec_drafted, 4)
                                    if self.spec_drafted else None),
                "acceptance_rate_pct_hist": self.spec_accept_rate.summary(),
                # committed tokens per stream per launch (a non-speculative
                # tick is exactly 1.0)
                "accepted_tokens_per_tick": (
                    round(self.decode_tokens / self.spec_stream_ticks, 2)
                    if self.spec_stream_ticks else None),
            }),
            **dict.fromkeys(_OFF_SECTIONS),
            "memory": (None if not self._memory_on else {
                "weight_bytes": self.weight_bytes,
                "page_pool_bytes": self.page_pool_bytes,
                "weight_dtype": self.weight_dtype,
                "kv_dtype": self.kv_dtype,
                "greedy_token_disagreements": self.greedy_token_disagreements,
            }),
            "kv_pages": (None if self.kv_pages_used is None else {
                "used": self.kv_pages_used,
                "capacity": self.kv_pages_capacity,
                "peak_used": self.peak_kv_pages_used,
                "allocs": self.kv_page_allocs,
                "frees": self.kv_page_frees,
            }),
            "compile": None,
            "latency": {
                "queue_wait_ms": self.queue_wait_ms.summary(),
                "ttft_ms": self.ttft_ms.summary(),
                "itl_ms": self.itl_ms.summary(),
            },
        }

    def histogram_dicts(self) -> dict:
        """Full sparse bucket forms of the latency histograms
        (``StreamingHistogram.to_dict``)."""
        return {
            "queue_wait_ms": self.queue_wait_ms.to_dict(),
            "ttft_ms": self.ttft_ms.to_dict(),
            "itl_ms": self.itl_ms.to_dict(),
        }
