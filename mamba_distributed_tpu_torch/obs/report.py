"""The telemetry report's numbers, from the port's own readers.

``build_report`` aggregates a list of records (``export.load_jsonl`` of
any mix of ``events.jsonl``, ``metrics.jsonl`` and a ``ServingMetrics``
stream) into the sections of the JAX package's ``scripts/obs_report.py``
that the port's records feed, with the same keys and rounding: ``spans``
(per-name totals and the share of top-level time), ``train``/``val``,
``serving`` (ticks, decode tokens/s, goodput, the prefix cache's hit
counters, the compacted ticks' widths, the speculation counters, the
adapter cache's counters, preemptions, the hybrid page gauges, the int8 memory stamp) and
``requests`` (exact nearest-rank
percentiles of queue-wait, TTFT and end-to-end latency, TTFT split by
prefix-cache outcome, and the per-request ITL histograms merged into
one).
"""

from __future__ import annotations

from mamba_distributed_tpu_torch.obs.histogram import StreamingHistogram


def pcts(values: list[float]) -> dict:
    """Exact nearest-rank percentiles of scalar samples."""
    if not values:
        return {"count": 0, "mean": None, "p50": None, "p95": None, "p99": None,
                "max": None}
    xs = sorted(values)
    pick = lambda q: xs[min(len(xs) - 1, max(0, -(-q * len(xs) // 100) - 1))]
    return {"count": len(xs), "mean": round(sum(xs) / len(xs), 3),
            "p50": round(pick(50), 3), "p95": round(pick(95), 3),
            "p99": round(pick(99), 3), "max": round(xs[-1], 3)}


def _spans(spans: list[dict]) -> dict:
    by_name: dict[str, dict] = {}
    for s in spans:
        d = by_name.setdefault(s["name"], {"count": 0, "total_ms": 0.0, "max_ms": 0.0,
                                           "depth": s.get("depth", 0)})
        d["count"] += 1
        d["total_ms"] += s.get("dur_ms", 0.0)
        d["max_ms"] = max(d["max_ms"], s.get("dur_ms", 0.0))
    top_total = sum(s.get("dur_ms", 0.0) for s in spans if s.get("depth", 0) == 0)
    for d in by_name.values():
        d["total_ms"] = round(d["total_ms"], 3)
        d["mean_ms"] = round(d["total_ms"] / d["count"], 3)
        d["share"] = (round(d["total_ms"] / top_total, 4)
                      if top_total and d["depth"] == 0 else None)
    return dict(sorted(by_name.items(), key=lambda kv: -kv[1]["total_ms"]))


def _train(train: list[dict]) -> dict:
    losses = [e["loss"] for e in train if e.get("loss") is not None]
    return {
        "steps": len(train),
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "non_finite_losses": sum(1 for e in train if e.get("loss") is None),
        "step_ms": pcts([e["step_ms"] for e in train if e.get("step_ms") is not None]),
        "mean_tokens_per_sec": (
            round(sum(e["tokens_per_sec"] for e in train) / len(train), 1)
            if all(e.get("tokens_per_sec") is not None for e in train) else None),
    }


def _goodput(ticks: list[dict]) -> dict | None:
    gticks = [e for e in ticks if e.get("useful_tokens") is not None]
    if not gticks:
        return None
    window = lambda e: (e.get("tick_ms") or 0.0) + (e.get("prefill_stall_ms") or 0.0)
    useful = sum(e["useful_tokens"] for e in gticks)
    wasted = sum(e.get("wasted_token_lanes", 0) for e in gticks)
    window_ms = sum(window(e) for e in gticks)
    mfu_ticks = [e for e in gticks if e.get("serving_mfu") is not None]
    mfu_den = sum(window(e) for e in mfu_ticks)
    return {
        "useful_tokens": useful,
        "wasted_token_lanes": wasted,
        "useful_fraction": round(useful / (useful + wasted), 4) if useful + wasted else None,
        "goodput_tokens_per_sec": (round(useful / (window_ms / 1000), 1)
                                   if window_ms else None),
        "serving_mfu": (round(sum(e["serving_mfu"] * window(e) for e in mfu_ticks)
                              / mfu_den, 6) if mfu_den else None),
    }


def _serving(ticks: list[dict]) -> dict:
    tokens = sum(e.get("tokens_emitted", 0) for e in ticks)
    total_ms = sum(e.get("tick_ms", 0.0) for e in ticks)
    ratios = [e["occupied"] / e["capacity"] for e in ticks
              if e.get("capacity") and e.get("occupied") is not None]
    stalls = [e["prefill_stall_ms"] for e in ticks if e.get("prefill_stall_ms")]
    chunk_tokens = sum(e.get("prefill_chunk_tokens", 0) for e in ticks)
    chunk_total_ms = sum(e.get("prefill_chunk_ms", 0.0) for e in ticks)
    kv_ticks = [e for e in ticks if e.get("kv_pages_used") is not None]
    kv_pages = None
    if kv_ticks:
        kv_pages = {
            "capacity": kv_ticks[-1].get("kv_pages_capacity"),
            "peak_used": max(e["kv_pages_used"] for e in kv_ticks),
            "mean_used": round(sum(e["kv_pages_used"] for e in kv_ticks) / len(kv_ticks), 2),
            "allocs": sum(e.get("kv_page_allocs", 0) for e in kv_ticks),
            "frees": sum(e.get("kv_page_frees", 0) for e in kv_ticks),
        }
    pticks = [e for e in ticks if e.get("prefix_hits") is not None]
    prefix = None
    if pticks:
        hits = sum(e["prefix_hits"] for e in pticks)
        misses = sum(e.get("prefix_misses", 0) for e in pticks)
        prefix = {
            "hits": hits,
            "misses": misses,
            "hit_rate": round(hits / (hits + misses), 4) if hits + misses else None,
            "saved_prefill_tokens": sum(e.get("prefix_saved_tokens", 0) for e in pticks),
            "entries": pticks[-1].get("prefix_cache_entries"),
            "bytes": pticks[-1].get("prefix_cache_bytes"),
        }
    cticks = [e for e in ticks if e.get("compaction_width") is not None]
    compaction = None
    if cticks:
        widths = [e["compaction_width"] for e in cticks]
        compaction = {
            "ticks": len(cticks),
            "ticks_compacted": sum(1 for e in cticks if e.get("capacity")
                                   and e["compaction_width"] < e["capacity"]),
            "mean_width": round(sum(widths) / len(widths), 2),
            "min_width": min(widths),
        }
    spticks = [e for e in ticks if e.get("spec_drafted") is not None]
    speculation = None
    if spticks:
        drafted = sum(e["spec_drafted"] for e in spticks)
        accepted = sum(e.get("spec_accepted", 0) for e in spticks)
        # committed tokens per stream per verify launch (records without
        # spec_streams fall back to per tick)
        streams = sum(e.get("spec_streams") or 0 for e in spticks)
        speculation = {
            "ticks": len(spticks),
            "drafted": drafted,
            "accepted": accepted,
            "acceptance_rate": round(accepted / drafted, 4) if drafted else None,
            "accepted_tokens_per_tick": round(
                sum(e.get("tokens_emitted", 0) for e in spticks) / (streams or len(spticks)), 2),
        }
    aticks = [e for e in ticks if e.get("adapters_resident") is not None]
    adapters = None
    if aticks:
        adapters = {
            "resident": aticks[-1]["adapters_resident"],
            "cache_hits": sum(e.get("adapter_cache_hits", 0) for e in aticks),
            "cache_misses": sum(e.get("adapter_cache_misses", 0) for e in aticks),
            "cache_evictions": sum(e.get("adapter_cache_evictions", 0) for e in aticks),
            "peak_live": max(e.get("adapters_live", 0) for e in aticks),
        }
    qticks = [e for e in ticks if e.get("quantized") is not None]
    memory = None
    if qticks:
        last = qticks[-1]
        memory = {"quantized": last["quantized"], "weight_bytes": last.get("weight_bytes"),
                  "page_pool_bytes": last.get("page_pool_bytes")}
    return {
        "ticks": len(ticks),
        "decode_tokens": tokens,
        "tick_ms": pcts([e["tick_ms"] for e in ticks if e.get("tick_ms") is not None]),
        "decode_tokens_per_sec": round(tokens / (total_ms / 1000), 1) if total_ms else None,
        "mean_slot_occupancy": round(sum(ratios) / len(ratios), 4) if ratios else None,
        "peak_queue_depth": max(e.get("queue_depth", 0) for e in ticks),
        "prefill_stall_ms": pcts(stalls) if stalls else None,
        "prefill_chunk_tokens": chunk_tokens,
        "prefill_chunk_tokens_per_sec": (
            round(chunk_tokens / (chunk_total_ms / 1000), 1)
            if chunk_tokens and chunk_total_ms else None),
        "goodput": _goodput(ticks),
        "prefix_cache": prefix,
        "compaction": compaction,
        "speculation": speculation,
        "adapters": adapters,
        "preemptions": sum(e.get("preemptions", 0) for e in ticks),
        "kv_pages": kv_pages,
        "memory": memory,
    }


def _requests(reqs: list[dict]) -> dict:
    col = lambda key: [e[key] for e in reqs if e.get(key) is not None]
    itl = None
    for e in reqs:
        if e.get("itl_hist"):
            h = StreamingHistogram.from_dict(e["itl_hist"])
            itl = h if itl is None else itl.merge(h)
    finish: dict[str, int] = {}
    for e in reqs:
        reason = e.get("finish_reason") or "?"
        finish[reason] = finish.get(reason, 0) + 1
    out = {
        "count": len(reqs),
        "finish_reasons": finish,
        "prompt_tokens": sum(col("prompt_tokens")),
        "new_tokens": sum(col("new_tokens")),
        "queue_wait_ms": pcts(col("queue_wait_ms")),
        "ttft_ms": pcts(col("ttft_ms")),
        "e2e_ms": pcts(col("e2e_ms")),
        "itl_ms": itl.summary() if itl is not None else None,
    }
    if stamped := [e for e in reqs if "prefix_hit" in e]:
        # a cache-on engine stamps each request with its lookup outcome
        timed = [e for e in stamped if e.get("ttft_ms") is not None]
        out["ttft_hit_ms"] = pcts([e["ttft_ms"] for e in timed if e["prefix_hit"]])
        out["ttft_miss_ms"] = pcts([e["ttft_ms"] for e in timed if not e["prefix_hit"]])
    return out


def build_report(events: list[dict]) -> dict:
    """The report sections the records in ``events`` feed."""
    of = lambda kind: [e for e in events if e.get("kind") == kind]
    report: dict = {}
    if spans := of("span"):
        report["spans"] = _spans(spans)
    if train := of("train"):
        report["train"] = _train(train)
    if vals := of("val"):
        report["val"] = {"count": len(vals), "last_loss": vals[-1].get("loss")}
    if ticks := of("serving_tick"):
        report["serving"] = _serving(ticks)
    if reqs := of("request"):
        report["requests"] = _requests(reqs)
    return report
