"""Chrome trace-event (Perfetto) export of the span jsonl streams.

``to_chrome_trace`` merges N ``SpanTracer`` streams into one trace-event
JSON document that loads in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``:

  * each input stream becomes one process track (``pid`` = stream
    index, named after its label or file name);
  * spans become complete ("X") slices at absolute wall-clock
    microseconds: every stream's ``trace_header`` record gives the wall
    time of that tracer's t=0, and ``ts = wall_t0 + t_ms``.  A stream
    that stamps a header again mid-file (a tracer rebuilt after a
    checkpoint resume) re-anchors its later records on the new epoch;
  * each host thread (``tid``) of a stream gets its own track;
  * spans carrying a ``trace`` attr (one request's journey, ids from
    ``obs/context.py``) are linked with flow arrows (``s``/``t``/``f``
    events sharing one id); a ``serving_tick`` slice lists its resident
    requests in a ``traces`` attr, and the first tick holding a request
    ends that request's arrow (its first decode tick, where TTFT lands).

Host-side post-processing only; the document is the JAX package's
``obs/export.py``'s, event for event.
"""

from __future__ import annotations

import json
import os


def load_jsonl(path: str, bad_lines: list | None = None) -> list[dict]:
    """All parseable records of one stream, in order.  Torn trailing
    lines (crashed writer) are skipped — an export must still come out
    of a post-mortem stream.  Pass ``bad_lines`` to collect the skipped
    raw lines; this is the one tolerant jsonl loader every stream
    consumer shares.

    A byte-capped SpanTracer (``rotate_bytes``) rolls its previous
    generation to ``<path>.1``; when that sibling exists the pair is
    read oldest-first (``.1`` then ``path``) so rotation never hides
    history from a consumer that was handed the live path."""
    records = []
    rolled = path + ".1"
    paths = [rolled, path] if os.path.exists(rolled) else [path]
    for p in paths:
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    if bad_lines is not None:
                        bad_lines.append(line)
                    continue
                if isinstance(rec, dict):
                    records.append(rec)
    return records


_SPAN_META = ("kind", "name", "t_ms", "dur_ms", "depth", "parent", "tid",
              "obs_src")


def split_pulled_stream(records: list[dict]) -> tuple[list[list[dict]],
                                                      list[str]]:
    """Split one merged stream into per-origin sub-streams.

    A stream that interleaves records pulled from several tracers stamps
    each with ``obs_src`` (its origin).  Grouping by ``obs_src`` (order
    of first appearance; untagged records form a ``"local"`` stream)
    recovers the per-process streams ``to_chrome_trace`` needs: each
    origin keeps its own ``trace_header`` epoch, so alignment and
    per-process tracks work as they do for N separate files.
    """
    order: list[str] = []
    by_src: dict[str, list[dict]] = {}
    for rec in records:
        src = str(rec.get("obs_src", "local"))
        if src not in by_src:
            by_src[src] = []
            order.append(src)
        by_src[src].append(rec)
    return [by_src[s] for s in order], order


def to_chrome_trace(
    streams: list[list[dict]], labels: list[str] | None = None
) -> dict:
    """Merge record streams into one Chrome trace-event document.

    Args:
      streams: one list of jsonl records per input file (``load_jsonl``).
      labels: per-stream process-track names (default ``stream<i>``).

    Returns the trace document: ``{"traceEvents": [...],
    "displayTimeUnit": "ms", "metadata": {...}}``.  Streams without a
    ``trace_header`` fall back to epoch 0 — they still render, but on
    their own (unaligned) clock; ``metadata.unaligned_streams`` counts
    them so the caller can warn.
    """
    labels = labels or []
    events: list[dict] = []
    # per-trace flow chain members: trace_id -> list[(ts_us, event)]
    chains: dict[str, list[tuple[float, dict]]] = {}
    # earliest tick slice containing each trace (terminates its arrow).
    # Resolved on timestamp after all streams load, so the true first
    # decode tick wins whatever the order of the streams.
    first_tick: dict[str, tuple[float, dict]] = {}
    unaligned = 0

    for pid, records in enumerate(streams):
        label = labels[pid] if pid < len(labels) else f"stream{pid}"
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": label}})
        wall_t0_us = None
        for rec in records:
            kind = rec.get("kind")
            if kind == "trace_header":
                wall_t0_us = float(rec.get("wall_t0_s", 0.0)) * 1e6
                continue
            if kind not in ("span", "event"):
                continue  # serving_tick/request/train records carry no t_ms
            if wall_t0_us is None:
                unaligned += 1  # once per headerless stream
                wall_t0_us = 0.0
            ts = wall_t0_us + float(rec.get("t_ms", 0.0)) * 1000.0
            args = {k: v for k, v in rec.items() if k not in _SPAN_META}
            # per-thread tracks: spans of different host threads (async
            # checkpoint vs trainer) overlap un-nested in wall time, so
            # each thread index gets its own tid (0 for headerless /
            # pre-tid streams)
            tid = int(rec.get("tid", 0))
            if kind == "event":
                events.append({"name": rec["name"], "ph": "i", "s": "t",
                               "ts": ts, "pid": pid, "tid": tid,
                               "args": args})
                continue
            ev = {"name": rec["name"], "ph": "X", "ts": ts,
                  "dur": float(rec.get("dur_ms", 0.0)) * 1000.0,
                  "pid": pid, "tid": tid, "args": args}
            events.append(ev)
            trace = rec.get("trace")
            if trace is not None:
                chains.setdefault(str(trace), []).append((ts, ev))
            # a tick's `traces` list terminates each member's chain at
            # its EARLIEST tick only — one arrow into the first decode
            # tick (where TTFT lands), not one per tick of the
            # request's lifetime
            for t in rec.get("traces") or ():
                t = str(t)
                cur = first_tick.get(t)
                if cur is None or ts < cur[0]:
                    first_tick[t] = (ts, ev)

    for t, member in first_tick.items():
        chains.setdefault(t, []).append(member)

    flows = 0
    for trace_id, members in chains.items():
        if len(members) < 2:
            continue
        members.sort(key=lambda m: m[0])
        for i, (ts, ev) in enumerate(members):
            ph = "s" if i == 0 else ("f" if i == len(members) - 1 else "t")
            # the trace id itself is the flow id (the trace-event format
            # accepts string ids) — hashing to an int would reintroduce
            # a collision class that cross-links unrelated requests
            flow = {"name": f"req {trace_id}", "cat": "request", "ph": ph,
                    "id": trace_id, "ts": ts, "pid": ev["pid"],
                    "tid": ev["tid"]}
            if ph == "f":
                flow["bp"] = "e"  # bind to the enclosing slice
            events.append(flow)
            flows += 1

    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "streams": len(streams),
            "flow_events": flows,
            "linked_requests": sum(1 for m in chains.values() if len(m) >= 2),
            "unaligned_streams": unaligned,
        },
    }


def export_chrome_trace(paths: list[str], out_path: str) -> dict:
    """Load each stream file, merge, write ``out_path``.
    Returns the document's metadata block.

    A file whose records carry ``obs_src`` tags expands into one
    sub-stream per origin (``split_pulled_stream``)."""
    streams: list[list[dict]] = []
    labels: list[str] = []
    for p in paths:
        records = load_jsonl(p)
        base = os.path.basename(p)
        if any("obs_src" in r for r in records):
            subs, srcs = split_pulled_stream(records)
            streams.extend(subs)
            labels.extend(f"{base}:{s}" for s in srcs)
        else:
            streams.append(records)
            labels.append(base)
    doc = to_chrome_trace(streams, labels=labels)
    with open(out_path, "w") as f:
        json.dump(doc, f)
    return doc["metadata"]
