"""Host-side span tracer: one jsonl event stream, no device work.

``SpanTracer.span("train_step")`` times a host-side phase and appends one
``{"kind": "span", ...}`` record on exit.  The tracer never touches a
tensor, so turning it on adds no kernel launch and no device sync: a
span that should cover device work closes after a host fetch the caller
already makes (the trainer's ``.tolist()`` of the step's scalars, the
engine's ``.cpu()`` of a tick's tokens).

``NULL_TRACER`` is the disabled implementation: ``span()`` returns a
shared ``nullcontext``, so instrumented code pays one attribute lookup
and one function call when telemetry is off.  Code under instrumentation
takes a tracer instance (trainer, serving engine) rather than consulting
a global, so two engines in one process can write disjoint streams.

The records are the JAX package's ``obs/tracer.py`` records, key for key,
so the same readers take either package's streams.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import threading
import time


def jsonable(record: dict) -> dict:
    """NaN/Inf are not valid JSON (json.dumps emits bare NaN tokens strict
    parsers reject, exactly in the diverged-run case where telemetry
    matters most); serialize them as null."""
    return {
        k: (None if isinstance(v, float) and not math.isfinite(v) else v)
        for k, v in record.items()
    }


def append_jsonl(path: str, record: dict, truncate: bool = False) -> None:
    """The one way every telemetry writer puts a record on disk: one
    jsonable object, one line, open-write-close per record (every line
    lands flushed and closed, so a crash leaves whole lines).
    ``truncate`` starts a fresh stream (writers defer it to their first
    write so a checkpoint resume can keep the history)."""
    with open(path, "w" if truncate else "a") as f:
        f.write(json.dumps(jsonable(record)) + "\n")


class SpanTracer:
    """Appends span/event records to one jsonl file.

    Span records carry the name, start offset from tracer creation
    (``t_ms``), duration (``dur_ms``), nesting ``depth`` and enclosing
    ``parent`` span name (per-thread stacks, so a second host thread
    cannot corrupt the trainer's nesting), plus any keyword attributes
    given at the call site.  Writes are lock-serialized, open-append-close
    per record.

    The first write also stamps one ``trace_header`` record
    (``wall_t0_s``: the wall clock paired with the tracer's t=0, plus the
    pid), which is what lets ``obs/export.py`` merge streams from
    different processes onto one timeline: ``t_ms`` alone is a
    process-local perf_counter offset.

    ``jsonl_path=None`` keeps the tracer live with no file behind it (the
    ring-only mode).  ``ring_len > 0`` also keeps the last N records in a
    bounded in-memory ring, each stamped with an increasing sequence
    number; ``ring_pull(cursor)`` drains it incrementally, and a reader
    whose cursor fell behind the ring gets an explicit ``dropped`` count.
    The ring holds already-jsonable dicts, so pulled records equal what
    the file received.

    ``rotate_bytes > 0`` caps the jsonl file: when appending a record
    would push the file past the cap, the current file rolls to
    ``<path>.1`` (one generation; the previous ``.1`` is dropped) and a
    fresh ``trace_header`` opens the new file so each generation stays
    alignable on its own.  ``obs/export.load_jsonl`` reads the rolled
    pair oldest-first.
    """

    enabled = True

    def __init__(self, jsonl_path: str | None = None,
                 _clock=time.perf_counter, *, ring_len: int = 0,
                 rotate_bytes: int = 0):
        if ring_len < 0:
            raise ValueError(f"ring_len must be >= 0, got {ring_len}")
        if rotate_bytes < 0:
            raise ValueError(
                f"rotate_bytes must be >= 0 (0 = no rotation), got "
                f"{rotate_bytes}"
            )
        if jsonl_path:
            parent = os.path.dirname(jsonl_path)
            if parent:
                os.makedirs(parent, exist_ok=True)
        self.jsonl_path = jsonl_path
        self.rotate_bytes = rotate_bytes
        # ring of (seq, jsonable record); None when disabled
        self._ring = (collections.deque(maxlen=ring_len)
                      if ring_len else None)
        self._seq = 0
        # file size for rotation, resolved at the first file write (a
        # preserved-history append starts from the existing file's size)
        self._file_bytes: int | None = None
        self._clock = _clock
        self._t0 = _clock()
        # wall clock paired with _t0 at the same instant: the epoch the
        # first write stamps as the "trace_header" record
        self.wall_t0 = time.time()
        self._lock = threading.Lock()
        self._local = threading.local()
        # small stable per-tracer thread index, stamped as ``tid`` on
        # span/event records: spans of different host threads overlap
        # without nesting, so the exporter gives each thread its own track
        self._tids: dict[int, int] = {}
        # truncation is deferred to the first write (the MetricsLogger
        # contract) so a checkpoint resume or an --auto-restart rebuild
        # can keep the pre-crash span history.  NB ``t_ms`` offsets
        # restart from 0 for the new tracer's records, under a fresh
        # header, so the exporter still places them on the timeline
        self._truncate_pending = True
        self._header_pending = True

    def _stack(self) -> list[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Time the enclosed host-side block as one span record."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        stack.append(name)
        t_start = self._clock()
        try:
            yield
        finally:
            dur = self._clock() - t_start
            stack.pop()
            record = {
                "kind": "span",
                "name": name,
                "t_ms": round((t_start - self._t0) * 1000, 3),
                "dur_ms": round(dur * 1000, 3),
                "depth": len(stack),
                "tid": self._tid(),
            }
            if parent is not None:
                record["parent"] = parent
            if attrs:
                record.update(attrs)
            self.write(record)

    def event(self, name: str, **attrs) -> None:
        """Record a point-in-time marker (no duration)."""
        record = {
            "kind": "event",
            "name": name,
            "t_ms": round((self._clock() - self._t0) * 1000, 3),
            "tid": self._tid(),
        }
        if attrs:
            record.update(attrs)
        self.write(record)

    def preserve_history(self) -> None:
        """Keep the existing stream (called on checkpoint resume)."""
        self._truncate_pending = False

    def _header_record(self) -> dict:
        return {"kind": "trace_header",
                "wall_t0_s": round(self.wall_t0, 6),
                "pid": os.getpid()}

    def _emit(self, record: dict, truncate: bool = False) -> None:
        """Lock held: one record into the ring and (if any) the file."""
        record = jsonable(record)
        if self._ring is not None:
            self._ring.append((self._seq, record))
            self._seq += 1
        if not self.jsonl_path:
            return
        line = json.dumps(record) + "\n"
        if self._file_bytes is None:
            self._file_bytes = (
                0 if truncate or not os.path.exists(self.jsonl_path)
                else os.path.getsize(self.jsonl_path)
            )
        if (self.rotate_bytes > 0 and self._file_bytes > 0
                and self._file_bytes + len(line) > self.rotate_bytes):
            # roll the full generation aside and re-head the fresh file;
            # the header does not enter the ring again
            os.replace(self.jsonl_path, self.jsonl_path + ".1")
            header = json.dumps(jsonable(self._header_record())) + "\n"
            with open(self.jsonl_path, "w") as f:
                f.write(header)
            self._file_bytes = len(header)
        with open(self.jsonl_path, "w" if truncate else "a") as f:
            f.write(line)
        self._file_bytes = (len(line) if truncate
                            else self._file_bytes + len(line))

    def write(self, record: dict) -> None:
        with self._lock:
            if self._header_pending:
                self._header_pending = False
                self._emit(self._header_record(),
                           truncate=self._truncate_pending)
                self._truncate_pending = False
            self._emit(record, truncate=self._truncate_pending)
            self._truncate_pending = False

    def ring_pull(self, cursor: int = 0, limit: int = 4096) -> dict:
        """Drain ring records with seq >= ``cursor`` (bounded).

        Returns ``{"records": [...], "cursor": next_cursor,
        "dropped": n}``: ``dropped`` counts records that aged out of the
        ring before this pull.  A tracer with no ring returns an empty
        page at the caller's cursor.
        """
        with self._lock:
            if self._ring is None:
                return {"records": [], "cursor": cursor, "dropped": 0}
            dropped = 0
            if self._ring:
                oldest = self._ring[0][0]
                if cursor < oldest:
                    dropped = oldest - cursor
                    cursor = oldest
            out = [rec for seq, rec in self._ring
                   if seq >= cursor][:max(0, limit)]
            return {"records": out, "cursor": cursor + len(out),
                    "dropped": dropped}


class _NullTracer:
    """Telemetry off: every operation is a no-op."""

    enabled = False
    _ctx = contextlib.nullcontext()  # reusable + reentrant

    def span(self, name: str, **attrs):
        return self._ctx

    def event(self, name: str, **attrs) -> None:
        pass

    def preserve_history(self) -> None:
        pass

    def write(self, record: dict) -> None:
        pass

    def ring_pull(self, cursor: int = 0, limit: int = 4096) -> dict:
        return {"records": [], "cursor": cursor, "dropped": 0}


NULL_TRACER = _NullTracer()
