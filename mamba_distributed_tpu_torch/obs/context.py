"""Trace ids: one id for one request's journey.

The scheduler mints one id per request at submit (or keeps the id the
request arrives with); the engine stamps it on the request's spans
(``trace=``), on its ``request`` record (``trace_id``) and on every tick
that advances it (``traces=[...]``), and ``obs/export.py`` turns the
stamps into Perfetto flow arrows.

Ids are strings, unique across processes (a per-process random nonce)
and ordered within one (a monotone counter), so two processes can never
mint the same id.  Host-side bookkeeping only.
"""

from __future__ import annotations

import itertools
import os
import secrets

# process-unique prefix: pid (readable in trace UIs) + random salt (pids
# recycle; two runs on one box must not collide in a merged trace)
_PROCESS_NONCE = ""
_COUNTER = itertools.count()  # atomic under the GIL: no lock for next()


def _reseed() -> None:
    """(Re)derive the process nonce and reset the counter, at import and
    after fork: a forked child inherits the parent's module state, and
    continuing from the same nonce and counter would mint colliding ids."""
    global _PROCESS_NONCE, _COUNTER
    _PROCESS_NONCE = f"{os.getpid():x}-{secrets.token_hex(3)}"
    _COUNTER = itertools.count()


_reseed()
if hasattr(os, "register_at_fork"):  # absent on non-POSIX
    os.register_at_fork(after_in_child=_reseed)


def mint_trace_id() -> str:
    """A fresh process-unique trace id (one per request journey): a bare
    string, spelled inline by every writer as ``trace=<id>`` on spans,
    ``trace_id`` on request records and ``traces=[...]`` on ticks."""
    return f"{_PROCESS_NONCE}-{next(_COUNTER):04x}"
