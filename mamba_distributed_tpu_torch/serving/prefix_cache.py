"""Prefix-state cache: O(1) carry snapshots keyed by prompt-prefix hash
(counterpart of ``mamba_distributed_tpu/serving/prefix_cache.py``; the
keys are its digests byte for byte).

Requests share system prompts and few-shot preambles, and a Mamba prefix
collapses to a fixed-size conv+SSM carry: the chunk planner
(serving/prefill.py) produces exactly these carries at chunk boundaries,
so prefilling a shared preamble again is waste.  This module is the
host-side LRU store:

  * **Keys** hash the exact chunk LAYOUT prefix, not just the token
    prefix: a chunk-boundary key covers ``(chunk, pad, tokens so far)``,
    the inputs that determine the carry after that chunk.  Two requests
    share a snapshot iff their padded layouts agree on every chunk up to
    the boundary, which makes a warm stream BIT-IDENTICAL to a cold one:
    the cached carry is the output of the computation the cold run would
    have made.  So prompts sharing a preamble share snapshots when their
    total lengths are congruent mod the chunk size (equal left pads).
  * **Full-prompt entries** also carry the last logits, so an exact
    prompt repeat skips prefill entirely.
  * **Entries hold device tensors.**  Looking up, pinning and evicting
    entries costs no device sync; a snapshot is a kept reference to
    tensors a prefill produced.  Consumers that write a tensor in place
    copy it first: the engine's slot writes copy into the pool, and
    ``generate()`` decodes from a clone.
  * **Hybrid entries pin KV pages** by id: the engine increfs the
    prefix's pages in its ``state_cache.PagePool`` when it stores an
    entry, and the ``evict_hook`` decrefs them when the LRU lets go;
    sharing across slots is copy-on-write (serving/engine.py).

Bounded by entries AND bytes (``cfg.prefix_cache_entries`` /
``prefix_cache_bytes``); ``min_hits`` (``cfg.prefix_min_chunk_hits``) is
promotion: a prefix must MISS that many times before its snapshot is
stored, so one-off prompts do not churn the LRU.

The cache is valid for ONE parameter set (keys hash prompts, not
weights) and, for hybrid entries, ONE engine's page pool; share an
instance between an engine and ``generate(prefix_cache=...)`` only when
both serve the same params.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict

import numpy as np


def _tokens_digest(h, prompt_ids, n: int) -> None:
    h.update(np.ascontiguousarray(
        np.asarray(prompt_ids, np.int32).reshape(-1)[:n]
    ).tobytes())


def boundary_key(prompt_ids, plan, i: int, salt: bytes = b"") -> str:
    """Key of the carry after chunk ``i`` of ``plan``'s layout: the
    chunk width, the left-pad, and every real token consumed through
    that chunk — exactly the inputs that determine the carry.
    ``salt`` mixes into the key anything else the carry depends on: the
    engine salts by LoRA adapter (serving/adapters.prefix_salt).
    The empty default leaves every digest byte-identical to the unsalted
    one."""
    real = (i + 1) * plan.chunk - plan.pad
    h = hashlib.sha1()
    h.update(salt)
    h.update(b"chunk:%d:%d:" % (plan.chunk, plan.pad))
    _tokens_digest(h, prompt_ids, real)
    return h.hexdigest()


def full_key(prompt_ids, chunk: int, salt: bytes = b"") -> str:
    """Key of a CHUNKED prompt's final (state, last-logits) pair.  The
    pad is a pure function of (len, chunk), so chunk + the full token
    sequence pin the layout (``salt``: see ``boundary_key``)."""
    h = hashlib.sha1()
    h.update(salt)
    h.update(b"full:%d:" % chunk)
    _tokens_digest(h, prompt_ids, len(prompt_ids))
    return h.hexdigest()


def layout_keys(prompt_ids, plan, salt: bytes = b"") -> tuple[list, str]:
    """Every boundary key of ``plan``'s layout plus the full key, in ONE
    O(prompt_len) pass: the boundary digests are prefix-snapshots of a
    single running hash (``hashlib`` copies), byte-identical to calling
    ``boundary_key`` per chunk — which would rehash the whole prefix per
    boundary, O(n_chunks x prompt_len) on the admission hot path."""
    ids = np.ascontiguousarray(np.asarray(prompt_ids, np.int32).reshape(-1))
    h = hashlib.sha1()
    h.update(salt)
    h.update(b"chunk:%d:%d:" % (plan.chunk, plan.pad))
    keys = []
    prev = 0
    for i in range(plan.n_chunks):
        real = (i + 1) * plan.chunk - plan.pad
        h.update(ids[prev:real].tobytes())
        prev = real
        keys.append(h.copy().hexdigest())
    hf = hashlib.sha1()
    hf.update(salt)
    hf.update(b"full:%d:" % plan.chunk)
    hf.update(ids.tobytes())
    return keys, hf.hexdigest()


def oneshot_key(prompt_ids, salt: bytes = b"") -> str:
    """Key of a ONE-SHOT (pow2-bucketed) prompt's final (state, logits)
    pair — the short pure-SSM admission path.  The bucket is a pure
    function of the length, so the tokens alone pin the layout
    (``salt``: see ``boundary_key``)."""
    h = hashlib.sha1()
    h.update(salt)
    h.update(b"oneshot:")
    _tokens_digest(h, prompt_ids, len(prompt_ids))
    return h.hexdigest()


@dataclasses.dataclass
class PrefixEntry:
    """One cached snapshot.

    ``state`` is the batch-1 ``{"blocks": (conv, ssm)}`` carry (device
    tensors); ``logits`` (1, V) marks a FULL entry (prefill skippable
    outright).  ``tokens`` is the real prompt tokens the snapshot
    covers (what a hit saves), ``chunks`` the chunk steps it skips.
    Hybrid entries pin ``kv_pages`` (physical ids, prefix order) whose
    first ``kv_len`` token positions hold the prefix's KV.  ``shard``
    is the page pool's data shard (always 0: the port's pool has one)."""

    state: dict
    tokens: int
    chunks: int
    nbytes: int
    logits: object | None = None
    kv_pages: tuple | None = None
    kv_len: int = 0
    shard: int = 0

    @property
    def full(self) -> bool:
        return self.logits is not None


class PrefixCache:
    """Bounded LRU of :class:`PrefixEntry` keyed by layout-prefix hash.

    Args:
      max_entries: entry-count cap (>= 1).
      max_bytes: byte cap over every entry's ``nbytes`` (0 = no byte
        cap).  Either cap evicts least-recently-used first.
      min_hits: misses a key must accumulate before ``wants`` lets its
        snapshot be stored (1 = store on first sight).
      evict_hook: called with each evicted PrefixEntry — the hybrid
        engine decrefs the entry's pinned KV pages here.
    """

    def __init__(self, max_entries: int = 256, max_bytes: int = 0,
                 min_hits: int = 1, evict_hook=None):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        if max_bytes < 0:
            raise ValueError(f"max_bytes must be >= 0, got {max_bytes}")
        if min_hits < 1:
            raise ValueError(f"min_hits must be >= 1, got {min_hits}")
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.min_hits = min_hits
        self.evict_hook = evict_hook
        self._entries: OrderedDict[str, PrefixEntry] = OrderedDict()
        self._seen: OrderedDict[str, int] = OrderedDict()  # miss counts
        self.nbytes = 0
        # lifetime stats (the engine keeps its own per-tick windows)
        self.hits = 0
        self.misses = 0
        self.saved_tokens = 0
        self.evictions = 0

    # -------------------------------------------------------------- basics

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def get(self, key: str, peek: bool = False) -> PrefixEntry | None:
        """The entry under ``key`` (refreshing its recency), or None.
        ``peek`` skips the recency touch, so a probe does not perturb
        eviction order."""
        e = self._entries.get(key)
        if e is not None and not peek:
            self._entries.move_to_end(key)
        return e

    def wants(self, key: str) -> bool:
        """Should the caller build + store a snapshot for ``key``?  No
        when it is already cached; no until the key has missed
        ``min_hits`` times (''note_miss'' counts — lookup bumps it)."""
        if key in self._entries:
            return False
        if self.min_hits <= 1:
            return True
        return self._seen.get(key, 0) >= self.min_hits

    def commit_lookup(self, prompt_ids, plan, hit,
                      salt: bytes = b"") -> None:
        """Record a lookup outcome once the admission actually went
        through.  The ENGINE probes with ``lookup(peek=True)`` and
        commits here only after securing a slot: a request stalled on
        KV pages retries its admission every step, and counting each
        retry would drift hit/miss stats and self-promote ``min_hits``
        counters (which are meant to count distinct misses, not
        retries of one).  ``hit`` is the peek's ``(entry, chunks_done)``
        — or None for a miss, including a hit the engine abandoned and
        served cold."""
        if hit is not None:
            entry, chunks_done = hit
            self.hits += 1
            self.saved_tokens += entry.tokens
            if plan is None:
                self.get(oneshot_key(prompt_ids, salt))  # deferred recency
                return
            bkeys, fkey = layout_keys(prompt_ids, plan, salt)
            if chunks_done == plan.n_chunks:
                self.get(fkey)
                return
            self.get(bkeys[chunks_done - 1])
            # keys DEEPER than the hit still missed — they count toward
            # promotion exactly as lookup()'s non-peek path counts them,
            # or a partially-hit prompt could never promote its full
            # entry past min_hits
            self.note_miss(fkey)
            for k in bkeys[chunks_done:plan.n_chunks - 1]:
                self.note_miss(k)
            return
        self.misses += 1
        if plan is None:
            self.note_miss(oneshot_key(prompt_ids, salt))
            return
        bkeys, fkey = layout_keys(prompt_ids, plan, salt)
        for k in [fkey] + bkeys[:-1]:
            self.note_miss(k)

    def evict_one_pinned(self, shards=None) -> bool:
        """Evict the least-recently-used entry that pins KV pages (the
        engine's admission pressure valve, serving/engine.py
        ``_reclaim_cache_pages``), optionally restricted to entries
        whose pages live in ``shards`` — evicting another shard's
        entries can never unblock this admission.  Returns False when
        no eligible entry exists."""
        victim_key = next((k for k, e in self._entries.items()
                           if e.kv_pages
                           and (shards is None or e.shard in shards)),
                          None)
        if victim_key is None:
            return False
        victim = self._entries.pop(victim_key)
        self.nbytes -= victim.nbytes
        self.evictions += 1
        if self.evict_hook is not None:
            self.evict_hook(victim)
        return True

    def note_miss(self, key: str) -> None:
        """Count a lookup miss toward ``min_hits`` promotion (bounded:
        the counter table trims FIFO at 4x the entry cap)."""
        if self.min_hits <= 1:
            return
        self._seen[key] = self._seen.get(key, 0) + 1
        self._seen.move_to_end(key)
        while len(self._seen) > 4 * self.max_entries:
            self._seen.popitem(last=False)

    def put(self, key: str, entry: PrefixEntry) -> None:
        """Store (caller checked ``wants`` first — storing over a live
        key would strand its side effects, e.g. page increfs)."""
        if key in self._entries:
            raise KeyError(f"prefix key {key} already cached — check "
                           f"wants() before building an entry")
        self._entries[key] = entry
        self.nbytes += entry.nbytes
        self._seen.pop(key, None)
        self._evict_over_caps()

    def _evict_over_caps(self) -> None:
        while (len(self._entries) > self.max_entries
               or (self.max_bytes and self.nbytes > self.max_bytes
                   and len(self._entries) > 1)):
            _, victim = self._entries.popitem(last=False)
            self.nbytes -= victim.nbytes
            self.evictions += 1
            if self.evict_hook is not None:
                self.evict_hook(victim)

    def clear(self) -> None:
        """Drop everything (evict hooks run, so pinned pages release)."""
        while self._entries:
            _, victim = self._entries.popitem(last=False)
            self.nbytes -= victim.nbytes
            self.evictions += 1
            if self.evict_hook is not None:
                self.evict_hook(victim)
        self._seen.clear()

    # ------------------------------------------------------------- lookups

    def lookup(self, prompt_ids, plan, peek: bool = False,
               salt: bytes = b""):
        """Deepest cached prefix for this prompt's exact layout.

        Returns ``(entry, chunks_done)`` — ``chunks_done ==
        plan.n_chunks`` (or 0 with ``plan=None``, the one-shot path)
        means a FULL hit whose entry carries the last logits — or None.
        Order: full entry first, then chunk boundaries deepest-first
        (the last boundary is skipped for this plan: without the final
        logits it cannot finish, though it serves LONGER same-pad
        prompts).  Misses bump the promotion counters; ``peek`` probes
        without touching stats or recency."""
        if plan is None:
            key = oneshot_key(prompt_ids, salt)
            e = self.get(key, peek=peek)
            if e is not None:
                if not peek:
                    self.hits += 1
                    self.saved_tokens += e.tokens
                return e, 0
            if not peek:
                self.misses += 1
                self.note_miss(key)
            return None
        bkeys, fkey = layout_keys(prompt_ids, plan, salt)
        keys = [(fkey, plan.n_chunks)]
        keys += [(bkeys[i], i + 1)
                 for i in reversed(range(plan.n_chunks - 1))]
        missed = []
        for key, chunks_done in keys:
            e = self.get(key, peek=peek)
            if e is not None:
                if not peek:
                    self.hits += 1
                    self.saved_tokens += e.tokens
                    for k in missed:
                        self.note_miss(k)
                return e, chunks_done
            missed.append(key)
        if not peek:
            self.misses += 1
            for k in missed:
                self.note_miss(k)
        return None

    # ------------------------------------------- pure-SSM store conveniences

    def maybe_store_boundary(self, prompt_ids, plan, i: int,
                             state: dict, salt: bytes = b"") -> None:
        """Store chunk ``i``'s carry for a PURE-SSM layout (hybrid
        entries need page pinning — the engine builds those itself).
        ``state`` must be safe to retain: nothing writes it in place."""
        key = boundary_key(prompt_ids, plan, i, salt)
        if not self.wants(key):
            return
        self.put(key, PrefixEntry(
            state=state, tokens=(i + 1) * plan.chunk - plan.pad,
            chunks=i + 1, nbytes=state_nbytes(state),
        ))

    def maybe_store_full(self, prompt_ids, state: dict, logits, *,
                         chunk: int = 0, chunks: int = 0,
                         salt: bytes = b"") -> None:
        """Store a full (state, logits) snapshot for a pure-SSM prompt
        — ``chunk > 0`` keys the chunked layout, 0 the one-shot pow2
        bucket."""
        key = (full_key(prompt_ids, chunk, salt) if chunk
               else oneshot_key(prompt_ids, salt))
        if not self.wants(key):
            return
        self.put(key, PrefixEntry(
            state=state, tokens=len(prompt_ids), chunks=chunks,
            logits=logits,
            nbytes=state_nbytes(state) + tensor_nbytes(logits),
        ))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def tensor_nbytes(t) -> int:
    """Bytes of one tensor."""
    return t.numel() * t.element_size()


def state_nbytes(state) -> int:
    """Bytes of every tensor in a (nested dict/tuple) state."""
    return sum(tensor_nbytes(x) for x in _leaves(state))
