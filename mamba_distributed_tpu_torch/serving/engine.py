"""Continuous-batching serving engine over the pooled recurrent-state cache
(counterpart of the core of ``mamba_distributed_tpu/serving/engine.py``).

Each ``step()`` first admits queued requests into free slots (highest
priority first, FCFS within a class): prompts up to
``cfg.effective_prefill_chunk_tokens`` prefill one-shot over their pow2
bucket right there; longer ones park a zero carry in their slot and
prefill chunk by chunk, at most ``prefill_tokens_per_tick`` chunk tokens
per step (at least one chunk), round-robin (or SRPT) across concurrent
long prompts.

Hybrid stacks (attention layers over a paged KV cache) prefill EVERY
prompt chunk by chunk, straight into the shared page pool.  Admission
reserves the pages of the whole request (prompt + ``max_new_tokens``)
up front; while the pool is short the request waits at the head of the
queue, so nothing runs out of pages mid-flight.  The engine keeps each
slot's page-table row and KV length on the host; eviction frees the
slot's pages and points its row at the trash page.  Then one tick advances
every decodable slot by ``tokens_per_tick`` tokens: a loop of sub-steps
at the fixed slot count S (sample, then ``lm_step`` over all S rows).
Slots mid-prefill are held out of the tick: they sample nothing and
their rows are restored after it.  The slot count and every tensor shape
of the tick stay fixed, so a later change can capture it in a CUDA
graph.

Parity contract: a request's token stream is bit-identical to
``generate(params, cfg, prompt[None], seed=request.seed,
decode_rows=capacity, ...)`` when ``request.top_k == max_top_k``,
whatever else shares the batch.  Both sides prefill the same layout
with the same decode-cast params and the same kernels; the step-i draw
depends on (seed, i) alone (inference/generate.step_uniform); and the
decode step runs at the same row count S on both sides, where each
row's arithmetic is independent of the other rows' values.

Int8 serving (``cfg.serving_weight_dtype`` and ``cfg.kv_page_dtype``
"int8") runs through the same loop: the shared decode cast quantizes the
weights, the pool's pages are int8 with their scales, and the chunk step
and the tick write both in place.

Telemetry (as the JAX engine wires it): ``metrics`` (a
``utils/metrics.ServingMetrics``; with a ``jsonl_path`` it writes one
``serving_tick`` record a tick and one ``request`` record a finished
request, with goodput, ``serving_mfu`` against the card's peak, the
hybrid page gauges and the int8 stamp), ``tracer`` (spans
``serving_admit``, ``serving_prefill``, ``serving_prefill_chunk``,
``serving_tick``, stamped with the request's trace id), ``slo`` (an
``obs/slo.SLOMonitor`` fed each request record) and ``tick_regression``
(an ``obs/slo.TickRegressionDetector`` fed each tick's ms).  All of it
reads host clocks and host arrays the loop already has: the
``serving_tick`` span encloses the tick's one host fetch, so it covers
the device work, and no telemetry adds a launch or a sync.

Admission and occupancy (the JAX engine's layer of the same name):

* **Prefix-state cache** (``prefix_cache=`` or ``cfg.prefix_cache_
  entries > 0``; serving/prefix_cache.py).  Admission peeks the longest
  cached chunk-aligned prefix of the prompt and commits the lookup only
  once a slot is secured.  A full hit inserts the cached state and
  logits (no prefill); a partial hit seeds the carry and chunking
  resumes at the first uncached chunk.  Hybrid hits share the prefix's
  whole KV pages read-only (refcounted) and copy the partial boundary
  page into a page of their own (copy-on-write).  When the cache stores
  a boundary that ends mid-page, it pins a frozen copy of that page, not
  the owner's live one: the owner goes on appending to its page, and an
  int8 append requantizes the page's earlier rows, which would change
  what a sharer reads.  So no slot ever writes a page another holder
  has.  Admission short of pages evicts page-pinning entries first.
* **Priorities and preemption** (``GenerationRequest.priority``,
  ``cfg.serving_default_priority``).  The queue pops the highest
  priority first; when its best request outranks a decoding slot and no
  slot is free, the lowest-priority victim swaps its carry and last
  logits to host memory, keeps its page refs and requeues; its resume
  (``state_cache.restore``) continues the stream bit for bit.
* **SRPT prefill grants** (``cfg.prefill_schedule="srpt"``): the chunk
  budget goes to the prefill with the fewest chunks left, except that a
  slot passed over ``SRPT_STARVATION_GRANTS`` times in a row goes first.
* **Compacted ticks** (``cfg.tick_compaction``): the tick gathers the
  decodable slots into a pow2 lane bucket (grown at once, shrunk after
  ``cfg.compaction_hysteresis_ticks``), runs the same sub-step loop at
  that width and scatters the rows back (``_compact_tick``).

Speculative decoding (``cfg.spec_tokens = K > 0``; serving/
spec_decode.py) swaps the tick for a draft-verify tick (``_spec_tick``):
per decodable slot a drafter proposes up to K tokens after its pending
committed ones, one ``lm_verify_chunk`` launch of width K+1 over the
slots scores them, and each slot commits its longest correct prefix
plus one token of the model's own.  Greedy only (``submit`` refuses
``top_k != 1``); the streams stay those of the non-speculative engine
up to the chunk-versus-step rounding of near ties.  Compaction runs the
verify at the lane width.  The hybrid page table gains a column that
always names the trash page, where a fully reserved slot's verify
overshoot lands.

Left out of the port for now: adapters, sessions' parking, migration,
meshes and sharded page pools.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.inference.bucketing import next_pow2_bucket, pad_to_bucket
from mamba_distributed_tpu_torch.inference.generate import (
    step_uniform,
    top_k_sample,
    vocab_pad_mask,
)
from mamba_distributed_tpu_torch.models.attention import attention_page_count
from mamba_distributed_tpu_torch.models.lm import (
    init_lm_blocks_state,
    lm_prefill,
    lm_step,
)
from mamba_distributed_tpu_torch.obs import NULL_TRACER, StreamingHistogram
from mamba_distributed_tpu_torch.ops.dispatch import check_kernel_shapes
from mamba_distributed_tpu_torch.ops.quant import param_bytes
from mamba_distributed_tpu_torch.serving import prefix_cache as prefix_cache_mod
from mamba_distributed_tpu_torch.serving import spec_decode, state_cache
from mamba_distributed_tpu_torch.serving.prefix_cache import PrefixCache
from mamba_distributed_tpu_torch.serving.prefill import (
    cast_decode_params,
    chunk_inputs,
    plan_chunks,
    prefill_chunk,
)
from mamba_distributed_tpu_torch.serving.scheduler import (
    FCFSScheduler,
    GenerationRequest,
    GenerationResult,
    RequestStatus,
    TokenEvent,
    _Tracked,
)
from mamba_distributed_tpu_torch.utils.flops import flops_per_token, peak_flops
from mamba_distributed_tpu_torch.utils.metrics import ServingMetrics


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class ServingEngine:
    """Continuous-batching host loop: priority-FCFS admission -> ticks.

    Args:
      params: fp32 master params (``models/lm.init_lm_params`` layout),
        moved to ``device`` and cast once to the decode layout here.
      cfg: a Mamba-2 or hybrid ``ModelConfig``.
      capacity: slot count S, the max concurrent requests.
      max_top_k: top-k width of the sampler; a request's ``top_k`` may
        be anything in [1, max_top_k] (rows mask past their own k).
      tokens_per_tick: decode sub-steps per tick.
      prefill_tokens_per_tick: chunk-prefill tokens spent per step
        (None => ``cfg.prefill_tokens_per_tick``; 0 => unbounded).
      device: where the engine runs; None means "cuda", which raises
        on a host without a card (pass ``device="cpu"`` there).
      metrics: a ``ServingMetrics`` (default: one with no jsonl stream).
      tracer: an ``obs.SpanTracer`` (default ``NULL_TRACER``: off).
      slo: an ``obs.SLOMonitor`` fed every finished request, or None.
      tick_regression: an ``obs.TickRegressionDetector`` fed every
        tick's wall ms, or None.
      prefix_cache: a ``PrefixCache``, or None to build one from
        ``cfg.prefix_cache_entries`` (0, the default, keeps it off).
        Hybrid entries pin pages of this engine's pool; a pure-SSM cache
        may be shared with ``generate(prefix_cache=)`` under the same
        params.
      drafter: a ``serving/spec_decode.Drafter`` for speculative decoding
        (read only when ``cfg.spec_tokens > 0``); None builds the
        config's (``spec_drafter="ngram"``; ``"model"`` needs an instance,
        a ``ModelDrafter``).  The drafter moves the acceptance rate, never
        the tokens.
    """

    # the SRPT starvation guard: grants a prefill may be passed over in a
    # row before it takes the next one
    SRPT_STARVATION_GRANTS = 4
    # the fewest lanes a compacted tick launches: on the CPU a one-row
    # fp32 product takes a matrix-vector path that rounds differently from
    # the multi-row one, so a one-lane launch pads to two
    COMPACT_MIN_LANES = 2

    def __init__(self, params: dict, cfg: ModelConfig, capacity: int = 8,
                 max_top_k: int = 50, tokens_per_tick: int = 8,
                 prefill_tokens_per_tick: int | None = None, device=None,
                 metrics: ServingMetrics | None = None, tracer=NULL_TRACER,
                 slo=None, tick_regression=None,
                 prefix_cache: PrefixCache | None = None,
                 drafter: spec_decode.Drafter | None = None):
        if not 1 <= max_top_k <= cfg.vocab_size_padded:
            raise ValueError(
                f"max_top_k={max_top_k} must be in [1, {cfg.vocab_size_padded}]")
        if tokens_per_tick < 1:
            raise ValueError("tokens_per_tick must be >= 1")
        if prefill_tokens_per_tick is None:
            prefill_tokens_per_tick = cfg.prefill_tokens_per_tick
        if prefill_tokens_per_tick < 0:
            raise ValueError("prefill_tokens_per_tick must be >= 0 (0 => unbounded)")
        if cfg.attn_layer_idx and cfg.effective_prefill_chunk_tokens == 0:
            raise ValueError(
                "hybrid serving needs chunked prefill: the engine admits every "
                "hybrid prompt through the chunk step, the one prefill that "
                "writes into the shared page pool; set prefill_chunk_tokens > 0"
            )
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda":
            check_kernel_shapes(cfg)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ServingEngine runs on the card by default and this host has "
                "none; pass device='cpu' to serve with the plain versions"
            )
        self.cfg = cfg
        self.device = device
        self.capacity = capacity
        self.max_top_k = max_top_k
        self.tokens_per_tick = tokens_per_tick
        self.prefill_tokens_per_tick = prefill_tokens_per_tick
        self._params = cast_decode_params(_to_device(params, device), cfg)
        self.pool = state_cache.init_pool(cfg, capacity, device)
        self.metrics = metrics or ServingMetrics(capacity)
        # speculative decoding: K = cfg.spec_tokens > 0 runs one verify
        # launch of width K+1 a step instead of the sub-step loop; K = 0
        # keeps no spec state and stamps nothing on the records
        self.spec = cfg.spec_tokens > 0
        if self.spec:
            self.spec_width = cfg.spec_tokens + 1
            self.drafter = drafter if drafter is not None else spec_decode.make_drafter(cfg)
            self._spec_drafted = 0  # per-window gauges -> serving_tick
            self._spec_accepted = 0
            self._spec_streams = 0  # live slot-launches in the window
            # verify lanes the last tick computed, debited from the next
            # step's chunk-prefill budget
            self._spec_budget_debt = 0
            self.metrics.configure_speculation(cfg.spec_tokens, cfg.spec_drafter)
        else:
            self.drafter = None
        self.hybrid = bool(cfg.attn_layer_idx)
        if self.hybrid:
            self.page_pool = state_cache.PagePool(
                state_cache.hybrid_pool_pages(cfg, capacity))
            # host-owned paged-KV metadata: each slot's page-table row
            # (unreserved entries name the trash page 0) and KV length.
            # Spec mode adds a column that always names the trash page:
            # the verify may write up to K+1 tokens past a slot's
            # reservation, and those writes must land there, never clamp
            # onto the slot's own last live page
            self._page_tbl = np.zeros(
                (capacity, cfg.kv_pages_per_slot + (1 if self.spec else 0)), np.int32)
            self._kv_len = np.zeros((capacity,), np.int32)
            self._page_allocs = 0  # per-window gauges -> serving_tick
            self._page_frees = 0
        self._pad_mask = vocab_pad_mask(cfg, device)
        self.scheduler = FCFSScheduler(default_priority=cfg.serving_default_priority)
        self._free: list[int] = list(range(capacity))
        self._slots: dict[int, _Tracked] = {}
        # slots holding a partial chunked prefill, in grant rotation order
        self._prefill_queue: list[int] = []
        self.results: dict[int, GenerationResult] = {}

        self.tracer = tracer
        self.slo = slo
        self.tick_regression = tick_regression
        # goodput: analytic FLOPs rates ("model" convention) against the
        # card's dense bf16 peak, so each tick record carries a
        # host-computed serving_mfu (None on the CPU).  Decode is priced
        # per sampled token, prefill per real prompt token at the chunk's
        # length (the default 256 when chunking is off)
        prefill_seq = cfg.effective_prefill_chunk_tokens or 256
        self.metrics.configure_goodput(
            flops_per_decode_token=flops_per_token(cfg, 1, training=False,
                                                   convention="model"),
            flops_per_prefill_token=flops_per_token(cfg, prefill_seq, training=False,
                                                    convention="model"),
            peak_flops=peak_flops(device) if device.type == "cuda" else None)
        # int8 serving: the resident-bytes gauges and the dtype stamp, only
        # when weights or KV pages are int8 (other records carry neither)
        self.quantized_weights = cfg.serving_weight_dtype == "int8"
        self.quantized_kv = self.hybrid and cfg.kv_quantized
        if self.quantized_weights or self.quantized_kv:
            self._weight_bytes = param_bytes(self._params)
            self._pool_bytes = (
                sum(t.numel() * t.element_size() for t in self.pool["state"]["attn_blocks"])
                if self.hybrid else None)
            self._quant_stamp = {"weights": cfg.serving_weight_dtype,
                                 "kv": cfg.kv_page_dtype}
            self.metrics.configure_memory(
                weight_bytes=self._weight_bytes, page_pool_bytes=self._pool_bytes or 0,
                weight_dtype=cfg.serving_weight_dtype, kv_dtype=cfg.kv_page_dtype)
        # the prefix-state cache (off unless configured): hybrid entries
        # pin pages of this pool, which the LRU's evict hook releases
        if prefix_cache is None and cfg.prefix_cache_entries > 0:
            prefix_cache = PrefixCache(max_entries=cfg.prefix_cache_entries,
                                       max_bytes=cfg.prefix_cache_bytes,
                                       min_hits=cfg.prefix_min_chunk_hits)
        self.prefix_cache = prefix_cache
        self.cow_copies = 0  # boundary pages copied on write, lifetime
        if prefix_cache is not None:
            if self.hybrid:
                prefix_cache.evict_hook = self._drop_entry_pages
                # bytes one physical page holds across every layer's K and V
                # (and int8 scales): the KV share of an entry's bytes
                self._page_nbytes = sum(t.numel() * t.element_size() // t.shape[1]
                                        for t in self.pool["state"]["attn_blocks"])
            self.metrics.configure_prefix_cache()
        # compacted ticks: the current pow2 lane bucket and the run of
        # ticks that would have fit a smaller one
        self.compaction = cfg.tick_compaction
        if self.compaction:
            self._compact_bucket = 1
            self._shrink_streak = 0
            self.metrics.configure_compaction()
        # per-window gauges -> serving_tick records
        self._pc_hits = 0
        self._pc_misses = 0
        self._pc_saved_tokens = 0
        self._preemptions = 0
        # prefill accounting awaiting a tick record: steps that run no
        # tick (every resident slot still mid-prefill) roll their stall
        # and chunk counters into the next tick's record
        self._pending_stall_ms = 0.0
        self._pending_chunk_tokens = 0
        self._pending_chunk_real_tokens = 0  # non-pad (goodput useful)
        self._pending_chunk_ms = 0.0
        # one-shot admissions in the window: real prompt tokens vs the
        # padded bucket lanes they computed
        self._pending_oneshot_real_tokens = 0
        self._pending_oneshot_lanes = 0

    # ------------------------------------------------------------ admission

    def submit(self, request: GenerationRequest) -> int:
        """Queue a request; returns its request_id."""
        if not 1 <= request.top_k <= self.max_top_k:
            raise ValueError(
                f"request top_k={request.top_k} must be in "
                f"[1, max_top_k={self.max_top_k}]")
        if self.spec and request.top_k != 1:
            raise ValueError(
                f"speculative decoding (cfg.spec_tokens="
                f"{self.cfg.spec_tokens}) is greedy-only: request "
                f"top_k={request.top_k} must be 1 (argmax).  Sampling-"
                f"mode rejection sampling is a ROADMAP residual; serve "
                f"sampled requests on a spec_tokens=0 engine")
        if self.hybrid:
            need = np.asarray(request.prompt_ids).size + request.max_new_tokens
            if need > self.cfg.kv_slot_tokens:
                raise ValueError(
                    f"hybrid request needs {need} KV tokens (prompt + "
                    f"max_new_tokens) > cfg.kv_slot_tokens="
                    f"{self.cfg.kv_slot_tokens}")
            need_pages = attention_page_count(self.cfg, need)
            if need_pages > self.page_pool.num_pages:
                raise ValueError(
                    f"hybrid request needs {need_pages} KV pages but the page "
                    f"pool holds {self.page_pool.num_pages} (cfg.kv_pool_pages): "
                    f"it could never be admitted")
        return self.scheduler.submit(request).request_id

    def _slot_meta(self, r: GenerationRequest) -> dict:
        return dict(max_new=r.max_new_tokens, top_k=r.top_k,
                    temperature=r.temperature,
                    eos_id=-1 if r.eos_id is None else r.eos_id)

    def _release_pages(self, slot: int, tracked: _Tracked) -> None:
        """Return a slot's KV pages to the pool and point its table row at
        the trash page, so nothing it computes can touch a recycled page."""
        if not (self.hybrid and tracked.pages):
            return
        self.page_pool.free(tracked.pages)
        self._page_frees += len(tracked.pages)
        tracked.pages = None
        self._page_tbl[slot] = 0
        self._kv_len[slot] = 0

    def _admit(self, tracked: _Tracked) -> bool:
        """Grant the next queued request a slot: a short pure-SSM prompt
        prefills one-shot here; a long one (and every hybrid one) parks a
        zero carry and prefills in the chunk budget
        (``_advance_prefill``).  With the prefix cache on, a full hit
        inserts the cached state and logits, and a partial hit seeds the
        carry at the deepest cached boundary; hybrid hits share the
        prefix's whole pages and copy its partial boundary page.  A
        preempted request resumes through ``_resume``.  Returns False,
        with the request back at the head of the queue, when a hybrid
        request's pages do not fit the free pool yet (after evicting the
        cache's page pins)."""
        if tracked.snapshot is not None:
            return self._resume(tracked)
        r = tracked.request
        plan = plan_chunks(len(r.prompt_ids), self.cfg.effective_prefill_chunk_tokens,
                           force=self.hybrid)
        # peek: the lookup commits only once a slot is secured, so a
        # request that waits for pages does not count a lookup a step
        hit = (None if self.prefix_cache is None
               else self.prefix_cache.lookup(r.prompt_ids, plan, peek=True))
        n_pages = shared_n = fresh_n = 0
        cow = False
        if self.hybrid:
            n_pages = attention_page_count(self.cfg, len(r.prompt_ids) + r.max_new_tokens)
            if hit is not None:
                # whole shared pages stay read-only; a prefix ending
                # mid-page costs one more fresh page, its copy
                page = self.cfg.kv_page_tokens
                shared_n = hit[0].kv_len // page
                cow = bool(hit[0].kv_len % page)
                fresh_n = n_pages - shared_n
                if fresh_n > self.page_pool.free_pages:
                    hit = None  # served cold (and committed as a miss)
            if hit is None and n_pages > self.page_pool.free_pages \
                    and not self._reclaim_cache_pages(n_pages):
                self.scheduler.requeue(tracked)
                return False
        slot = self._free.pop(0)
        tracked.status = RequestStatus.PREFILL
        entry = hit[0] if hit is not None else None
        full_hit = entry is not None and entry.full
        t0 = time.perf_counter()
        try:
            if self.hybrid and entry is not None:
                fresh = self.page_pool.alloc(fresh_n)
                shared = list(entry.kv_pages[:shared_n])
                self.page_pool.incref(shared)
                # the gauges count page refs taken and dropped, so allocs
                # still equal frees on a cache-sharing engine
                self._page_allocs += fresh_n + len(shared)
                tracked.pages = shared + fresh
                if cow:
                    # the slot's first write lands at kv_len, inside the
                    # prefix's last (partial) page: it appends into a copy
                    state_cache.copy_page(self.pool["state"]["attn_blocks"],
                                          entry.kv_pages[shared_n], fresh[0])
                    self.cow_copies += 1
                self._page_tbl[slot] = 0
                self._page_tbl[slot, :n_pages] = tracked.pages
                self._kv_len[slot] = entry.kv_len
            if full_hit:
                # the snapshot is the prefill's output: insert and decode
                with self.tracer.span("serving_prefill", slot=slot, request=tracked.request_id,
                                      trace=tracked.trace_id, cache="full"):
                    state_cache.insert(self.pool, slot, {"blocks": entry.state["blocks"]},
                                       entry.logits, **self._slot_meta(r))
                    self._seed_spec(tracked, entry.logits)
            elif entry is not None:
                # partial hit: the remaining chunks run the computation a
                # cold admission would, so the stream is the cold one
                tracked.plan = plan
                tracked.chunks_done = hit[1]
                tracked.prefill_dt = 0.0
                tracked.prefill_seeded_tokens = entry.tokens
                state_cache.stash_prefill(self.pool, slot, {"blocks": entry.state["blocks"]},
                                          **self._slot_meta(r))
            elif plan is None:
                # one span per one-shot prefill, trace-stamped, so even a
                # short prompt's journey has an anchor in the stream
                with self.tracer.span("serving_prefill", slot=slot,
                                      request=tracked.request_id, trace=tracked.trace_id):
                    prompt = torch.as_tensor(r.prompt_ids, dtype=torch.int64,
                                             device=self.device)[None]
                    ids, mask = pad_to_bucket(prompt, next_pow2_bucket(prompt.shape[1]))
                    logits, state = lm_prefill(self._params, self.cfg, ids,
                                               token_mask=mask)
                    state_cache.insert(self.pool, slot, state, logits,
                                       **self._slot_meta(r))
                    self._seed_spec(tracked, logits)
                    if self.prefix_cache is not None:
                        # insert copied the state into the pool, so the
                        # prefill's own tensors can be kept
                        self.prefix_cache.maybe_store_full(r.prompt_ids, state, logits)
            else:
                tracked.plan = plan
                tracked.chunks_done = 0
                tracked.prefill_dt = 0.0
                if self.hybrid:
                    tracked.pages = self.page_pool.alloc(n_pages)
                    self._page_allocs += n_pages
                    self._page_tbl[slot] = 0
                    self._page_tbl[slot, :n_pages] = tracked.pages
                    self._kv_len[slot] = 0
                state_cache.stash_prefill(
                    self.pool, slot,
                    {"blocks": init_lm_blocks_state(self.cfg, 1, self.device)},
                    **self._slot_meta(r))
        except Exception:
            # a failed prefill leaks neither the slot nor its pages, and
            # does not drop the request
            self._release_pages(slot, tracked)
            self._free.insert(0, slot)
            self.scheduler.requeue(tracked)
            raise
        if self.prefix_cache is not None:
            # the admission went through: commit the lookup (the cache's
            # stats, recency and promotion counters) and the window gauges
            self.prefix_cache.commit_lookup(r.prompt_ids, plan, hit)
            kind = None if entry is None else ("full" if full_hit else "partial")
            tracked.cache_hit = kind
            if kind is None:
                self._pc_misses += 1
            else:
                self._pc_hits += 1
                self._pc_saved_tokens += entry.tokens
            self.metrics.record_prefix_lookup(kind, 0 if entry is None else entry.tokens)
        # dt is host dispatch time (the next tick's fetch absorbs the
        # device work)
        t_admit = time.perf_counter()
        if plan is None and entry is None:
            self.metrics.record_prefill(len(r.prompt_ids), t_admit - t0)
            # goodput: the one-shot prefill's real tokens vs the padded
            # bucket lanes it computed, in the next tick's window (a full
            # hit computed no lanes: its win is prefix_saved_tokens)
            self._pending_oneshot_real_tokens += len(r.prompt_ids)
            self._pending_oneshot_lanes += next_pow2_bucket(len(r.prompt_ids))
        tracked.t_admit = t_admit
        tracked.itl_hist = StreamingHistogram()
        self.metrics.record_queue_wait(t_admit - tracked.t_submit)
        tracked.slot = slot
        self._slots[slot] = tracked
        if full_hit or plan is None:
            tracked.status = RequestStatus.DECODE
        else:
            self._prefill_queue.append(slot)
        return True

    def _seed_spec(self, tracked: _Tracked, logits) -> None:
        """Seed a newly decodable slot's pending tokens with the greedy
        argmax of its prefill logits: the token the first non-speculative
        tick would emit, and the drafter's anchor.  Its fetch is the one
        host sync speculation adds per request.  Nothing when speculation
        is off."""
        if not self.spec:
            return
        tracked.spec_pending = [spec_decode.greedy_token(logits, self.cfg.vocab_size)]
        tracked.spec_pending_emitted = 0

    def _advance_prefill(self, slot: int, budget_left: float) -> float:
        """Run ONE chunk of ``slot``'s prefill; returns the budget left."""
        tracked = self._slots[slot]
        plan, r = tracked.plan, tracked.request
        try:
            state = state_cache.read_state(self.pool, slot)
            if self.hybrid:
                # the chunk step writes this slot's pages of the shared
                # pool in place, through its table row and length
                state["attn_blocks"] = self.pool["state"]["attn_blocks"]
                state["attn_meta"] = (
                    torch.tensor(self._page_tbl[slot:slot + 1], device=self.device),
                    torch.tensor(self._kv_len[slot:slot + 1], device=self.device))
            i = tracked.chunks_done
            ids, mask = chunk_inputs(r.prompt_ids, plan, i, device=self.device)
            t0 = time.perf_counter()
            with self.tracer.span("serving_prefill_chunk", slot=slot, chunk=i,
                                  of=plan.n_chunks, trace=tracked.trace_id):
                logits, state = prefill_chunk(self._params, ids, mask, state, self.cfg)
            dt = time.perf_counter() - t0  # host dispatch time
            if self.hybrid:
                # the left pad of chunk 0 is never written
                self._kv_len[slot] += plan.real_tokens(i)
            tracked.chunks_done += 1
            tracked.prefill_dt += dt
            self.metrics.record_prefill_chunk(plan.chunk, dt)
            # goodput: the real (non-pad) chunk tokens are the useful
            # share of this window's prefill lanes
            self._pending_chunk_real_tokens += plan.real_tokens(i)
            self._prefill_queue.remove(slot)
            # the prefix cache keeps this boundary's carry (the chunk
            # step's output, which nothing writes in place: the pool
            # takes a copy); the last boundary too, which seeds longer
            # prompts with the same left pad
            state = {"blocks": state["blocks"]}
            self._store_prefix(r.prompt_ids, plan, i, state, slot)
            if tracked.chunks_done == plan.n_chunks:
                # ...and the full-prompt entry, which an exact repeat
                # takes without a prefill
                self._store_prefix(r.prompt_ids, plan, i, state, slot, logits=logits)
                state_cache.finish_prefill(self.pool, slot, state, logits)
                self._seed_spec(tracked, logits)
                tracked.status = RequestStatus.DECODE
                # only the computed tokens: a partial hit's seeded ones
                # are prefix_saved_tokens
                self.metrics.record_prefill(plan.prompt_len - tracked.prefill_seeded_tokens,
                                            tracked.prefill_dt)
            else:
                state_cache.stash_prefill(self.pool, slot, state, **self._slot_meta(r))
                # rotate to the back: the next grant goes to the others first
                self._prefill_queue.append(slot)
        except Exception:
            state_cache.evict(self.pool, slot)
            self._release_pages(slot, tracked)
            if slot in self._prefill_queue:
                self._prefill_queue.remove(slot)
            del self._slots[slot]
            self._free.insert(0, slot)
            self._free.sort()
            self.scheduler.requeue(tracked)
            raise
        return budget_left - plan.chunk

    # ------------------------------------------------- prefix-state cache

    def _drop_entry_pages(self, entry) -> None:
        """The cache's evict hook: release an entry's page refs (a page
        frees only when no slot still shares it)."""
        if entry.kv_pages:
            self.page_pool.free(list(entry.kv_pages))
            self._page_frees += len(entry.kv_pages)

    def _store_prefix(self, prompt_ids, plan, i: int, state: dict, slot: int,
                      logits=None) -> None:
        """Snapshot chunk ``i``'s carry into the prefix cache (with
        ``logits``: the full-prompt entry).  A hybrid entry holds refs on
        the whole pages of the prefix and a frozen copy of its partial
        last page, if any (the slot goes on writing its own; see the
        module docstring); with no free page for that copy the entry is
        not stored."""
        pc = self.prefix_cache
        if pc is None:
            return
        if logits is not None:
            key = prefix_cache_mod.full_key(prompt_ids, plan.chunk)
            tokens = plan.prompt_len
        else:
            key = prefix_cache_mod.boundary_key(prompt_ids, plan, i)
            tokens = (i + 1) * plan.chunk - plan.pad
        if not pc.wants(key):
            return
        kv_pages, kv_len, page_bytes = None, 0, 0
        if self.hybrid:
            kv_len = tokens
            whole, tail = divmod(kv_len, self.cfg.kv_page_tokens)
            pages = self._slots[slot].pages
            if tail and not self.page_pool.free_pages:
                return
            self.page_pool.incref(pages[:whole])
            kv_pages = list(pages[:whole])
            if tail:
                (frozen,) = self.page_pool.alloc(1)
                state_cache.copy_page(self.pool["state"]["attn_blocks"], pages[whole], frozen)
                kv_pages.append(frozen)
            kv_pages = tuple(kv_pages)
            # refs taken (balanced by the evict hook's frees in the gauges)
            self._page_allocs += len(kv_pages)
            page_bytes = len(kv_pages) * self._page_nbytes
        nbytes = (prefix_cache_mod.state_nbytes(state) + page_bytes
                  + (prefix_cache_mod.tensor_nbytes(logits) if logits is not None else 0))
        pc.put(key, prefix_cache_mod.PrefixEntry(
            state=state, tokens=tokens, chunks=i + 1, nbytes=nbytes, logits=logits,
            kv_pages=kv_pages, kv_len=kv_len))

    def _reclaim_cache_pages(self, n_pages: int) -> bool:
        """Admission's pressure valve: evict page-pinning cache entries,
        least recently used first, until ``n_pages`` are free (cache refs
        would otherwise never release while admission waits on them).
        Returns True when the reservation fits now."""
        pc = self.prefix_cache
        if pc is None or not self._free:
            return False
        while n_pages > self.page_pool.free_pages:
            if not pc.evict_one_pinned():
                return False
        return True

    def prefix_hit_fraction(self, prompt_ids) -> float:
        """Fraction of ``prompt_ids`` whose prefill the cache could skip
        now (0.0 with the cache off): a probe that counts nothing and
        touches no recency."""
        pc = self.prefix_cache
        if pc is None or len(prompt_ids) == 0:
            return 0.0
        plan = plan_chunks(len(prompt_ids), self.cfg.effective_prefill_chunk_tokens,
                           force=self.hybrid)
        hit = pc.lookup(np.asarray(prompt_ids, np.int64), plan, peek=True)
        return 0.0 if hit is None else min(1.0, hit[0].tokens / len(prompt_ids))

    # ------------------------------------------------ priority preemption

    def _victim_slot_admits(self, head: _Tracked) -> bool:
        """Would a freed slot let ``head`` admit?  Preemption frees a slot,
        never pages (the victim keeps its refs), so a hybrid head that
        waits for pages is not helped; a preempted head needs no pages."""
        if not self.hybrid or head.snapshot is not None:
            return True
        r = head.request
        return (attention_page_count(self.cfg, len(r.prompt_ids) + r.max_new_tokens)
                <= self.page_pool.free_pages)

    def _pick_victim(self) -> _Tracked | None:
        """The decoding request to preempt for the queue's best one: the
        lowest priority strictly below it, then the fewest generated
        tokens, then the newest.  None when nothing is outranked (with
        uniform priorities preemption never happens) or a freed slot
        would not admit the head."""
        head = self.scheduler.peek()
        if head is None or not self._victim_slot_admits(head):
            return None
        victims = [t for t in self._slots.values()
                   if t.status is RequestStatus.DECODE and t.priority < head.priority]
        if not victims:
            return None
        return min(victims, key=lambda t: (t.priority, len(t.new_tokens), -t.request_id))

    def _preempt(self, tracked: _Tracked) -> None:
        """Swap a decoding slot out to host memory: copy its carry and last
        logits off the card (a synchronizing copy: the swap-out is a move
        to the host), keep its page refs on the tracker, free the slot and
        requeue it.  ``_resume`` restores it with the token count, so the
        stream goes on as if never interrupted."""
        slot = tracked.slot
        with self.tracer.span("serving_preempt", slot=slot, request=tracked.request_id,
                              trace=tracked.trace_id):
            # copies even when the pool lies on the host (.cpu() would alias)
            snap = {
                "blocks": tuple(t[:, slot:slot + 1].to("cpu", copy=True)
                                for t in self.pool["state"]["blocks"]),
                "logits": self.pool["logits"][slot:slot + 1].to("cpu", copy=True),
                "step": len(tracked.new_tokens),
            }
            if self.hybrid:
                snap["kv_len"] = int(self._kv_len[slot])
                self._page_tbl[slot] = 0
                self._kv_len[slot] = 0
            tracked.snapshot = snap
            tracked.preempted += 1
            self._preemptions += 1
            self.metrics.record_preemption()
            state_cache.evict(self.pool, slot)
            del self._slots[slot]
            self._free.append(slot)
            self._free.sort()
            self.scheduler.requeue(tracked)

    def _resume(self, tracked: _Tracked) -> bool:
        """Re-admit a preempted request from its host snapshot into the
        first free slot, its token count restored (its page refs rode on
        the tracker).  Returns False, requeued, when no slot is free."""
        if not self._free:
            self.scheduler.requeue(tracked)
            return False
        snap, r = tracked.snapshot, tracked.request
        slot = self._free.pop(0)
        try:
            with self.tracer.span("serving_resume", slot=slot, request=tracked.request_id,
                                  trace=tracked.trace_id):
                state_cache.restore(
                    self.pool, slot,
                    {"blocks": tuple(t.to(self.device) for t in snap["blocks"])},
                    snap["logits"].to(self.device), snap["step"], **self._slot_meta(r))
                if self.hybrid:
                    self._page_tbl[slot] = 0
                    self._page_tbl[slot, :len(tracked.pages)] = tracked.pages
                    self._kv_len[slot] = snap["kv_len"]
        except Exception:
            # the snapshot survives the requeue: a retry restores it
            self._free.insert(0, slot)
            self._free.sort()
            self.scheduler.requeue(tracked)
            raise
        if self.spec and not tracked.spec_pending:
            # a snapshot without pending tokens: derive the first from its
            # logits (a preempted request keeps its own pending)
            self._seed_spec(tracked, snap["logits"])
        tracked.snapshot = None
        tracked.slot = slot
        tracked.status = RequestStatus.DECODE
        self._slots[slot] = tracked
        return True

    def _resume_parked(self) -> None:
        """Resume queued preempted requests into free slots while the
        queue's best request waits for pages: a swap-in needs no pages,
        and finishing is how a preempted request releases the pages the
        head waits for (without this the two would wait on each other)."""
        while self._free:
            parked = self.scheduler.pop_preempted()
            if parked is None or not self._admit(parked):
                return

    # ------------------------------------------------------ prefill phase

    def _pick_prefill_slot(self) -> int:
        """Which partial prefill takes the next chunk grant.  "rr": the
        rotation head (``_advance_prefill`` moves a still-partial slot to
        the back).  "srpt": the slot with the fewest chunks left, unless
        one was passed over ``SRPT_STARVATION_GRANTS`` times in a row;
        ties go to the rotation order."""
        queue = self._prefill_queue
        if self.cfg.prefill_schedule != "srpt" or len(queue) == 1:
            self._slots[queue[0]].prefill_skipped = 0
            return queue[0]
        starved = [s for s in queue
                   if self._slots[s].prefill_skipped >= self.SRPT_STARVATION_GRANTS]
        pick = starved[0] if starved else min(
            queue, key=lambda s: self._slots[s].plan.n_chunks - self._slots[s].chunks_done)
        for s in queue:
            if s != pick:
                self._slots[s].prefill_skipped += 1
        self._slots[pick].prefill_skipped = 0
        return pick

    def _prefill_phase(self) -> tuple[float, int]:
        """Admissions, then the chunk budget, one grant at a time
        (``_pick_prefill_slot``).  When the queue's best request outranks
        a decoding slot and no slot is free, the victim is preempted so
        the request admits this step.  Returns the host seconds spent
        (the tick's ``prefill_stall``) and the chunk tokens run."""
        next_victim = (self._pick_victim()
                       if self.scheduler.depth and not self._free else None)
        if not ((self._free and self.scheduler.depth) or self._prefill_queue
                or next_victim is not None):
            return 0.0, 0
        t0 = time.perf_counter()
        chunk_tokens0 = self.metrics.prefill_chunk_tokens
        chunk_s0 = self.metrics.prefill_chunk_time_s
        if self.scheduler.depth and (self._free or next_victim is not None):
            with self.tracer.span("serving_admit", queued=self.scheduler.depth):
                while self.scheduler.depth:
                    if not self._free:
                        victim = next_victim or self._pick_victim()
                        next_victim = None
                        if victim is None:
                            break
                        self._preempt(victim)
                    if not self._admit(self.scheduler.pop()):
                        # the head waits for pages: preempted requests
                        # behind it resume (they need none)
                        self._resume_parked()
                        break
        budget = self.prefill_tokens_per_tick
        left = float("inf") if budget == 0 else float(budget)
        if self.spec and budget:
            # the last verify tick's lanes count against this step's chunk
            # budget, so speculation does not raise the per-step work the
            # knob bounds; one chunk still runs whatever the debit
            left = max(0.0, left - self._spec_budget_debt)
            self._spec_budget_debt = 0
        chunks_run = 0
        while self._prefill_queue and (left > 0 or chunks_run == 0):
            left = self._advance_prefill(self._pick_prefill_slot(), left)
            chunks_run += 1
        self._pending_chunk_ms += (self.metrics.prefill_chunk_time_s - chunk_s0) * 1000
        return (time.perf_counter() - t0,
                self.metrics.prefill_chunk_tokens - chunk_tokens0)

    # ------------------------------------------------------------- decoding

    @property
    def pending(self) -> int:
        """Requests not yet finished (queued + in flight)."""
        return self.scheduler.depth + len(self._slots)

    def _sub_steps(self, state: dict, logits, meta: dict, u, attn_meta=None,
                   split_rows: int | None = None):
        """The tick's ``tokens_per_tick`` sub-steps over one set of rows
        (the pool's, or a compacted tick's lanes): sample, then
        ``lm_step``, which writes ``state`` in place.  Returns the last
        logits, the rows' step and done counters and the per-sub-step
        tokens, live flags and done flags."""
        has_eos = meta["eos_id"] >= 0
        step, done = meta["step"], meta["done"]
        toks, emitted, dones = [], [], []
        for j in range(self.tokens_per_tick):
            live = meta["active"] & ~done & ~meta["prefilling"]
            tok = top_k_sample(logits + self._pad_mask, u[j], self.max_top_k,
                               meta["temperature"], meta["top_k"])
            tok = torch.where(done & has_eos, meta["eos_id"], tok)
            if self.hybrid:
                # rows that are not live (empty, done, prefilling, pad
                # lanes) write the trash page only and keep their length
                logits, stepped = lm_step(self._params, self.cfg,
                                          {**state, "attn_meta": attn_meta}, tok,
                                          write_mask=live, split_rows=split_rows)
                attn_meta = stepped["attn_meta"]
            else:
                logits, _ = lm_step(self._params, self.cfg, state, tok)
            step = step + live
            done = done | (live & ((has_eos & (tok == meta["eos_id"]))
                                   | (step >= meta["max_new"])))
            toks.append(tok)
            emitted.append(live)
            dones.append(done)
        return logits, step, done, toks, emitted, dones

    def _uniforms(self, lanes: dict[int, int], width: int) -> torch.Tensor:
        """(steps, width) draws: lane ``lanes[s]`` of decoding slot s
        samples token len(new_tokens) + j of its request at sub-step j."""
        u = np.full((self.tokens_per_tick, width), 0.5, np.float32)
        for s, lane in lanes.items():
            t = self._slots[s]
            n0 = len(t.new_tokens)
            u[:, lane] = [step_uniform(t.request.seed, n0 + j)
                          for j in range(self.tokens_per_tick)]
        return torch.from_numpy(u).to(self.device)

    def _tick(self, live_slots: list[int]):
        """Advance every decodable slot ``tokens_per_tick`` tokens at the
        full slot count.  Returns host arrays (tokens, emitted, done),
        each (steps, S)."""
        dev = self.device
        pool, meta = self.pool, self.pool["meta"]
        u = self._uniforms({s: s for s in live_slots}, self.capacity)
        # lm_step updates the pool's state rows in place; a prefilling
        # slot's rows hold a real carry, so save and restore them
        held = sorted(self._prefill_queue)
        if held:
            idx = torch.tensor(held, device=dev)
            saved = [t.index_select(1, idx) for t in pool["state"]["blocks"]]
        attn_meta = None
        if self.hybrid:
            # the full kv_pages_per_slot width, not a bucket of the live
            # extent: the kernel walks only pages below each row's length,
            # so a wide table costs nothing on the card, and a fixed width
            # keeps the tick's shapes static.  generate() sizes its private
            # table to the same width, so the plain version reduces over
            # the same width on both sides and streams stay bit-identical.
            attn_meta = (torch.tensor(self._page_tbl, device=dev),
                         torch.tensor(self._kv_len, device=dev))
        logits, step, done, toks, emitted, dones = self._sub_steps(
            pool["state"], pool["logits"], meta, u, attn_meta)
        if held:
            for t, v in zip(pool["state"]["blocks"], saved):
                t.index_copy_(1, idx, v)
        pool["logits"] = logits
        meta["step"], meta["done"] = step, done
        # the one host sync of the tick
        tokens, emitted = torch.stack(toks).cpu().numpy(), torch.stack(emitted).cpu().numpy()
        if self.hybrid:
            # mirror the device-side lengths: +1 per live sub-step
            self._kv_len += emitted.sum(axis=0).astype(np.int32)
        return tokens, emitted, torch.stack(dones).cpu().numpy()

    # ----------------------------------------------------- compacted ticks

    def _compaction_width(self, live_slots: list[int]) -> int | None:
        """Lane width of this tick's compacted launch, or None for the
        full-width tick (compaction off, or no narrower than capacity).
        The bucket is the pow2 of the live count, grown at once and
        shrunk only after ``cfg.compaction_hysteresis_ticks`` ticks in a
        row that would have fit the smaller one; the launch takes at
        least ``COMPACT_MIN_LANES`` lanes."""
        if not self.compaction:
            return None
        need = next_pow2_bucket(max(1, len(live_slots)), min_bucket=1)
        b = self._compact_bucket
        if need > b:
            b, self._shrink_streak = need, 0
        elif need < b:
            self._shrink_streak += 1
            if self._shrink_streak >= self.cfg.compaction_hysteresis_ticks:
                b, self._shrink_streak = need, 0
        else:
            self._shrink_streak = 0
        self._compact_bucket = b
        width = max(b, self.COMPACT_MIN_LANES)
        return None if width >= self.capacity else width

    def _gather_lanes(self, live_slots: list[int], width: int):
        """Gather the decodable slots' rows into ``width`` lanes (live
        slots in slot order, pad lanes repeating slot 0 as the JAX engine
        pads).  Returns the lane map {slot: lane}, the scatter maps (inv,
        touched) on the device, the pool's per-slot rows, their gathered
        copies and the lanes' launch state: the gathered carries and, for
        a hybrid, the shared pages and an ``attn_meta`` whose pad lanes
        point at the trash page with length 0."""
        dev = self.device
        lanes = {s: j for j, s in enumerate(sorted(live_slots))}
        idx = np.zeros((width,), np.int64)
        inv = np.zeros((self.capacity,), np.int64)
        touched = np.zeros((self.capacity,), bool)
        for s, j in lanes.items():
            idx[j], inv[s], touched[s] = s, j, True
        rows = {"blocks": self.pool["state"]["blocks"], "logits": self.pool["logits"],
                "meta": self.pool["meta"]}
        lane_rows = state_cache.gather_slots(rows, torch.from_numpy(idx).to(dev))
        state = {"blocks": lane_rows["blocks"]}
        if self.hybrid:
            state["attn_blocks"] = self.pool["state"]["attn_blocks"]
            tbl = self._page_tbl[idx]
            lengths = self._kv_len[idx]
            tbl[len(lanes):] = 0
            lengths[len(lanes):] = 0
            state["attn_meta"] = (torch.from_numpy(tbl).to(dev),
                                  torch.from_numpy(lengths).to(dev))
        return (lanes, torch.from_numpy(inv).to(dev), torch.from_numpy(touched).to(dev),
                rows, lane_rows, state)

    def _compact_tick(self, live_slots: list[int], width: int):
        """One compacted tick: gather the decodable slots' rows into
        ``width`` lanes (live slots in slot order, pad lanes repeating
        slot 0 as the JAX engine pads), run the full tick's sub-steps at
        that width and scatter the live lanes back; mid-prefill rows are
        never gathered, so none needs saving.  Pad lanes' table rows
        point at the trash page with length 0, so their KV writes land
        there.

        The launch is made to compute what the full tick computes for
        each live row: every op of the decode step is per row, the page
        table keeps its full width, the paged decode's split rule is
        pinned to the capacity (``split_rows``), and no launch goes below
        ``COMPACT_MIN_LANES`` rows (a one-row fp32 product takes the
        CPU's matrix-vector path, which rounds differently).  Two
        row-count effects remain.  On the CPU an elementwise kernel
        computes the scalar tail of a small tensor with other rounding
        than its vector body (the softplus of dt, (lanes, heads), at 24
        heads), so a carry can differ in its last bit with its lane; on
        the card a GEMM may pick another kernel at another row count.
        Either moves a carry by an ulp; the CPU tests hold the streams
        equal at their size, and ``chip_smoke.py`` measures the card.
        Returns (tokens, emitted, done) at full width (steps, S)."""
        lanes, inv, touched, rows, lane_rows, state = self._gather_lanes(live_slots, width)
        attn_meta = state.pop("attn_meta", None)
        u = self._uniforms(lanes, width)
        logits, step, done, toks, emitted, dones = self._sub_steps(
            state, lane_rows["logits"], lane_rows["meta"], u, attn_meta,
            split_rows=self.capacity)
        state_cache.scatter_slots(
            rows, {"blocks": state["blocks"], "logits": logits,
                   "meta": {**lane_rows["meta"], "step": step, "done": done}}, inv, touched)
        # the one host sync of the tick
        tokens = torch.stack(toks).cpu().numpy()
        emitted = torch.stack(emitted).cpu().numpy()
        done = torch.stack(dones).cpu().numpy()
        cols = np.fromiter(lanes.keys(), np.int64, len(lanes))
        ls = np.fromiter(lanes.values(), np.int64, len(lanes))
        out = [np.zeros((self.tokens_per_tick, self.capacity), a.dtype)
               for a in (tokens, emitted, done)]
        for full, lane in zip(out, (tokens, emitted, done)):
            full[:, cols] = lane[:, ls]
        if self.hybrid:
            self._kv_len += out[1].sum(axis=0).astype(np.int32)
        return tuple(out)

    # ----------------------------------------------------- speculative tick

    def _spec_feed(self, tracked: _Tracked) -> list[int]:
        """One slot's verify row: bring the drafter up to the stream's
        committed history (prompt + emitted + the unemitted pending; only
        the part it has not seen), then its pending tokens and up to
        W - len(pending) drafts, zero-filled to the width W."""
        W, rid = self.spec_width, tracked.request_id
        if tracked.spec_observed == 0:
            # a fresh (or requeued) stream: drop any stale drafter state
            self.drafter.forget(rid)
        pend = tracked.spec_pending[tracked.spec_pending_emitted:]
        plen = len(tracked.request.prompt_ids)
        total = plen + len(tracked.new_tokens) + len(pend)
        if total > tracked.spec_observed:
            k = tracked.spec_observed - plen
            if k < 0:
                delta = tracked.request.prompt_ids[k:].tolist() + tracked.new_tokens + pend
            elif k <= len(tracked.new_tokens):
                delta = tracked.new_tokens[k:] + pend
            else:
                delta = pend[k - len(tracked.new_tokens):]
            self.drafter.observe(rid, delta)
            tracked.spec_observed = total
        n = W - len(tracked.spec_pending)
        drafts = list(self.drafter.draft(rid, n))[:n] if n > 0 else []
        self._spec_drafted += n
        return spec_decode.build_feed(tracked.spec_pending, drafts, W)

    def _spec_tick(self, live_slots: list[int], width: int | None):
        """One draft-verify tick (serving/spec_decode.py): compose every
        decodable slot's feed (``_spec_feed``), run ONE ``spec_verify``
        over the pool's rows (or, with ``width``, over the compacted
        lanes, scattered back after), fetch the (rows, W) greedy matrix
        (the tick's one host sync) and decide per slot.  A full accept
        commits the launch's carries and final logits (the state moved W
        tokens) and banks the last position's argmax as the next pending;
        a rejection keeps the pre-tick carries (``spec_commit``'s per-row
        select) and banks the accepted prefix and the model's correction.
        Masked rows (empty, mid-prefill, pad lanes) write no KV cell and
        keep their carries.  A hybrid's lengths advance by W on full
        accepts only.  Returns (tokens, emitted, done), each (W+1, S)."""
        W, S, dev = self.spec_width, self.capacity, self.device
        live = {s: self._slots[s] for s in live_slots}
        if width is not None:
            lanes, inv, touched, rows, lane_rows, state = self._gather_lanes(live_slots, width)
        else:
            lanes = {s: s for s in live}
            rows = lane_rows = {"blocks": self.pool["state"]["blocks"],
                                "logits": self.pool["logits"], "meta": self.pool["meta"]}
            state = {"blocks": rows["blocks"]}
            if self.hybrid:
                state["attn_blocks"] = self.pool["state"]["attn_blocks"]
                state["attn_meta"] = (torch.tensor(self._page_tbl, device=dev),
                                      torch.tensor(self._kv_len, device=dev))
        n_lanes = S if width is None else width
        ids = np.zeros((n_lanes, W), np.int64)
        tmask = np.zeros((n_lanes, W), np.float32)
        trusted = {}
        for slot, tracked in live.items():
            ids[lanes[slot]] = self._spec_feed(tracked)
            tmask[lanes[slot]] = 1.0
            trusted[slot] = len(tracked.spec_pending)
        greedy_d, final_logits, new_state, old = spec_decode.spec_verify(
            self._params, state, torch.from_numpy(ids).to(dev),
            torch.from_numpy(tmask).to(dev), self.cfg)
        greedy = greedy_d.cpu().numpy()  # the one host sync of the tick
        tokens = np.zeros((W + 1, S), np.int64)
        emitted = np.zeros((W + 1, S), bool)
        done = np.zeros((W + 1, S), bool)
        advance = np.zeros((n_lanes,), bool)
        for slot, tracked in live.items():
            nt, fed = trusted[slot], ids[lanes[slot]].tolist()
            a, adv, nxt = spec_decode.verify_greedy(fed, greedy[lanes[slot]], nt)
            self._spec_accepted += a
            pending = tracked.spec_pending
            stream = pending[tracked.spec_pending_emitted:] + fed[nt:nt + a] + [nxt]
            r = tracked.request
            now, finished = [], False
            for tok in stream:
                now.append(tok)
                # the non-speculative tick's finish rule: the eos or
                # budget token is emitted, nothing after it
                if ((r.eos_id is not None and tok == r.eos_id)
                        or len(tracked.new_tokens) + len(now) >= r.max_new_tokens):
                    finished = True
                    break
            tokens[:len(now), slot] = now
            emitted[:len(now), slot] = True
            if finished:
                done[len(now) - 1, slot] = True
            elif adv:
                advance[lanes[slot]] = True
                tracked.spec_pending, tracked.spec_pending_emitted = [nxt], 1
            else:
                tracked.spec_pending = pending + fed[nt:nt + a] + [nxt]
                tracked.spec_pending_emitted = len(tracked.spec_pending)
        # the next step's chunk budget pays for the lanes this tick
        # computed: the compacted width, or the live rows
        self._spec_budget_debt = (len(live) if width is None else width) * W
        self._spec_streams += len(live)
        spec_decode.spec_commit(new_state, old["blocks"], lane_rows["logits"],
                                lane_rows["meta"], final_logits,
                                torch.from_numpy(advance).to(dev), W)
        if width is not None:
            state_cache.scatter_slots(rows, lane_rows, inv, touched)
        if self.hybrid:
            adv_full = np.zeros((S,), np.int32)
            for slot, lane in lanes.items():
                adv_full[slot] = advance[lane]
            self._kv_len += W * adv_full
        return tokens, emitted, done

    @torch.no_grad()
    def step(self) -> list[TokenEvent]:
        """One engine iteration: prefill phase, then one tick.  Returns the
        tick's TokenEvents in emission order (none while only partial
        prefills are resident); finished requests are evicted and their
        results kept in ``self.results``."""
        stall_s, chunk_tokens = self._prefill_phase()
        if stall_s:
            self.metrics.record_prefill_stall(stall_s)
        self._pending_stall_ms += stall_s * 1000
        self._pending_chunk_tokens += chunk_tokens
        if not any(t.status is RequestStatus.DECODE for t in self._slots.values()):
            return []
        occupied = len(self._slots)
        live_slots = [s for s, t in self._slots.items() if t.status is RequestStatus.DECODE]
        # the lane width this tick launches (None: the full width);
        # mid-prefill residents are left out of a compacted launch
        width = self._compaction_width(live_slots)
        # the requests this tick advances (mid-prefill residents sample
        # nothing), stamped on the span and the tick record
        live_traces = sorted(self._slots[s].trace_id for s in live_slots)
        t0 = time.perf_counter()
        # the span encloses the tick's one host fetch, so it covers the
        # tick's device work
        with self.tracer.span("serving_tick", occupied=occupied, traces=live_traces):
            if self.spec:
                tokens, emitted, done = self._spec_tick(live_slots, width)
            elif width is None:
                tokens, emitted, done = self._tick(live_slots)
            else:
                tokens, emitted, done = self._compact_tick(live_slots, width)
        t_now = time.perf_counter()
        dt = t_now - t0
        events: list[TokenEvent] = []
        for j in range(tokens.shape[0]):
            for slot, tracked in self._slots.items():
                if not emitted[j, slot]:
                    continue
                r = tracked.request
                tok = int(tokens[j, slot])
                tracked.new_tokens.append(tok)
                if done[j, slot]:
                    tracked.status = RequestStatus.FINISHED
                    tracked.finish_reason = (
                        "eos" if r.eos_id is not None and tok == r.eos_id else "length")
                events.append(TokenEvent(tracked.request_id, tok,
                                         len(tracked.new_tokens) - 1,
                                         bool(done[j, slot]), tracked.finish_reason))
        # per-request latency stamps (before eviction).  A tick's m tokens
        # reach the host at its one fetch and share one time stamp: each
        # inter-token gap is the span since the request's previous
        # arrival (the tick's start for its first tick) over m
        for slot, tracked in self._slots.items():
            m = int(emitted[:, slot].sum())
            if not m:
                continue
            if tracked.t_first_token is None:
                tracked.t_first_token = t_now
                self.metrics.record_ttft(t_now - tracked.t_submit)
                if self.prefix_cache is not None:
                    # TTFT split by the cache outcome
                    self.metrics.record_prefix_ttft(t_now - tracked.t_submit,
                                                    hit=tracked.cache_hit is not None)
                gaps, t_prev = m - 1, t0
            else:
                gaps, t_prev = m, tracked.t_last_token
            if gaps:
                per_token_s = (t_now - t_prev) / m
                self.metrics.record_itl(per_token_s, gaps)
                tracked.itl_hist.record(per_token_s * 1000, gaps)
            tracked.t_last_token = t_now
        for slot in [s for s, t in self._slots.items()
                     if t.status is RequestStatus.FINISHED]:
            tracked = self._slots.pop(slot)
            state_cache.evict(self.pool, slot)
            self._release_pages(slot, tracked)
            self._free.append(slot)
            if self.spec:
                self.drafter.forget(tracked.request_id)
            r = tracked.request
            request_record = {
                "request_id": tracked.request_id,
                "trace_id": tracked.trace_id,
                "prompt_tokens": int(len(r.prompt_ids)),
                "new_tokens": len(tracked.new_tokens),
                "finish_reason": tracked.finish_reason,
                "queue_wait_ms": round((tracked.t_admit - tracked.t_submit) * 1000, 3),
                "ttft_ms": round((tracked.t_first_token - tracked.t_submit) * 1000, 3),
                "e2e_ms": round((t_now - tracked.t_submit) * 1000, 3),
                "itl_hist": tracked.itl_hist.to_dict(),
            }
            # feature stamps only when the features are on, so records of
            # plain engines keep their bytes
            if self.prefix_cache is not None:
                request_record["prefix_hit"] = tracked.cache_hit
            if tracked.preempted:
                request_record["preemptions"] = tracked.preempted
            if tracked.priority != self.scheduler.default_priority:
                request_record["priority"] = tracked.priority
            self.metrics.record_request(request_record)
            if self.slo is not None:
                self.slo.observe_request(request_record)
            self.results[tracked.request_id] = GenerationResult(
                request_id=tracked.request_id, prompt_ids=r.prompt_ids,
                new_tokens=np.asarray(tracked.new_tokens, np.int64),
                finish_reason=tracked.finish_reason)
        self._free.sort()
        gauges = {}
        if self.hybrid:
            # page-pool occupancy at this tick + the window's allocator churn
            gauges.update(kv_pages_used=self.page_pool.pages_in_use,
                          kv_pages_capacity=self.page_pool.num_pages,
                          kv_page_allocs=self._page_allocs,
                          kv_page_frees=self._page_frees)
            self._page_allocs = 0
            self._page_frees = 0
        if self.prefix_cache is not None:
            gauges.update(prefix_hits=self._pc_hits, prefix_misses=self._pc_misses,
                          prefix_saved_tokens=self._pc_saved_tokens,
                          prefix_cache_entries=len(self.prefix_cache),
                          prefix_cache_bytes=self.prefix_cache.nbytes)
            self._pc_hits = self._pc_misses = self._pc_saved_tokens = 0
        if self.quantized_weights or self.quantized_kv:
            gauges.update(quantized=self._quant_stamp, weight_bytes=self._weight_bytes,
                          page_pool_bytes=self._pool_bytes)
        if self.spec:
            # the window's draft and accept counts and live slot-launches
            # (absent when speculation is off)
            gauges.update(spec_drafted=self._spec_drafted,
                          spec_accepted=self._spec_accepted,
                          spec_streams=self._spec_streams)
            self._spec_drafted = self._spec_accepted = self._spec_streams = 0
        if self.tick_regression is not None:
            self.tick_regression.observe_tick(dt * 1000)
        self.metrics.record_tick(
            occupied=occupied, queue_depth=self.scheduler.depth,
            tokens_emitted=len(events), dt_s=dt,
            prefill_stall_ms=self._pending_stall_ms,
            prefill_chunk_tokens=self._pending_chunk_tokens,
            prefill_chunk_ms=self._pending_chunk_ms,
            prefill_real_tokens=self._pending_chunk_real_tokens,
            prefill_oneshot_tokens=self._pending_oneshot_real_tokens,
            prefill_oneshot_lanes=self._pending_oneshot_lanes,
            # the tick computes every lane it launched, live or not: the
            # compacted width, or the capacity
            slot_lanes=((self.capacity if width is None else width)
                        * (self.spec_width if self.spec else self.tokens_per_tick)),
            compaction_width=(((self.capacity if width is None else width)
                               if self.compaction else None)),
            traces=live_traces, preemptions=self._preemptions, **gauges)
        self._preemptions = 0
        self._pending_stall_ms = 0.0
        self._pending_chunk_tokens = 0
        self._pending_chunk_real_tokens = 0
        self._pending_chunk_ms = 0.0
        self._pending_oneshot_real_tokens = 0
        self._pending_oneshot_lanes = 0
        return events

    # ------------------------------------------------------------ frontends

    def serve(self, requests=()):  # -> Iterator[TokenEvent]
        """Accept requests, stream TokenEvents back as ticks complete."""
        for r in requests:
            self.submit(r)
        while self.pending:
            yield from self.step()

    def run(self, requests=()) -> list[GenerationResult]:
        """Submit ``requests``, drain the engine, return results in
        submission order."""
        ids = [self.submit(r) for r in requests]
        for _ in self.serve():
            pass
        return [self.results[i] for i in ids]
