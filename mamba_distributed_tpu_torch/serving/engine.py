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

Multi-tenant LoRA (``cfg.lora_max_adapters > 0``; serving/adapters.py):
the engine holds an ``AdapterRegistry`` of named adapters and a bounded,
refcounted ``AdapterCache`` of their factors on the card, attached to
the decode params.  ``submit`` pins a request's adapter version (A/B
routing with ``cfg.lora_ab_fraction < 1``); admission checks the tenant
quota (``cfg.tenant_max_slots``), then reserves the adapter's cache row
before any page, and waits while every row is pinned; the row rides a
preemption and is released at finish or failure.  Each slot's row sits
in the pool meta (``adapter_id``, 0 = none), and every tick, compacted
tick, prefill chunk and verify binds the rows of its launch once, so
slots running different adapters share one launch.  Prefix-cache keys
carry the adapter's salt.  ``hot_swap_adapter`` moves a decoding stream
to another adapter version without losing a token.  Int8 weights with
LoRA raise at construction.

Serving meshes (``mesh=``, or ``cfg.serving_*_shards`` > 1; JAX
``engine.py:461-531``): one process per coordinate of a
``parallel/mesh.serving_mesh``, each building the engine from the same
params, config and requests.  The host loop (scheduler, admission, the
``PagePool``, the prefix cache, compaction, speculation's acceptance, the
adapter cache) runs the same way on every rank and reads only what every
rank holds, so every rank takes the same decisions.  The weights are cut
over ``model`` (the packed per-rank heads, the vocab axis of the
embedding and head) and ``stage`` (each stage its block of each layer
family), and the slots over ``data``: data rank d holds slots ``[d C/D,
(d+1) C/D)`` and its shard's page rows, runs the tick on its block (and
the prefills and chunks of its slots only), and the tick's one host sync
gathers the token blocks over ``data``.  A prefix-cache entry's or a
preempted stream's carry is broadcast over ``data`` from its slot's
shard, so a hit or a resume on any shard reads it; a hybrid entry's
pages stay in their shard.  Engine streams equal a solo
``generate(mesh=engine.mesh, decode_rows=capacity)`` bit for bit.  The
records gain ``model_shards`` and, at a stage axis, ``stage_shards`` and
``bubble_lanes`` (the microbatched decode clock's ramp, billed into
goodput).

Left out of the port for now: sessions' parking, migration, the router's
adapter affinity and the online-tuning plane.
"""

from __future__ import annotations

import dataclasses
import time
import zlib

import numpy as np
import torch

from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.inference.bucketing import next_pow2_bucket, pad_to_bucket
from mamba_distributed_tpu_torch.inference.generate import (
    decode_micro,
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
from mamba_distributed_tpu_torch.parallel.collectives import serve_broadcast_, serve_gather
from mamba_distributed_tpu_torch.parallel.mesh import serving_mesh
from mamba_distributed_tpu_torch.parallel.sharding import (
    validate_serving_model_shards,
    validate_serving_stage_shards,
)
from mamba_distributed_tpu_torch.parallel.tp_layout import pack_leaf, serving_plan
from mamba_distributed_tpu_torch.serving import prefix_cache as prefix_cache_mod
from mamba_distributed_tpu_torch.serving import adapters as adapters_mod
from mamba_distributed_tpu_torch.serving import spec_decode, state_cache
from mamba_distributed_tpu_torch.serving.prefix_cache import PrefixCache
from mamba_distributed_tpu_torch.serving.prefill import (
    ServingShard,
    chunk_inputs,
    plan_chunks,
    prefill_chunk,
    serving_shard,
)
from mamba_distributed_tpu_torch.serving.scheduler import (
    FCFSScheduler,
    GenerationRequest,
    GenerationResult,
    RequestStatus,
    TenantQuotaExceeded,
    TokenEvent,
    _Tracked,
    check_tenant_quota,
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
      adapters: a ``serving/adapters.AdapterRegistry`` of named LoRA
        adapters (read only when ``cfg.lora_max_adapters > 0``; None
        builds an empty one over ``params``' targets).  One registry may
        back several engines; each keeps its own device cache.  A stream
        under adapter ``a`` matches a solo ``generate()`` on
        ``adapters.merge(params, a)`` up to the re-association of the
        delta's sums.
      mesh: a ``parallel/mesh.ServingMesh`` (every rank of it builds the
        engine alike); None builds one from ``cfg.serving_data_shards`` x
        ``cfg.serving_stage_shards`` x ``cfg.serving_model_shards`` when
        any is above 1 (the world must hold that many ranks).  ``params``
        may then be this rank's ``serving/prefill.ServingShard`` instead
        of the fp32 masters (not with LoRA, whose registry reads the
        masters).
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
                 drafter: spec_decode.Drafter | None = None,
                 adapters: adapters_mod.AdapterRegistry | None = None,
                 mesh=None):
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
        if mesh is None and (cfg.serving_data_shards > 1 or cfg.serving_model_shards > 1
                             or cfg.serving_stage_shards > 1):
            mesh = serving_mesh(cfg.serving_data_shards, cfg.serving_model_shards,
                                cfg.serving_stage_shards)
        self.mesh = mesh
        self.num_shards = 1 if mesh is None else mesh.data
        self.model_shards = 1 if mesh is None else mesh.model
        self.stage_shards = 1 if mesh is None else mesh.stage
        if capacity % self.num_shards:
            raise ValueError(
                f"capacity={capacity} must divide over "
                f"serving_data_shards={self.num_shards} (each data shard "
                f"holds capacity/shards slot rows)")
        validate_serving_model_shards(cfg, self.model_shards)
        validate_serving_stage_shards(cfg, self.stage_shards)
        # this rank's block of slots: [_slot_base, _slot_base + _per)
        self._per = capacity // self.num_shards
        self._data_rank = 0 if mesh is None else mesh.data_rank
        self._slot_base = self._data_rank * self._per
        # the model and stage groups of every forward (None: one device)
        self._mesh_kw = ({} if mesh is None
                         else dict(tp=mesh.tp, stage=mesh.stage_ctx))
        # the row count a compacted decode launch's GEMMs run at (None:
        # the launch's own): over the model axis, a shard's full block,
        # since cuBLAS picks its kernel, and so a row's summation order,
        # by the row count, and a rank's halved products parted compacted
        # ticks from full ones on the card (one process's did not)
        self._gemm_rows = self._per if self.model_shards > 1 else None
        self.cfg = cfg
        self.device = device
        self.capacity = capacity
        self.max_top_k = max_top_k
        self.tokens_per_tick = tokens_per_tick
        self.prefill_tokens_per_tick = prefill_tokens_per_tick
        if isinstance(params, ServingShard):
            self._params = ServingShard(_to_device(params, device))
        else:
            self._params = serving_shard(_to_device(params, device), cfg, mesh)
        self.pool = state_cache.init_pool(cfg, capacity, device, mesh)
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
                state_cache.hybrid_pool_pages(cfg, capacity, self.num_shards),
                self.num_shards)
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
            peak_flops=(peak_flops(device) * self.num_shards * self.model_shards
                        * self.stage_shards if device.type == "cuda" else None))
        if self.stage_shards > 1:
            self.metrics.configure_pipeline(self.stage_shards)
        # int8 serving: the resident-bytes gauges and the dtype stamp, only
        # when weights or KV pages are int8 (other records carry neither)
        self.quantized_weights = cfg.serving_weight_dtype == "int8"
        self.quantized_kv = self.hybrid and cfg.kv_quantized
        # the resident weight bytes of this rank's shard
        self.weight_bytes = param_bytes(self._params)
        if self.quantized_weights or self.quantized_kv:
            self._pool_bytes = (
                sum(t.numel() * t.element_size() for t in self.pool["state"]["attn_blocks"])
                if self.hybrid else None)
            self._quant_stamp = {"weights": cfg.serving_weight_dtype,
                                 "kv": cfg.kv_page_dtype}
            self.metrics.configure_memory(
                weight_bytes=self.weight_bytes, page_pool_bytes=self._pool_bytes or 0,
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
                # (and int8 scales): the KV share of an entry's bytes, of
                # the whole model (the same on every rank of a mesh)
                self._page_nbytes = sum(
                    t.numel() * t.element_size() // t.shape[1]
                    for t in state_cache.init_pool(cfg, 1, "meta")["state"]["attn_blocks"])
            # the bytes of one whole-model carry (every rank prices an
            # entry alike, so the cache's byte cap evicts alike)
            self._carry_nbytes = prefix_cache_mod.state_nbytes(
                {"blocks": init_lm_blocks_state(cfg, 1, "meta")})
            self.metrics.configure_prefix_cache()
        # compacted ticks: the current pow2 lane bucket and the run of
        # ticks that would have fit a smaller one
        self.compaction = cfg.tick_compaction
        if self.compaction:
            self._compact_bucket = 1
            self._shrink_streak = 0
            self.metrics.configure_compaction()
        # multi-tenant LoRA: factor pools attached to the decode params and
        # per-slot adapter rows bound into every launch.  Off (the default)
        # attaches nothing and stamps nothing
        self.lora = cfg.lora_max_adapters > 0
        if self.lora:
            if isinstance(params, ServingShard):
                raise ValueError("a LoRA engine's adapter registry reads the fp32 master "
                                 "params: pass them, not a ServingShard")
            if self.quantized_weights:
                raise ValueError(
                    "int8 base weights + a LoRA delta is a ROADMAP "
                    "residual (the two dequant paths don't compose "
                    "yet): serve LoRA adapters with "
                    "serving_weight_dtype='bf16', or quantize without "
                    "lora_max_adapters")
            self.adapters = (adapters if adapters is not None
                             else adapters_mod.AdapterRegistry(cfg, params))
            if self.adapters.rank != cfg.lora_rank:
                raise ValueError(
                    f"adapter registry rank {self.adapters.rank} != "
                    f"cfg.lora_rank {cfg.lora_rank} — the factor pools "
                    f"are static-shape; one rank per engine")
            if self.model_shards > 1:
                self._serve_plan = serving_plan(cfg, self.model_shards)
            self.adapter_cache = adapters_mod.AdapterCache(
                self.adapters, cfg.effective_lora_cache_slots,
                compute_dtype=cfg.torch_compute_dtype, device=device,
                cut=None if mesh is None else self._lora_cut)
            self._base_decode_params = self._params
            self._lora_version = -1
            self._refresh_lora_params()
            # the cache's lifetime counters at the last tick record
            self._ad_hits0 = self._ad_misses0 = self._ad_evictions0 = 0
            self.metrics.configure_adapters(cfg.lora_max_adapters, cfg.lora_rank,
                                            cfg.effective_lora_cache_slots)
        else:
            self.adapters = None
            self.adapter_cache = None
        # the per-tenant slot quota (0 = none) and the window counters of
        # quota stalls and hot swaps
        self.tenant_max_slots = cfg.tenant_max_slots
        self._quota_stalls = 0
        self._hot_swaps = 0
        if self.tenant_max_slots:
            self.metrics.configure_tuning()
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
        if request.adapter:
            if not self.lora:
                raise ValueError(
                    f"request names adapter {request.adapter!r} but this "
                    f"engine serves the base model only "
                    f"(cfg.lora_max_adapters=0); enable multi-tenant LoRA "
                    f"serving or drop the adapter field")
            if request.adapter not in self.adapters:
                raise adapters_mod.UnknownAdapterError(
                    f"unknown adapter {request.adapter!r}: this engine's "
                    f"registry holds {self.adapters.names()}")
            # pin the version at submit, so a version registered later
            # never retargets a queued stream (A/B-routed below 1.0)
            request.adapter = self._ab_resolve(request, request.adapter)
        if self.hybrid:
            need = np.asarray(request.prompt_ids).size + request.max_new_tokens
            if need > self.cfg.kv_slot_tokens:
                raise ValueError(
                    f"hybrid request needs {need} KV tokens (prompt + "
                    f"max_new_tokens) > cfg.kv_slot_tokens="
                    f"{self.cfg.kv_slot_tokens}")
            need_pages = attention_page_count(self.cfg, need)
            if need_pages > self._max_shard_pages():
                raise ValueError(
                    f"hybrid request needs {need_pages} KV pages but the page "
                    f"pool's widest shard holds {self._max_shard_pages()} "
                    f"({self.page_pool.num_pages} over {self.num_shards} shard(s); "
                    f"cfg.kv_pool_pages): it could never be admitted")
        return self.scheduler.submit(request).request_id

    def _slot_meta(self, tracked: _Tracked) -> dict:
        r = tracked.request
        return dict(max_new=r.max_new_tokens, top_k=r.top_k,
                    temperature=r.temperature,
                    eos_id=-1 if r.eos_id is None else r.eos_id,
                    adapter_id=tracked.adapter_slot or 0)

    # ------------------------------------------------------- serving mesh

    def _slot_shard(self, slot: int) -> int:
        """The data shard whose ranks hold ``slot``'s pool rows."""
        return slot * self.num_shards // self.capacity

    def _owns(self, slot: int) -> bool:
        """Does this rank hold ``slot``'s rows (its data shard's)?"""
        return self._slot_shard(slot) == self._data_rank

    def _row(self, slot: int) -> int:
        """``slot``'s row in this rank's block of the pool."""
        return slot - self._slot_base

    def _max_shard_pages(self) -> int:
        """The most pages one shard could ever have free: the bound on
        one request's reservation (a slot draws from its shard only)."""
        return max(self.page_pool.shard_capacity(d) for d in range(self.num_shards))

    def _local_pages(self, ids):
        """This rank's page-array rows of global page ids (numpy)."""
        return self.page_pool.local_rows(np.asarray(ids, np.int32), self._data_rank)

    def _table(self, slots) -> torch.Tensor:
        """The page-table rows of ``slots`` on the device, as this rank's
        page rows (a row of another shard, or unreserved, reads the
        local trash row)."""
        return torch.from_numpy(self._local_pages(self._page_tbl[slots])).to(self.device)

    def _lora_cut(self, path: str, part: str, factor: torch.Tensor) -> torch.Tensor:
        """This rank's part of one adapter factor (``AdapterCache(cut=)``):
        its model rank's cut (``tp_layout.ServingPlan``) of its stage's
        layers."""
        if self.model_shards > 1:
            lp = self._serve_plan.leaf((*path.split("/"), "lora", part))
            factor = pack_leaf(factor, lp, self.mesh.model_rank)
        if self.stage_shards > 1:
            n = factor.shape[0] // self.stage_shards
            factor = factor[self.mesh.stage_rank * n:(self.mesh.stage_rank + 1) * n]
        return factor

    def _share_carry(self, state: dict | None, logits, shard: int,
                     with_logits: bool = True):
        """A batch-1 carry (and its last logits, ``with_logits``) that the
        ranks of data shard ``shard`` computed, on every data rank: one
        broadcast over the data group a tensor, the others passing
        buffers of this rank's shapes.  ``state``/``logits`` are read on
        ``shard``'s ranks only.  Identity with one data shard."""
        if self.num_shards == 1:
            return state, logits
        if self._data_rank == shard:
            bufs = [*state["blocks"]] + ([logits] if with_logits else [])
        else:
            bufs = list(init_lm_blocks_state(self.cfg, 1, self.device, self.mesh.tp,
                                             self.stage_shards))
            if with_logits:
                bufs.append(torch.empty((1, self.cfg.vocab_size_padded), device=self.device))
        ctx = self.mesh.data_ctx
        out = [serve_broadcast_(t.contiguous(), ctx, shard, "carry") for t in bufs]
        return {"blocks": tuple(out[:2])}, (out[2] if with_logits else None)

    def _gather_blocks(self, *blocks: torch.Tensor) -> list:
        """Host arrays of this rank's (steps, lanes) blocks gathered over
        the data group along the lanes, in shard order: the tick's one
        host sync (one gather for all of them)."""
        stacked = torch.stack([b.to(torch.int64) for b in blocks])
        if self.num_shards > 1:
            stacked = serve_gather(stacked, self.mesh.data_ctx, 2, "tokens")
        return list(stacked.cpu().numpy())

    # ---------------------------------------------------- multi-tenant LoRA

    def _refresh_lora_params(self) -> None:
        """Re-attach the adapter cache's pools to the decode params after
        a pool write (``AdapterCache.version``).  Host-side tree surgery:
        the pools are written in place, so the tree holds the same
        tensors."""
        if self.adapter_cache.version == self._lora_version:
            return
        self._params = adapters_mod.attach_adapter_pools(
            self._base_decode_params, self.adapter_cache.pools)
        self._lora_version = self.adapter_cache.version

    def _bound_params(self, ids: torch.Tensor | None) -> dict:
        """The decode params with a launch's (b,) adapter rows bound
        (LoRA engines), or as they are."""
        if not self.lora or ids is None:
            return self._params
        return adapters_mod.bind_adapter_ids(self._params, ids)

    def adapter_resident(self, name: str) -> bool:
        """Is ``name``'s factor set in this engine's device cache now?
        A pure probe."""
        return self.lora and self.adapter_cache.resident(name)

    def _ab_resolve(self, request: GenerationRequest, adapter: str) -> str:
        """Submit-time version pin with A/B routing: the plain ``resolve``
        with ``cfg.lora_ab_fraction >= 1``, for explicit ``@vN`` names
        and for tenants with one version.  Below 1, a bare name routes
        that share of requests to the latest version and the rest to the
        previous one, by a crc32 of the adapter base, the seed and the
        prompt bytes (the JAX package's hash, so both pick the same arm)."""
        frac = self.cfg.lora_ab_fraction
        base, ver = adapters_mod.split_adapter_version(adapter)
        if frac >= 1.0 or ver is not None:
            return self.adapters.resolve(adapter)
        latest = self.adapters.version_of(base)
        if latest < 2:
            return self.adapters.resolve(adapter)
        prev_key = adapters_mod.versioned_name(base, latest - 1)
        if prev_key not in self.adapters:
            # a forward version jump: no control arm to route to
            return self.adapters.resolve(adapter)
        h = zlib.crc32(
            np.asarray(request.prompt_ids, np.int32).tobytes(),
            zlib.crc32(f"{base}:{request.seed}".encode("utf-8")))
        if (h % 10_000) < int(frac * 10_000):
            return adapters_mod.versioned_name(base, latest)
        return prev_key

    def _adapter_salt(self, request: GenerationRequest) -> bytes:
        """Prefix-cache key salt of a request's adapter (``b""`` on
        LoRA-less engines and adapter-less requests)."""
        if not self.lora:
            return b""
        return adapters_mod.prefix_salt(request.adapter)

    def _acquire_adapter_ref(self, tracked: _Tracked) -> bool:
        """Reserve the request's adapter cache row (``tracked.adapter_
        slot``; 0 = no adapter).  False when every row is pinned: the
        caller requeues and admission waits, as for short pages."""
        if not self.lora or not tracked.request.adapter:
            tracked.adapter_slot = 0
            return True
        if tracked.adapter_slot:  # a preempted resume: the ref rode along
            return True
        slot = self.adapter_cache.acquire(tracked.request.adapter)
        if slot is None:
            return False
        tracked.adapter_slot = slot
        self._refresh_lora_params()
        return True

    def _lora_ids(self, tracked: _Tracked) -> torch.Tensor | None:
        """The (1,) adapter row of a batch-1 prefill launch (LoRA engines
        only; row 0 for adapter-less requests)."""
        if not self.lora:
            return None
        return torch.full((1,), tracked.adapter_slot or 0, dtype=torch.int32,
                          device=self.device)

    def _release_adapter_ref(self, tracked: _Tracked) -> None:
        """Drop the request's adapter-row ref (finish, failure, a page
        stall, a hot swap).  Idempotent through the ``adapter_slot``
        sentinel."""
        if self.lora and tracked.adapter_slot:
            self.adapter_cache.release(tracked.request.adapter)
        tracked.adapter_slot = None

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
        # the tenant quota: a tenant at its cap waits in the queue (a
        # resume bypasses it: it held a slot before)
        if self.tenant_max_slots:
            try:
                check_tenant_quota(r.adapter,
                                   (t.request.adapter for t in self._slots.values()),
                                   self.tenant_max_slots)
            except TenantQuotaExceeded:
                self._quota_stalls += 1
                self.metrics.record_quota_stall()
                self.scheduler.requeue(tracked)
                return False
        # the adapter's cache row first, as for pages: while every row is
        # pinned the request waits, so nothing misses its factors mid-flight
        if not self._acquire_adapter_ref(tracked):
            self.scheduler.requeue(tracked)
            return False
        salt = self._adapter_salt(r)
        plan = plan_chunks(len(r.prompt_ids), self.cfg.effective_prefill_chunk_tokens,
                           force=self.hybrid)
        # peek: the lookup commits only once a slot is secured, so a
        # request that waits for pages does not count a lookup a step
        hit = (None if self.prefix_cache is None
               else self.prefix_cache.lookup(r.prompt_ids, plan, peek=True, salt=salt))
        n_pages = shared_n = fresh_n = 0
        cow = False
        if self.hybrid:
            n_pages = attention_page_count(self.cfg, len(r.prompt_ids) + r.max_new_tokens)
            slot = None
            if hit is not None:
                # a cached prefix's pages lie in one data shard: attaching
                # takes a free slot of that shard with fresh pages there
                # for all it will write; whole shared pages stay
                # read-only, a prefix ending mid-page costs one more fresh
                # page, its copy
                page = self.cfg.kv_page_tokens
                shared_n = hit[0].kv_len // page
                cow = bool(hit[0].kv_len % page)
                fresh_n = n_pages - shared_n
                slot = next((s for s in self._free if self._slot_shard(s) == hit[0].shard
                             and fresh_n <= self.page_pool.free_pages_in(hit[0].shard)),
                            None)
                if slot is None:
                    hit = None  # served cold (and committed as a miss)
            if hit is None:
                # the first free slot whose shard covers the reservation
                def fits():
                    return next((s for s in self._free if n_pages
                                 <= self.page_pool.free_pages_in(self._slot_shard(s))), None)

                slot = fits()
                if slot is None and self._reclaim_cache_pages(n_pages):
                    slot = fits()
                if slot is None:
                    # page-stalled: the adapter ref goes too (the retry
                    # takes it again), so a waiting request pins no cache row
                    self._release_adapter_ref(tracked)
                    self.scheduler.requeue(tracked)
                    return False
            self._free.remove(slot)
        else:
            slot = self._free.pop(0)
        owner, row, shard = self._owns(slot), self._row(slot), self._slot_shard(slot)
        tracked.status = RequestStatus.PREFILL
        entry = hit[0] if hit is not None else None
        full_hit = entry is not None and entry.full
        t0 = time.perf_counter()
        try:
            if self.hybrid and entry is not None:
                fresh = self.page_pool.alloc(fresh_n, entry.shard)
                shared = list(entry.kv_pages[:shared_n])
                self.page_pool.incref(shared)
                # the gauges count page refs taken and dropped, so allocs
                # still equal frees on a cache-sharing engine
                self._page_allocs += fresh_n + len(shared)
                tracked.pages = shared + fresh
                if cow:
                    # the slot's first write lands at kv_len, inside the
                    # prefix's last (partial) page: it appends into a copy
                    if owner:
                        state_cache.copy_page(
                            self.pool["state"]["attn_blocks"],
                            *self._local_pages([entry.kv_pages[shared_n], fresh[0]]).tolist())
                    self.cow_copies += 1
                self._page_tbl[slot] = 0
                self._page_tbl[slot, :n_pages] = tracked.pages
                self._kv_len[slot] = entry.kv_len
            if full_hit:
                # the snapshot is the prefill's output: insert and decode
                with self.tracer.span("serving_prefill", slot=slot, request=tracked.request_id,
                                      trace=tracked.trace_id, cache="full"):
                    if owner:
                        state_cache.insert(self.pool, row, {"blocks": entry.state["blocks"]},
                                           entry.logits, **self._slot_meta(tracked))
                    self._seed_spec(tracked, entry.logits)
            elif entry is not None:
                # partial hit: the remaining chunks run the computation a
                # cold admission would, so the stream is the cold one
                tracked.plan = plan
                tracked.chunks_done = hit[1]
                tracked.prefill_dt = 0.0
                tracked.prefill_seeded_tokens = entry.tokens
                if owner:
                    state_cache.stash_prefill(self.pool, row, {"blocks": entry.state["blocks"]},
                                              **self._slot_meta(tracked))
            elif plan is None:
                # one span per one-shot prefill, trace-stamped, so even a
                # short prompt's journey has an anchor in the stream
                with self.tracer.span("serving_prefill", slot=slot,
                                      request=tracked.request_id, trace=tracked.trace_id):
                    logits = state = None
                    if owner:
                        prompt = torch.as_tensor(r.prompt_ids, dtype=torch.int64,
                                                 device=self.device)[None]
                        ids, mask = pad_to_bucket(prompt, next_pow2_bucket(prompt.shape[1]))
                        logits, state = lm_prefill(
                            self._bound_params(self._lora_ids(tracked)), self.cfg, ids,
                            token_mask=mask, **self._mesh_kw)
                        state_cache.insert(self.pool, row, state, logits,
                                           **self._slot_meta(tracked))
                    key = prefix_cache_mod.oneshot_key(r.prompt_ids, salt)
                    store = self.prefix_cache is not None and self.prefix_cache.wants(key)
                    if store or self.spec:
                        # the stream's host decisions read the logits on every rank
                        state, logits = self._share_carry(state, logits, shard)
                    self._seed_spec(tracked, logits)
                    if store:
                        # insert copied the state into the pool, so the
                        # prefill's own tensors can be kept
                        self.prefix_cache.put(key, prefix_cache_mod.PrefixEntry(
                            state=state, tokens=len(r.prompt_ids), chunks=0, logits=logits,
                            nbytes=self._carry_nbytes + prefix_cache_mod.tensor_nbytes(logits)))
            else:
                tracked.plan = plan
                tracked.chunks_done = 0
                tracked.prefill_dt = 0.0
                if self.hybrid:
                    tracked.pages = self.page_pool.alloc(n_pages, shard)
                    self._page_allocs += n_pages
                    self._page_tbl[slot] = 0
                    self._page_tbl[slot, :n_pages] = tracked.pages
                    self._kv_len[slot] = 0
                if owner:
                    state_cache.stash_prefill(
                        self.pool, row,
                        {"blocks": init_lm_blocks_state(self.cfg, 1, self.device,
                                                        self._mesh_kw.get("tp"),
                                                        self.stage_shards)},
                        **self._slot_meta(tracked))
        except Exception:
            # a failed prefill leaks neither the slot nor its pages nor its
            # adapter ref, and does not drop the request
            self._release_pages(slot, tracked)
            self._release_adapter_ref(tracked)
            self._free.insert(0, slot)
            self._free.sort()
            self.scheduler.requeue(tracked)
            raise
        if self.prefix_cache is not None:
            # the admission went through: commit the lookup (the cache's
            # stats, recency and promotion counters) and the window gauges
            self.prefix_cache.commit_lookup(r.prompt_ids, plan, hit, salt=salt)
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
        """Run ONE chunk of ``slot``'s prefill; returns the budget left.
        On a mesh only the ranks of the slot's data shard run it; the
        others keep the same host books."""
        tracked = self._slots[slot]
        plan, r = tracked.plan, tracked.request
        owner, row, shard = self._owns(slot), self._row(slot), self._slot_shard(slot)
        try:
            i = tracked.chunks_done
            logits = state = None
            t0 = time.perf_counter()
            with self.tracer.span("serving_prefill_chunk", slot=slot, chunk=i,
                                  of=plan.n_chunks, trace=tracked.trace_id):
                if owner:
                    state = state_cache.read_state(self.pool, row)
                    if self.hybrid:
                        # the chunk step writes this slot's pages of the
                        # shared pool in place, through its table row and
                        # length
                        state["attn_blocks"] = self.pool["state"]["attn_blocks"]
                        state["attn_meta"] = (
                            self._table(slice(slot, slot + 1)),
                            torch.tensor(self._kv_len[slot:slot + 1], device=self.device))
                    ids, mask = chunk_inputs(r.prompt_ids, plan, i, device=self.device)
                    logits, state = prefill_chunk(self._params, ids, mask, state, self.cfg,
                                                  adapter_ids=self._lora_ids(tracked),
                                                  mesh=self.mesh)
                    state = {"blocks": state["blocks"]}
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
            last = tracked.chunks_done == plan.n_chunks
            shared = last and self.num_shards > 1 and (self.spec
                                                       or self.prefix_cache is not None)
            if shared:
                # the stream's host decisions (the spec seed, the cache)
                # read them on every rank
                state, logits = self._share_carry(state, logits, shard)
            # the prefix cache keeps this boundary's carry (the chunk
            # step's output, which nothing writes in place: the pool
            # takes a copy); the last boundary too, which seeds longer
            # prompts with the same left pad
            salt = self._adapter_salt(r)
            self._store_prefix(r.prompt_ids, plan, i, state, slot, salt=salt, shared=shared)
            if last:
                # ...and the full-prompt entry, which an exact repeat
                # takes without a prefill
                self._store_prefix(r.prompt_ids, plan, i, state, slot, logits=logits,
                                   salt=salt, full=True, shared=shared)
                if owner:
                    state_cache.finish_prefill(self.pool, row, state, logits)
                self._seed_spec(tracked, logits)
                tracked.status = RequestStatus.DECODE
                # only the computed tokens: a partial hit's seeded ones
                # are prefix_saved_tokens
                self.metrics.record_prefill(plan.prompt_len - tracked.prefill_seeded_tokens,
                                            tracked.prefill_dt)
            else:
                if owner:
                    state_cache.stash_prefill(self.pool, row, state,
                                              **self._slot_meta(tracked))
                # rotate to the back: the next grant goes to the others first
                self._prefill_queue.append(slot)
        except Exception:
            if owner:
                state_cache.evict(self.pool, row)
            self._release_pages(slot, tracked)
            self._release_adapter_ref(tracked)
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

    def _store_prefix(self, prompt_ids, plan, i: int, state: dict | None, slot: int,
                      logits=None, salt: bytes = b"", full: bool = False,
                      shared: bool = False) -> None:
        """Snapshot chunk ``i``'s carry into the prefix cache (``full``:
        the full-prompt entry, with ``logits``).  A hybrid entry holds
        refs on the whole pages of the prefix and a frozen copy of its
        partial last page, if any (the slot goes on writing its own; see
        the module docstring); with no free page for that copy in the
        slot's shard the entry is not stored.  On a mesh the carry is
        broadcast from the slot's data shard unless it already was
        (``shared``), and every rank prices the entry alike."""
        pc = self.prefix_cache
        if pc is None:
            return
        if full:
            key = prefix_cache_mod.full_key(prompt_ids, plan.chunk, salt)
            tokens = plan.prompt_len
        else:
            key = prefix_cache_mod.boundary_key(prompt_ids, plan, i, salt)
            tokens = (i + 1) * plan.chunk - plan.pad
        if not pc.wants(key):
            return
        shard = self._slot_shard(slot)
        kv_pages, kv_len, page_bytes = None, 0, 0
        if self.hybrid:
            kv_len = tokens
            whole, tail = divmod(kv_len, self.cfg.kv_page_tokens)
            pages = self._slots[slot].pages
            if tail and not self.page_pool.free_pages_in(shard):
                return
            self.page_pool.incref(pages[:whole])
            kv_pages = list(pages[:whole])
            if tail:
                (frozen,) = self.page_pool.alloc(1, shard)
                if self._owns(slot):
                    state_cache.copy_page(self.pool["state"]["attn_blocks"],
                                          *self._local_pages([pages[whole], frozen]).tolist())
                kv_pages.append(frozen)
            kv_pages = tuple(kv_pages)
            # refs taken (balanced by the evict hook's frees in the gauges)
            self._page_allocs += len(kv_pages)
            page_bytes = len(kv_pages) * self._page_nbytes
        if not shared:
            state, logits = self._share_carry(state, logits, shard, with_logits=full)
        nbytes = (self._carry_nbytes + page_bytes
                  + (prefix_cache_mod.tensor_nbytes(logits) if full else 0))
        pc.put(key, prefix_cache_mod.PrefixEntry(
            state=state, tokens=tokens, chunks=i + 1, nbytes=nbytes,
            logits=logits if full else None, kv_pages=kv_pages, kv_len=kv_len, shard=shard))

    def _reclaim_cache_pages(self, n_pages: int) -> bool:
        """Admission's pressure valve: evict page-pinning cache entries of
        the free slots' shards, least recently used first, until one of
        those shards has ``n_pages`` free (cache refs would otherwise
        never release while admission waits on them).  Returns True when
        the reservation fits now."""
        pc = self.prefix_cache
        if pc is None or not self._free:
            return False
        shards = {self._slot_shard(s) for s in self._free}
        while not any(n_pages <= self.page_pool.free_pages_in(d) for d in shards):
            if not pc.evict_one_pinned(shards):
                return False
        return True

    def prefix_hit_fraction(self, prompt_ids, adapter: str | None = None) -> float:
        """Fraction of ``prompt_ids`` whose prefill the cache could skip
        now (0.0 with the cache off): a probe that counts nothing and
        touches no recency.  ``adapter`` keys the probe to a LoRA
        identity: entries under another adapter are not hits."""
        pc = self.prefix_cache
        if pc is None or len(prompt_ids) == 0:
            return 0.0
        plan = plan_chunks(len(prompt_ids), self.cfg.effective_prefill_chunk_tokens,
                           force=self.hybrid)
        hit = pc.lookup(np.asarray(prompt_ids, np.int64), plan, peek=True,
                        salt=b"" if not self.lora else adapters_mod.prefix_salt(adapter))
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
        to the host; on a mesh first broadcast from the slot's data
        shard, so a resume on any shard has them), keep its page refs on
        the tracker, free the slot and requeue it.  ``_resume`` restores
        it with the token count, so the stream goes on as if never
        interrupted."""
        slot = tracked.slot
        with self.tracer.span("serving_preempt", slot=slot, request=tracked.request_id,
                              trace=tracked.trace_id):
            owner, row, shard = self._owns(slot), self._row(slot), self._slot_shard(slot)
            state = logits = None
            if owner:
                state = {"blocks": tuple(t[:, row:row + 1] for t in self.pool["state"]["blocks"])}
                logits = self.pool["logits"][row:row + 1]
            state, logits = self._share_carry(state, logits, shard)
            # copies even when the pool lies on the host (.cpu() would alias)
            snap = {
                "blocks": tuple(t.to("cpu", copy=True) for t in state["blocks"]),
                "logits": logits.to("cpu", copy=True),
                # the device step counter of the current request (a hot-
                # swapped continuation restarted it at swap_base)
                "step": len(tracked.new_tokens) - tracked.swap_base,
                "shard": shard,
            }
            if self.hybrid:
                snap["kv_len"] = int(self._kv_len[slot])
                self._page_tbl[slot] = 0
                self._kv_len[slot] = 0
            tracked.snapshot = snap
            tracked.preempted += 1
            self._preemptions += 1
            self.metrics.record_preemption()
            if owner:
                state_cache.evict(self.pool, row)
            del self._slots[slot]
            self._free.append(slot)
            self._free.sort()
            self.scheduler.requeue(tracked)

    def _resume(self, tracked: _Tracked) -> bool:
        """Re-admit a preempted request from its host snapshot into the
        first free slot (a hybrid's: of the shard its pages lie in), its
        token count restored (its page refs rode on the tracker).
        Returns False, requeued, when no such slot is free."""
        snap = tracked.snapshot
        if self.hybrid:
            slot = next((s for s in self._free if self._slot_shard(s) == snap["shard"]), None)
        else:
            slot = self._free[0] if self._free else None
        # the adapter row first (a preempted request's ref rode along)
        if slot is None or not self._acquire_adapter_ref(tracked):
            self.scheduler.requeue(tracked)
            return False
        self._free.remove(slot)
        try:
            with self.tracer.span("serving_resume", slot=slot, request=tracked.request_id,
                                  trace=tracked.trace_id):
                if self._owns(slot):
                    state_cache.restore(
                        self.pool, self._row(slot),
                        {"blocks": tuple(t.to(self.device) for t in snap["blocks"])},
                        snap["logits"].to(self.device), snap["step"],
                        **self._slot_meta(tracked))
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
                   split_rows: int | None = None, n_micro: int | None = None,
                   gemm_rows: int | None = None):
        """The tick's ``tokens_per_tick`` sub-steps over one set of rows
        (the pool's, or a compacted tick's lanes): sample, then
        ``lm_step``, which writes ``state`` in place.  A LoRA engine binds
        the rows' adapter ids (``meta["adapter_id"]``) once for the whole
        tick: admission happens between ticks.  ``n_micro`` runs the
        decode step on the stage axis's microbatched clock; ``split_rows``
        and ``gemm_rows`` pin the paged decode's split rule and the GEMMs'
        row count (``lm_step``).  Returns the
        last logits, the rows' step and done counters and the
        per-sub-step tokens, live flags and done flags."""
        params = self._bound_params(meta["adapter_id"])
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
                logits, stepped = lm_step(params, self.cfg,
                                          {**state, "attn_meta": attn_meta}, tok,
                                          write_mask=live, split_rows=split_rows,
                                          gemm_rows=gemm_rows, **self._mesh_kw)
                attn_meta = stepped["attn_meta"]
            else:
                logits, _ = lm_step(params, self.cfg, state, tok, pipeline=n_micro,
                                    gemm_rows=gemm_rows, **self._mesh_kw)
            step = step + live
            done = done | (live & ((has_eos & (tok == meta["eos_id"]))
                                   | (step >= meta["max_new"])))
            toks.append(tok)
            emitted.append(live)
            dones.append(done)
        return logits, step, done, toks, emitted, dones

    def _uniforms(self, lanes: dict[int, int], width: int, lo: int = 0,
                  n: int | None = None) -> torch.Tensor:
        """(steps, n) draws of lanes ``[lo, lo + n)`` of a launch of
        ``width`` lanes (default all): lane ``lanes[s]`` of decoding slot
        s samples token len(new_tokens) + j of its request at sub-step j."""
        u = np.full((self.tokens_per_tick, width), 0.5, np.float32)
        for s, lane in lanes.items():
            t = self._slots[s]
            # a hot-swapped continuation draws from step 0 of its own
            n0 = len(t.new_tokens) - t.swap_base
            u[:, lane] = [step_uniform(t.request.seed, n0 + j)
                          for j in range(self.tokens_per_tick)]
        n = width - lo if n is None else n
        return torch.from_numpy(np.ascontiguousarray(u[:, lo:lo + n])).to(self.device)

    def _tick(self, live_slots: list[int], n_micro: int | None = None):
        """Advance every decodable slot ``tokens_per_tick`` tokens at the
        full slot count (on a mesh: this data rank's block of slots).
        Returns host arrays (tokens, emitted, done), each (steps, S)."""
        dev = self.device
        pool, meta = self.pool, self.pool["meta"]
        lo, per = self._slot_base, self._per
        u = self._uniforms({s: s for s in live_slots}, self.capacity, lo, per)
        # lm_step updates the pool's state rows in place; a prefilling
        # slot's rows hold a real carry, so save and restore them
        held = [self._row(s) for s in sorted(self._prefill_queue) if self._owns(s)]
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
            attn_meta = (self._table(slice(lo, lo + per)),
                         torch.tensor(self._kv_len[lo:lo + per], device=dev))
        logits, step, done, toks, emitted, dones = self._sub_steps(
            pool["state"], pool["logits"], meta, u, attn_meta, n_micro=n_micro)
        if held:
            for t, v in zip(pool["state"]["blocks"], saved):
                t.index_copy_(1, idx, v)
        pool["logits"] = logits
        meta["step"], meta["done"] = step, done
        # the one host sync of the tick
        tokens, emitted, done = self._gather_blocks(torch.stack(toks), torch.stack(emitted),
                                                    torch.stack(dones))
        emitted, done = emitted.astype(bool), done.astype(bool)
        if self.hybrid:
            # mirror the device-side lengths: +1 per live sub-step
            self._kv_len += emitted.sum(axis=0).astype(np.int32)
        return tokens, emitted, done

    # ----------------------------------------------------- compacted ticks

    def _compaction_width(self, live_slots: list[int]) -> int | None:
        """Lane width of this tick's compacted launch, or None for the
        full-width tick (compaction off, or no narrower than a shard's
        block).  The bucket is the pow2 of the busiest data shard's live
        count (every shard runs as many lanes), grown at once and shrunk
        only after ``cfg.compaction_hysteresis_ticks`` ticks in a row
        that would have fit the smaller one; a shard launches at least
        ``COMPACT_MIN_LANES`` lanes.  The width is the shards' lanes in
        all (JAX ``engine.py:2315-2342``).  A speculative engine over the
        model axis verifies at the full width: the verify's GEMMs run at
        their own row count (``_gemm_rows`` pins the decode step's)."""
        if not self.compaction or (self.spec and self._gemm_rows is not None):
            return None
        by_shard = [0] * self.num_shards
        for s in live_slots:
            by_shard[self._slot_shard(s)] += 1
        need = next_pow2_bucket(max(1, max(by_shard)), min_bucket=1)
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
        return None if width >= self._per else width * self.num_shards

    def _gather_lanes(self, live_slots: list[int], width: int):
        """Gather the decodable slots' rows into lanes: data shard d's
        live slots, in slot order, into its ``width / D`` lanes ``[d b, d
        b + n_d)`` (pad lanes repeating the shard's first slot, as the
        JAX engine pads; JAX ``engine.py:2344-2370``); this rank gathers
        its own shard's lanes from its block.  Returns the lane map
        {slot: lane} (every shard's), this rank's scatter maps (inv,
        touched) on the device, its pool rows, their gathered copies and
        the lanes' launch state: the gathered carries and, for a hybrid,
        the shared pages and an ``attn_meta`` whose pad lanes point at
        the trash page with length 0."""
        dev = self.device
        b = width // self.num_shards
        fill = [d * b for d in range(self.num_shards)]
        lanes = {}
        for s in sorted(live_slots):
            d = self._slot_shard(s)
            lanes[s] = fill[d]
            fill[d] += 1
        lo = self._data_rank * b
        idx = np.zeros((b,), np.int64)
        inv = np.zeros((self._per,), np.int64)
        touched = np.zeros((self._per,), bool)
        n_live = 0
        for s, lane in lanes.items():
            if self._owns(s):
                idx[lane - lo], inv[self._row(s)], touched[self._row(s)] = (
                    self._row(s), lane - lo, True)
                n_live += 1
        rows = {"blocks": self.pool["state"]["blocks"], "logits": self.pool["logits"],
                "meta": self.pool["meta"]}
        lane_rows = state_cache.gather_slots(rows, torch.from_numpy(idx).to(dev))
        state = {"blocks": lane_rows["blocks"]}
        if self.hybrid:
            state["attn_blocks"] = self.pool["state"]["attn_blocks"]
            slots = idx + self._slot_base
            tbl = self._page_tbl[slots]
            lengths = self._kv_len[slots]
            tbl[n_live:] = 0
            lengths[n_live:] = 0
            state["attn_meta"] = (torch.from_numpy(self._local_pages(tbl)).to(dev),
                                  torch.from_numpy(lengths).to(dev))
        return (lanes, torch.from_numpy(inv).to(dev), torch.from_numpy(touched).to(dev),
                rows, lane_rows, state)

    def _compact_tick(self, live_slots: list[int], width: int, n_micro: int | None = None):
        """One compacted tick: gather the decodable slots' rows into
        ``width`` lanes (``_gather_lanes``), run the full tick's sub-steps
        at that width and scatter the live lanes back; mid-prefill rows
        are never gathered, so none needs saving.  Pad lanes' table rows
        point at the trash page with length 0, so their KV writes land
        there.

        The launch is made to compute what the full tick computes for
        each live row: every op of the decode step is per row, the page
        table keeps its full width, the paged decode's split rule is
        pinned to a shard's full block (``split_rows``), over the model
        axis every GEMM runs at that block's rows, zero-padded
        (``_gemm_rows``), and no launch goes below ``COMPACT_MIN_LANES``
        rows.  One row-count
        effect remains on the CPU: an elementwise kernel computes the
        scalar tail of a small tensor with other rounding than its vector
        body (the softplus of dt, (lanes, heads), at 24 heads), so a carry
        can differ in its last bit with its lane; the CPU tests hold the
        streams equal at their size, and ``chip_smoke.py`` measures the
        card.
        Returns (tokens, emitted, done) at full width (steps, S)."""
        lanes, inv, touched, rows, lane_rows, state = self._gather_lanes(live_slots, width)
        attn_meta = state.pop("attn_meta", None)
        b = width // self.num_shards
        u = self._uniforms(lanes, width, self._data_rank * b, b)
        logits, step, done, toks, emitted, dones = self._sub_steps(
            state, lane_rows["logits"], lane_rows["meta"], u, attn_meta,
            split_rows=self._per, n_micro=n_micro, gemm_rows=self._gemm_rows)
        state_cache.scatter_slots(
            rows, {"blocks": state["blocks"], "logits": logits,
                   "meta": {**lane_rows["meta"], "step": step, "done": done}}, inv, touched)
        # the one host sync of the tick
        tokens, emitted, done = self._gather_blocks(torch.stack(toks), torch.stack(emitted),
                                                    torch.stack(dones))
        cols = np.fromiter(lanes.keys(), np.int64, len(lanes))
        ls = np.fromiter(lanes.values(), np.int64, len(lanes))
        out = [np.zeros((self.tokens_per_tick, self.capacity), a.dtype)
               for a in (tokens, emitted.astype(bool), done.astype(bool))]
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
        (the tick's one host sync; on a mesh each data rank verifies its
        own block and the matrix is gathered over ``data``) and decide
        per slot.  A full accept commits the launch's carries and final
        logits (the state moved W tokens) and banks the last position's
        argmax as the next pending; a rejection keeps the pre-tick
        carries (``spec_commit``'s per-row select) and banks the accepted
        prefix and the model's correction.  Masked rows (empty,
        mid-prefill, pad lanes) write no KV cell and keep their carries.
        A hybrid's lengths advance by W on full accepts only.  Returns
        (tokens, emitted, done), each (W+1, S)."""
        W, S, dev = self.spec_width, self.capacity, self.device
        live = {s: self._slots[s] for s in live_slots}
        if width is not None:
            lanes, inv, touched, rows, lane_rows, state = self._gather_lanes(live_slots, width)
            n_lanes, n_local = width, width // self.num_shards
        else:
            lanes = {s: s for s in live}
            rows = lane_rows = {"blocks": self.pool["state"]["blocks"],
                                "logits": self.pool["logits"], "meta": self.pool["meta"]}
            state = {"blocks": rows["blocks"]}
            n_lanes, n_local = S, self._per
            if self.hybrid:
                lo = self._slot_base
                state["attn_blocks"] = self.pool["state"]["attn_blocks"]
                state["attn_meta"] = (self._table(slice(lo, lo + n_local)),
                                      torch.tensor(self._kv_len[lo:lo + n_local], device=dev))
        lo = self._data_rank * n_local  # this rank's lanes
        ids = np.zeros((n_lanes, W), np.int64)
        tmask = np.zeros((n_lanes, W), np.float32)
        trusted = {}
        for slot, tracked in live.items():
            ids[lanes[slot]] = self._spec_feed(tracked)
            tmask[lanes[slot]] = 1.0
            trusted[slot] = len(tracked.spec_pending)
        greedy_d, final_logits, new_state, old = spec_decode.spec_verify(
            self._params, state, torch.from_numpy(ids[lo:lo + n_local]).to(dev),
            torch.from_numpy(tmask[lo:lo + n_local]).to(dev), self.cfg,
            adapter_ids=lane_rows["meta"]["adapter_id"] if self.lora else None,
            mesh=self.mesh)
        (greedy,) = self._gather_blocks(greedy_d.t())  # the one host sync
        greedy = greedy.T
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
                                torch.from_numpy(advance[lo:lo + n_local]).to(dev), W)
        if width is not None:
            state_cache.scatter_slots(rows, lane_rows, inv, touched)
        if self.hybrid:
            adv_full = np.zeros((S,), np.int32)
            for slot, lane in lanes.items():
                adv_full[slot] = advance[lane]
            self._kv_len += W * adv_full
        return tokens, emitted, done

    def _pipeline_micro(self, width: int | None) -> int | None:
        """Microbatches of the stage axis's GPipe decode clock for this
        tick's launch, or None for the layer walk (JAX ``engine.py:
        2421-2447``): ``inference/generate.decode_micro``'s rule (a
        pure-SSM stack on a mesh whose only axis above 1 is the stage
        axis, ``stage`` microbatches when the width divides, else 1),
        off under speculation (chunk-shaped launches) and LoRA."""
        if self.spec or self.lora:
            return None
        return decode_micro(self.cfg, self.mesh,
                            self.capacity if width is None else width)

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
        # the stage axis's microbatched decode clock for this launch (None:
        # the layer walk) and its ramp's bill: (stages - 1) idle stage
        # ticks a sub-step, each a microbatch of full-depth lanes
        n_micro = self._pipeline_micro(width)
        bubble_lanes = 0
        if n_micro:
            bubble_lanes = ((self.stage_shards - 1)
                            * ((self.capacity if width is None else width) // n_micro)
                            * self.tokens_per_tick)
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
                tokens, emitted, done = self._tick(live_slots, n_micro)
            else:
                tokens, emitted, done = self._compact_tick(live_slots, width, n_micro)
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
            if self._owns(slot):
                state_cache.evict(self.pool, self._row(slot))
            self._release_pages(slot, tracked)
            self._release_adapter_ref(tracked)
            self._free.append(slot)
            if self.spec:
                self.drafter.forget(tracked.request_id)
            # a hot-swapped stream finishes as its continuation request:
            # the record and result echo what the user submitted
            r = tracked.orig_request or tracked.request
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
            if self.lora and tracked.request.adapter:
                # the adapter the stream finished under (a hot swap's target)
                request_record["adapter"] = tracked.request.adapter
            if tracked.hot_swaps:
                request_record["hot_swaps"] = tracked.hot_swaps
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
            gauges.update(quantized=self._quant_stamp, weight_bytes=self.weight_bytes,
                          page_pool_bytes=self._pool_bytes)
        if self.spec:
            # the window's draft and accept counts and live slot-launches
            # (absent when speculation is off)
            gauges.update(spec_drafted=self._spec_drafted,
                          spec_accepted=self._spec_accepted,
                          spec_streams=self._spec_streams)
            self._spec_drafted = self._spec_accepted = self._spec_streams = 0
        if self.lora:
            # the adapter cache's window churn, residency and the distinct
            # adapters this tick's launch mixed (absent with LoRA off)
            ac = self.adapter_cache
            gauges.update(
                adapters_resident=ac.resident_count,
                adapter_cache_hits=ac.hits - self._ad_hits0,
                adapter_cache_misses=ac.misses - self._ad_misses0,
                adapter_cache_evictions=ac.evictions - self._ad_evictions0,
                adapters_live=len({t.adapter_slot for t in self._slots.values()
                                   if t.status is RequestStatus.DECODE and t.adapter_slot}))
            self._ad_hits0, self._ad_misses0 = ac.hits, ac.misses
            self._ad_evictions0 = ac.evictions
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
            traces=live_traces, preemptions=self._preemptions,
            # mesh stamps only on a mesh's model or stage axis, so other
            # engines' records keep their bytes
            model_shards=self.model_shards if self.model_shards > 1 else None,
            stage_shards=self.stage_shards if self.stage_shards > 1 else None,
            bubble_lanes=bubble_lanes if self.stage_shards > 1 else None,
            # stamped only when nonzero
            tenant_quota_stalls=self._quota_stalls, adapter_hot_swaps=self._hot_swaps,
            **gauges)
        self._preemptions = 0
        self._quota_stalls = 0
        self._hot_swaps = 0
        self._pending_stall_ms = 0.0
        self._pending_chunk_tokens = 0
        self._pending_chunk_real_tokens = 0
        self._pending_chunk_ms = 0.0
        self._pending_oneshot_real_tokens = 0
        self._pending_oneshot_lanes = 0
        return events

    # ------------------------------------------------------------ hot swaps

    def hot_swap_adapter(self, request_id: int, adapter: str | None = None) -> str:
        """Move a live decoding stream to another adapter version
        (default: the latest of its current base) without losing a token.

        The carry was shaped by the old factors, so it goes, once: the
        slot is evicted and its pages and adapter ref released, and the
        stream is requeued as a continuation request whose prompt is the
        original prompt plus every token emitted since the last swap,
        decoding under the new version.  ``tracked.new_tokens`` goes on
        across the swap; ``tracked.orig_request`` keeps what the user
        submitted (for the finish record and result) and ``tracked.
        swap_base`` the tokens emitted at the swap (the continuation's
        step counter restarts at 0).  Returns the adapter now in effect
        (no-op when already there).  Raises ``ValueError`` for a stream
        that is not decoding or holds speculative tokens in flight."""
        if not self.lora:
            raise ValueError(
                "hot_swap_adapter needs multi-tenant LoRA serving "
                "(cfg.lora_max_adapters > 0)")
        tracked = next((t for t in self._slots.values() if t.request_id == request_id),
                       None)
        if tracked is None or tracked.status is not RequestStatus.DECODE:
            raise ValueError(
                f"request {request_id} is not swappable: only a resident "
                f"DECODING stream holds the carry a swap invalidates "
                f"(queued/prefilling streams finish prefill first; retry "
                f"shortly)")
        if self.spec and tracked.spec_pending:
            raise ValueError(
                f"request {request_id} has {len(tracked.spec_pending)} "
                f"speculative draft token(s) in flight; retry after the "
                f"next verify tick drains them")
        r = tracked.request
        old = r.adapter
        if not old:
            raise ValueError(
                f"request {request_id} decodes the base model — there is "
                f"no adapter to swap")
        new = self.adapters.resolve(
            adapter if adapter is not None else self.adapters.latest(old))
        self.adapters.factors(new)  # UnknownAdapterError before any change
        if new == old:
            return old
        slot = tracked.slot
        emitted = len(tracked.new_tokens)
        with self.tracer.span("serving_hot_swap", slot=slot, request=tracked.request_id,
                              trace=tracked.trace_id, adapter=new):
            # the release keys off the old request's adapter: before the
            # request changes
            if self._owns(slot):
                state_cache.evict(self.pool, self._row(slot))
            self._release_pages(slot, tracked)
            self._release_adapter_ref(tracked)
            del self._slots[slot]
            self._free.append(slot)
            self._free.sort()
            if tracked.orig_request is None:
                tracked.orig_request = r
            tracked.request = dataclasses.replace(
                r,
                prompt_ids=np.concatenate([
                    np.asarray(r.prompt_ids, np.int64),
                    np.asarray(tracked.new_tokens[tracked.swap_base:], np.int64)]),
                max_new_tokens=r.max_new_tokens - (emitted - tracked.swap_base),
                adapter=new)
            tracked.swap_base = emitted
            tracked.hot_swaps += 1
            self._hot_swaps += 1
            self.metrics.record_hot_swap()
            # the continuation prefills again through admission (prefix-
            # warm under the new version's salt where it can)
            self.scheduler.requeue(tracked)
        return new

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
