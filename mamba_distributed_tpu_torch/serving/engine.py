"""Continuous-batching serving engine over the pooled recurrent-state cache
(counterpart of the core of ``mamba_distributed_tpu/serving/engine.py``).

Each ``step()`` first admits queued requests into free slots (FCFS):
prompts up to ``cfg.effective_prefill_chunk_tokens`` prefill one-shot
over their pow2 bucket right there; longer ones park a zero carry in
their slot and prefill chunk by chunk, at most
``prefill_tokens_per_tick`` chunk tokens per step (at least one chunk),
round-robin across concurrent long prompts.

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

Left out of the port for now: prefix cache and copy-on-write pages,
adapters, speculative decoding, preemption and priorities, migration,
tick compaction, meshes and sharded page pools, the int8 telemetry,
metrics and the tracer.
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
from mamba_distributed_tpu_torch.ops.dispatch import check_kernel_shapes
from mamba_distributed_tpu_torch.serving import state_cache
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


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class ServingEngine:
    """Continuous-batching host loop: FCFS admission -> ticks.

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
    """

    def __init__(self, params: dict, cfg: ModelConfig, capacity: int = 8,
                 max_top_k: int = 50, tokens_per_tick: int = 8,
                 prefill_tokens_per_tick: int | None = None, device=None):
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
        self.hybrid = bool(cfg.attn_layer_idx)
        if self.hybrid:
            self.page_pool = state_cache.PagePool(
                state_cache.hybrid_pool_pages(cfg, capacity))
            # host-owned paged-KV metadata: each slot's page-table row
            # (unreserved entries name the trash page 0) and KV length
            self._page_tbl = np.zeros((capacity, cfg.kv_pages_per_slot), np.int32)
            self._kv_len = np.zeros((capacity,), np.int32)
        self._pad_mask = vocab_pad_mask(cfg, device)
        self.scheduler = FCFSScheduler()
        self._free: list[int] = list(range(capacity))
        self._slots: dict[int, _Tracked] = {}
        # slots holding a partial chunked prefill, in grant rotation order
        self._prefill_queue: list[int] = []
        self.results: dict[int, GenerationResult] = {}

    # ------------------------------------------------------------ admission

    def submit(self, request: GenerationRequest) -> int:
        """Queue a request; returns its request_id."""
        if not 1 <= request.top_k <= self.max_top_k:
            raise ValueError(
                f"request top_k={request.top_k} must be in "
                f"[1, max_top_k={self.max_top_k}]")
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
        tracked.pages = None
        self._page_tbl[slot] = 0
        self._kv_len[slot] = 0

    def _admit(self, tracked: _Tracked) -> bool:
        """Grant the next queued request a slot: a short pure-SSM prompt
        prefills one-shot here; a long one (and every hybrid one) parks a
        zero carry and prefills in the chunk budget
        (``_advance_prefill``).  Returns False, with the request back at
        the head of the queue, when a hybrid request's pages do not fit
        the free pool yet."""
        r = tracked.request
        plan = plan_chunks(len(r.prompt_ids), self.cfg.effective_prefill_chunk_tokens,
                           force=self.hybrid)
        n_pages = 0
        if self.hybrid:
            n_pages = attention_page_count(self.cfg, len(r.prompt_ids) + r.max_new_tokens)
            if n_pages > self.page_pool.free_pages:
                self.scheduler.requeue(tracked)
                return False
        slot = self._free.pop(0)
        tracked.status = RequestStatus.PREFILL
        try:
            if plan is None:
                prompt = torch.as_tensor(r.prompt_ids, dtype=torch.int64,
                                         device=self.device)[None]
                ids, mask = pad_to_bucket(prompt, next_pow2_bucket(prompt.shape[1]))
                logits, state = lm_prefill(self._params, self.cfg, ids, token_mask=mask)
                state_cache.insert(self.pool, slot, state, logits, **self._slot_meta(r))
            else:
                tracked.plan = plan
                tracked.chunks_done = 0
                if self.hybrid:
                    tracked.pages = self.page_pool.alloc(n_pages)
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
        tracked.t_admit = time.perf_counter()
        tracked.slot = slot
        self._slots[slot] = tracked
        if plan is None:
            tracked.status = RequestStatus.DECODE
        else:
            self._prefill_queue.append(slot)
        return True

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
            ids, mask = chunk_inputs(r.prompt_ids, plan, tracked.chunks_done,
                                     device=self.device)
            logits, state = prefill_chunk(self._params, ids, mask, state, self.cfg)
            if self.hybrid:
                # the left pad of chunk 0 is never written
                self._kv_len[slot] += plan.real_tokens(tracked.chunks_done)
            tracked.chunks_done += 1
            self._prefill_queue.remove(slot)
            if tracked.chunks_done == plan.n_chunks:
                state_cache.finish_prefill(self.pool, slot, state, logits)
                tracked.status = RequestStatus.DECODE
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

    def _prefill_phase(self) -> None:
        while self._free and self.scheduler.depth:
            if not self._admit(self.scheduler.pop()):
                break  # the queue head waits for pages
        budget = self.prefill_tokens_per_tick
        left = float("inf") if budget == 0 else float(budget)
        chunks_run = 0
        while self._prefill_queue and (left > 0 or chunks_run == 0):
            left = self._advance_prefill(self._prefill_queue[0], left)
            chunks_run += 1

    # ------------------------------------------------------------- decoding

    @property
    def pending(self) -> int:
        """Requests not yet finished (queued + in flight)."""
        return self.scheduler.depth + len(self._slots)

    def _tick(self):
        """Advance every decodable slot ``tokens_per_tick`` tokens.
        Returns host arrays (tokens, emitted, done), each (steps, S)."""
        S, steps, dev = self.capacity, self.tokens_per_tick, self.device
        pool, meta = self.pool, self.pool["meta"]
        # the draws of this tick: slot s's sub-step j samples token
        # len(new_tokens) + j of its request (it stays live until done)
        u = np.full((steps, S), 0.5, np.float32)
        for s, t in self._slots.items():
            if t.status is RequestStatus.DECODE:
                n0 = len(t.new_tokens)
                u[:, s] = [step_uniform(t.request.seed, n0 + j) for j in range(steps)]
        u = torch.from_numpy(u).to(dev)
        # lm_step updates the pool's state rows in place; a prefilling
        # slot's rows hold a real carry, so save and restore them
        held = sorted(self._prefill_queue)
        if held:
            idx = torch.tensor(held, device=dev)
            saved = [t.index_select(1, idx) for t in pool["state"]["blocks"]]
        if self.hybrid:
            # the full kv_pages_per_slot width, not a bucket of the live
            # extent: the kernel walks only pages below each row's length,
            # so a wide table costs nothing on the card, and a fixed width
            # keeps the tick's shapes static.  generate() sizes its private
            # table to the same width, so the plain version reduces over
            # the same width on both sides and streams stay bit-identical.
            tbl = torch.tensor(self._page_tbl, device=dev)
            lengths = torch.tensor(self._kv_len, device=dev)
        logits = pool["logits"]
        has_eos = meta["eos_id"] >= 0
        step, done = meta["step"], meta["done"]
        toks, emitted, dones = [], [], []
        for j in range(steps):
            live = meta["active"] & ~done & ~meta["prefilling"]
            tok = top_k_sample(logits + self._pad_mask, u[j], self.max_top_k,
                               meta["temperature"], meta["top_k"])
            tok = torch.where(done & has_eos, meta["eos_id"], tok)
            if self.hybrid:
                # rows that are not live (empty, done, prefilling) write
                # the trash page only and keep their length
                state = {**pool["state"], "attn_meta": (tbl, lengths)}
                logits, state = lm_step(self._params, self.cfg, state, tok,
                                        write_mask=live)
                lengths = state["attn_meta"][1]
            else:
                logits, _ = lm_step(self._params, self.cfg, pool["state"], tok)
            step = step + live
            done = done | (live & ((has_eos & (tok == meta["eos_id"]))
                                   | (step >= meta["max_new"])))
            toks.append(tok)
            emitted.append(live)
            dones.append(done)
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

    @torch.no_grad()
    def step(self) -> list[TokenEvent]:
        """One engine iteration: prefill phase, then one tick.  Returns the
        tick's TokenEvents in emission order (none while only partial
        prefills are resident); finished requests are evicted and their
        results kept in ``self.results``."""
        self._prefill_phase()
        if not any(t.status is RequestStatus.DECODE for t in self._slots.values()):
            return []
        tokens, emitted, done = self._tick()
        t_now = time.perf_counter()
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
        for slot, tracked in self._slots.items():
            if emitted[:, slot].any():
                if tracked.t_first_token is None:
                    tracked.t_first_token = t_now
                tracked.t_last_token = t_now
        for slot in [s for s, t in self._slots.items()
                     if t.status is RequestStatus.FINISHED]:
            tracked = self._slots.pop(slot)
            state_cache.evict(self.pool, slot)
            self._release_pages(slot, tracked)
            self._free.append(slot)
            r = tracked.request
            self.results[tracked.request_id] = GenerationResult(
                request_id=tracked.request_id, prompt_ids=r.prompt_ids,
                new_tokens=np.asarray(tracked.new_tokens, np.int64),
                finish_reason=tracked.finish_reason)
        self._free.sort()
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
