"""Chunked prefill: plan, chunk step, whole-prompt loop (counterpart of
``mamba_distributed_tpu/serving/prefill.py``).

Prompts longer than ``cfg.effective_prefill_chunk_tokens`` pad LEFT to a
multiple of the chunk (the pad lies inside chunk 0, under the usual
``token_mask``) and run as a sequence of fixed-shape chunk steps, each
resuming from the previous chunk's conv/SSM carry.  The serving engine
drives the same step chunk by chunk between decode ticks; ``generate()``
drives it through ``chunked_prefill``.  Both run the same step over the
same layout with the same decode-cast params, so their states, and so
their token streams, agree bit for bit.

Hybrid stacks plan EVERY prompt as chunks (``plan_chunks(force=True)``):
the chunk step is the one prefill that writes straight into the paged KV
cache and never writes pad keys.  Its pages are updated in place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.inference.bucketing import (
    chunk_aligned_bucket,
    use_chunked_prefill,
)
from mamba_distributed_tpu_torch.inference.generate import _decode_params
from mamba_distributed_tpu_torch.models.attention import attention_page_count
from mamba_distributed_tpu_torch.models.lm import init_lm_state, lm_prefill_chunk


def cast_decode_params(params: dict, cfg: ModelConfig) -> dict:
    """The decode-layout cast shared by the engine and ``generate()``."""
    return _decode_params(params, cfg)


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """How one prompt splits into prefill chunks."""

    prompt_len: int
    chunk: int  # tokens per chunk (cfg.effective_prefill_chunk_tokens)
    bucket: int  # padded length = n_chunks * chunk
    n_chunks: int

    @property
    def pad(self) -> int:
        """Left-pad tokens (all inside chunk 0)."""
        return self.bucket - self.prompt_len

    def real_tokens(self, i: int) -> int:
        """Non-pad prompt tokens in chunk ``i`` (what advances a hybrid's
        KV length)."""
        return self.chunk - (self.pad if i == 0 else 0)


def plan_chunks(prompt_len: int, chunk_tokens: int,
                force: bool = False) -> ChunkPlan | None:
    """The chunk plan, or None when the prompt takes the one-shot pow2
    path (too short to chunk, or chunking disabled).  ``force`` plans a
    prompt that fits one chunk too (the hybrid path)."""
    if not use_chunked_prefill(prompt_len, chunk_tokens):
        if not (force and chunk_tokens > 0):
            return None
    bucket = chunk_aligned_bucket(prompt_len, chunk_tokens)
    return ChunkPlan(prompt_len=prompt_len, chunk=chunk_tokens, bucket=bucket,
                     n_chunks=bucket // chunk_tokens)


def chunk_inputs(prompt_ids, plan: ChunkPlan, i: int, device=None):
    """ids (b, chunk) int64 + mask (b, chunk) fp32 {0,1} of chunk ``i``
    of the left-padded layout (pads hold id 0 and mask 0)."""
    if not 0 <= i < plan.n_chunks:
        raise ValueError(f"chunk {i} out of range [0, {plan.n_chunks})")
    ids = np.asarray(torch.as_tensor(prompt_ids).cpu(), np.int64)
    if ids.ndim == 1:
        ids = ids[None, :]
    b, t = ids.shape
    if t != plan.prompt_len:
        raise ValueError(f"prompt length {t} != plan.prompt_len {plan.prompt_len}")
    lo, hi = i * plan.chunk, (i + 1) * plan.chunk  # padded coordinates
    pad = plan.pad
    out = np.zeros((b, plan.chunk), np.int64)
    mask = np.zeros((b, plan.chunk), np.float32)
    src_lo, src_hi = max(lo, pad) - pad, hi - pad
    dst_lo = max(lo, pad) - lo
    out[:, dst_lo:] = ids[:, src_lo:src_hi]
    mask[:, dst_lo:] = 1.0
    return torch.from_numpy(out).to(device), torch.from_numpy(mask).to(device)


def prefill_chunk(params: dict, ids, mask, state: dict, cfg: ModelConfig):
    """The chunk step: (ids, mask, carry) -> (last logits, carry').
    ``params`` must already be decode-cast (``cast_decode_params``).  A
    hybrid carry's KV pages are written in place."""
    return lm_prefill_chunk(params, cfg, ids, state, token_mask=mask)


def private_page_count(cfg: ModelConfig, max_len: int) -> int:
    """Page-table width of a private (``generate()``) hybrid cache: the
    serving slot's full ``kv_pages_per_slot``, or more when ``max_len``
    needs it.  The engine's tick always passes that full width, and the
    plain attention reduces over the table's whole width, so equal
    widths keep the two sides' streams bit-identical."""
    return max(cfg.kv_pages_per_slot, attention_page_count(cfg, max_len))


def _clone_blocks(blocks) -> tuple:
    return tuple(t.clone() for t in blocks)


@torch.no_grad()
def chunked_prefill(params: dict, cfg: ModelConfig, prompt_ids,
                    plan: ChunkPlan | None = None, max_len: int = 0,
                    prefix_cache=None):
    """Drive a whole prompt through the chunk step (the solo
    ``generate()`` path; the engine paces the same loop itself).
    ``params`` must already be decode-cast.  For hybrid stacks
    ``max_len`` (prompt + decode budget) sizes the private paged KV
    cache.  Returns (last_logits (b, V) fp32, state).

    ``prefix_cache`` (a serving/prefix_cache.PrefixCache; batch-1
    pure-SSM prompts only: hybrid entries pin a serving engine's pages)
    reuses and refreshes carry snapshots.  A full hit returns the cached
    logits and a clone of the cached state with no chunk step; a partial
    hit resumes from the deepest cached boundary carry (the chunk step
    does not write its input carry); each chunk stores its boundary, and
    the last also the full entry.  The returned state is decoded in
    place by the caller, so the last chunk's carry is stored as a clone.
    Cached carries are outputs of this exact layout's chunk steps, so
    warm results are bit-identical to cold ones, and to a cache-enabled
    engine's."""
    dev = params["norm_f"]["weight"].device  # the embedding may be int8 codes + scales
    prompt = torch.as_tensor(prompt_ids, dtype=torch.int64)
    if prompt.ndim == 1:
        prompt = prompt[None, :]
    b, t = prompt.shape
    hybrid = bool(cfg.attn_layer_idx)
    if plan is None:
        plan = plan_chunks(t, cfg.effective_prefill_chunk_tokens, force=hybrid)
    if plan is None:
        raise ValueError(
            f"prompt length {t} does not take the chunked path "
            f"(prefill_chunk_tokens={cfg.effective_prefill_chunk_tokens}); "
            f"use lm_prefill over the pow2 bucket instead"
        )
    if hybrid and max_len < t:
        raise ValueError(
            f"hybrid chunked prefill needs KV capacity for the whole "
            f"request: max_len={max_len} < prompt length {t}"
        )
    pages = private_page_count(cfg, max_len) if hybrid else 0
    state = init_lm_state(cfg, batch=b, max_len=pages * cfg.kv_page_tokens, device=dev)
    use_cache = prefix_cache is not None and not hybrid and b == 1
    start = 0
    if use_cache:
        hit = prefix_cache.lookup(prompt[0].numpy(), plan)
        if hit is not None:
            entry, start = hit
            if start == plan.n_chunks:
                return entry.logits, {"blocks": _clone_blocks(entry.state["blocks"])}
            state = {"blocks": entry.state["blocks"]}
    logits = None
    for i in range(start, plan.n_chunks):
        ids, mask = chunk_inputs(prompt, plan, i, device=dev)
        logits, state = prefill_chunk(params, ids, mask, state, cfg)
        if use_cache:
            last = i == plan.n_chunks - 1
            keep = {"blocks": _clone_blocks(state["blocks"]) if last else state["blocks"]}
            prefix_cache.maybe_store_boundary(prompt[0].numpy(), plan, i, keep)
            if last:
                prefix_cache.maybe_store_full(prompt[0].numpy(), keep, logits,
                                              chunk=plan.chunk, chunks=plan.n_chunks)
    return logits, state
