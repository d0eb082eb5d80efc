"""Speculative decoding on the chunk machinery: K-token draft-verify
(counterpart of ``mamba_distributed_tpu/serving/spec_decode.py``).

Decode reads every weight to emit one token per slot.  The chunk step
that prefills a prompt already pushes a chunk of tokens through the
conv/SSM carries and the paged KV write in one launch, and
``models/lm.lm_verify_chunk`` is that step with the logits of every
position: the verifier.  A drafter proposes K guesses, one launch scores
all K+1 fed positions, and the longest correct prefix commits, so a
launch commits up to K+2 tokens.

Greedy only, and lossless: an accepted draft is the token argmax would
have emitted, and a rejected one is replaced by the model's own argmax,
so the streams are those of greedy decoding whatever the drafter
proposes (the drafter only moves the acceptance rate).

The pending-token scheme (rollback costs a select, not a recompute):

* each stream carries ``pending``, tokens already committed to its
  output but not yet folded into the device state;
* a verify tick feeds ``pending + drafts`` (static width W = K+1): the
  pending tokens are trusted, each draft is checked against the argmax
  after the position before it;
* when every fed token verifies, the launch's carries commit as they are
  (the state moved W tokens) and the last position's argmax is a bonus
  token, the new one-token pending;
* at the first rejection the row keeps its pre-tick carries (a per-row
  ``torch.where``, ``spec_commit``), and the accepted prefix plus the
  model's correction become the new pending, fed again as trusted
  tokens next tick: every launch commits at least one token.

The JAX step donates its state; the port's chunk step never writes its
input carries (models/lm.lm_prefill_chunk), so the pre-tick conv and SSM
carries stay alive as ``old`` while the verify runs.  Hybrid stacks need
no KV rollback: the verify writes the fed tokens' K/V in place at
``[lengths, lengths + W)``, and a rejected tick does not advance the
host's lengths, so those cells are dead and the next verify writes them
again.  In spec mode the engine's page table carries one more column
that always names the trash page, so a fully reserved slot's overshoot
lands there and never on a live page.

Drafters: ``NGramDrafter`` (prompt lookup over the stream's own history)
and ``ModelDrafter`` (a small pure-SSM companion model's greedy rollout).
Both are deterministic, so the engine and ``spec_generate`` speculate
alike: the same drafts, the same accept pattern, the same streams.

``TRACE_COUNTS`` counts calls of each step (the JAX package counts jit
traces; the port runs eagerly and has none to count).
"""

from __future__ import annotations

import numpy as np
import torch

from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.inference.bucketing import next_pow2_bucket, pad_to_bucket
from mamba_distributed_tpu_torch.inference.generate import _pad_rows, vocab_pad_mask
from mamba_distributed_tpu_torch.models.lm import lm_prefill, lm_step, lm_verify_chunk
from mamba_distributed_tpu_torch.ops.dispatch import check_kernel_shapes
from mamba_distributed_tpu_torch.serving.prefill import (
    cast_decode_params,
    chunked_prefill,
    plan_chunks,
)

# calls of each step: the verify and commit of the engine and
# spec_generate, spec_generate's one-shot prefill, and the companion
# model's prefill, step and rollout
TRACE_COUNTS = {
    "verify": 0,
    "commit": 0,
    "prefill": 0,
    "draft_prefill": 0,
    "draft_step": 0,
    "draft_rollout": 0,
}


# ------------------------------------------------------------ device steps


def spec_verify(params: dict, state: dict, ids: torch.Tensor, token_mask: torch.Tensor,
                cfg: ModelConfig):
    """The verify launch: feed every row's ``ids`` (b, W) through
    ``lm_verify_chunk`` from ``state`` and score all W positions.

    ``token_mask`` rows are all 1 for live rows and all 0 for masked ones
    (empty, done, mid-prefill or pad rows): a masked row writes no KV
    cell, and ``spec_commit`` discards its carries.  ``state``'s carries
    are not written; a hybrid's pages are, in place.

    Returns ``(greedy (b, W) int64, final_logits (b, V) fp32, new_state,
    old)``: ``greedy[:, i]`` is the argmax over the real vocab after fed
    token i (the whole accept/reject input, fetched once by the caller),
    ``old`` the pre-tick ``{"blocks"}`` (and a hybrid's ``attn_meta``)."""
    TRACE_COUNTS["verify"] += 1
    old = {"blocks": state["blocks"]}
    if "attn_meta" in state:
        old["attn_meta"] = state["attn_meta"]
    pos_logits, new_state = lm_verify_chunk(params, cfg, ids, state, token_mask=token_mask)
    pad_mask = vocab_pad_mask(cfg, pos_logits.device)
    greedy = torch.argmax(pos_logits + pad_mask[None, None, :], dim=-1)
    return greedy, pos_logits[:, -1], new_state, old


def spec_commit(new_state: dict, old_blocks: tuple, logits: torch.Tensor, meta: dict,
                final_logits: torch.Tensor, advance: torch.Tensor, width: int) -> dict:
    """Per-row accept/rollback select, IN PLACE: rows with ``advance``
    take the verify's carries and final logits (their state moved
    ``width`` tokens) and step ``width`` further; the other rows keep
    ``old_blocks``, ``logits`` and their step bit for bit.  Hybrid pages
    always ride forward from ``new_state`` (written in place; a rejected
    row's cells are dead by its length).  Returns the reassembled
    ``{"state", "logits", "meta"}`` over the same tensors."""
    TRACE_COUNTS["commit"] += 1

    def keep(n, o):
        o.copy_(torch.where(advance.reshape((1, -1) + (1,) * (n.ndim - 2)), n, o))
        return o

    blocks = tuple(keep(n, o) for n, o in zip(new_state["blocks"], old_blocks))
    logits.copy_(torch.where(advance[:, None], final_logits, logits))
    meta["step"] += advance.to(meta["step"].dtype) * width
    return {"state": {**new_state, "blocks": blocks}, "logits": logits, "meta": meta}


# -------------------------------------------------------------- host logic


def greedy_token(logits, vocab_size: int) -> int:
    """argmax of one logits row over the real vocab columns (padding
    columns must not win), ties to the lowest index: the token a greedy
    (top_k=1) sampler emits."""
    row = np.asarray(torch.as_tensor(logits).float().cpu()).reshape(-1)
    return int(np.argmax(row[:vocab_size]))


def verify_greedy(fed, greedy, n_trusted: int):
    """The accept/rollback decision for one stream.

    ``fed`` (W,) are the tick's fed tokens, the first ``n_trusted``
    committed (pending) ones, the rest drafts; ``greedy`` (W,) the
    model's argmaxes, ``greedy[i]`` scoring the position after
    ``fed[i]``.  Draft ``fed[i]`` is correct iff it equals
    ``greedy[i-1]`` and every earlier draft was.

    Returns ``(accepted, advance, next_token)``: the accepted draft
    count, whether every fed token verified (the state commits), and the
    model's token after the last valid fed position (the bonus on a full
    accept, the correction at the first rejection).  ``n_trusted >= 1``
    always, so the index is in range.  The engine and ``spec_generate``
    share this one rule."""
    a = 0
    for i in range(n_trusted, len(fed)):
        if int(fed[i]) == int(greedy[i - 1]):
            a += 1
        else:
            break
    advance = n_trusted + a == len(fed)
    return a, advance, int(greedy[n_trusted + a - 1])


def build_feed(pending, drafts, width: int):
    """One verify row: pending (trusted) + drafts, zero-filled to
    ``width``.  Fill tokens are drafts like any other (almost always
    rejected), so a short draft needs no mask (masking a suffix would
    corrupt the conv carry; the chunk step takes left pads only)."""
    fed = [int(t) for t in pending] + [int(t) for t in drafts]
    fed = fed[:width]
    fed += [0] * (width - len(fed))
    return fed


# ---------------------------------------------------------------- drafters


class Drafter:
    """Draft-token source.  One drafter serves many streams (keyed by an
    opaque stream id); every method runs on the host.

    ``observe(stream, tokens)`` appends committed tokens (the prompt
    first, then emissions) to the stream's history; ``draft(stream, n)``
    proposes up to ``n`` continuation guesses (fewer, or none, is always
    legal: correctness never depends on them); ``forget(stream)`` drops
    the stream's state."""

    def observe(self, stream, tokens) -> None:  # pragma: no cover
        raise NotImplementedError

    def draft(self, stream, n: int) -> list:  # pragma: no cover
        raise NotImplementedError

    def forget(self, stream) -> None:  # pragma: no cover
        raise NotImplementedError


class NGramDrafter(Drafter):
    """Prompt-lookup drafting: match the stream's trailing ``order``-gram
    (falling back to shorter ones) against its own history and propose
    the tokens that followed its most recent earlier occurrence with a
    full ``n``-token continuation (else the longest one).  No model
    cost; strong on repetitive text, code and the cycles greedy decoding
    falls into."""

    def __init__(self, order: int = 3):
        if order < 1:
            raise ValueError(f"order must be >= 1, got {order}")
        self.order = order
        self._hist: dict = {}

    def observe(self, stream, tokens) -> None:
        self._hist.setdefault(stream, []).extend(int(t) for t in tokens)

    def draft(self, stream, n: int) -> list:
        h = self._hist.get(stream)
        if n <= 0 or h is None or len(h) < 2:
            return []
        arr = np.asarray(h, np.int64)
        for k in range(min(self.order, arr.size - 1), 0, -1):
            pat = arr[-k:]
            # windows over arr[:-1]: every match ends before the last
            # token, so it has a continuation and is never the suffix
            win = np.lib.stride_tricks.sliding_window_view(arr[:-1], k)
            hits = np.nonzero((win == pat).all(axis=1))[0]
            if hits.size:
                cont = np.minimum(n, arr.size - (hits + k))
                full = hits[cont >= n]
                i = int(full[-1]) if full.size else int(
                    hits[len(hits) - 1 - np.argmax(cont[::-1])])
                return arr[i + k:i + k + n].tolist()
        return []

    def forget(self, stream) -> None:
        self._hist.pop(stream, None)


def _params_device(params: dict) -> torch.device:
    return params["norm_f"]["weight"].device  # the embedding may be int8 codes + scales


class ModelDrafter(Drafter):
    """Companion-model drafting: a small pure-SSM LM (its own params and
    config, O(1) state per stream) shadows each stream through
    ``lm_prefill``/``lm_step``, and its drafts are a greedy rollout from
    the stream's last committed token.  The rollout runs from a copy of
    the stored state, which it never writes (drafting must not commit):
    a draft costs K small-model steps and one host fetch."""

    def __init__(self, params: dict, cfg: ModelConfig):
        if cfg.attn_layer_idx:
            raise ValueError(
                "ModelDrafter companions are pure-SSM (an O(1)-state "
                "shadow per stream); hybrid draft configs would need "
                "their own paged KV plumbing"
            )
        self.cfg = cfg
        self.params = cast_decode_params(params, cfg)
        self._device = _params_device(self.params)
        self._pad_mask = vocab_pad_mask(cfg, self._device)
        self._streams: dict = {}

    @torch.no_grad()
    def observe(self, stream, tokens) -> None:
        toks = [int(t) for t in tokens]
        if not toks:
            return
        st = self._streams.get(stream)
        if st is None:
            # the first observation is the prompt (and anything already
            # emitted): one bucketed prefill, not len(toks) steps
            TRACE_COUNTS["draft_prefill"] += 1
            ids = torch.tensor([toks], dtype=torch.int64, device=self._device)
            padded, mask = pad_to_bucket(ids, next_pow2_bucket(len(toks)))
            logits, state = lm_prefill(self.params, self.cfg, padded, token_mask=mask)
            self._streams[stream] = {"state": state, "logits": logits}
            return
        for t in toks:
            TRACE_COUNTS["draft_step"] += 1
            # lm_step advances the stored state in place: observing commits
            st["logits"], st["state"] = lm_step(
                self.params, self.cfg, st["state"],
                torch.tensor([t], dtype=torch.int64, device=self._device))

    @torch.no_grad()
    def draft(self, stream, n: int) -> list:
        st = self._streams.get(stream)
        if st is None or n <= 0:
            return []
        TRACE_COUNTS["draft_rollout"] += 1
        state = {"blocks": tuple(t.clone() for t in st["state"]["blocks"])}
        logits, toks = st["logits"], []
        for i in range(n):
            tok = torch.argmax(logits + self._pad_mask[None, :], dim=-1)
            toks.append(tok)
            if i + 1 < n:
                logits, state = lm_step(self.params, self.cfg, state, tok)
        return torch.cat(toks).tolist()

    def forget(self, stream) -> None:
        self._streams.pop(stream, None)


def make_drafter(cfg: ModelConfig) -> Drafter:
    """The drafter ``cfg`` asks for when none was passed.  ``"model"``
    cannot be built from the config alone (the companion's params are
    not derivable from it): the error says so."""
    if cfg.spec_drafter == "model":
        raise ValueError(
            "spec_drafter='model' needs an explicit drafter instance — "
            "the companion model's params are not derivable from the "
            "config; pass drafter=ModelDrafter(draft_params, draft_cfg) "
            "or set spec_drafter='ngram'"
        )
    return NGramDrafter(cfg.spec_ngram_order)


# ------------------------------------------------------ generate()'s path


def spec_page_len(cfg: ModelConfig, need: int) -> int:
    """KV capacity (tokens) of ``spec_generate``'s private hybrid cache:
    the request's ``need`` (prompt + budget + the last verify's
    overshoot), and at least the spec engine's table width
    (``kv_pages_per_slot`` + its trash column), so that both reduce over
    tables of one width and their streams agree bit for bit."""
    return max(need, (cfg.kv_pages_per_slot + 1) * cfg.kv_page_tokens)


@torch.no_grad()
def spec_generate(params: dict, cfg: ModelConfig, prompt_ids, max_new_tokens: int = 32,
                  eos_id: int | None = None, prefix_cache=None,
                  drafter: Drafter | None = None, decode_rows: int | None = None):
    """The solo ``generate()`` speculative path (batch 1, greedy): the
    draft -> verify -> accept/rollback loop of the engine's spec tick,
    with the same prefill layouts, the same ``spec_verify`` and the same
    ``verify_greedy``, so its stream equals the engine's when both use
    the same deterministic drafter.  ``decode_rows`` pads the verify
    batch with masked rows (as ``generate(decode_rows=)`` pads decode):
    ``decode_rows=capacity`` runs every launch at the engine's row count.

    Returns (1, t + max_new_tokens) int64 on the params' device; with
    ``eos_id`` set, the suffix past an emitted eos repeats it."""
    dev = _params_device(params)
    prompt = np.asarray(torch.as_tensor(prompt_ids).cpu(), np.int64)
    if prompt.ndim == 1:
        prompt = prompt[None, :]
    if prompt.shape[0] != 1:
        raise ValueError("spec_generate is batch-1 (the serving engine "
                         "is the batched speculative path)")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if dev.type == "cuda":
        check_kernel_shapes(cfg)
    t = prompt.shape[1]
    hybrid = bool(cfg.attn_layer_idx)
    W = cfg.spec_tokens + 1
    dparams = cast_decode_params(params, cfg)
    plan = plan_chunks(t, cfg.effective_prefill_chunk_tokens, force=hybrid)
    if hybrid:
        # the capacity covers prompt + budget + the verify overshoot (the
        # last tick may feed W tokens past the budget: they must land in
        # allocated dead cells, never clamp onto a live one)
        logits, state = chunked_prefill(
            dparams, cfg, prompt, max_len=spec_page_len(cfg, t + max_new_tokens + W))
    elif plan is not None:
        logits, state = chunked_prefill(dparams, cfg, prompt, prefix_cache=prefix_cache)
    else:
        hit = prefix_cache.lookup(prompt[0], None) if prefix_cache is not None else None
        if hit is not None:
            entry = hit[0]
            logits, state = entry.logits, {"blocks": entry.state["blocks"]}
        else:
            TRACE_COUNTS["prefill"] += 1
            ids, mask = pad_to_bucket(torch.from_numpy(prompt).to(dev), next_pow2_bucket(t))
            logits, state = lm_prefill(dparams, cfg, ids, token_mask=mask)
    # the commit writes the carries in place, and a cache entry's (or a
    # chunked prefill's stored) carry must live on: work on a copy
    state = {**state, "blocks": tuple(x.clone() for x in state["blocks"])}
    rows = max(decode_rows or 1, 1)
    state, logits = _pad_rows(state, logits.clone(), rows)
    meta = {"step": torch.zeros((rows,), dtype=torch.int64, device=dev)}
    tmask = torch.zeros((rows, W), dtype=torch.float32, device=dev)
    tmask[0] = 1.0

    if drafter is None:
        drafter = make_drafter(cfg)
    sid = object()  # a private stream key: never collides across calls

    pending = [greedy_token(logits[0], cfg.vocab_size)]
    pending_emitted = 0
    emitted: list[int] = []
    observed = 0
    finished = False
    while not finished:
        # the drafter sees prompt + emitted + the unemitted pending: the
        # engine's observation rule, so the drafts, the accept pattern
        # and the streams are the engine's
        hist = prompt[0].tolist() + emitted + pending[pending_emitted:]
        if len(hist) > observed:
            drafter.observe(sid, hist[observed:])
            observed = len(hist)
        n = W - len(pending)
        drafts = list(drafter.draft(sid, n))[:n] if n > 0 else []
        fed = build_feed(pending, drafts, W)
        ids = torch.zeros((rows, W), dtype=torch.int64)
        ids[0] = torch.tensor(fed)
        greedy_d, final_logits, new_state, old = spec_verify(
            dparams, state, ids.to(dev), tmask, cfg)
        a, advance, nxt = verify_greedy(fed, greedy_d[0].tolist(), len(pending))
        stream = pending[pending_emitted:] + fed[len(pending):len(pending) + a] + [nxt]
        for tok in stream:
            emitted.append(tok)
            if (eos_id is not None and tok == eos_id) or len(emitted) >= max_new_tokens:
                finished = True
                break
        if finished:
            break
        adv = torch.zeros((rows,), dtype=torch.bool)
        adv[0] = advance
        committed = spec_commit(new_state, old["blocks"], logits, meta, final_logits,
                                adv.to(dev), W)
        state = committed["state"]
        if hybrid:
            # the lengths advance by the chunk width on a full accept only
            state["attn_meta"] = (old["attn_meta"][0],
                                  old["attn_meta"][1] + W * adv.to(dev, torch.int32))
        if advance:
            pending, pending_emitted = [nxt], 1
        else:
            pending = pending + fed[len(pending):len(pending) + a] + [nxt]
            pending_emitted = len(pending)
    drafter.forget(sid)
    if eos_id is not None:
        emitted += [eos_id] * (max_new_tokens - len(emitted))
    out = np.concatenate([prompt[0], np.asarray(emitted[:max_new_tokens], np.int64)])
    return torch.from_numpy(out)[None].to(dev)
