"""Request lifecycle + priority-FCFS admission for the serving engine
(counterpart of ``mamba_distributed_tpu/serving/scheduler.py``, without
adapters and tenant quotas).

A request moves QUEUED -> PREFILL -> DECODE -> FINISHED:

  QUEUED    in the queue, waiting for a free slot (a preempted request
            waits here too, holding its swap-out snapshot)
  PREFILL   building its recurrent state chunk by chunk across ticks
  DECODE    occupying a slot; one token per tick sub-step
  FINISHED  sampled its ``eos_id`` or exhausted ``max_new_tokens``
"""

from __future__ import annotations

import dataclasses
import enum
import time
from collections import deque
from typing import Iterator

import numpy as np

from mamba_distributed_tpu_torch.obs.context import mint_trace_id


class RequestStatus(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"


@dataclasses.dataclass
class GenerationRequest:
    """One generation job.  ``seed`` fixes the sampling draws: a solo
    ``generate(..., seed=seed)`` reproduces this request's tokens (the
    engine parity contract, serving/engine.py)."""

    prompt_ids: np.ndarray  # (t,) int
    max_new_tokens: int = 32
    top_k: int = 50
    temperature: float = 1.0
    eos_id: int | None = None
    seed: int = 0
    # echo of the id the scheduler assigned at the last submit
    request_id: int | None = None
    # the trace id of this request's journey (obs/context.py); None =>
    # the scheduler mints a fresh one at each submit
    trace_id: str | None = None
    # priority class (higher = more important; None takes
    # cfg.serving_default_priority).  Admission pops the highest priority
    # first (FCFS within a class), and the engine preempts a lower-
    # priority decoding slot when this request waits with no slot free
    priority: int | None = None


@dataclasses.dataclass
class TokenEvent:
    """One streamed token (serve()/step() output, in emission order)."""

    request_id: int
    token: int
    index: int  # 0-based position within the generated suffix
    done: bool
    finish_reason: str | None = None  # "eos" | "length" when done


@dataclasses.dataclass
class GenerationResult:
    request_id: int
    prompt_ids: np.ndarray
    new_tokens: np.ndarray  # generated suffix (includes eos when hit)
    finish_reason: str  # "eos" | "length"

    @property
    def tokens(self) -> np.ndarray:
        """prompt + generated suffix, ``generate()``-shaped."""
        return np.concatenate([self.prompt_ids, self.new_tokens])


@dataclasses.dataclass
class _Tracked:
    """Host-side mirror of one in-flight request."""

    request: GenerationRequest
    request_id: int = -1
    # the trace id every span and record of this request carries
    # (request.trace_id when it came with one, else minted at submit)
    trace_id: str = ""
    status: RequestStatus = RequestStatus.QUEUED
    slot: int | None = None
    new_tokens: list[int] = dataclasses.field(default_factory=list)
    finish_reason: str | None = None
    # host clock stamps (time.perf_counter seconds)
    t_submit: float = 0.0
    t_admit: float | None = None
    t_first_token: float | None = None
    t_last_token: float | None = None
    # per-request inter-token latency histogram (obs/histogram.py), made
    # at admission; it rides in the request's finish record
    itl_hist: object | None = None
    # chunked-prefill progress: the plan (None => one-shot) and chunks run
    plan: object | None = None
    chunks_done: int = 0
    prefill_dt: float = 0.0  # host dispatch seconds of the chunk steps run
    # real prompt tokens a partial prefix-cache hit seeded: the finished
    # prefill reports only the tokens it computed
    prefill_seeded_tokens: int = 0
    # consecutive chunk grants this slot was passed over for (the SRPT
    # starvation guard, serving/engine._pick_prefill_slot)
    prefill_skipped: int = 0
    # hybrid stacks: the KV pages this request holds a ref on (reserved at
    # admission, or shared from a cached prefix), dropped at eviction
    pages: list[int] | None = None
    # resolved priority class: admission order and preemption rank
    priority: int = 0
    # a preempted request's swap-out (serving/engine._preempt): host
    # copies of its carry and last logits and its token count, so the
    # resume restores it mid-decode.  It survives requeue: dropping it
    # would re-prefill and replay tokens already delivered
    snapshot: dict | None = None
    preempted: int = 0  # times this request was swapped out
    # prefix-cache outcome at admission: "full" | "partial" | None
    cache_hit: str | None = None
    # speculative decoding (serving/spec_decode.py, the pending-token
    # scheme): tokens committed to the stream but not yet folded into the
    # device state, how many of them the consumer has received, and how
    # much committed history the drafter has observed.  All three survive
    # preemption (the snapshot pairs with them); requeue resets them only
    # when the request will prefill again from scratch
    spec_pending: list = dataclasses.field(default_factory=list)
    spec_pending_emitted: int = 0
    spec_observed: int = 0


class FCFSScheduler:
    """First-come-first-served admission queue with priority classes:
    ``pop``/``peek`` take the highest-priority entry, FCFS within a
    class; with every request at the default priority it is the plain
    arrival-order queue."""

    def __init__(self, default_priority: int = 0) -> None:
        self._queue: deque[_Tracked] = deque()
        self._next_id = 0
        self.default_priority = default_priority

    def submit(self, request: GenerationRequest) -> _Tracked:
        prompt = np.asarray(request.prompt_ids, np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if request.top_k < 1:
            raise ValueError("top_k must be >= 1")
        if request.temperature <= 0.0:
            raise ValueError("temperature must be > 0")
        request.prompt_ids = prompt
        tracked = _Tracked(request=request, request_id=self._next_id,
                           trace_id=request.trace_id or mint_trace_id(),
                           priority=(self.default_priority if request.priority is None
                                     else request.priority),
                           t_submit=time.perf_counter())
        self._next_id += 1
        request.request_id = tracked.request_id
        self._queue.append(tracked)
        return tracked

    def _best(self) -> int | None:
        """Index of the next request to admit: highest priority, earliest
        queue position within a class."""
        if not self._queue:
            return None
        return max(range(len(self._queue)),
                   key=lambda i: (self._queue[i].priority, -i))

    def pop(self) -> _Tracked | None:
        """Next request to admit (priority, then arrival order), or None
        when empty."""
        i = self._best()
        if i is None:
            return None
        tracked = self._queue[i]
        del self._queue[i]
        return tracked

    def peek(self) -> _Tracked | None:
        """What ``pop`` would return, without removing it."""
        i = self._best()
        return None if i is None else self._queue[i]

    def pop_preempted(self) -> _Tracked | None:
        """Next queued preempted request (one holding a snapshot), or
        None.  The engine resumes these even while the queue's best
        request waits for KV pages: a swap-in needs no new pages, and
        running it is how the pages it holds get released."""
        for i, t in enumerate(self._queue):
            if t.snapshot is not None:
                del self._queue[i]
                return t
        return None

    def requeue(self, tracked: _Tracked) -> None:
        """Put a popped-but-not-admitted request back at the queue head
        (a preempted request resumes ahead of its class: it arrived
        first).  Its prefill restarts from chunk 0; a preemption
        ``snapshot`` survives."""
        tracked.status = RequestStatus.QUEUED
        tracked.slot = None
        tracked.plan = None
        tracked.chunks_done = 0
        tracked.prefill_dt = 0.0
        tracked.prefill_seeded_tokens = 0
        tracked.prefill_skipped = 0
        if tracked.snapshot is None:
            # a fresh prefill derives the first pending token again, and
            # the drafter's stream restarts (spec_observed 0 tells the
            # spec tick to forget it); a preempted request keeps all three
            tracked.spec_pending = []
            tracked.spec_pending_emitted = 0
            tracked.spec_observed = 0
        self._queue.appendleft(tracked)

    @property
    def depth(self) -> int:
        return len(self._queue)

    def __iter__(self) -> Iterator[_Tracked]:
        return iter(self._queue)
