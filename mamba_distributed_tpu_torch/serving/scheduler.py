"""Request lifecycle + FCFS admission for the serving engine (counterpart
of ``mamba_distributed_tpu/serving/scheduler.py``, without adapters,
tenant quotas and priorities).

A request moves QUEUED -> PREFILL -> DECODE -> FINISHED:

  QUEUED    in the FCFS queue, waiting for a free slot
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
    # hybrid stacks: the KV pages reserved for the whole request
    pages: list[int] | None = None


class FCFSScheduler:
    """First-come-first-served admission queue."""

    def __init__(self) -> None:
        self._queue: deque[_Tracked] = deque()
        self._next_id = 0

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
                           t_submit=time.perf_counter())
        self._next_id += 1
        request.request_id = tracked.request_id
        self._queue.append(tracked)
        return tracked

    def pop(self) -> _Tracked | None:
        """Next request to admit, or None when empty."""
        return self._queue.popleft() if self._queue else None

    def requeue(self, tracked: _Tracked) -> None:
        """Put a popped-but-not-admitted request back at the queue head;
        its prefill restarts from chunk 0."""
        tracked.status = RequestStatus.QUEUED
        tracked.slot = None
        tracked.plan = None
        tracked.chunks_done = 0
        self._queue.appendleft(tracked)

    @property
    def depth(self) -> int:
        return len(self._queue)

    def __iter__(self) -> Iterator[_Tracked]:
        return iter(self._queue)
