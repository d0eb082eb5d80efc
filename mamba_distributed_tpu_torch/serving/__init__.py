"""Serving core of the port: slot pool, priority-FCFS scheduler, chunked
prefill, the prefix-state cache and the continuous-batching engine."""

from mamba_distributed_tpu_torch.serving.engine import ServingEngine
from mamba_distributed_tpu_torch.serving.prefix_cache import PrefixCache, PrefixEntry
from mamba_distributed_tpu_torch.serving.scheduler import (
    GenerationRequest,
    GenerationResult,
    RequestStatus,
    TokenEvent,
)

__all__ = ["GenerationRequest", "GenerationResult", "PrefixCache", "PrefixEntry",
           "RequestStatus", "ServingEngine", "TokenEvent"]
