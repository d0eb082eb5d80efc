"""Serving core of the port: slot pool, FCFS scheduler, chunked prefill
and the continuous-batching engine."""

from mamba_distributed_tpu_torch.serving.engine import ServingEngine
from mamba_distributed_tpu_torch.serving.scheduler import (
    GenerationRequest,
    GenerationResult,
    RequestStatus,
    TokenEvent,
)

__all__ = ["GenerationRequest", "GenerationResult", "RequestStatus",
           "ServingEngine", "TokenEvent"]
