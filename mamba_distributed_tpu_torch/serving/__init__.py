"""Serving core of the port: slot pool, priority-FCFS scheduler, chunked
prefill, the prefix-state cache, speculative decoding's drafters and the
continuous-batching engine."""

from mamba_distributed_tpu_torch.serving.engine import ServingEngine
from mamba_distributed_tpu_torch.serving.prefix_cache import PrefixCache, PrefixEntry
from mamba_distributed_tpu_torch.serving.spec_decode import Drafter, ModelDrafter, NGramDrafter
from mamba_distributed_tpu_torch.serving.scheduler import (
    GenerationRequest,
    GenerationResult,
    RequestStatus,
    TokenEvent,
)

__all__ = ["Drafter", "GenerationRequest", "GenerationResult", "ModelDrafter", "NGramDrafter",
           "PrefixCache", "PrefixEntry", "RequestStatus", "ServingEngine", "TokenEvent"]
