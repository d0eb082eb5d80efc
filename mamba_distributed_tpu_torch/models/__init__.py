"""Model stack of the port (pure Mamba-2 LM)."""

from mamba_distributed_tpu_torch.models.lm import (
    init_lm_params,
    init_lm_state,
    lm_prefill,
    lm_prefill_chunk,
    lm_step,
)

__all__ = ["init_lm_params", "init_lm_state", "lm_prefill", "lm_prefill_chunk",
           "lm_step"]
