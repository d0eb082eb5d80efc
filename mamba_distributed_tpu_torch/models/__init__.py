"""Model stack of the port (Mamba-2 and hybrid LMs)."""

from mamba_distributed_tpu_torch.models.lm import (
    init_lm_params,
    init_lm_state,
    lm_prefill,
    lm_prefill_chunk,
    lm_step,
)

__all__ = ["init_lm_params", "init_lm_state", "lm_prefill", "lm_prefill_chunk",
           "lm_step"]
