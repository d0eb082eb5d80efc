"""Model stack of the port (Mamba-2 and hybrid LMs)."""

from mamba_distributed_tpu_torch.models.lm import (
    count_params,
    init_lm_params,
    init_lm_state,
    lm_forward,
    lm_loss,
    lm_prefill,
    lm_prefill_chunk,
    lm_step,
)

__all__ = ["count_params", "init_lm_params", "init_lm_state", "lm_forward", "lm_loss",
           "lm_prefill", "lm_prefill_chunk", "lm_step"]
