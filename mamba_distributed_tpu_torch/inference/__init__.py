"""Generation of the port: bucketing and the recurrent decode loop."""

from mamba_distributed_tpu_torch.inference.bucketing import (
    next_pow2_bucket,
    pad_to_bucket,
)
from mamba_distributed_tpu_torch.inference.generate import generate

__all__ = ["generate", "next_pow2_bucket", "pad_to_bucket"]
