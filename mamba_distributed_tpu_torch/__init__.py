"""PyTorch/CUDA port of ``mamba_distributed_tpu`` (serving of Mamba-2 and
hybrid stacks, training of Mamba-2 stacks).

A second package beside the JAX one: it imports ``torch`` and never
``jax``, and nothing of ``mamba_distributed_tpu``.  Module names mirror
the JAX package's so each counterpart is easy to find.  Entry points run
on the card unless the caller asks for the CPU.
"""

from mamba_distributed_tpu_torch.config import ModelConfig, get_preset

__all__ = ["ModelConfig", "get_preset"]
