"""Training of the port: optimizer, train step, checkpoints, trainer."""

from mamba_distributed_tpu_torch.training.trainer import Trainer

__all__ = ["Trainer"]
