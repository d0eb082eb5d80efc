"""Train and eval steps with gradient accumulation (counterpart of the
JAX package's ``training/train_step.py``, one device).

The JAX step is one jit: a ``lax.scan`` over the leading accum axis
sums the micro-batch gradients, then divides by accum, takes the global
norm before the clip, and applies the optimizer.  Here the same runs
eagerly: a Python loop over the micro-batches, ``torch.autograd.grad``
for each, the same sums and divisions, then ``AdamW.step`` in place.
"""

from __future__ import annotations

import torch

from mamba_distributed_tpu_torch.config import TrainConfig
from mamba_distributed_tpu_torch.models.lm import lm_loss
from mamba_distributed_tpu_torch.training.optimizer import AdamW, global_norm, tree_leaves


def loss_and_grads(params: dict, cfg: TrainConfig, x: torch.Tensor, y: torch.Tensor):
    """Mean loss and mean gradients over the accum axis of x, y
    (accum, B, T): (loss 0-d fp32 tensor, grads tree like params)."""
    leaves = tree_leaves(params)
    accum = x.shape[0]
    gsum, lsum = None, None
    for i in range(accum):
        loss = lm_loss(params, cfg.model, x[i], y[i])
        g = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        if gsum is None:
            gsum, lsum = list(g), loss
        else:  # in place: autograd.grad returns fresh tensors
            for a, b in zip(gsum, g):
                a.add_(b)
            lsum = lsum + loss
    if accum > 1:
        for v in gsum:
            v.div_(accum)
        lsum = lsum / accum
    return lsum, _rebuild(params, iter(gsum))


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    return next(it)


def make_train_step(cfg: TrainConfig, optimizer: AdamW):
    """``step(params, x, y) -> (loss, grad_norm)`` with x/y (accum, B, T);
    ``params`` is updated in place.  The norm is the pre-clip global norm."""

    def step(params: dict, x: torch.Tensor, y: torch.Tensor):
        loss, grads = loss_and_grads(params, cfg, x, y)
        grad_norm = global_norm(grads)
        optimizer.step(params, grads, grad_norm)
        return loss, grad_norm

    return step


def make_eval_step(cfg: TrainConfig):
    """Loss-only step, x/y (B, T)."""

    @torch.no_grad()
    def eval_step(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return lm_loss(params, cfg.model, x, y)

    return eval_step
