"""AdamW with the dim >= 2 decay mask and the warmup/cosine schedule
(counterpart of the JAX package's ``training/optimizer.py``, which
chains ``optax.clip_by_global_norm`` and ``optax.adamw``).

The reference recipe:

* AdamW betas (0.9, 0.95), eps 1e-8, weight decay 0.1 on parameters with
  per-layer ndim >= 2 only (matmul weights and the embedding; biases,
  norms, dt/A/D do not decay);
* clip to global norm 1.0 by optax's rule, written out here: the norm is
  sqrt(sum g^2) over every leaf and, where it is not below the limit,
  every leaf becomes g / norm * limit (``torch.nn.utils.clip_grad_norm_``
  divides by norm + 1e-6, which differs);
* LR: linear warmup with the reference's (step + 1) / warmup, then cosine
  to 10% at ``max_steps``, constant beyond.

Parameters, gradients and moments are plain dicts of tensors (the
port's param tree).  The update runs in place on the parameters and the
moments: the optimizer state is twice the parameters, and a functional
update would allocate both again every step.  Under FSDP the trees are
this rank's shards (``parallel/sharding.shard_params``): the moments are
allocated on the shards, so they inherit the param's spec, the decay
mask keys on a leaf's ndim, which sharding leaves alone, and the clip
takes the global norm the train step computes from the shards.
"""

from __future__ import annotations

import math

import torch

from mamba_distributed_tpu_torch.config import TrainConfig


def lr_schedule(cfg: TrainConfig):
    """step -> learning rate (optimizer.py:27-41)."""
    max_lr = cfg.max_lr
    min_lr = cfg.max_lr * cfg.min_lr_ratio
    warmup, max_steps = cfg.warmup_steps, cfg.max_steps

    def schedule(step: int) -> float:
        if step < warmup:
            return max_lr * (step + 1.0) / warmup
        if step > max_steps:
            return min_lr
        ratio = min(max((step - warmup) / (max_steps - warmup), 0.0), 1.0)
        return min_lr + 0.5 * (1.0 + math.cos(math.pi * ratio)) * (max_lr - min_lr)

    return schedule


def tree_map(fn, *trees):
    """Apply ``fn`` leaf-wise over dicts of the same keys."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def decay_mask(params: dict, _stacked: bool = False):
    """True for every parameter that decays: per-layer ndim >= 2 (the
    leading layer axis of the stacked ``blocks``/``attn_blocks`` leaves
    does not count), as optimizer.py:44-60."""
    if isinstance(params, dict):
        return {k: decay_mask(v, _stacked or k in ("blocks", "attn_blocks"))
                for k, v in params.items()}
    return params.ndim - (1 if _stacked else 0) >= 2


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, fp32 (optax.global_norm)."""
    return torch.sqrt(sum(g.float().square().sum() for g in tree_leaves(grads)))


class AdamW:
    """clip_by_global_norm(grad_clip) -> adamw(schedule, b1, b2, eps,
    weight_decay, mask=decay_mask), as one ``step``."""

    def __init__(self, cfg: TrainConfig, params: dict):
        self.cfg = cfg
        self.schedule = lr_schedule(cfg)
        self.mask = decay_mask(params)
        self.count = 0
        self.mu = tree_map(torch.zeros_like, params)
        self.nu = tree_map(torch.zeros_like, params)

    @torch.no_grad()
    def step(self, params: dict, grads: dict, norm: torch.Tensor | None = None) -> None:
        """One update of ``params`` in place; ``norm`` is the global grad
        norm when the caller has it already."""
        cfg = self.cfg
        if norm is None:
            norm = global_norm(grads)
        # optax.clip_by_global_norm: g unchanged below the limit, else g / norm * limit
        keep = norm < cfg.grad_clip
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = 1.0 - cfg.adam_b1 ** self.count
        bc2 = 1.0 - cfg.adam_b2 ** self.count
        for p, g, m, v, decay in zip(tree_leaves(params), tree_leaves(grads),
                                     tree_leaves(self.mu), tree_leaves(self.nu),
                                     tree_leaves(self.mask)):
            g = torch.where(keep, g, g / norm * cfg.grad_clip)
            m.mul_(cfg.adam_b1).add_((1.0 - cfg.adam_b1) * g)
            v.mul_(cfg.adam_b2).add_((1.0 - cfg.adam_b2) * g.square())
            u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.adam_eps)
            if decay:
                u = u + cfg.weight_decay * p
            p.add_(-lr * u)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        tree_map(lambda dst, src: dst.copy_(src), self.mu, state["mu"])
        tree_map(lambda dst, src: dst.copy_(src), self.nu, state["nu"])
