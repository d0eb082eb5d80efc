"""Vocab-blocked cross-entropy (counterpart of
``mamba_distributed_tpu/ops/loss.py``): the LM-head product and the
softmax cross-entropy without ever making the (b, t, V) logits.

The forward walks the vocab in ``n_blocks`` blocks under an online
logsumexp; the backward recomputes each block's logits from ``(normed,
head, targets, lse)``, so only (b, t, V / n_blocks) exists at a time in
either direction.  Each block's logits take the dense head's round trip
(compute-dtype operands, fp32 accumulation, one rounding to the compute
dtype; models/lm.py ``lm_forward``), and the loss is the same
``mean(logsumexp - gathered logit)`` in fp32.  The head products are
plain ``torch`` GEMMs: the JAX package computes them outside any Pallas
kernel.
"""

from __future__ import annotations

import torch

from mamba_distributed_tpu_torch.models.common import mm_f32


def _block_logits(normed_cd: torch.Tensor, head_blk: torch.Tensor, compute_dtype):
    """One vocab block of the head product in fp32, rounded once to the
    compute dtype (the dense path's logits): (b, t, d) x (bs, d) -> (b, t, bs)."""
    return (normed_cd @ head_blk.to(compute_dtype).t()).float()


def _in_block(targets: torch.Tensor, off: int, bs: int):
    """(targets inside [off, off + bs), their index in the block, clipped)."""
    return (targets >= off) & (targets < off + bs), (targets - off).clamp(0, bs - 1)


class BlockedCrossEntropy(torch.autograd.Function):
    """``blocked_cross_entropy``'s ``custom_vjp`` (loss.py:37-123)."""

    @staticmethod
    def forward(ctx, normed, head, targets, n_blocks: int, compute_dtype):
        V, _ = head.shape
        if V % n_blocks:
            raise ValueError(f"vocab {V} does not split into {n_blocks} blocks")
        bs = V // n_blocks
        nc = normed.to(compute_dtype)
        m = torch.full(targets.shape, float("-inf"), device=normed.device)
        s = torch.zeros(targets.shape, device=normed.device)
        tgt = torch.zeros(targets.shape, device=normed.device)
        for j in range(n_blocks):
            logits = _block_logits(nc, head[j * bs:(j + 1) * bs], compute_dtype)
            m_new = torch.maximum(m, logits.amax(-1))
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[..., None]).sum(-1)
            m = m_new
            inside, idx = _in_block(targets, j * bs, bs)
            tl = logits.gather(-1, idx[..., None])[..., 0]
            tgt = torch.where(inside, tl, tgt)
        lse = m + torch.log(s)
        ctx.save_for_backward(normed, head, targets, lse)
        ctx.n_blocks, ctx.compute_dtype = n_blocks, compute_dtype
        return (lse - tgt).mean()

    @staticmethod
    def backward(ctx, g):
        normed, head, targets, lse = ctx.saved_tensors
        cd, n_blocks = ctx.compute_dtype, ctx.n_blocks
        V, d = head.shape
        bs = V // n_blocks
        scale = g / targets.numel()  # d(mean) / d(per-position loss)
        nc = normed.to(cd)
        flat = nc.reshape(-1, d)
        dnormed = torch.zeros(normed.shape, device=normed.device)
        dhead = torch.empty((V, d), device=head.device)
        for j in range(n_blocks):
            blk = head[j * bs:(j + 1) * bs]
            p = torch.exp(_block_logits(nc, blk, cd) - lse[..., None])
            inside, idx = _in_block(targets, j * bs, bs)
            p.scatter_add_(-1, idx[..., None], -inside[..., None].to(p.dtype))
            dl = (p * scale).to(cd)  # (b, t, bs)
            dnormed += mm_f32(dl, blk.to(cd))
            dhead[j * bs:(j + 1) * bs] = mm_f32(dl.reshape(-1, bs).t(), flat)
        return dnormed.to(normed.dtype), dhead.to(head.dtype), None, None, None


def blocked_cross_entropy(normed: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
                          n_blocks: int = 8, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Mean CE over the (b, t) positions of ``normed`` (b, t, d) against
    ``targets`` (b, t); ``head`` (V, d) is the tied embedding or
    ``lm_head.kernel.T``.  Differentiable in ``normed`` and ``head``."""
    return BlockedCrossEntropy.apply(normed, head, targets.long(), n_blocks, compute_dtype)
