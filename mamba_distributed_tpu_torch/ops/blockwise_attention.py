"""Blockwise causal attention with an online softmax over KV blocks
(counterpart of ``mamba_distributed_tpu/ops/blockwise_attention.py``).

The ``attn_impl="xla"`` path of the full-sequence attention: plain
tensor code that autograd differentiates.  The KV sequence is consumed
block by block, carrying the (running max, numerator, denominator)
online-softmax state, so no (t, t) score tensor exists beyond one
(q block, kv block) tile.  Fully-future block pairs are computed and
masked, as in the JAX package (its scan is branch-free); the hand-written
flash kernels (ops/cuda/flash_kernels.py) skip them.
"""

from __future__ import annotations

import math

import torch

from mamba_distributed_tpu_torch.ops.ssd import _divisor_chunk

DEFAULT_BLOCK = 256


def ols_init(b: int, nkv: int, rep: int, tq: int, hd: int, device=None):
    """Fresh online-softmax accumulator for a (b, tq, nkv, rep, hd) Q slab."""
    m = torch.full((b, nkv, rep, tq), float("-inf"), device=device)
    num = torch.zeros((b, nkv, rep, tq, hd), device=device)
    den = torch.zeros((b, nkv, rep, tq), device=device)
    return m, num, den


def ols_block_update(acc, qh, k_blk, v_blk, qpos, kpos):
    """Fold one KV block into the accumulator.

    qh (b, tq, nkv, rep, hd); k_blk/v_blk (b, kb, nkv, hd); qpos (tq,)
    and kpos (kb,) absolute positions for the causal mask.  Scores and
    softmax in fp32; the weights are rounded to V's dtype for the PV
    product, which accumulates in fp32 (bf16 products are exact there)."""
    m, num, den = acc
    hd = qh.shape[-1]
    s = torch.einsum("bqgrh,bkgh->bgrqk", qh.float(), k_blk.float()) / math.sqrt(hd)
    s = s.masked_fill(~(qpos[:, None] >= kpos[None, :]), float("-inf"))
    m_new = torch.maximum(m, s.amax(dim=-1))
    # rows masked so far keep m = -inf; exp(-inf - -inf) is guarded
    scale = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
    p = torch.where(torch.isfinite(s), torch.exp(s - m_new[..., None]), 0.0)
    num = num * scale[..., None] + torch.einsum(
        "bgrqk,bkgh->bgrqh", p.to(v_blk.dtype).float(), v_blk.float())
    den = den * scale + p.sum(dim=-1)
    return m_new, num, den


def ols_finalize(acc, out_dtype):
    """(b, nkv, rep, tq, hd) accumulator -> (b, tq, nh, hd) output."""
    _, num, den = acc
    out = num / torch.clamp(den[..., None], min=1e-30)
    b, nkv, rep, tq, hd = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, tq, nkv * rep, hd).to(out_dtype)


def blockwise_sdpa_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          offset: int = 0, q_block: int = DEFAULT_BLOCK,
                          k_block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Causal softmax(QK^T/sqrt(d))V with GQA broadcast, O(t * block)
    memory.  q (b, tq, nh, hd); k/v (b, tk, nkv, hd); ``offset`` is the
    absolute position of q[0] minus that of k[0]; query head ``g * rep +
    e`` reads KV head ``g``.  Returns (b, tq, nh, hd) in q's dtype."""
    b, tq, nh, hd = q.shape
    tk, nkv = k.shape[1], k.shape[2]
    rep = nh // nkv
    qb = _divisor_chunk(tq, q_block)
    kb = _divisor_chunk(tk, k_block)
    qh = q.reshape(b, tq, nkv, rep, hd)
    outs = []
    for qi in range(tq // qb):
        q_blk = qh[:, qi * qb:(qi + 1) * qb]
        qpos = offset + qi * qb + torch.arange(qb, device=q.device)
        acc = ols_init(b, nkv, rep, qb, hd, q.device)
        for kj in range(tk // kb):
            kpos = kj * kb + torch.arange(kb, device=q.device)
            acc = ols_block_update(acc, q_blk, k[:, kj * kb:(kj + 1) * kb],
                                   v[:, kj * kb:(kj + 1) * kb], qpos, kpos)
        outs.append(ols_finalize(acc, q.dtype))
    return torch.cat(outs, dim=1)
