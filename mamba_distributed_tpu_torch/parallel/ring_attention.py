"""Ring attention over the seq ranks (counterpart of the JAX package's
``parallel/ring_attention.py``).

Each rank keeps its query block and the KV blocks travel around the ring
of seq ranks, one hop at a time (S - 1 hops in the forward), so no rank
ever holds the whole sequence's keys.  The causal mask follows from the
global positions: the KV block held at hop i came from rank
``(rank - i) mod S``.

Two branches, as ``attn_impl`` picks:

* ``"xla"``: the blockwise online softmax (``ops/blockwise_attention``)
  folds every hop's KV block, fully-future ones computed and masked; the
  hops are ``collectives.seq_shift``, so autograd differentiates the
  whole ring;
* the kernels (``"pallas"``/``"auto"``): ``RingAttentionFunction``.  A
  hop is fully past (its owner precedes this rank: every pair unmasked,
  ``flash_pair_fwd`` at offset ``t_local``), diagonal (this rank's own
  block: causal at offset 0) or fully future (skipped, lse -inf).  The
  partials (o_i, lse_i) merge in fp32.  The backward takes the merged
  lse and delta = rowsum(dO O) in fp32: dq accumulates locally, and dk,
  dv ride the ring with their KV block for S hops, one more than the
  forward, so they land back on the block's owner.  A skipped hop still
  passes its KV on, so every rank makes the same exchanges.
"""

from __future__ import annotations

import torch

from mamba_distributed_tpu_torch.ops.blockwise_attention import (
    DEFAULT_BLOCK,
    ols_block_update,
    ols_finalize,
    ols_init,
)
from mamba_distributed_tpu_torch.ops.cuda.flash_kernels import (
    flash_pair_dkv,
    flash_pair_dq,
    flash_pair_fwd,
    readable_grad,
)
from mamba_distributed_tpu_torch.ops.remat import core_output
from mamba_distributed_tpu_torch.ops.ssd import _divisor_chunk
from mamba_distributed_tpu_torch.parallel import collectives
from mamba_distributed_tpu_torch.parallel.collectives import seq_shift


def ring_attention(seq, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   k_block: int = DEFAULT_BLOCK, impl: str = "xla") -> torch.Tensor:
    """q (b, t_local, nh, hd), k/v (b, t_local, nkv, hd), this rank's
    block of the sequence -> (b, t_local, nh, hd) in q's dtype, causal
    over the global sequence.  ``impl``: "xla" (blockwise) or anything
    else (the flash kernels, ``RingAttentionFunction``)."""
    if impl != "xla":
        o = RingAttentionFunction.apply(q.transpose(1, 2), k, v, seq)
        return o.transpose(1, 2)
    n, my = seq.size, seq.rank
    b, tl, nh, hd = q.shape
    nkv = k.shape[2]
    rep = nh // nkv
    qh = q.reshape(b, tl, nkv, rep, hd)
    qpos = my * tl + torch.arange(tl, device=q.device)
    kb = _divisor_chunk(tl, k_block)
    acc = ols_init(b, nkv, rep, tl, hd, q.device)
    kv = torch.stack([k, v])
    for i in range(n):
        src = (my - i) % n  # the rank whose block is held at hop i
        for kj in range(tl // kb):
            kpos = src * tl + kj * kb + torch.arange(kb, device=q.device)
            blk = kv[:, :, kj * kb:(kj + 1) * kb]
            acc = ols_block_update(acc, qh, blk[0], blk[1], qpos, kpos)
        if i < n - 1:  # the last block is consumed without a final hop
            kv = seq_shift(kv, seq, 1, cyclic=True)
    return ols_finalize(acc, q.dtype)


def _merge_partial(m, num, den, o_i, lse_i):
    """Fold one hop's normalized partial (o_i, lse_i) into the running
    (max, numerator, denominator), all fp32."""
    m_new = torch.maximum(m, lse_i)
    w_prev = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
    w_i = torch.where(torch.isfinite(lse_i), torch.exp(lse_i - m_new), 0.0)
    num = num * w_prev[..., None] + o_i.float() * w_i[..., None]
    den = den * w_prev + w_i
    return m_new, num, den


def _hop_offset(seq, i: int, tl: int):
    """The flash offset of hop i: ``tl`` for a fully-past block, 0 for
    this rank's own, None for a fully-future one (skipped)."""
    src = (seq.rank - i) % seq.size
    return tl if src < seq.rank else (0 if src == seq.rank else None)


class RingAttentionFunction(torch.autograd.Function):
    """The ring on the flash kernels (``_ring_attention_pallas``, JAX
    ring_attention.py:131-272): head-major qt (b, nh, tl, hd), k and v
    (b, tl, nkv, hd) -> head-major o.  Under the "mixer" remat policy each
    hop's forward kernel output is kept (ops/remat.py); the KV blocks
    still travel on a recompute, so every rank's exchanges pair up."""

    @staticmethod
    def forward(ctx, qt, k, v, seq):
        b, nh, tl, hd = qt.shape
        m = qt.new_full((b, nh, tl), float("-inf"), dtype=torch.float32)
        num = qt.new_zeros((b, nh, tl, hd), dtype=torch.float32)
        den = qt.new_zeros((b, nh, tl), dtype=torch.float32)
        kv = torch.stack([k, v])  # (2, b, tl, nkv, hd): one exchange a hop
        for i in range(seq.size):
            off = _hop_offset(seq, i, tl)
            if off is not None:
                kt, vt = kv[0].transpose(1, 2), kv[1].transpose(1, 2)
                o_i, lse_i = core_output(lambda: flash_pair_fwd(qt, kt, vt, off))
                m, num, den = _merge_partial(m, num, den, o_i, lse_i)
            if i < seq.size - 1:
                kv = collectives.seq_exchange(kv, seq, 1, True)
        o = (num / den.clamp_min(1e-30)[..., None]).to(qt.dtype)
        lse = torch.where(den > 0.0, m + torch.log(den.clamp_min(1e-30)), float("inf"))
        ctx.save_for_backward(qt, k, v, o, lse)
        ctx.seq = seq
        return o

    @staticmethod
    def backward(ctx, do):
        qt, k, v, o, lse = ctx.saved_tensors
        seq = ctx.seq
        tl = qt.shape[2]
        do = readable_grad(do)
        # delta = rowsum(dO * O) in fp32, over the merged output
        dlt = (do.float() * o.float()).sum(dim=-1).contiguous()
        dq = torch.zeros(qt.shape, dtype=torch.float32, device=qt.device)
        kv = torch.stack([k, v])
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=kv.device)
        for i in range(seq.size):
            off = _hop_offset(seq, i, tl)
            if off is not None:
                kt, vt = kv[0].transpose(1, 2), kv[1].transpose(1, 2)
                dq += flash_pair_dq(qt, kt, vt, do, lse, dlt, off)
                dk, dv = flash_pair_dkv(qt, kt, vt, do, lse, dlt, off)
                dkv[0] += dk.transpose(1, 2)
                dkv[1] += dv.transpose(1, 2)
            # dk and dv ride with their block: after S hops each is home
            if i < seq.size - 1:
                kv = collectives.seq_exchange(kv, seq, 1, True)
            dkv = collectives.seq_exchange(dkv, seq, 1, True)
        return dq.to(qt.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype), None
