"""Ulysses sequence parallelism for attention (counterpart of the JAX
package's ``parallel/ulysses.py``).

Where ring attention keeps the heads whole and moves KV blocks around
the seq ranks, Ulysses redistributes once: a tiled all-to-all over the
seq group turns the sequence cut into a head cut (K and V stacked into
one call), each rank runs ordinary full-sequence causal attention on its
heads (the flash kernels, or the blockwise online softmax under
``"xla"``), and a second all-to-all turns the result back.  The heads
and the KV heads must both divide by the seq size, so that contiguous
head slices keep the GQA groups whole.

Under tensor parallelism a rank holds its tensor shard's heads.  When
they divide by the seq size, Ulysses cuts them as it would cut all of
them.  When the global heads divide and the local ones do not (8 KV
heads over tensor 4 and seq 4 leave 2 a rank), the block gathers its
q, k and v heads over the tensor group, runs Ulysses on every head and
keeps its own heads' output: each tensor rank then computes the
attention of all heads, as the JAX package's GSPMD does when it gathers
the heads around its seq ``shard_map``.
"""

from __future__ import annotations

import torch

from mamba_distributed_tpu_torch.ops.blockwise_attention import blockwise_sdpa_causal
from mamba_distributed_tpu_torch.ops.cuda.flash_kernels import flash_sdpa_causal
from mamba_distributed_tpu_torch.parallel.collectives import gather_heads_tp, seq_all_to_all


def ulysses_attention(seq, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      impl: str = "xla", tp=None) -> torch.Tensor:
    """q (b, t_local, nh, hd), k/v (b, t_local, nkv, hd), this rank's
    block of the sequence -> (b, t_local, nh, hd) in q's dtype, causal
    over the global sequence.  ``impl``: "xla" (blockwise) or anything
    else (the flash kernels).  ``tp``: the tensor group whose shard of
    the heads q, k and v are (module docstring)."""
    n = seq.size
    nh, nkv = q.shape[2], k.shape[2]
    if tp is not None and (nh % n or nkv % n):
        q, k, v = (gather_heads_tp(a, tp, 2) for a in (q, k, v))
        out = ulysses_attention(seq, q, k, v, impl)
        return out.narrow(2, tp.rank * nh, nh)
    if nh % n or nkv % n:
        raise ValueError(
            f"ulysses_attention needs num_heads ({nh}) and num_kv_heads "
            f"({nkv}) divisible by the seq axis size ({n}); use ring "
            "attention for this config"
        )
    sdpa = blockwise_sdpa_causal if impl == "xla" else flash_sdpa_causal
    # sequence cut -> head cut: split the heads, concatenate the sequence
    qh = seq_all_to_all(q, seq, 2, 1)
    kv = seq_all_to_all(torch.stack([k, v]), seq, 3, 2)
    out = sdpa(qh, kv[0], kv[1])
    # head cut -> sequence cut
    return seq_all_to_all(out, seq, 1, 2)
