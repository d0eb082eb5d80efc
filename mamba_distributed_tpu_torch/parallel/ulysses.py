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
"""

from __future__ import annotations

import torch

from mamba_distributed_tpu_torch.ops.blockwise_attention import blockwise_sdpa_causal
from mamba_distributed_tpu_torch.ops.cuda.flash_kernels import flash_sdpa_causal
from mamba_distributed_tpu_torch.parallel.collectives import seq_all_to_all


def ulysses_attention(seq, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      impl: str = "xla") -> torch.Tensor:
    """q (b, t_local, nh, hd), k/v (b, t_local, nkv, hd), this rank's
    block of the sequence -> (b, t_local, nh, hd) in q's dtype, causal
    over the global sequence.  ``impl``: "xla" (blockwise) or anything
    else (the flash kernels)."""
    n = seq.size
    nh, nkv = q.shape[2], k.shape[2]
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
