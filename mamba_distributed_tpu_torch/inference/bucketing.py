"""Power-of-two prompt-length bucketing for prefill (counterpart of
``mamba_distributed_tpu/inference/bucketing.py``).

Prompts are LEFT-padded to the next power of two and a {0,1} mask zeroes
the mixer inputs at pad positions (``token_mask`` in models/lm.py), so a
padded prefill yields the unpadded one's state up to summation order.
The JAX package buckets to bound jit traces; here the buckets bound the
set of kernel shapes (the SSD chunk length is a power of two from 8 to
256) and keep ``generate()`` and the serving engine on one layout, which
their token-parity contract needs.  Prompts longer than
``cfg.effective_prefill_chunk_tokens`` pad to a multiple of the chunk
instead and prefill chunk by chunk (serving/prefill.py).
"""

from __future__ import annotations

import torch

# Smallest bucket: below this, padding waste is negligible.
MIN_BUCKET = 8


def next_pow2_bucket(t: int, min_bucket: int = MIN_BUCKET) -> int:
    """Smallest power of two >= t (and >= min_bucket)."""
    if t < 1:
        raise ValueError(f"prompt length must be >= 1, got {t}")
    b = max(min_bucket, 1)
    while b < t:
        b *= 2
    return b


def chunk_aligned_bucket(t: int, chunk: int) -> int:
    """Smallest multiple of ``chunk`` >= t (the chunked-prefill layout)."""
    if t < 1:
        raise ValueError(f"prompt length must be >= 1, got {t}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return ((t + chunk - 1) // chunk) * chunk


def use_chunked_prefill(t: int, chunk_tokens: int) -> bool:
    """One rule for ``generate()`` and the serving engine: prompts longer
    than the chunk take the chunked path; ``chunk_tokens <= 0`` disables
    chunking."""
    return chunk_tokens > 0 and t > chunk_tokens


def pad_to_bucket(prompt_ids: torch.Tensor, bucket: int):
    """Left-pad (b, t) prompts to (b, bucket) + an fp32 {0,1} mask.  Pad
    positions hold token id 0, which the mask keeps out of the state."""
    b, t = prompt_ids.shape
    if bucket < t:
        raise ValueError(f"bucket {bucket} < prompt length {t}")
    pad = bucket - t
    padded = torch.nn.functional.pad(prompt_ids, (pad, 0))
    mask = torch.zeros((b, bucket), dtype=torch.float32, device=prompt_ids.device)
    mask[:, pad:] = 1.0
    return padded, mask
