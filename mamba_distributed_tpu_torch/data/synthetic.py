"""Deterministic synthetic token shards (copy of the JAX package's
``data/synthetic.py``).

The real 10B-token corpus is bring-your-own-data; for tests, smoke
training and chip runs this writes Zipf-distributed uint16 shards in the
on-disk format the loader reads (``{split}`` in the file name, ``.npy``
of token ids).  Nothing is downloaded.
"""

from __future__ import annotations

import os

import numpy as np


def ensure_synthetic_shards(
    data_dir: str,
    vocab_size: int = 50257,
    tokens_per_shard: int = 2_097_152,
    num_shards: int = 2,
    val_shards: int = 1,
    seed: int = 1337,
) -> str:
    """Create shards in ``data_dir`` if it does not already hold any.

    Zipf-ish marginals give a non-flat unigram distribution, so losses
    move the way real text's do (a uniform stream would pin the loss at
    ln(V))."""
    if os.path.isdir(data_dir) and any(f.endswith(".npy") for f in os.listdir(data_dir)):
        return data_dir
    os.makedirs(data_dir, exist_ok=True)
    for split, count in (("train", num_shards), ("val", val_shards)):
        for i in range(count):
            rng = np.random.default_rng(seed + i + (10_000 if split == "val" else 0))
            ranks = rng.zipf(1.2, size=tokens_per_shard)
            tokens = (ranks - 1).clip(max=vocab_size - 1).astype(np.uint16)
            np.save(os.path.join(data_dir, f"synthetic_{split}_{i:06d}.npy"), tokens)
    return data_dir
