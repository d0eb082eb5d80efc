"""Rank-strided ``.npy`` token-shard loader (copy of the JAX package's
``data/loader.py``, numpy backend).

Sorted shard discovery filtered by split name, rank-strided sequential
windows (rank r reads windows r, r+W, r+2W, ... of each shard),
next-token (x, y) pairs from a B*T+1 slice, shard cycling with dropped
tails, no shuffling.  ``state()``/``restore()`` give an exact-resume
cursor, and one worker thread assembles the next batch while the caller
trains on the current one: the batch sequence is a pure function of the
cursor, so prefetching changes nothing observable.  The JAX package's
optional C++ memory-mapped reader is not carried over.
"""

from __future__ import annotations

import os
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def load_tokens(path: str) -> np.ndarray:
    """np.load + widen to int32 (shards are uint16/uint32 on disk)."""
    return np.load(path).astype(np.int32)


class ShardedTokenLoader:
    def __init__(self, B: int, T: int, data_dir: str, split: str = "train",
                 process_rank: int = 0, num_processes: int = 1,
                 master_process: bool = True, prefetch: bool = True):
        if split not in ("train", "val"):
            raise ValueError(f"split must be 'train' or 'val', got {split!r}")
        self.B, self.T = B, T
        self.process_rank = process_rank
        self.num_processes = num_processes
        shards = sorted(os.path.join(data_dir, s) for s in os.listdir(data_dir)
                        if split in s and s.endswith(".npy"))
        if not shards:
            raise FileNotFoundError(f"no shards found for split {split} in {data_dir}")
        self.shards = shards
        if master_process:
            print(f"found {len(shards)} shards for split {split}")
        self._open_idx: int | None = None
        self.tokens = None
        self._pool = ThreadPoolExecutor(max_workers=1) if prefetch else None
        self._pending = None  # (cursor, Future) for the batch at that cursor
        self.reset()
        self._open_shard(0)

    def _open_shard(self, idx: int) -> None:
        if idx != self._open_idx:
            self.tokens = load_tokens(self.shards[idx])
            self._open_idx = idx

    def _compute(self, cursor):
        """Pure step: cursor (shard, pos) -> ((x, y), next cursor).  Runs
        on the worker thread or inline, never concurrently with itself
        (one worker, and the consume-then-resubmit protocol)."""
        shard_idx, pos = cursor
        B, T = self.B, self.T
        self._open_shard(shard_idx)
        buf = self.tokens[pos:pos + B * T + 1]
        x, y = buf[:-1].reshape(B, T), buf[1:].reshape(B, T)
        next_pos = pos + B * T * self.num_processes
        # advance when the next strided window would overrun the shard
        # (tails are dropped)
        if next_pos + (B * T * self.num_processes + 1) > len(self.tokens):
            shard_idx = (shard_idx + 1) % len(self.shards)
            next_pos = B * T * self.process_rank
        return (x, y), (shard_idx, next_pos)

    def reset(self) -> None:
        self._cancel_pending()
        self._cursor = (0, self.B * self.T * self.process_rank)

    def next_batch(self) -> tuple[np.ndarray, np.ndarray]:
        if self._pending is not None and self._pending[0] == self._cursor:
            fut = self._pending[1]
            # cleared before result(): a failed prefetch raises once and
            # the next call retries inline
            self._pending = None
            (x, y), self._cursor = fut.result()
        else:
            self._cancel_pending()
            (x, y), self._cursor = self._compute(self._cursor)
        if self._pool is not None:
            cur = self._cursor
            self._pending = (cur, self._pool.submit(self._compute, cur))
        return x, y

    def _cancel_pending(self) -> None:
        if getattr(self, "_pending", None) is not None:
            fut = self._pending[1]
            # a prefetch already running is waited out, so the shard state
            # is quiet before the cursor moves under it
            if not fut.cancel():
                try:
                    fut.result()
                except Exception as e:  # discarded: the cursor is moving
                    warnings.warn(f"discarding failed prefetch during reset: {e!r}",
                                  RuntimeWarning, stacklevel=3)
            self._pending = None

    def close(self) -> None:
        """Stop the prefetch worker (joins any compute in flight)."""
        self._cancel_pending()
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
        self.tokens = None
        self._open_idx = None

    def state(self) -> dict:
        return {"current_shard": self._cursor[0], "current_position": self._cursor[1]}

    def restore(self, state: dict) -> None:
        self._cancel_pending()
        self._cursor = (int(state["current_shard"]) % len(self.shards),
                        int(state["current_position"]))
