"""Rank-strided ``.npy`` token-shard loader (copy of the JAX package's
``data/loader.py``).

Sorted shard discovery filtered by split name, rank-strided sequential
windows (rank r reads windows r, r+W, r+2W, ... of each shard),
next-token (x, y) pairs from a B*T+1 slice, shard cycling with dropped
tails, no shuffling.  ``state()``/``restore()`` give an exact-resume
cursor, and one worker thread assembles the next batch while the caller
trains on the current one: the batch sequence is a pure function of the
cursor, so prefetching changes nothing observable.

Two backends give the same batches: ``"native"`` memory-maps each shard
and assembles x/y in C++ (data/native.py, data/native/shard_reader.cc),
``"numpy"`` loads the whole shard.  ``backend="native"`` raises at
construction when the reader did not build or cannot parse the first
shard; ``"auto"`` settles once, up front: native when it built, numpy
otherwise, and numpy for the whole loader when a shard's dtype is
outside the C++ parser's set (e.g. int64).  ``self.backend`` names the
one in use.
"""

from __future__ import annotations

import os
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from mamba_distributed_tpu_torch.data import native


def load_tokens(path: str) -> np.ndarray:
    """np.load + widen to int32 (shards are uint16/uint32 on disk)."""
    return np.load(path).astype(np.int32)


class ShardedTokenLoader:
    def __init__(self, B: int, T: int, data_dir: str, split: str = "train",
                 process_rank: int = 0, num_processes: int = 1,
                 master_process: bool = True, backend: str = "auto",
                 prefetch: bool = True):
        if split not in ("train", "val"):
            raise ValueError(f"split must be 'train' or 'val', got {split!r}")
        if backend not in ("auto", "native", "numpy"):
            raise ValueError(f"backend must be 'auto', 'native' or 'numpy', got {backend!r}")
        if backend == "native" and not native.available():
            raise RuntimeError(f"native shard reader unavailable: {native.unavailable_reason()}")
        self._requested = backend
        self.backend = "native" if backend != "numpy" and native.available() else "numpy"
        self.B, self.T = B, T
        self.process_rank = process_rank
        self.num_processes = num_processes
        shards = sorted(os.path.join(data_dir, s) for s in os.listdir(data_dir)
                        if split in s and s.endswith(".npy"))
        if not shards:
            raise FileNotFoundError(f"no shards found for split {split} in {data_dir}")
        self.shards = shards
        self._open_idx: int | None = None
        self.tokens = None
        self._shard = None
        self._pool = ThreadPoolExecutor(max_workers=1) if prefetch else None
        self._pending = None  # (cursor, Future) for the batch at that cursor
        self.reset()
        # shard 0 opens now: "native" fails here on a shard it cannot
        # parse, and "auto" settles its backend up front
        self._open_shard(0)
        if master_process:
            print(f"found {len(shards)} shards for split {split} ({self.backend})")

    def _open_shard(self, idx: int) -> None:
        if idx == self._open_idx:
            return
        path = self.shards[idx]
        if self.backend == "native":
            if self._shard is not None:
                self._shard.close()
                self._shard = None
            try:
                self._shard = native.NativeShard(path)
            except OSError:
                if self._requested == "native":
                    raise
                # "auto": a shard outside the C++ parser's set (e.g. int64,
                # big-endian) moves this loader to numpy for good
                self.backend = "numpy"
            else:
                self._shard_len = len(self._shard)
                self._open_idx = idx
                return
        self.tokens = load_tokens(path)
        self._shard_len = len(self.tokens)
        self._open_idx = idx

    def _slice(self, pos: int):
        B, T = self.B, self.T
        if self.backend == "native":
            return self._shard.fill_batch(pos, B, T)
        buf = self.tokens[pos:pos + B * T + 1]
        return buf[:-1].reshape(B, T), buf[1:].reshape(B, T)

    def _compute(self, cursor):
        """Pure step: cursor (shard, pos) -> ((x, y), next cursor).  Runs
        on the worker thread or inline, never concurrently with itself
        (one worker, and the consume-then-resubmit protocol)."""
        shard_idx, pos = cursor
        B, T = self.B, self.T
        self._open_shard(shard_idx)
        x, y = self._slice(pos)
        next_pos = pos + B * T * self.num_processes
        # advance when the next strided window would overrun the shard
        # (tails are dropped)
        if next_pos + (B * T * self.num_processes + 1) > self._shard_len:
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
        if self._shard is not None:
            self._shard.close()
            self._shard = None
        self.tokens = None  # the numpy backend holds the whole shard
        self._open_idx = None

    def state(self) -> dict:
        return {"current_shard": self._cursor[0], "current_position": self._cursor[1]}

    def restore(self, state: dict) -> None:
        self._cancel_pending()
        self._cursor = (int(state["current_shard"]) % len(self.shards),
                        int(state["current_position"]))
