"""Pooled recurrent-state cache: the slot pool under the serving engine
(counterpart of the slot-pool half of
``mamba_distributed_tpu/serving/state_cache.py``).

Mamba's decode state is O(1) per sequence, so the serving "KV cache" is
a fixed-capacity pool of S slots whose tensors never change shape:

  pool = {
    "state": {"blocks": (conv (L, S, d_conv-1, conv_dim), ssm (L, S, h, p, n) fp32)},
    "logits": (S, V_padded) fp32        # last logits per slot
    "meta": {                           # (S,) tensors on the pool's device
      "active", "done", "prefilling": bool,
      "step", "max_new", "top_k": int64,
      "temperature": fp32, "eos_id": int64 (-1 => no EOS stopping),
    },
  }

Where the JAX package donates the pool to jitted writes, every function
here writes the pool's tensors IN PLACE (one slot's rows) and returns the
same pool.  A slot holding a partial chunked prefill is ``active`` and
``prefilling``: the decode tick keeps it out of sampling and restores its
rows after the step (serving/engine.py).
"""

from __future__ import annotations

import torch

from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.models.lm import init_lm_blocks_state


def init_pool(cfg: ModelConfig, capacity: int, device=None) -> dict:
    """An empty slot pool for ``capacity`` concurrent requests."""
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    S = capacity

    def full(v, dtype):
        return torch.full((S,), v, dtype=dtype, device=device)

    return {
        "state": {"blocks": init_lm_blocks_state(cfg, S, device)},
        "logits": torch.zeros((S, cfg.vocab_size_padded), dtype=torch.float32,
                              device=device),
        "meta": {
            "active": full(False, torch.bool),
            "done": full(False, torch.bool),
            "prefilling": full(False, torch.bool),
            "step": full(0, torch.int64),
            "max_new": full(1, torch.int64),
            "top_k": full(1, torch.int64),
            "temperature": full(1.0, torch.float32),
            "eos_id": full(-1, torch.int64),
        },
    }


def _write_blocks(pool: dict, slot: int, state: dict) -> None:
    """Write a batch-1 ``{"blocks": ...}`` state into ``slot`` (in place)."""
    for dst, src in zip(pool["state"]["blocks"], state["blocks"]):
        dst[:, slot].copy_(src[:, 0])


def _write_meta(pool: dict, slot: int, **values) -> None:
    meta = pool["meta"]
    for k, v in values.items():
        meta[k][slot] = v


def insert(pool: dict, slot: int, state: dict, logits: torch.Tensor,
           max_new: int, top_k: int, temperature: float, eos_id: int) -> dict:
    """Admit a prefilled request (batch-1 ``state`` + last ``logits``)
    into ``slot``, in place."""
    _write_blocks(pool, slot, state)
    pool["logits"][slot].copy_(logits[0])
    _write_meta(pool, slot, active=True, done=False, prefilling=False,
                step=0, max_new=max_new, top_k=top_k, temperature=temperature,
                eos_id=eos_id)
    return pool


def evict(pool: dict, slot: int) -> dict:
    """Free ``slot``: mark it empty.  Stale state and logits stay (the
    next insert overwrites them; the tick masks inactive slots)."""
    _write_meta(pool, slot, active=False, done=False, prefilling=False)
    return pool


def stash_prefill(pool: dict, slot: int, state: dict, max_new: int,
                  top_k: int, temperature: float, eos_id: int) -> dict:
    """Park a PARTIAL prefill carry in ``slot`` (in place): active, but
    ``prefilling`` keeps it out of the decode tick.  Re-stashing after
    more chunks overwrites the carry."""
    _write_blocks(pool, slot, state)
    _write_meta(pool, slot, active=True, done=False, prefilling=True,
                step=0, max_new=max_new, top_k=top_k, temperature=temperature,
                eos_id=eos_id)
    return pool


def read_state(pool: dict, slot: int) -> dict:
    """A copy of ``slot``'s batch-1 state (to resume a stashed prefill)."""
    return {"blocks": tuple(t[:, slot:slot + 1].clone()
                            for t in pool["state"]["blocks"])}


def finish_prefill(pool: dict, slot: int, state: dict,
                   logits: torch.Tensor) -> dict:
    """Complete a chunked prefill (in place): write the final carry and
    last logits and make the slot decodable."""
    _write_blocks(pool, slot, state)
    pool["logits"][slot].copy_(logits[0])
    _write_meta(pool, slot, prefilling=False)
    return pool
