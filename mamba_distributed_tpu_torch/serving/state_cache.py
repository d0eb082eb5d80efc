"""Pooled recurrent-state cache: the slot pool under the serving engine,
and the KV page allocator of hybrid stacks (counterpart of
``mamba_distributed_tpu/serving/state_cache.py``, single shard).

Mamba's decode state is O(1) per sequence, so the serving "KV cache" is
a fixed-capacity pool of S slots whose tensors never change shape:

  pool = {
    "state": {"blocks": (conv (L, S, d_conv-1, conv_dim), ssm (L, S, h, p, n) fp32)},
              # Mamba-1: conv (L, S, d_conv-1, d_inner), ssm (L, S, d_inner, n) fp32
    "logits": (S, V_padded) fp32        # last logits per slot
    "meta": {                           # (S,) tensors on the pool's device
      "active", "done", "prefilling": bool,
      "step", "max_new", "top_k": int64,
      "temperature": fp32, "eos_id": int64 (-1 => no EOS stopping),
    },
  }

Hybrid stacks add ``"attn_blocks": (k_pages, v_pages)`` to the state,
each (A, 1 + pool_pages, nkv, page, hd) with page 0 the trash page (int8
pools: the 4-tuple with ``k_scale, v_scale`` (A, 1 + pool_pages, nkv)
fp32, a scale per page and KV head that travels with its page index):
one page pool shared by every slot, handed out page by page by
``PagePool`` (host-side bookkeeping; the engine keeps each slot's
page-table row and length on the host).

Where the JAX package donates the pool to jitted writes, every function
here writes the pool's tensors IN PLACE (one slot's rows) and returns the
same pool.  A slot holding a partial chunked prefill is ``active`` and
``prefilling``: the decode tick keeps it out of sampling and restores its
rows after the step (serving/engine.py).
"""

from __future__ import annotations

import torch

from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.models.attention import init_attention_state
from mamba_distributed_tpu_torch.models.lm import init_lm_blocks_state


class PagePoolError(RuntimeError):
    """A page-accounting violation: double free, freeing the trash page,
    or a page id outside the pool.  Always a caller bug, so it raises
    instead of corrupting the free list."""


class PagePool:
    """Host-side KV page allocator of a hybrid pool: a free list over the
    physical pages [1, num_pages]; page 0 is the trash page and is never
    handed out.  Pages are refcounted: ``alloc`` hands them out at one
    holder, ``incref`` adds a holder, ``free`` drops one and returns a
    page to the free list at zero.  One shard only: the JAX package's
    mesh-sharded pools wait for the port of the serving meshes."""

    def __init__(self, num_pages: int, num_shards: int = 1):
        if num_pages < 1:
            raise ValueError(f"need >= 1 usable page, got {num_pages}")
        if num_shards != 1:
            raise ValueError(
                f"num_shards={num_shards}: sharded page pools wait for the "
                f"port of the serving meshes; the port has one shard"
            )
        self.num_pages = num_pages
        self._free = list(range(1, num_pages + 1))
        self._refs: dict[int, int] = {}  # allocated page -> holder count

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - self.free_pages

    def refcount(self, page: int) -> int:
        """Current holder count (0 = free or never allocated)."""
        return self._refs.get(page, 0)

    def alloc(self, n: int) -> list[int]:
        """Reserve ``n`` pages at refcount 1, lowest ids first, or raise
        when the pool cannot cover them (callers check ``free_pages``
        first: admission waits)."""
        if n > len(self._free):
            raise RuntimeError(
                f"KV page pool exhausted: want {n}, have {len(self._free)}")
        ids, self._free = self._free[:n], self._free[n:]
        for page in ids:
            self._refs[page] = 1
        return ids

    def incref(self, ids: list[int]) -> None:
        """Add one holder to each page; only allocated pages can gain one."""
        for page in ids:
            if self._refs.get(page, 0) <= 0:
                raise PagePoolError(
                    f"incref of page {page}, which is not allocated: only a "
                    f"live page can gain a holder")
        for page in ids:
            self._refs[page] += 1

    def free(self, ids: list[int]) -> None:
        """Drop one holder per page; a page returns to the free list at
        refcount 0.  Raises ``PagePoolError`` on the trash page, on ids
        outside the pool and on double frees."""
        for page in ids:
            if page == 0:
                raise PagePoolError(
                    "page 0 is the trash page: it is never allocated and must "
                    "never be freed (masked writes land there)")
            if not 1 <= page <= self.num_pages:
                raise PagePoolError(
                    f"page {page} is outside the pool's [1, {self.num_pages}] range")
            rc = self._refs.get(page, 0)
            if rc <= 0:
                raise PagePoolError(
                    f"double free of page {page}: it has no holders (already "
                    f"free or never allocated)")
            if rc == 1:
                del self._refs[page]
                self._free.append(page)
            else:
                self._refs[page] = rc - 1
        self._free.sort()  # deterministic reuse order


def hybrid_pool_pages(cfg: ModelConfig, capacity: int) -> int:
    """Usable pages of a serving pool (the trash page excluded):
    ``cfg.kv_pool_pages``, or every slot's full ``kv_slot_tokens``
    budget at once."""
    return cfg.kv_pool_pages or capacity * cfg.kv_pages_per_slot


def init_pool(cfg: ModelConfig, capacity: int, device=None) -> dict:
    """An empty slot pool for ``capacity`` concurrent requests; hybrid
    stacks add the KV page pool (``hybrid_pool_pages`` pages + trash)."""
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    S = capacity

    def full(v, dtype):
        return torch.full((S,), v, dtype=dtype, device=device)

    state = {"blocks": init_lm_blocks_state(cfg, S, device)}
    if cfg.attn_layer_idx:
        n_attn = len(cfg.attn_layer_idx)
        # one page per "row" of init_attention_state: 1 + n_pages pages
        layer = init_attention_state(cfg, hybrid_pool_pages(cfg, capacity),
                                     cfg.kv_page_tokens, device)
        state["attn_blocks"] = tuple(x[None].repeat(n_attn, *([1] * x.ndim))
                                     for x in layer)
    return {
        "state": state,
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
