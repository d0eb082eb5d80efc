"""Pooled recurrent-state cache: the slot pool under the serving engine,
and the KV page allocator of hybrid stacks (counterpart of
``mamba_distributed_tpu/serving/state_cache.py``).

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
      "adapter_id": int32,              # LoRA factor-pool row (0 = none)
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

The admission and occupancy features of the engine add: ``restore`` (a
preempted request back mid-decode), ``copy_page`` (the prefix cache's
copy-on-write of a shared page) and ``gather_slots``/``scatter_slots``
(the compacted tick's lanes).

On a serving mesh each rank's pool is its part (``init_pool(mesh=)``):
the writes below take that pool's rows (a slot's row within its data
shard's block, a page's row within its shard's tile), and gathers and
scatters stay within the shard.
"""

from __future__ import annotations

import torch

import numpy as np

from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.models.attention import init_attention_state
from mamba_distributed_tpu_torch.models.lm import init_lm_blocks_state, stage_layers
from mamba_distributed_tpu_torch.parallel.tp_layout import block_tp


class PagePoolError(RuntimeError):
    """A page-accounting violation: double free, freeing the trash page,
    or a page id outside the pool.  Always a caller bug, so it raises
    instead of corrupting the free list."""


def page_shard_ranges(num_pages: int, num_shards: int) -> list[tuple[int, int]]:
    """Each data shard's usable page ids ``[lo, hi)``: the (P+1) page ids
    (trash page 0 included) cut into equal contiguous tiles, shard d
    owning ``[d (P+1)/n, (d+1) (P+1)/n)`` minus page 0, which lies in
    shard 0 and is never handed out (JAX ``state_cache.py:94-122``).
    Needs ``(num_pages + 1) % num_shards == 0`` (``hybrid_pool_pages``
    rounds up to it)."""
    rows = num_pages + 1
    if rows % num_shards:
        raise ValueError(
            f"page array of {rows} rows (pages + trash) does not divide "
            f"over {num_shards} shards"
        )
    per = rows // num_shards
    if per < 2:
        raise ValueError(
            f"{num_pages} usable pages over {num_shards} shards leaves "
            f"shard 0 with none (its tile is the trash page); raise "
            f"cfg.kv_pool_pages or lower serving_data_shards"
        )
    return [(max(1, d * per), (d + 1) * per) for d in range(num_shards)]


class PagePool:
    """Host-side KV page allocator of a hybrid pool: free lists over the
    physical pages [1, num_pages]; page 0 is the trash page and is never
    handed out.  Pages are refcounted: ``alloc`` hands them out at one
    holder, ``incref`` adds a holder, ``free`` drops one and returns a
    page to its shard's free list at zero.

    With ``num_shards > 1`` (a serving mesh's data axis) the pages fall
    into per-shard free lists along ``page_shard_ranges``: a slot of data
    shard d allocates only from shard d's pages, which only shard d's
    ranks hold (``local_rows`` maps a shard's global ids to its rows of
    the page arrays).  The model and stage axes never cut pages."""

    def __init__(self, num_pages: int, num_shards: int = 1):
        if num_pages < 1:
            raise ValueError(f"need >= 1 usable page, got {num_pages}")
        if num_shards < 1:
            raise ValueError(f"need >= 1 shard, got {num_shards}")
        self.num_pages = num_pages
        self.num_shards = num_shards
        self._ranges = page_shard_ranges(num_pages, num_shards)
        self._free_lists = [list(range(lo, hi)) for lo, hi in self._ranges]
        self._refs: dict[int, int] = {}  # allocated page -> holder count

    @property
    def _free(self) -> list[int]:
        """Every free page, sorted (shard-blind callers and tests)."""
        return sorted(p for lst in self._free_lists for p in lst)

    @property
    def free_pages(self) -> int:
        return sum(len(lst) for lst in self._free_lists)

    def free_pages_in(self, shard: int) -> int:
        return len(self._free_lists[shard])

    def shard_capacity(self, shard: int) -> int:
        """Pages shard ``shard`` could ever have free (its range)."""
        lo, hi = self._ranges[shard]
        return hi - lo

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - self.free_pages

    def refcount(self, page: int) -> int:
        """Current holder count (0 = free or never allocated)."""
        return self._refs.get(page, 0)

    def _owner(self, page: int) -> int:
        if not 1 <= page <= self.num_pages:
            raise ValueError(f"page {page} outside every shard range")
        return page // ((self.num_pages + 1) // self.num_shards)

    def shard_rows(self) -> int:
        """Rows of a shard's page arrays: the whole pool with its trash
        page at one shard, else one tile and a local trash row 0."""
        if self.num_shards == 1:
            return self.num_pages + 1
        return (self.num_pages + 1) // self.num_shards + 1

    def local_rows(self, ids, shard: int):
        """Shard ``shard``'s rows of the page arrays for global page ids
        (a numpy array): its own pages at ``id - lo + 1``, every other id
        (the trash page 0, another shard's page) at its local trash row
        0, so no rank writes a page it does not hold.  The identity at
        one shard."""
        lo, hi = self._ranges[shard]
        return np.where((ids >= lo) & (ids < hi), ids - lo + 1, 0).astype(ids.dtype)

    def alloc(self, n: int, shard: int = 0) -> list[int]:
        """Reserve ``n`` pages of ``shard``'s range at refcount 1, lowest
        ids first, or raise when it cannot cover them (callers check
        ``free_pages_in`` first: admission waits)."""
        lst = self._free_lists[shard]
        if n > len(lst):
            raise RuntimeError(
                f"KV page pool exhausted: want {n}, shard {shard} has {len(lst)}")
        ids, self._free_lists[shard] = lst[:n], lst[n:]
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
        """Drop one holder per page; a page returns to its shard's free
        list at refcount 0.  Raises ``PagePoolError`` on the trash page,
        on ids outside the pool and on double frees."""
        touched = set()
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
                d = self._owner(page)
                self._free_lists[d].append(page)
                touched.add(d)
            else:
                self._refs[page] = rc - 1
        for d in touched:
            self._free_lists[d].sort()  # deterministic reuse order


def hybrid_pool_pages(cfg: ModelConfig, capacity: int, num_shards: int = 1) -> int:
    """Usable pages of a serving pool (the trash page excluded):
    ``cfg.kv_pool_pages``, or every slot's full ``kv_slot_tokens``
    budget at once; over data shards, rounded up so the (P+1) page ids
    divide over them."""
    pages = cfg.kv_pool_pages or capacity * cfg.kv_pages_per_slot
    if num_shards > 1 and (pages + 1) % num_shards:
        pages += num_shards - (pages + 1) % num_shards
    return pages


def init_pool(cfg: ModelConfig, capacity: int, device=None, mesh=None) -> dict:
    """An empty slot pool for ``capacity`` concurrent requests; hybrid
    stacks add the KV page pool (``hybrid_pool_pages`` pages + trash).
    On a serving ``mesh`` (parallel/mesh.ServingMesh) it is this rank's
    part only: its data shard's block of ``capacity / data`` slots and
    page rows (``PagePool.shard_rows``), its model rank's heads and its
    stage's layers (``parallel/sharding.slot_pool_specs`` records the
    cut)."""
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    tp, stages, shards = (None, 1, 1) if mesh is None else (mesh.tp, mesh.stage, mesh.data)
    S = capacity // shards

    def full(v, dtype):
        return torch.full((S,), v, dtype=dtype, device=device)

    state = {"blocks": init_lm_blocks_state(cfg, S, device, tp, stages)}
    if cfg.attn_layer_idx:
        n_attn = stage_layers(cfg, stages)[1]
        pages = hybrid_pool_pages(cfg, capacity, shards)
        rows = PagePool(pages, shards).shard_rows()
        layer = init_attention_state(cfg, 0, cfg.kv_page_tokens, device,
                                     tp=block_tp(tp, cfg, "attn"), pages=rows)
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
            # the slot's LoRA factor-pool row (serving/adapters.py): the
            # tick binds it as the launch's row ids; 0 is the zero row
            "adapter_id": full(0, torch.int32),
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
           max_new: int, top_k: int, temperature: float, eos_id: int,
           adapter_id: int = 0) -> dict:
    """Admit a prefilled request (batch-1 ``state`` + last ``logits``)
    into ``slot``, in place.  ``adapter_id`` is the request's LoRA
    factor-pool row (0 = none)."""
    _write_blocks(pool, slot, state)
    pool["logits"][slot].copy_(logits[0])
    _write_meta(pool, slot, active=True, done=False, prefilling=False,
                step=0, max_new=max_new, top_k=top_k, temperature=temperature,
                eos_id=eos_id, adapter_id=adapter_id)
    return pool


def restore(pool: dict, slot: int, state: dict, logits: torch.Tensor, step: int,
            max_new: int, top_k: int, temperature: float, eos_id: int,
            adapter_id: int = 0) -> dict:
    """Re-admit a PREEMPTED request mid-decode (in place): ``insert`` with
    the generated-token counter restored instead of zeroed, so the
    stream continues where the swap-out cut it (and its adapter row)."""
    _write_blocks(pool, slot, state)
    pool["logits"][slot].copy_(logits[0])
    _write_meta(pool, slot, active=True, done=False, prefilling=False,
                step=step, max_new=max_new, top_k=top_k, temperature=temperature,
                eos_id=eos_id, adapter_id=adapter_id)
    return pool


def copy_page(attn_blocks: tuple, src: int, dst: int) -> tuple:
    """Copy-on-write page duplication: copy physical page ``src`` into
    ``dst`` across every attention layer's K and V pool (page axis 1 of
    the (A, P+1, nkv, page, hd) leaves) and, for int8 pages, the page's
    (A, P+1, nkv) scales, in place.  A slot that appends to a shared
    cached prefix writes into its own copy of the boundary page; the
    sharers keep reading the original."""
    for t in attn_blocks:
        t[:, dst].copy_(t[:, src])
    return attn_blocks


def gather_slots(rows: dict, idx: torch.Tensor) -> dict:
    """Gather slot rows ``idx`` (W,) of a ``{"blocks", "logits", "meta"}``
    tree (the per-slot parts of a pool: ``blocks`` leaves (L, S, ...) on
    axis 1, ``logits`` and ``meta`` leaves on axis 0) into a compact tree
    of W lanes (copies: the full pool lives on).  Pad lanes may repeat
    any in-range slot: ``scatter_slots`` never reads them back."""
    return {
        "blocks": tuple(t.index_select(1, idx) for t in rows["blocks"]),
        "logits": rows["logits"].index_select(0, idx),
        "meta": {k: v.index_select(0, idx) for k, v in rows["meta"].items()},
    }


def scatter_slots(rows: dict, compact: dict, inv: torch.Tensor,
                  touched: torch.Tensor) -> dict:
    """Write a compacted tick's lanes back into the full rows, in place:
    slot s takes lane ``inv[s]`` where ``touched[s]`` and keeps its row
    otherwise (mid-prefill carries, empty slots).  A per-slot gather and
    select, not a scatter, so a pad lane that repeats a slot can never
    overwrite a live row."""

    def put(full, lanes, ax):
        sel = touched.reshape((1,) * ax + (-1,) + (1,) * (full.ndim - ax - 1))
        full.copy_(torch.where(sel, lanes.index_select(ax, inv), full))

    for f, c in zip(rows["blocks"], compact["blocks"]):
        put(f, c, 1)
    put(rows["logits"], compact["logits"], 0)
    for k, f in rows["meta"].items():
        put(f, compact["meta"][k], 0)
    return rows


def evict(pool: dict, slot: int) -> dict:
    """Free ``slot``: mark it empty.  Stale state and logits stay (the
    next insert overwrites them; the tick masks inactive slots)."""
    _write_meta(pool, slot, active=False, done=False, prefilling=False)
    return pool


def stash_prefill(pool: dict, slot: int, state: dict, max_new: int,
                  top_k: int, temperature: float, eos_id: int,
                  adapter_id: int = 0) -> dict:
    """Park a PARTIAL prefill carry in ``slot`` (in place): active, but
    ``prefilling`` keeps it out of the decode tick.  Re-stashing after
    more chunks overwrites the carry."""
    _write_blocks(pool, slot, state)
    _write_meta(pool, slot, active=True, done=False, prefilling=True,
                step=0, max_new=max_new, top_k=top_k, temperature=temperature,
                eos_id=eos_id, adapter_id=adapter_id)
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
