"""Ragged paged attention through the hand-written Hopper kernels
(``csrc/ragged_paged_attention.cu``), and their plain PyTorch versions.

Counterparts of ``ragged_paged_decode_attention`` and
``ragged_paged_prefill_attention`` (mamba_distributed_tpu/ops/pallas/
attention_kernels.py:612 and :868): the kernel ``rpa_fwd`` replaces
``_rpa_kernel`` (:525) and ``rpp_fwd`` replaces ``_rpp_kernel`` (:722),
for bf16 and fp32 pages (the int8 branches wait for ops/quant.py).  The
source's header states what bounds them on the card and what their
design does about that.

Layouts are the JAX package's: pages ``(P, nkv, page, hd)``, head-major,
page 0 the trash page; ``page_table`` ``(b, W)`` int32; ``kv_len``,
``lengths`` and ``chunk_real`` ``(b,)`` int32.  Query head ``g * rep + e``
reads KV head ``g``.

The plain versions are the scatter + ``gather_kv_pages`` +
``_sdpa_positions`` formulation of the JAX package's fallback path
(models/attention.py re-exports the two helpers).  Each wrapper runs its
plain version on a CPU tensor; on a CUDA tensor it launches its kernel or
raises.  ``build.LAUNCHES`` counts the launches (``"ragged_decode"``,
``"ragged_prefill"``).  Both kernels read q and the chunk K/V through
their strides (slices of the qkv projection go in uncopied); pages,
tables and lengths must be contiguous.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from mamba_distributed_tpu_torch.ops.cuda import build
from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
from mamba_distributed_tpu_torch.ops.dispatch import use_kernel

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


# ------------------------------------------------------------ plain versions


def gather_kv_pages(k_pages: torch.Tensor, v_pages: torch.Tensor,
                    page_table: torch.Tensor,
                    live_pages: torch.Tensor | None = None):
    """Each row's logical KV view: pages (P, nkv, pg, hd) + table (b, W)
    -> (b, W*pg, nkv, hd) for K and V.  ``live_pages`` (b,) redirects
    table entries at or past each row's live extent to the trash page, so
    the gather reads live pages only; every position there is masked by
    the callers' position bounds, so no live output changes."""
    b, W = page_table.shape
    _, nkv, pg, hd = k_pages.shape
    if live_pages is not None:
        col = torch.arange(W, device=page_table.device)
        page_table = torch.where(col[None, :] < live_pages[:, None], page_table, 0)
    idx = page_table.long()

    def gather(pages):
        return pages[idx].transpose(2, 3).reshape(b, W * pg, nkv, hd)

    return gather(k_pages), gather(v_pages)


def _sdpa_positions(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    qpos: torch.Tensor) -> torch.Tensor:
    """Masked SDPA with per-row absolute query positions: q (b, tq, nh,
    hd), k/v (b, L, nkv, hd) the gathered cache view, qpos (b, tq); query
    i of row r attends cache position j iff ``j <= qpos[r, i]``.  Scores
    and softmax in fp32, weights rounded to q's dtype for the PV product,
    fp32 accumulation (bf16 products are exact in fp32)."""
    b, tq, nh, hd = q.shape
    nkv = k.shape[2]
    qh = q.reshape(b, tq, nkv, nh // nkv, hd).float()
    scores = torch.einsum("bqgrh,bkgh->bgrqk", qh, k.float()) / math.sqrt(hd)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = qpos[:, None, None, :, None] >= kpos
    scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrqk,bkgh->bqgrh", w.float(), v.float())
    return out.reshape(b, tq, nh, hd).to(q.dtype)


def ragged_paged_decode_attention_plain(q, k_pages, v_pages, page_table, kv_len):
    """The plain version of ``ragged_paged_decode_attention``: gather the
    live pages, masked SDPA at position ``kv_len - 1``.  Rows with
    ``kv_len == 0`` emit zeros, as the kernel does."""
    pg = k_pages.shape[2]
    kk, vv = gather_kv_pages(k_pages, v_pages, page_table, (kv_len + pg - 1) // pg)
    out = _sdpa_positions(q[:, None], kk, vv, (kv_len - 1)[:, None])[:, 0]
    return torch.where((kv_len > 0)[:, None, None], out, torch.zeros((), dtype=out.dtype,
                                                                     device=out.device))


def ragged_paged_prefill_attention_plain(q, k_chunk, v_chunk, k_pages, v_pages,
                                         page_table, lengths, chunk_real):
    """The plain version of ``ragged_paged_prefill_attention``: scatter
    the chunk's real rows into their pages (in place; left-pad rows go to
    the trash page), gather the live pages, masked SDPA at each query's
    position.  Returns (o, k_pages, v_pages)."""
    b, c = q.shape[:2]
    pg = k_pages.shape[2]
    W = page_table.shape[1]
    i = torch.arange(c, device=q.device)
    pad = c - chunk_real
    posc = (lengths[:, None] + i[None, :] - pad[:, None]).clamp(min=0)
    real = i[None, :] >= pad[:, None]
    pidx = (posc // pg).clamp(0, W - 1)
    phys = torch.where(real, page_table.gather(1, pidx), 0).long()
    off = torch.where(real, posc % pg, 0).long()
    k_pages[phys, :, off] = k_chunk.to(k_pages.dtype)
    v_pages[phys, :, off] = v_chunk.to(v_pages.dtype)
    # live extent after the write = prefix + the chunk's real tokens (at
    # least one page: an all-pad row's queries clamp to position 0)
    tokens = (lengths + chunk_real).clamp(max=W * pg)
    kk, vv = gather_kv_pages(k_pages, v_pages, page_table,
                             ((tokens + pg - 1) // pg).clamp(min=1))
    out = _sdpa_positions(q, kk, vv, posc.clamp(max=W * pg - 1))
    return out, k_pages, v_pages


# ----------------------------------------------------------- kernel wrappers


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (built at first use)."""
    lib = build.load("ragged_paged_attention")
    lib.mdt_rpa_fwd.argtypes = [_P] * 6 + [_I] * 6 + [_L] * 2 + [_F, _I, _P]
    lib.mdt_rpa_fwd.restype = _I
    lib.mdt_rpp_fwd.argtypes = [_P] * 9 + [_I] * 8 + [_L] * 9 + [_F, _I, _P]
    lib.mdt_rpp_fwd.restype = _I
    for fn in (lib.mdt_rpa_max_rep, lib.mdt_rpa_max_head_dim):
        fn.argtypes = []
        fn.restype = _I
    return lib


def _check(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_common(name, q, k_pages, v_pages, page_table, lens, nh):
    """Checks shared by both wrappers; returns (lib, nkv, pg, hd, W)."""
    _, nkv, pg, hd = k_pages.shape
    b, W = page_table.shape
    _check(q.dtype in _DTYPE_CODE, name, f"dtype {q.dtype} not float32/bfloat16")
    for t_name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        _check(t.dtype == q.dtype, name, f"{t_name} dtype {t.dtype} != q dtype {q.dtype}")
        _check(t.is_contiguous() and t.device == q.device, name,
               f"{t_name} must be contiguous on {q.device}")
    _check(v_pages.shape == k_pages.shape, name, "k_pages and v_pages shapes differ")
    _check(q.shape[-1] == hd and q.stride(-1) == 1, name,
           f"q's last axis must be the head dim {hd}, contiguous")
    for t_name, t in (("page_table", page_table), *lens):
        _check(t.dtype == torch.int32 and t.is_contiguous() and t.device == q.device,
               name, f"{t_name} must be contiguous int32 on {q.device}")
        _check(t.shape[0] == b, name, f"{t_name} has {t.shape[0]} rows, table has {b}")
    _check(nh % nkv == 0, name, f"{nh} query heads do not split over {nkv} KV heads")
    lib = _lib()
    _check(nh // nkv <= lib.mdt_rpa_max_rep(), name,
           f"GQA rep {nh // nkv} > {lib.mdt_rpa_max_rep()} is not built")
    _check(hd <= lib.mdt_rpa_max_head_dim(), name,
           f"head dim {hd} > {lib.mdt_rpa_max_head_dim()} is not built")
    return lib, nkv, pg, hd, W


def ragged_paged_decode_attention(q, k_pages, v_pages, page_table, kv_len):
    """Paged decode attention with per-row lengths (the JAX contract).

    q (S, nh, hd) one query token per slot; k_pages/v_pages (P, nkv, pg,
    hd); page_table (S, W) int32; kv_len (S,) int32 tokens readable per
    row, including any written this step.  Returns (S, nh, hd); rows with
    ``kv_len == 0`` are zeros."""
    if not use_kernel("pallas", q):
        return ragged_paged_decode_attention_plain(q, k_pages, v_pages, page_table, kv_len)
    name = "ragged_paged_decode_attention"
    S, nh, hd = q.shape
    lib, nkv, pg, hd, W = _check_common(name, q, k_pages, v_pages, page_table,
                                        [("kv_len", kv_len)], nh)
    out = torch.empty((S, nh, hd), dtype=q.dtype, device=q.device)
    err = lib.mdt_rpa_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), S, nh, nkv, hd, pg, W,
        q.stride(0), q.stride(1), 1.0 / math.sqrt(hd), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"rpa_fwd launch failed: cudaError {err}")
    LAUNCHES["ragged_decode"] += 1
    return out


def ragged_paged_prefill_attention(q, k_chunk, v_chunk, k_pages, v_pages,
                                   page_table, lengths, chunk_real):
    """Fused paged prefill (the JAX contract): write one chunk's K/V into
    each row's pages, then attend every chunk query over the page view.

    q (b, c, nh, hd) RoPE'd chunk queries; k_chunk/v_chunk (b, c, nkv, hd)
    (left-pad rows are never written); k_pages/v_pages (P, nkv, pg, hd);
    page_table (b, W) int32; lengths (b,) int32 tokens cached before the
    chunk; chunk_real (b,) int32 real tokens in the chunk.  Real token i
    lands at position ``lengths[r] + i - pad``.  The pages are written IN
    PLACE.  Returns (o (b, c, nh, hd), k_pages, v_pages); output rows of
    pad queries are garbage on both versions."""
    if not use_kernel("pallas", q):
        return ragged_paged_prefill_attention_plain(
            q, k_chunk, v_chunk, k_pages, v_pages, page_table, lengths, chunk_real)
    name = "ragged_paged_prefill_attention"
    b, c, nh, hd = q.shape
    lib, nkv, pg, hd, W = _check_common(
        name, q, k_pages, v_pages, page_table,
        [("lengths", lengths), ("chunk_real", chunk_real)], nh)
    for t_name, t in (("k_chunk", k_chunk), ("v_chunk", v_chunk)):
        _check(tuple(t.shape) == (b, c, nkv, hd), name,
               f"{t_name} shape {tuple(t.shape)} != {(b, c, nkv, hd)}")
        _check(t.dtype == q.dtype and t.device == q.device and t.stride(-1) == 1, name,
               f"{t_name} must be {q.dtype} on {q.device} with a contiguous last axis")
    out = torch.empty((b, c, nh, hd), dtype=q.dtype, device=q.device)
    err = lib.mdt_rpp_fwd(
        q.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        chunk_real.data_ptr(), out.data_ptr(), b, c, nh, nkv, hd, pg, W,
        k_pages.shape[0], *q.stride()[:3], *k_chunk.stride()[:3], *v_chunk.stride()[:3],
        1.0 / math.sqrt(hd), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"rpp_fwd launch failed: cudaError {err}")
    LAUNCHES["ragged_prefill"] += 1
    return out, k_pages, v_pages
