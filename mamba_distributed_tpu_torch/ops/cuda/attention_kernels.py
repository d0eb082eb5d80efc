"""Ragged paged attention through the hand-written Hopper kernels
(``csrc/ragged_paged_attention.cu``), and their plain PyTorch versions.

Counterparts of ``ragged_paged_decode_attention`` and
``ragged_paged_prefill_attention`` (mamba_distributed_tpu/ops/pallas/
attention_kernels.py:612 and :868): the kernel ``rpa_fwd`` replaces
``_rpa_kernel`` (:525) and ``rpp_fwd`` replaces ``_rpp_kernel`` (:722),
for bf16 and fp32 pages and, with their int8 branches, for int8 pages
with per-(page, KV head) fp32 scales (ops/quant.py,
models/attention.py).  The source's header states what bounds them on
the card and what their design does about that.

Layouts are the JAX package's: pages ``(P, nkv, page, hd)``, head-major,
page 0 the trash page; ``page_table`` ``(b, W)`` int32; ``kv_len``,
``lengths`` and ``chunk_real`` ``(b,)`` int32.  Query head ``g * rep + e``
reads KV head ``g``.

The plain versions are the scatter + ``gather_kv_pages`` +
``_sdpa_positions`` formulation of the JAX package's fallback path
(models/attention.py re-exports the two helpers); with int8 pages, the
requant-merge of the chunk's write window (models/attention.py:648-699)
and a dequantizing gather into q's dtype.  Each wrapper runs its plain
version on a CPU tensor; on a CUDA tensor it launches its kernel or
raises.  ``build.LAUNCHES`` counts the launches (``"ragged_decode"``,
``"ragged_prefill"``; int8 pages ``"ragged_decode_int8"``,
``"ragged_prefill_int8"``).  Both kernels read q and the chunk K/V
through their strides (slices of the qkv projection go in uncopied);
pages, scales, tables and lengths must be contiguous.

The prefill's attend runs on the tensor cores (``wgmma`` on bf16 tiles,
the K/V tiles copied out of the pool by TMA) when
``rpp_uses_tensor_cores`` says so: bf16 q, head dim 32, 64 or 128, pages
a multiple of 64 tokens, bf16 or int8 pages.  That one rule, by dtype
and shape, is also the C dispatch's (``mdt_rpp_uses_tc``); every other
shape runs the CUDA-core attend.  TMA needs the (contiguous) pools to
start at a 16-byte boundary, which the wrapper checks and raises on
rather than copying.

The decode is split-K: each row's pages are cut into ``rpa_splits``
ranges of whole pages (the C side's ``mdt_rpa_splits`` is the same
rule), one CTA of four warps each, and a second small kernel combines
the ranges' fp32 partials from a workspace (one range: the walk writes
the output).
The wrapper allocates the workspace from PyTorch's caching allocator (no
launch, no host synchronisation); the call counts one launch.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from mamba_distributed_tpu_torch.ops.cuda import build
from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
from mamba_distributed_tpu_torch.ops.dispatch import use_kernel
from mamba_distributed_tpu_torch.ops.quant import kv_quantize, kv_requant

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# the limits the kernels are built for (``mdt_rpa_max_rep`` and
# ``mdt_rpa_max_head_dim``; ``chip_smoke.py`` holds them to agree)
MAX_REP = 64
MAX_HEAD_DIM = 128
# the tensor-core prefill attend: head dims, and the page multiple of its
# 64-key tiles (``mdt_rpp_uses_tc``)
TC_HEAD_DIMS = (32, 64, 128)
TC_KEYS = 64
# the split decode: about two CTAs (of four warps) on each of the H100's
# 132 SMs, what their registers let run at once (``kSplitTargetCtas``)
SPLIT_TARGET_CTAS = 2 * 132


def rpa_split_pages(S: int, nkv: int, W: int) -> int:
    """Pages in each of a decode row's split ranges, for S slots, nkv KV
    heads and W pages a slot (the C dispatch's ``rpa_split_pages``)."""
    splits = max(1, min(W, -(-SPLIT_TARGET_CTAS // (S * nkv))))
    return -(-W // splits)


def rpa_splits(S: int, nkv: int, W: int) -> int:
    """How many page ranges the decode cuts each row into (``mdt_rpa_splits``)."""
    return -(-W // rpa_split_pages(S, nkv, W))


def rpp_uses_tensor_cores(dtype: torch.dtype, hd: int, pg: int) -> bool:
    """Whether a prefill with q of ``dtype``, head dim ``hd`` and pages of
    ``pg`` tokens runs the tensor-core attend (the C dispatch's rule)."""
    return dtype == torch.bfloat16 and hd in TC_HEAD_DIMS and pg % TC_KEYS == 0


# ------------------------------------------------------------ plain versions


def gather_kv_pages(k_pages: torch.Tensor, v_pages: torch.Tensor,
                    page_table: torch.Tensor,
                    live_pages: torch.Tensor | None = None,
                    k_scale: torch.Tensor | None = None,
                    v_scale: torch.Tensor | None = None,
                    dtype: torch.dtype = torch.float32):
    """Each row's logical KV view: pages (P, nkv, pg, hd) + table (b, W)
    -> (b, W*pg, nkv, hd) for K and V.  ``live_pages`` (b,) redirects
    table entries at or past each row's live extent to the trash page, so
    the gather reads live pages only; every position there is masked by
    the callers' position bounds, so no live output changes.
    ``k_scale``/``v_scale`` (int8 pools, (P, nkv)) dequantize the
    gathered pages into ``dtype``: codes and scales each cast to it, then
    multiplied (models/attention.py:331-371)."""
    b, W = page_table.shape
    _, nkv, pg, hd = k_pages.shape
    if live_pages is not None:
        col = torch.arange(W, device=page_table.device)
        page_table = torch.where(col[None, :] < live_pages[:, None], page_table, 0)
    idx = page_table.long()

    def gather(pages, scales):
        x = pages[idx]
        if scales is not None:
            x = x.to(dtype) * scales[idx][..., None, None].to(dtype)
        return x.transpose(2, 3).reshape(b, W * pg, nkv, hd)

    return gather(k_pages, k_scale), gather(v_pages, v_scale)


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


def ragged_paged_decode_attention_plain(q, k_pages, v_pages, page_table, kv_len,
                                        k_scale=None, v_scale=None):
    """The plain version of ``ragged_paged_decode_attention``: gather the
    live pages (int8 pages dequantized into q's dtype), masked SDPA at
    position ``kv_len - 1``.  Rows with ``kv_len == 0`` emit zeros, as
    the kernel does."""
    pg = k_pages.shape[2]
    kk, vv = gather_kv_pages(k_pages, v_pages, page_table, (kv_len + pg - 1) // pg,
                             k_scale, v_scale, q.dtype)
    out = _sdpa_positions(q[:, None], kk, vv, (kv_len - 1)[:, None])[:, 0]
    return torch.where((kv_len > 0)[:, None, None], out, torch.zeros((), dtype=out.dtype,
                                                                     device=out.device))


def _requant_merge(pages, old_scales, new_scales, x, page_table, lengths, chunk_real,
                   real, posc):
    """The int8 chunk write of the plain version (models/attention.py:
    648-679), in place: every page of each row's write window (at most
    ceil(c / pg) + 1 pages from ``lengths // pg``) is rewritten whole,
    its old rows requantized under the page's new scale (ratio 0 when the
    page holds no prior token of the row) and the chunk's real rows
    quantized in; window slots that take no write go to the trash page."""
    b, c = real.shape
    _, nkv, pg, hd = pages.shape
    W = page_table.shape[1]
    Wc = min(W, -(-c // pg) + 1)
    j0 = lengths.long() // pg
    wj = j0[:, None] + torch.arange(Wc, device=x.device)[None, :]       # (b, Wc)
    in_range = wj < W
    wtbl = page_table.gather(1, torch.where(in_range, wj, W - 1)).long()
    total = (lengths + chunk_real)[:, None]
    takes = ((wj * pg < total) & ((wj + 1) * pg > lengths[:, None])
             & (chunk_real > 0)[:, None] & in_range)
    has_prior = (lengths[:, None] > wj * pg) & in_range
    lpos = (posc - (j0 * pg)[:, None]).clamp(0, Wc * pg - 1)             # (b, c)
    old_s, new_s = old_scales[wtbl], new_scales[wtbl]                   # (b, Wc, nkv)
    ratio = torch.where(has_prior[..., None], old_s / new_s, 0.0)
    req = kv_requant(pages[wtbl], ratio[..., None, None])               # (b, Wc, nkv, pg, hd)
    row_s = new_s.gather(1, (lpos // pg)[:, :, None].expand(b, c, nkv))
    q_rows = kv_quantize(x, row_s[..., None])                           # (b, c, nkv, hd)
    # the window as a flat (b, Wc*pg + 1, nkv, hd) view; pad rows land in
    # the extra last slot
    view = torch.cat([req.transpose(2, 3).reshape(b, Wc * pg, nkv, hd),
                      req.new_zeros((b, 1, nkv, hd))], dim=1)
    idx = torch.where(real, lpos, Wc * pg)
    view[torch.arange(b, device=x.device)[:, None], idx] = q_rows
    merged = view[:, :-1].reshape(b, Wc, pg, nkv, hd).transpose(2, 3)
    pages[torch.where(takes, wtbl, 0)] = merged.to(pages.dtype)


def ragged_paged_prefill_attention_plain(q, k_chunk, v_chunk, k_pages, v_pages,
                                         page_table, lengths, chunk_real,
                                         k_scale_old=None, v_scale_old=None,
                                         k_scale_new=None, v_scale_new=None):
    """The plain version of ``ragged_paged_prefill_attention``: scatter
    the chunk's real rows into their pages (in place; left-pad rows go to
    the trash page), gather the live pages, masked SDPA at each query's
    position.  Int8 pages (the four scales given): the requant-merge of
    the write window (``_requant_merge``), then a gather dequantized with
    the new scales into q's dtype.  Returns (o, k_pages, v_pages)."""
    b, c = q.shape[:2]
    pg = k_pages.shape[2]
    W = page_table.shape[1]
    i = torch.arange(c, device=q.device)
    pad = c - chunk_real
    posc = (lengths[:, None] + i[None, :] - pad[:, None]).clamp(min=0)
    real = i[None, :] >= pad[:, None]
    if k_scale_old is not None:
        window = (page_table, lengths, chunk_real, real, posc)
        _requant_merge(k_pages, k_scale_old, k_scale_new, k_chunk, *window)
        _requant_merge(v_pages, v_scale_old, v_scale_new, v_chunk, *window)
    else:
        pidx = (posc // pg).clamp(0, W - 1)
        phys = torch.where(real, page_table.gather(1, pidx), 0).long()
        off = torch.where(real, posc % pg, 0).long()
        k_pages[phys, :, off] = k_chunk.to(k_pages.dtype)
        v_pages[phys, :, off] = v_chunk.to(v_pages.dtype)
    # live extent after the write = prefix + the chunk's real tokens (at
    # least one page: an all-pad row's queries clamp to position 0)
    tokens = (lengths + chunk_real).clamp(max=W * pg)
    kk, vv = gather_kv_pages(k_pages, v_pages, page_table,
                             ((tokens + pg - 1) // pg).clamp(min=1),
                             k_scale_new, v_scale_new, q.dtype)
    out = _sdpa_positions(q, kk, vv, posc.clamp(max=W * pg - 1))
    return out, k_pages, v_pages


# ----------------------------------------------------------- kernel wrappers


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (built at first use)."""
    lib = declare(build.load("ragged_paged_attention"))
    for fn in (lib.mdt_rpp_uses_tc, lib.mdt_rpa_splits):
        fn.argtypes = [_I, _I, _I]
        fn.restype = _I
    return lib


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``ragged_paged_attention.cu``) with the C
    signatures of its two kernels and its limits declared."""
    lib.mdt_rpa_fwd.argtypes = [_P] * 9 + [_I] * 7 + [_L] * 2 + [_F, _I, _I, _P]
    lib.mdt_rpa_fwd.restype = _I
    lib.mdt_rpp_fwd.argtypes = [_P] * 13 + [_I] * 8 + [_L] * 9 + [_F, _I, _I, _P]
    lib.mdt_rpp_fwd.restype = _I
    for fn in (lib.mdt_rpa_max_rep, lib.mdt_rpa_max_head_dim):
        fn.argtypes = []
        fn.restype = _I
    return lib


def _check(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_common(name, q, k_pages, v_pages, page_table, lens, nh, scales, lib=None):
    """Checks shared by both wrappers; returns (lib, nkv, pg, hd, W),
    ``lib`` the package's build unless the caller gave another.
    ``scales`` are the (name, tensor) scale arguments: all given for
    int8 pages, none for bf16/fp32 pages."""
    P, nkv, pg, hd = k_pages.shape
    b, W = page_table.shape
    _check(q.dtype in (torch.float32, torch.bfloat16), name,
           f"dtype {q.dtype} not float32/bfloat16")
    quant = k_pages.dtype == torch.int8
    for t_name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        _check(t.dtype == (torch.int8 if quant else q.dtype), name,
               f"{t_name} dtype {t.dtype} is neither int8 nor q's {q.dtype}")
        _check(t.is_contiguous() and t.device == q.device, name,
               f"{t_name} must be contiguous on {q.device}")
    _check(v_pages.shape == k_pages.shape, name, "k_pages and v_pages shapes differ")
    given = [t is not None for _, t in scales]
    _check(all(given) if quant else not any(given), name,
           f"int8 pages take all of {[n for n, _ in scales]} and other pages none")
    for t_name, t in scales if quant else ():
        _check(t.dtype == torch.float32 and tuple(t.shape) == (P, nkv)
               and t.is_contiguous() and t.device == q.device, name,
               f"{t_name} must be a contiguous fp32 {(P, nkv)} on {q.device}")
    _check(q.shape[-1] == hd and q.stride(-1) == 1, name,
           f"q's last axis must be the head dim {hd}, contiguous")
    for t_name, t in (("page_table", page_table), *lens):
        _check(t.dtype == torch.int32 and t.is_contiguous() and t.device == q.device,
               name, f"{t_name} must be contiguous int32 on {q.device}")
        _check(t.shape[0] == b, name, f"{t_name} has {t.shape[0]} rows, table has {b}")
    _check(nh % nkv == 0, name, f"{nh} query heads do not split over {nkv} KV heads")
    _check(nh // nkv <= MAX_REP, name, f"GQA rep {nh // nkv} > {MAX_REP} is not built")
    _check(hd <= MAX_HEAD_DIM, name, f"head dim {hd} > {MAX_HEAD_DIM} is not built")
    return _lib() if lib is None else lib, nkv, pg, hd, W


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def ragged_paged_decode_attention(q, k_pages, v_pages, page_table, kv_len,
                                  k_scale=None, v_scale=None, *, lib=None,
                                  split_rows: int | None = None):
    """Paged decode attention with per-row lengths (the JAX contract).

    q (S, nh, hd) one query token per slot; k_pages/v_pages (P, nkv, pg,
    hd); page_table (S, W) int32; kv_len (S,) int32 tokens readable per
    row, including any written this step; int8 pages take ``k_scale``
    and ``v_scale`` (P, nkv) fp32.  Returns (S, nh, hd) in q's dtype;
    rows with ``kv_len == 0`` are zeros.  ``lib``: another build of
    ``ragged_paged_attention.cu`` (through ``declare``) to launch instead
    of the package's.  ``split_rows``: the row count whose split rule
    cuts each row's pages (None: the launch's own S).  A row's result
    depends on its split count only, so a launch over some of a batch's
    rows that passes the batch's S computes what the batch's launch
    computes for them (the serving engine's compacted tick)."""
    if not use_kernel("pallas", q):
        return ragged_paged_decode_attention_plain(q, k_pages, v_pages, page_table, kv_len,
                                                   k_scale, v_scale)
    name = "ragged_paged_decode_attention"
    S, nh, hd = q.shape
    lib, nkv, pg, hd, W = _check_common(
        name, q, k_pages, v_pages, page_table, [("kv_len", kv_len)], nh,
        [("k_scale", k_scale), ("v_scale", v_scale)], lib)
    out = torch.empty((S, nh, hd), dtype=q.dtype, device=q.device)
    splits = rpa_splits(S if split_rows is None else split_rows, nkv, W)
    part = torch.empty(splits * S * nh * (hd + 2), dtype=torch.float32, device=q.device)
    err = lib.mdt_rpa_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        kv_len.data_ptr(), _ptr(k_scale), _ptr(v_scale), out.data_ptr(), part.data_ptr(),
        S, nh, nkv, hd, pg, W, splits,
        q.stride(0), q.stride(1), 1.0 / math.sqrt(hd), _DTYPE_CODE[q.dtype],
        _DTYPE_CODE[k_pages.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"rpa_fwd launch failed: cudaError {err}")
    LAUNCHES["ragged_decode_int8" if k_scale is not None else "ragged_decode"] += 1
    return out


def ragged_paged_prefill_attention(q, k_chunk, v_chunk, k_pages, v_pages,
                                   page_table, lengths, chunk_real,
                                   k_scale_old=None, v_scale_old=None,
                                   k_scale_new=None, v_scale_new=None, *, lib=None):
    """Fused paged prefill (the JAX contract): write one chunk's K/V into
    each row's pages, then attend every chunk query over the page view.

    q (b, c, nh, hd) RoPE'd chunk queries; k_chunk/v_chunk (b, c, nkv, hd)
    (left-pad rows are never written); k_pages/v_pages (P, nkv, pg, hd);
    page_table (b, W) int32; lengths (b,) int32 tokens cached before the
    chunk; chunk_real (b,) int32 real tokens in the chunk.  Real token i
    lands at position ``lengths[r] + i - pad``.  Int8 pages take the four
    (P, nkv) fp32 scales, old and new (``models/attention.
    _chunk_page_scales``); the kernel only reads them, and every page of
    each row's write window is rewritten.  The pages are written IN
    PLACE.  Returns (o (b, c, nh, hd), k_pages, v_pages); output rows of
    pad queries are garbage on both versions.  ``lib``: another build of
    ``ragged_paged_attention.cu`` (through ``declare``) to launch instead
    of the package's."""
    scales = [("k_scale_old", k_scale_old), ("v_scale_old", v_scale_old),
              ("k_scale_new", k_scale_new), ("v_scale_new", v_scale_new)]
    if not use_kernel("pallas", q):
        return ragged_paged_prefill_attention_plain(
            q, k_chunk, v_chunk, k_pages, v_pages, page_table, lengths, chunk_real,
            *(t for _, t in scales))
    name = "ragged_paged_prefill_attention"
    b, c, nh, hd = q.shape
    lib, nkv, pg, hd, W = _check_common(
        name, q, k_pages, v_pages, page_table,
        [("lengths", lengths), ("chunk_real", chunk_real)], nh, scales, lib)
    if rpp_uses_tensor_cores(q.dtype, hd, pg):  # TMA reads the pools from 16-byte boundaries
        for t_name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
            _check(t.data_ptr() % 16 == 0, name, f"{t_name} cannot be read by TMA: its data "
                   f"starts at byte {t.data_ptr() % 16} past a 16-byte boundary")
    for t_name, t in (("k_chunk", k_chunk), ("v_chunk", v_chunk)):
        _check(tuple(t.shape) == (b, c, nkv, hd), name,
               f"{t_name} shape {tuple(t.shape)} != {(b, c, nkv, hd)}")
        _check(t.dtype == q.dtype and t.device == q.device and t.stride(-1) == 1, name,
               f"{t_name} must be {q.dtype} on {q.device} with a contiguous last axis")
    out = torch.empty((b, c, nh, hd), dtype=q.dtype, device=q.device)
    err = lib.mdt_rpp_fwd(
        q.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        chunk_real.data_ptr(), _ptr(k_scale_old), _ptr(k_scale_new), _ptr(v_scale_old),
        _ptr(v_scale_new), out.data_ptr(), b, c, nh, nkv, hd, pg, W,
        k_pages.shape[0], *q.stride()[:3], *k_chunk.stride()[:3], *v_chunk.stride()[:3],
        1.0 / math.sqrt(hd), _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"rpp_fwd launch failed: cudaError {err}")
    LAUNCHES["ragged_prefill_int8" if k_scale_old is not None else "ragged_prefill"] += 1
    return out, k_pages, v_pages
