"""Causal GQA flash attention through the hand-written Hopper kernels
(``csrc/flash_attention.cu``), their plain PyTorch versions, and the
``torch.autograd.Function`` around them.

Counterpart of the flash half of mamba_distributed_tpu/ops/pallas/
attention_kernels.py (:51-501).  Three kernels:

* ``flash_fwd`` replaces ``_fa_fwd_kernel`` (:65): o and the row
  log-sum-exp, fully-future kv blocks skipped;
* ``flash_bwd_dq`` replaces ``_fa_bwd_dq_kernel`` (:127): dq (fp32);
* ``flash_bwd_dkv`` replaces ``_fa_bwd_dkv_kernel`` (:171): dk, dv
  (fp32), summed over each GQA group's query heads.

Layouts are the JAX pair functions': head-major qt (b, nh, tq, hd), kt
and vt (b, nkv, tk, hd), lse and delta (b, nh, tq) fp32; query head ``g
* rep + e`` reads KV head ``g``; query row i sits at position ``i +
offset`` and sees key j iff ``j <= i + offset`` and ``j < tk_valid``.
The kernels read q, k, v and dO through their (batch, head, time)
strides with a contiguous head dim, so ``flash_sdpa_causal`` hands them
transposed views of (b, t, h, hd) tensors, and write o, dq, dk and dv in
(b, t, h, hd) memory order (returned as head-major views).  A ragged
length is bounds-checked in the kernels, never padded.

In bf16 all three kernels run on the tensor cores (``wgmma`` on bf16
tiles that TMA copies into shared memory, 64-row tiles, a two-stage
ring); TMA reads each tensor at a 16-byte-aligned address through
strides that are multiples of 16 bytes, which ``tma_layout_problem``
checks and the three wrappers enforce (they raise rather than copy).
fp32 inputs run the CUDA-core kernels, which take any strides: the
dtype alone picks the kernel.

Each wrapper runs its plain version on a CPU tensor and, on a CUDA
tensor, launches its kernel or raises; ``build.LAUNCHES`` counts the
launches (``"flash_fwd"``, ``"flash_bwd_dq"``, ``"flash_bwd_dkv"``).
``FlashAttentionFunction`` (``_fa_core`` with its ``custom_vjp``,
:432-453) runs the forward kernel and, in its backward, delta = rowsum(dO
* O) in fp32 and the two backward kernels; on a CPU tensor it runs the
three plain versions, so the CPU tests exercise its glue.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from mamba_distributed_tpu_torch.ops.cuda import build
from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
from mamba_distributed_tpu_torch.ops.dispatch import use_kernel
from mamba_distributed_tpu_torch.ops.remat import core_output

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# head dims the kernels are built for (``mdt_flash_supports``)
HEAD_DIMS = (32, 64, 128)
_STRIDES = ctypes.c_longlong * 3


# ------------------------------------------------------------ plain versions


def _probs(qt, kt, offset: int, tk_valid: int, lse=None):
    """Masked fp32 scores s (b, nkv, rep, tq, tk) of head-major q and k,
    and, given the row ``lse``, p = exp(s - lse) (0 where masked)."""
    b, nh, tq, hd = qt.shape
    nkv, tk = kt.shape[1], kt.shape[2]
    q5 = qt.reshape(b, nkv, nh // nkv, tq, hd).float()
    s = torch.einsum("bgrqh,bgkh->bgrqk", q5, kt.float()) * (1.0 / math.sqrt(hd))
    qpos = offset + torch.arange(tq, device=qt.device)
    kpos = torch.arange(tk, device=qt.device)
    mask = (qpos[:, None] >= kpos[None, :]) & (kpos < tk_valid)[None, :]
    s = s.masked_fill(~mask, float("-inf"))
    if lse is None:
        return s
    return torch.exp(s - lse.reshape(b, nkv, nh // nkv, tq)[..., None])


def flash_fwd_plain(qt, kt, vt, offset: int, tk_valid: int):
    """The plain version of ``flash_fwd``: materialized masked softmax in
    fp32, the weights rounded to V's dtype for the PV product.  Returns
    (o (b, nh, tq, hd) in q's dtype, lse (b, nh, tq) fp32, +inf on rows
    that see no key)."""
    b, nh, tq, hd = qt.shape
    s = _probs(qt, kt, offset, tk_valid)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(torch.isfinite(s), torch.exp(s - m), 0.0)
    den = p.sum(dim=-1)
    o = torch.einsum("bgrqk,bgkh->bgrqh", p.to(vt.dtype).float(), vt.float())
    o = o / torch.clamp(den, min=1e-30)[..., None]
    lse = torch.where(den > 0, m[..., 0] + torch.log(torch.clamp(den, min=1e-30)),
                      float("inf"))
    return o.reshape(b, nh, tq, hd).to(qt.dtype), lse.reshape(b, nh, tq)


def _dscores(qt, kt, vt, do, lse, delta, offset, tk_valid):
    """(p, ds) of the backward: p = exp(s - lse), ds = p (dO v^T - delta)."""
    b, nh, tq, hd = qt.shape
    nkv = kt.shape[1]
    p = _probs(qt, kt, offset, tk_valid, lse)
    do5 = do.reshape(b, nkv, nh // nkv, tq, hd).float()
    dp = torch.einsum("bgrqh,bgkh->bgrqk", do5, vt.float())
    ds = p * (dp - delta.reshape(b, nkv, nh // nkv, tq)[..., None])
    return p, ds, do5


def flash_bwd_dq_plain(qt, kt, vt, do, lse, delta, offset: int, tk_valid: int):
    """The plain version of ``flash_bwd_dq``: dq (b, nh, tq, hd) fp32
    from the row ``lse`` and ``delta`` (b, nh, tq)."""
    b, nh, tq, hd = qt.shape
    _, ds, _ = _dscores(qt, kt, vt, do, lse, delta, offset, tk_valid)
    dq = torch.einsum("bgrqk,bgkh->bgrqh", ds.to(kt.dtype).float(), kt.float())
    return (dq * (1.0 / math.sqrt(hd))).reshape(b, nh, tq, hd)


def flash_bwd_dkv_plain(qt, kt, vt, do, lse, delta, offset: int, tk_valid: int):
    """The plain version of ``flash_bwd_dkv``: (dk, dv) (b, nkv, tk, hd)
    fp32, summed over each KV head's query heads."""
    b, nh, tq, hd = qt.shape
    p, ds, do5 = _dscores(qt, kt, vt, do, lse, delta, offset, tk_valid)
    q5 = qt.reshape(do5.shape).float()
    dv = torch.einsum("bgrqk,bgrqh->bgkh", p.to(do.dtype).float(), do5)
    dk = torch.einsum("bgrqk,bgrqh->bgkh", ds.to(qt.dtype).float(), q5)
    return dk * (1.0 / math.sqrt(hd)), dv


# ----------------------------------------------------------- kernel wrappers


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (built at first use)."""
    return declare(build.load("flash_attention"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``flash_attention.cu``) with its C signatures
    declared."""
    lib.mdt_flash_fwd.argtypes = [_P] * 5 + [_I] * 8 + [_P] * 4 + [_F, _I, _P]
    lib.mdt_flash_bwd_dq.argtypes = [_P] * 7 + [_I] * 8 + [_P] * 5 + [_F, _I, _P]
    lib.mdt_flash_bwd_dkv.argtypes = [_P] * 8 + [_I] * 8 + [_P] * 6 + [_F, _I, _P]
    for fn in (lib.mdt_flash_fwd, lib.mdt_flash_bwd_dq, lib.mdt_flash_bwd_dkv):
        fn.restype = _I
    lib.mdt_flash_supports.argtypes = [_I]
    lib.mdt_flash_supports.restype = _I
    return lib


def _check(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_common(name, qt, kt, vt, tk_valid, do=None, lse=None, delta=None, lib=None):
    """Checks shared by the three wrappers; returns (lib, b, nh, nkv, tq,
    tk, hd), ``lib`` the package's build unless the caller gave another."""
    b, nh, tq, hd = qt.shape
    nkv, tk = kt.shape[1], kt.shape[2]
    _check(qt.dtype in _DTYPE_CODE, name, f"dtype {qt.dtype} not float32/bfloat16")
    _check(tuple(kt.shape) == (b, nkv, tk, hd) and vt.shape == kt.shape, name,
           f"k/v shapes {tuple(kt.shape)} {tuple(vt.shape)} do not match q {tuple(qt.shape)}")
    _check(nkv > 0 and nh % nkv == 0, name, f"{nh} query heads do not split over {nkv} KV heads")
    _check(0 <= tk_valid <= tk, name, f"tk_valid={tk_valid} outside [0, {tk}]")
    named = [("q", qt), ("k", kt), ("v", vt)] + ([("dO", do)] if do is not None else [])
    for t_name, t in named:
        _check(t.dtype == qt.dtype and t.device == qt.device, name,
               f"{t_name} must be {qt.dtype} on {qt.device}")
        _check(t.stride(-1) == 1, name, f"{t_name}'s head dim must be contiguous")
    if do is not None:
        _check(do.shape == qt.shape, name, f"dO shape {tuple(do.shape)} != q's")
        for t_name, t in (("lse", lse), ("delta", delta)):
            _check(t.dtype == torch.float32 and tuple(t.shape) == (b, nh, tq)
                   and t.is_contiguous() and t.device == qt.device, name,
                   f"{t_name} must be a contiguous fp32 {(b, nh, tq)} on {qt.device}")
    lib = _lib() if lib is None else lib
    _check(bool(lib.mdt_flash_supports(hd)), name, f"head dim {hd} is not built {HEAD_DIMS}")
    return lib, b, nh, nkv, tq, tk, hd


def tma_layout_problem(shape, strides, elem_size: int, addr: int,
                       dims=("batch", "head", "time")) -> str | None:
    """Why the tensor-core kernels' TMA copies cannot read a head-major
    (b, h, t, hd) tensor of this ``shape``, element ``strides`` and
    ``elem_size``, starting at byte address ``addr``; None when they can.
    TMA needs a 16-byte-aligned start, a contiguous head dim, and the
    (batch, head, time) strides of every dimension longer than 1 a
    positive multiple of 16 bytes below 2**40 bytes.  ``dims`` names the
    three outer dimensions in the message."""
    if addr % 16:
        return f"its data starts at byte {addr % 16} past a 16-byte boundary"
    if strides[-1] != 1:
        return f"its head dim has stride {strides[-1]}, not 1"
    for dim, n, st in zip(dims, shape[:3], strides[:3]):
        nbytes = st * elem_size
        if n > 1 and (nbytes <= 0 or nbytes % 16 or nbytes >= 1 << 40):
            return (f"its {dim} stride is {st} elements ({nbytes} bytes), not a positive "
                    f"multiple of 16 bytes")
    return None


def check_tma_layout(name: str, **tensors) -> None:
    """Raise a ValueError naming the first tensor the TMA copies cannot
    read (``tma_layout_problem``)."""
    for t_name, t in tensors.items():
        why = tma_layout_problem(t.shape, t.stride(), t.element_size(), t.data_ptr())
        if why is not None:
            raise ValueError(f"{name}: {t_name} cannot be read by TMA: {why}")


def _s(t) -> _STRIDES:
    """(batch, head, time) strides of a head-major tensor."""
    return _STRIDES(*t.stride()[:3])


def _head_major(shape, dtype, device):
    """Head-major (b, h, t, hd) view of a fresh (b, t, h, hd) tensor."""
    b, h, t, hd = shape
    return torch.empty((b, t, h, hd), dtype=dtype, device=device).transpose(1, 2)


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_fwd(qt, kt, vt, offset: int, tk_valid: int, *, lib=None):
    """Causal GQA flash forward: (o (b, nh, tq, hd) in q's dtype, lse
    (b, nh, tq) fp32); the contract of ``flash_fwd_plain``.  ``lib``, in
    all three wrappers: another build of ``flash_attention.cu`` (through
    ``declare``) to launch instead of the package's."""
    if not use_kernel("pallas", qt):
        return flash_fwd_plain(qt, kt, vt, offset, tk_valid)
    name = "flash_fwd"
    lib, b, nh, nkv, tq, tk, hd = _check_common(name, qt, kt, vt, tk_valid, lib=lib)
    if qt.dtype == torch.bfloat16:
        check_tma_layout(name, q=qt, k=kt, v=vt)
    o = _head_major((b, nh, tq, hd), qt.dtype, qt.device)
    lse = torch.empty((b, nh, tq), dtype=torch.float32, device=qt.device)
    err = lib.mdt_flash_fwd(
        qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, nh, nkv, tq, tk, hd, int(offset), int(tk_valid),
        _s(qt), _s(kt), _s(vt), _s(o), 1.0 / math.sqrt(hd), _DTYPE_CODE[qt.dtype],
        _stream(qt))
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {err}")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_bwd_dq(qt, kt, vt, do, lse, delta, offset: int, tk_valid: int, *, lib=None):
    """dq (b, nh, tq, hd) fp32 from the row ``lse`` and ``delta``; the
    contract of ``flash_bwd_dq_plain``."""
    if not use_kernel("pallas", qt):
        return flash_bwd_dq_plain(qt, kt, vt, do, lse, delta, offset, tk_valid)
    name = "flash_bwd_dq"
    lib, b, nh, nkv, tq, tk, hd = _check_common(name, qt, kt, vt, tk_valid, do, lse, delta,
                                                lib)
    if qt.dtype == torch.bfloat16:
        check_tma_layout(name, q=qt, k=kt, v=vt, dO=do)
    dq = _head_major((b, nh, tq, hd), torch.float32, qt.device)
    err = lib.mdt_flash_bwd_dq(
        qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b, nh, nkv, tq, tk, hd, int(offset), int(tk_valid),
        _s(qt), _s(kt), _s(vt), _s(do), _s(dq), 1.0 / math.sqrt(hd), _DTYPE_CODE[qt.dtype],
        _stream(qt))
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq launch failed: cudaError {err}")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(qt, kt, vt, do, lse, delta, offset: int, tk_valid: int, *, lib=None):
    """(dk, dv) (b, nkv, tk, hd) fp32, GQA group-summed; the contract of
    ``flash_bwd_dkv_plain``."""
    if not use_kernel("pallas", qt):
        return flash_bwd_dkv_plain(qt, kt, vt, do, lse, delta, offset, tk_valid)
    name = "flash_bwd_dkv"
    lib, b, nh, nkv, tq, tk, hd = _check_common(name, qt, kt, vt, tk_valid, do, lse, delta,
                                                lib)
    if qt.dtype == torch.bfloat16:
        check_tma_layout(name, q=qt, k=kt, v=vt, dO=do)
    dk = _head_major((b, nkv, tk, hd), torch.float32, qt.device)
    dv = _head_major((b, nkv, tk, hd), torch.float32, qt.device)
    err = lib.mdt_flash_bwd_dkv(
        qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, nh, nkv, tq, tk, hd, int(offset),
        int(tk_valid), _s(qt), _s(kt), _s(vt), _s(do), _s(dk), _s(dv), 1.0 / math.sqrt(hd),
        _DTYPE_CODE[qt.dtype], _stream(qt))
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv launch failed: cudaError {err}")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def flash_work(b, tq, tk, nh, nkv, hd, offset, dtype):
    """(bytes, flops) of ``flash_fwd``, ``flash_bwd_dq`` and
    ``flash_bwd_dkv`` on these shapes: each input read once and each
    output written once; the multiply-adds of the (query, key) pairs the
    causal mask keeps (2, 3 and 4 hd-long products per pair)."""
    e = torch.finfo(dtype).bits // 8
    qs, kvs, rows = b * tq * nh * hd, b * tk * nkv * hd, b * nh * tq
    pairs = b * nh * sum(min(max(i + offset + 1, 0), tk) for i in range(tq))
    fwd = (2 * qs * e + 2 * kvs * e + rows * 4, 4 * hd * pairs)
    dq = (2 * qs * e + 2 * kvs * e + 2 * rows * 4 + qs * 4, 6 * hd * pairs)
    dkv = (2 * qs * e + 2 * kvs * e + 2 * rows * 4 + 2 * kvs * 4, 8 * hd * pairs)
    return fwd, dq, dkv


# ------------------------------------------------- the pair API (ring hops)


def flash_pair_fwd(qt, kt, vt, offset: int):
    """Raw pair forward (attention_kernels.py:363): (o, lse (b, nh, tq)),
    head-major, not differentiable on its own; ring attention merges the
    per-hop partials and reuses ``flash_pair_dq``/``flash_pair_dkv`` with
    the global lse and delta in its backward."""
    return flash_fwd(qt, kt, vt, offset, kt.shape[2])


def flash_pair_dq(qt, kt, vt, do, lse, dlt, offset: int):
    """Raw pair dq (fp32) from the GLOBAL row lse / delta (b, nh, tq)."""
    return flash_bwd_dq(qt, kt, vt, do, lse.contiguous(), dlt.contiguous(), offset,
                        kt.shape[2])


def flash_pair_dkv(qt, kt, vt, do, lse, dlt, offset: int):
    """Raw pair (dk, dv) (fp32, GQA group-summed) from GLOBAL lse/delta."""
    return flash_bwd_dkv(qt, kt, vt, do, lse.contiguous(), dlt.contiguous(), offset,
                         kt.shape[2])


# --------------------------------------------------------- the autograd core


def readable_grad(do: torch.Tensor) -> torch.Tensor:
    """An incoming output gradient as the backward kernels read it: a
    fresh contiguous copy when its last axis is strided or, for the bf16
    kernels' TMA, its layout is not one TMA reads (it may be expanded or
    offset)."""
    tc = do.is_cuda and do.dtype == torch.bfloat16  # read by TMA in both kernels
    if do.stride(-1) != 1 or (tc and tma_layout_problem(
            do.shape, do.stride(), do.element_size(), do.data_ptr()) is not None):
        return do.clone(memory_format=torch.contiguous_format)
    return do


class FlashAttentionFunction(torch.autograd.Function):
    """``_fa_core`` with its ``custom_vjp`` (attention_kernels.py:432-453):
    head-major (qt, kt, vt) -> o, differentiable in q, k and v.  Under
    the "mixer" remat policy the forward kernel's o and lse are kept
    (ops/remat.py)."""

    @staticmethod
    def forward(ctx, qt, kt, vt, offset: int):
        o, lse = core_output(lambda: flash_fwd(qt, kt, vt, offset, kt.shape[2]))
        ctx.save_for_backward(qt, kt, vt, o, lse)
        ctx.offset = offset
        return o

    @staticmethod
    def backward(ctx, do):
        qt, kt, vt, o, lse = ctx.saved_tensors
        do = readable_grad(do)
        # D_i = rowsum(dO * O) in fp32 (attention_kernels.py:353-355)
        delta = (do.float() * o.float()).sum(dim=-1).contiguous()
        tk = kt.shape[2]
        dq = flash_bwd_dq(qt, kt, vt, do, lse, delta, ctx.offset, tk)
        dk, dv = flash_bwd_dkv(qt, kt, vt, do, lse, delta, ctx.offset, tk)
        return dq.to(qt.dtype), dk.to(kt.dtype), dv.to(vt.dtype), None


def flash_sdpa_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      offset: int = 0) -> torch.Tensor:
    """Causal softmax(QK^T/sqrt(d))V with GQA broadcast through the flash
    kernels (the contract of ``blockwise_sdpa_causal``): q (b, tq, nh,
    hd); k/v (b, tk, nkv, hd); ``offset`` = absolute position of q[0]
    minus that of k[0].  Returns (b, tq, nh, hd) in q's dtype."""
    nh, nkv = q.shape[2], k.shape[2]
    if nh % nkv:
        raise ValueError(f"num_heads {nh} not a multiple of kv heads {nkv}")
    o = FlashAttentionFunction.apply(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), int(offset))
    return o.transpose(1, 2)
