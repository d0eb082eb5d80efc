"""SSD forward and backward through the hand-written Hopper kernels.

Counterpart of ``ssd_chunked_pallas`` and its ``custom_vjp``
(mamba_distributed_tpu/ops/pallas/ssd_kernels.py:560-630).  Three
kernels, each beside its plain PyTorch version:

* ``ssd_fwd`` (``csrc/ssd_fwd.cu``) replaces ``_ssd_fused_fwd_kernel``
  (ssd_kernels.py:164): the forward, state carried on chip; in bf16 at
  headdim 64 and d_state 64 or 128 (``ssd_uses_tensor_cores``, the C
  dispatch's rule too) a ``wgmma`` kernel that reads x, B and C by TMA,
  else a CUDA-core kernel;
* ``ssd_chunk_states`` (``csrc/ssd_bwd.cu``) replaces
  ``_chunk_states_kernel`` (:61): the per-chunk state summaries the
  backward recomputes; on the backward's tensor-core rule
  (``ssd_bwd_uses_tensor_cores``) a ``wgmma`` kernel that reads x and B
  by TMA, else a CUDA-core kernel;
* ``ssd_bwd`` (``csrc/ssd_bwd.cu``) replaces ``_ssd_fused_bwd_kernel``
  (:299): every per-cell gradient of a chunk.  In bf16 at headdim 64,
  d_state 64 or 128 and a chunk that is a multiple of 64
  (``ssd_bwd_uses_tensor_cores``, the C dispatch's rule too) two
  ``wgmma`` kernels that read their tiles by TMA: the state cotangent
  walked over the chunks per (batch, head) (``ssd_state_cotangents_plain``
  is its plain version), then the cell gradients on one warpgroup per
  (64-row block, head, batch, chunk), in parallel over the chunks; else
  one CUDA-core kernel per (batch, head) that walks the chunks in
  reverse.

``SSDFunction`` is the ``torch.autograd.Function`` around them: its
forward runs ``ssd_fwd`` and saves ``(x, dt, A, B, C, initial_state)``;
its backward runs ``ssd_chunk_states``, ``ops/ssd.state_passing`` to
recompute the entering states, ``ssd_bwd``, and the plain epilogue of
ssd_kernels.py:521-538 (``da`` through the cumsum chain into dt and A,
the group sums of dB and dC).  The D skip stays outside the Function,
as ``_add_D`` does in the JAX package.

Every wrapper runs its plain version on a CPU tensor (the CPU tests go
through the Function's glue that way) and, on a CUDA tensor, launches
its kernel or raises.  ``LAUNCHES`` (shared by every kernel of the
port, ``build.py``) counts the launches.  The sources' headers state
what bounds each kernel on the card and what its design does about it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mamba_distributed_tpu_torch.ops.cuda import build
from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
from mamba_distributed_tpu_torch.ops.cuda.flash_kernels import tma_layout_problem
from mamba_distributed_tpu_torch.ops.dispatch import use_kernel
from mamba_distributed_tpu_torch.ops.remat import core_output
from mamba_distributed_tpu_torch.ops.ssd import (
    _add_D,
    _divisor_chunk,
    chunk_log_decay,
    heads_of_groups,
    reverse_cumsum,
    ssd_chunked,
    state_passing,
)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# (headdim, d_state) pairs the kernels are built for (ssd_fwd.cu's and
# ssd_bwd.cu's ``mdt_*_supports``; ``chip_smoke.py`` holds the two to
# agree); ``ops/dispatch.check_kernel_shapes`` refuses any other
BUILT_SHAPES = frozenset({(32, 64), (32, 128), (64, 64), (64, 128), (128, 128)})
# the (headdim, d_state) pairs of the tensor-core forward and backward
# (``mdt_ssd_uses_tc``, ``mdt_ssd_bwd_uses_tc``)
TC_SHAPES = frozenset({(64, 64), (64, 128)})
TC_ROWS = 64  # the tensor-core backward's row block: its chunk is a multiple of it
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def ssd_uses_tensor_cores(dtype: torch.dtype, p: int, n: int) -> bool:
    """Whether a forward with x of ``dtype``, headdim ``p`` and d_state
    ``n`` runs the tensor-core kernel (the C dispatch's rule)."""
    return dtype == torch.bfloat16 and (p, n) in TC_SHAPES


def ssd_bwd_uses_tensor_cores(dtype: torch.dtype, p: int, n: int, l: int) -> bool:
    """Whether the chunk states and the backward with x of ``dtype``,
    headdim ``p``, d_state ``n`` and chunk ``l`` run the tensor-core kernels
    (the C dispatch's rule)."""
    return dtype == torch.bfloat16 and (p, n) in TC_SHAPES and l % TC_ROWS == 0


@functools.cache
def _fwd_lib() -> ctypes.CDLL:
    """The forward library with its C signatures declared (built at first use)."""
    lib = declare_fwd(build.load("ssd_fwd"))
    lib.mdt_ssd_uses_tc.argtypes = [_I, _I, _I]
    lib.mdt_ssd_uses_tc.restype = _I
    return lib


def declare_fwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``ssd_fwd.cu``) with the C signatures of its
    forward and its shape table declared."""
    lib.mdt_ssd_fwd.argtypes = [_P] * 8 + [_I] * 7 + [_L] * 12 + [_I, _P]
    lib.mdt_ssd_fwd.restype = _I
    lib.mdt_ssd_fwd_supports.argtypes = [_I, _I]
    lib.mdt_ssd_fwd_supports.restype = _I
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    """The backward library (kernels 2 and 3) with its C signatures."""
    return declare_bwd(build.load("ssd_bwd"))


def declare_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``ssd_bwd.cu``) with the C signatures of its
    kernels, its shape table and its dispatch rule declared."""
    lib.mdt_ssd_chunk_states.argtypes = [_P] * 5 + [_I] * 7 + [_L] * 9 + [_I, _P]
    lib.mdt_ssd_chunk_states.restype = _I
    lib.mdt_ssd_bwd.argtypes = [_P] * 15 + [_I] * 7 + [_L] * 12 + [_P] * 3 + [_I, _P]
    lib.mdt_ssd_bwd.restype = _I
    lib.mdt_ssd_bwd_supports.argtypes = [_I, _I]
    lib.mdt_ssd_bwd_supports.restype = _I
    lib.mdt_ssd_bwd_uses_tc.argtypes = [_I] * 4
    lib.mdt_ssd_bwd_uses_tc.restype = _I
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssd kernels: {msg}")


def _check_inputs(x, dt, B, C, compute_dtype, supports) -> tuple:
    """Device, dtype, shape and stride checks shared by the three
    kernels (x is on the card: the dispatch rule took the kernel); returns
    (b, t, h, p, g, n)."""
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    _check(x.dtype in _DTYPE_CODE, f"x dtype {x.dtype} not float32/bfloat16")
    _check(compute_dtype == x.dtype,
           f"compute_dtype {compute_dtype} must equal x dtype {x.dtype}")
    _check(B.dtype == x.dtype and (C is None or C.dtype == x.dtype),
           "B and C must share x's dtype")
    _check(tuple(B.shape) == (b, t, g, n) and (C is None or tuple(C.shape) == (b, t, g, n)),
           f"B/C shapes {tuple(B.shape)} {None if C is None else tuple(C.shape)}")
    _check(h % g == 0, f"{h} heads do not split into {g} groups")
    _check(dt.dtype == torch.float32 and tuple(dt.shape) == (b, t, h),
           f"dt must be fp32 (b, t, h), got {dt.dtype} {tuple(dt.shape)}")
    for name, v in (("x", x), ("B", B), ("C", C)):
        if v is None:
            continue
        _check(v.device == x.device, f"{name} not on {x.device}")
        _check(v.stride(-1) == 1, f"{name}'s last axis must be contiguous")
    _check(dt.device == x.device, "dt device")
    _check(bool(supports(p, n)), f"no kernel instance for headdim={p}, d_state={n}")
    return b, t, h, p, g, n


def _f32_on(v, shape, device, name):
    _check(v.dtype == torch.float32 and tuple(v.shape) == shape and v.is_contiguous()
           and v.device == device,
           f"{name} must be a contiguous fp32 {shape} on {device}")


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _tma_problem(v, grouped: bool = False) -> str | None:
    """Why TMA cannot read the (b, t, head or group, hd) view ``v``, or None."""
    # as the (batch, head, time, hd) of the flash kernels' check
    return tma_layout_problem(
        (v.shape[0], v.shape[2], v.shape[1], v.shape[3]),
        (v.stride(0), v.stride(2), v.stride(1), v.stride(3)),
        v.element_size(), v.data_ptr(),
        dims=("batch", "group" if grouped else "head", "time"))


def _check_tma(kernel: str, **views) -> None:
    """Raise a ValueError naming the first view that TMA cannot read (the
    tensor-core kernels copy x, B, C and dy by TMA; a view is never copied)."""
    for name, v in views.items():
        why = _tma_problem(v, grouped=name in ("B", "C"))
        if why is not None:
            raise ValueError(f"{kernel}: {name} cannot be read by TMA: {why}")


# ------------------------------------------------------------------- forward


def _ssd_fwd(x, dt, A, B, C, l: int, initial_state, compute_dtype, lib=None):
    """Forward without D: (y in x's dtype, final state fp32).  Kernel 1
    on a CUDA tensor, the plain ``ssd_chunked`` on a CPU tensor.  On the
    tensor-core route x, B and C are read by TMA: a view it cannot read
    raises a ValueError that names it (never a copy).  ``lib``: another
    build of ``ssd_fwd.cu`` (through ``declare_fwd``) to launch instead of
    the package's."""
    if not use_kernel("pallas", x):
        return ssd_chunked(x, dt, A, B, C, chunk_size=l, initial_state=initial_state,
                           return_final_state=True, compute_dtype=compute_dtype)
    lib = _fwd_lib() if lib is None else lib
    b, t, h, p, g, n = _check_inputs(x, dt, B, C, compute_dtype, lib.mdt_ssd_fwd_supports)
    if ssd_uses_tensor_cores(x.dtype, p, n):
        _check_tma("ssd_fwd", x=x, B=B, C=C)
    _check(A.dtype == torch.float32 and tuple(A.shape) == (h,) and A.is_contiguous()
           and A.device == x.device, "A must be a contiguous fp32 (h,) on x's device")
    if initial_state is not None:
        _f32_on(initial_state, (b, h, p, n), x.device, "initial_state")
    _check(l <= 256, f"chunk {l} > 256")
    y = torch.empty((b, t, h, p), dtype=x.dtype, device=x.device)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    err = lib.mdt_ssd_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        None if initial_state is None else initial_state.data_ptr(),
        y.data_ptr(), final.data_ptr(),
        b, t, h, p, g, n, l,
        x.stride(0), x.stride(1), x.stride(2),
        dt.stride(0), dt.stride(1), dt.stride(2),
        B.stride(0), B.stride(1), B.stride(2),
        C.stride(0), C.stride(1), C.stride(2),
        _DTYPE_CODE[x.dtype], _stream(x),
    )
    if err != 0:
        raise RuntimeError(f"ssd_fwd launch failed: cudaError {err}")
    LAUNCHES["ssd_fwd"] += 1
    return y, final


# ------------------------------------------------- kernel 2: chunk states


def _cd(v, cd):
    """Round to the compute dtype and back to fp32 (a kernel cast point)."""
    return v.to(cd).float()


def ssd_chunk_states_plain(x, dt, a_cum, B, l: int, compute_dtype):
    """Per-chunk state summaries ``out[b, c, h] = round(x)^T round(B * w)``,
    ``w = dt * exp(a_last - a)`` (ssd_kernels.py:61-73): x (b, t, h, p),
    dt (b, t, h) fp32, a_cum (b, t, h) fp32 (``chunk_log_decay``), B
    (b, t, g, n) -> (b, nc, h, p, n) fp32."""
    b, t, h, p = x.shape
    nc, n = t // l, B.shape[-1]
    a = a_cum.reshape(b, nc, l, h)
    w = dt.float().reshape(b, nc, l, h) * torch.exp(a[:, :, -1:] - a)
    Bh = heads_of_groups(B.reshape(b, nc, l, -1, n), h).float()
    Bd = _cd(Bh * w[..., None], compute_dtype)
    return torch.einsum("bcjhp,bcjhn->bchpn", _cd(x.reshape(b, nc, l, h, p), compute_dtype), Bd)


def ssd_chunk_states_kernel(x, dt, a_cum, B, l: int, compute_dtype, lib=None):
    """``ssd_chunk_states_plain`` through kernel 2 on a CUDA tensor (x, B
    read through their strides; a_cum contiguous (b, t, h) fp32).  On the
    tensor-core route (``ssd_bwd_uses_tensor_cores``, the backward's rule)
    x and B are read by TMA: a view it cannot read raises a ValueError that
    names it (never a copy).  ``lib``: another build of ``ssd_bwd.cu``
    (through ``declare_bwd``) to launch instead of the package's."""
    if not use_kernel("pallas", x):
        return ssd_chunk_states_plain(x, dt, a_cum, B, l, compute_dtype)
    lib = _bwd_lib() if lib is None else lib
    b, t, h, p, g, n = _check_inputs(x, dt, B, None, compute_dtype, lib.mdt_ssd_bwd_supports)
    _f32_on(a_cum, (b, t, h), x.device, "a_cum")
    _check(l <= 256 and t % l == 0, f"chunk {l} must divide {t} and be <= 256")
    if ssd_bwd_uses_tensor_cores(x.dtype, p, n, l):
        _check_tma("ssd_chunk_states", x=x, B=B)
    out = torch.empty((b, t // l, h, p, n), dtype=torch.float32, device=x.device)
    err = lib.mdt_ssd_chunk_states(
        x.data_ptr(), dt.data_ptr(), a_cum.data_ptr(), B.data_ptr(), out.data_ptr(),
        b, t, h, p, g, n, l,
        x.stride(0), x.stride(1), x.stride(2),
        dt.stride(0), dt.stride(1), dt.stride(2),
        B.stride(0), B.stride(1), B.stride(2),
        _DTYPE_CODE[x.dtype], _stream(x),
    )
    if err != 0:
        raise RuntimeError(f"ssd_chunk_states launch failed: cudaError {err}")
    LAUNCHES["ssd_chunk_states"] += 1
    return out


# ------------------------------------------------ kernel 3: fused backward


def ssd_state_cotangents_plain(dy, a_cum, C, prev_states, dfinal, l: int, compute_dtype):
    """The state cotangent of every chunk (ssd_kernels.py:414-428), the
    plain version of the tensor-core route's first kernel: with dP_c =
    round(dy_c)^T round(e^a C_c), gP walks the chunks in reverse from
    ``dfinal`` (zeros if None), dS_c = gP before chunk c's step, gP <- dP_c
    + e^(a_L) gP.

    dy (b, t, h, p); a_cum (b, t, h) fp32; C (b, t, g, n); prev_states
    (b, nc, h, p, n) fp32.  Returns dS (b, nc, h, p, n) fp32 (the cotangent
    of the state leaving each chunk), dgamma = <dS_c, P_c> (b, nc, h) fp32
    and dinit (b, h, p, n) fp32 (gP after chunk 0)."""
    cd = compute_dtype
    b, t, h, p = dy.shape
    nc, n = t // l, C.shape[-1]
    a = a_cum.reshape(b, nc, l, h)
    Ch = heads_of_groups(C.reshape(b, nc, l, -1, n), h).float()
    dyc = _cd(dy.reshape(b, nc, l, h, p), cd)
    gamma = torch.exp(a[:, :, -1])  # (b, nc, h)
    dP = torch.einsum("bcihp,bcihn->bchpn", dyc, _cd(torch.exp(a)[..., None] * Ch, cd))
    gP = (torch.zeros_like(prev_states[:, 0]) if dfinal is None else dfinal.float())
    dS = torch.empty_like(prev_states)
    for c in reversed(range(nc)):
        dS[:, c] = gP
        gP = dP[:, c] + gamma[:, c, :, None, None] * gP
    return dS, (dS * prev_states).sum((-2, -1)), gP


def ssd_bwd_plain(x, dt, a_cum, B, C, prev_states, dy, dfinal, l: int, compute_dtype):
    """Every per-cell gradient of the SSD forward (ssd_kernels.py:299-431),
    rounding at the TPU kernel's cast points, with the state cotangent
    gP walked over the chunks in reverse from ``dfinal`` (zeros if None).

    x (b, t, h, p); dt, a_cum (b, t, h) fp32; B, C (b, t, g, n);
    prev_states (b, nc, h, p, n) fp32 (the state entering each chunk);
    dy (b, t, h, p).  Returns dx (b, t, h, p) in x's dtype, ddt_direct
    and da (b, t, h) fp32, dB and dC per head (b, t, h, n) fp32, dgamma
    (b, nc, h) fp32 and dinit (b, h, p, n) fp32 (gP after chunk 0)."""
    cd = compute_dtype
    b, t, h, p = x.shape
    nc, n = t // l, B.shape[-1]
    xc = x.float().reshape(b, nc, l, h, p)
    dtc = dt.float().reshape(b, nc, l, h)
    a = a_cum.reshape(b, nc, l, h)
    Bh = heads_of_groups(B.reshape(b, nc, l, -1, n), h).float()
    Ch = heads_of_groups(C.reshape(b, nc, l, -1, n), h).float()
    dyc = _cd(dy.reshape(b, nc, l, h, p), cd)
    P = prev_states
    e = torch.exp(a)
    d = torch.exp(a[:, :, -1:] - a)
    u = xc * dtc[..., None]

    # intra-chunk: y_diag = (G .* L) @ u
    G = torch.einsum("bcihn,bcjhn->bchij", _cd(Ch, cd), _cd(Bh, cd))
    seg = a.movedim(2, -1)  # (b, nc, h, l)
    diff = seg[..., :, None] - seg[..., None, :]
    tril = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    Lm = torch.where(tril, torch.exp(torch.where(tril, diff, 0.0)), 0.0)  # mask before exp
    M = G * Lm
    dM = torch.einsum("bcihp,bcjhp->bchij", dyc, _cd(u, cd))
    du = torch.einsum("bchij,bcihp->bcjhp", _cd(M, cd), dyc)
    dMM = dM * M
    da = (dMM.sum(-1) - dMM.sum(-2)).movedim(-1, 2)  # (b, nc, l, h)
    dG = _cd(dM * Lm, cd)
    dB = torch.einsum("bchij,bcihn->bcjhn", dG, _cd(Ch, cd))
    dC = torch.einsum("bchij,bcjhn->bcihn", dG, _cd(Bh, cd))

    # off-diagonal: y_off = diag(e) C @ P^T
    T = torch.einsum("bcihp,bchpn->bcihn", dyc, _cd(P, cd))
    dC = dC + e[..., None] * T
    da = da + (T * Ch).sum(-1) * e

    dS, dgamma, dinit = ssd_state_cotangents_plain(dy, a_cum, C, P, dfinal, l, cd)

    # state summary: S = sum_j d_j u_j (x) B_j
    dw = torch.einsum("bcjhn,bchpn->bcjhp", _cd(Bh, cd), _cd(dS, cd))
    dB = dB + torch.einsum("bcjhp,bchpn->bcjhn", _cd(u * d[..., None], cd), _cd(dS, cd))
    du = du + d[..., None] * dw
    ddd = (u * dw).sum(-1) * d
    da = da - ddd
    da[:, :, -1] += ddd.sum(2)

    dx = (dtc[..., None] * du).to(x.dtype).reshape(b, t, h, p)
    ddt_dir = (xc * du).sum(-1).reshape(b, t, h)
    return (dx, ddt_dir, da.reshape(b, t, h), dB.reshape(b, t, h, n),
            dC.reshape(b, t, h, n), dgamma, dinit)


def ssd_bwd_kernel(x, dt, a_cum, B, C, prev_states, dy, dfinal, l: int, compute_dtype,
                   lib=None):
    """``ssd_bwd_plain`` through kernel 3 on a CUDA tensor.  dy must be
    contiguous (b, t, h, p) in x's dtype; prev_states and dfinal
    contiguous fp32.  On the tensor-core route (``ssd_bwd_uses_tensor_cores``)
    x, B, C and dy are read by TMA: a view it cannot read raises a
    ValueError that names it (never a copy); the route's workspaces come
    from the caching allocator, and the last row's total of each chunk's
    da is added from the row blocks' partials here (``add_row_block_tails``).
    ``lib``: another build of ``ssd_bwd.cu`` (through ``declare_bwd``) to
    launch instead of the package's."""
    if not use_kernel("pallas", x):
        return ssd_bwd_plain(x, dt, a_cum, B, C, prev_states, dy, dfinal, l, compute_dtype)
    lib = _bwd_lib() if lib is None else lib
    b, t, h, p, g, n = _check_inputs(x, dt, B, C, compute_dtype, lib.mdt_ssd_bwd_supports)
    _check(l <= 256 and t % l == 0, f"chunk {l} must divide {t} and be <= 256")
    nc = t // l
    _f32_on(a_cum, (b, t, h), x.device, "a_cum")
    _f32_on(prev_states, (b, nc, h, p, n), x.device, "prev_states")
    _check(dy.dtype == x.dtype and tuple(dy.shape) == (b, t, h, p) and dy.is_contiguous()
           and dy.device == x.device, "dy must be a contiguous (b, t, h, p) in x's dtype")
    if dfinal is not None:
        _f32_on(dfinal, (b, h, p, n), x.device, "dfinal")
    dev, f32 = x.device, torch.float32
    tc = ssd_bwd_uses_tensor_cores(x.dtype, p, n, l)
    ws = (None, None, None)
    if tc:
        _check_tma("ssd_bwd", x=x, B=B, C=C, dy=dy)
        ws = (torch.empty((b, nc, h, p, n), dtype=x.dtype, device=dev),
              torch.empty((b, nc, h, p, n), dtype=x.dtype, device=dev),
              torch.empty((b, nc, h, l // TC_ROWS), dtype=f32, device=dev))
    dx = torch.empty((b, t, h, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, t, h), dtype=f32, device=dev)
    da = torch.empty((b, t, h), dtype=f32, device=dev)
    dB = torch.empty((b, t, h, n), dtype=f32, device=dev)
    dC = torch.empty((b, t, h, n), dtype=f32, device=dev)
    dgamma = torch.empty((b, nc, h), dtype=f32, device=dev)
    dinit = torch.empty((b, h, p, n), dtype=f32, device=dev)
    err = lib.mdt_ssd_bwd(
        x.data_ptr(), dt.data_ptr(), a_cum.data_ptr(), B.data_ptr(), C.data_ptr(),
        prev_states.data_ptr(), dy.data_ptr(),
        None if dfinal is None else dfinal.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        dgamma.data_ptr(), dinit.data_ptr(),
        b, t, h, p, g, n, l,
        x.stride(0), x.stride(1), x.stride(2),
        dt.stride(0), dt.stride(1), dt.stride(2),
        B.stride(0), B.stride(1), B.stride(2),
        C.stride(0), C.stride(1), C.stride(2),
        *(None if w is None else w.data_ptr() for w in ws),
        _DTYPE_CODE[x.dtype], _stream(x),
    )
    if err != 0:
        raise RuntimeError(f"ssd_bwd launch failed: cudaError {err}")
    if tc:
        add_row_block_tails(da, ws[2], l)
    LAUNCHES["ssd_bwd"] += 1
    return dx, ddt, da, dB, dC, dgamma, dinit


def add_row_block_tails(da, tails, l: int) -> None:
    """Add, in place, each chunk's total of d .* rowsum(u .* dw) to its
    last row's da: ``tails`` (b, nc, h, l / 64) holds the tensor-core
    kernel's per-row-block sums, added in block order (the same bits at
    every launch, no atomics)."""
    b, t, h = da.shape
    da.view(b, t // l, l, h)[:, :, l - 1] += tails.sum(-1)


# ------------------------------------------------------- the autograd core


def ssd_backward(x, dt, A, B, C, dy, l: int, compute_dtype,
                 initial_state=None, dfinal=None):
    """Gradients of the SSD forward without D (``_ssd_pallas_bwd_impl``,
    ssd_kernels.py:434-547): kernel 2, ``state_passing``, kernel 3,
    then the plain epilogue.  Returns (dx, ddt, dA, dB, dC, dinit), dinit
    None without an ``initial_state``."""
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc = t // l
    a4 = chunk_log_decay(dt, A, l)  # (b, nc, l, h)
    a_cum = a4.reshape(b, t, h)
    chunk_decay = torch.exp(a4[:, :, -1])  # (b, nc, h)
    states = ssd_chunk_states_kernel(x, dt, a_cum, B, l, compute_dtype)
    prev_states, _ = state_passing(states, chunk_decay, initial_state)
    dy = dy.contiguous()
    if (use_kernel("pallas", x) and ssd_bwd_uses_tensor_cores(x.dtype, p, n, l)
            and _tma_problem(dy) is not None):
        dy = dy.clone()  # an incoming gradient may be offset: a fresh copy
    dx, ddt_dir, da, dB_h, dC_h, dgamma, dinit = ssd_bwd_kernel(
        x, dt, a_cum, B, C, prev_states.contiguous(), dy,
        None if dfinal is None else dfinal.contiguous(), l, compute_dtype)

    # epilogue: the chunk decay's gradient lands on the last row's a,
    # then `da` goes through the in-chunk cumsum into dt and A
    da = da.reshape(b, nc, l, h)
    da = torch.cat([da[:, :, :-1], (da[:, :, -1] + dgamma * chunk_decay)[:, :, None]], 2)
    ddA = reverse_cumsum(da, dim=2)
    ddt = ddt_dir + (ddA * A.float()).reshape(b, t, h)
    dA = (ddA * dt.float().reshape(b, nc, l, h)).sum((0, 1, 2))
    # a group's h/g heads are consecutive
    dB = dB_h.reshape(b, t, g, h // g, n).sum(3)
    dC = dC_h.reshape(b, t, g, h // g, n).sum(3)
    return (dx, ddt.to(dt.dtype), dA.to(A.dtype), dB.to(B.dtype), dC.to(C.dtype),
            dinit if initial_state is not None else None)


class SSDFunction(torch.autograd.Function):
    """``_ssd_pallas_core`` with its ``custom_vjp`` (ssd_kernels.py:560-595):
    (x, dt, A, B, C, initial_state) -> (y without D, final state), the
    final state None unless ``need_final``.  Under the "mixer" remat
    policy the forward kernel's outputs are kept (ops/remat.py)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, initial_state, l, compute_dtype, need_final=True):
        def fwd():
            y, final = _ssd_fwd(x, dt, A, B, C, l, initial_state, compute_dtype)
            return y, (final if need_final else None)

        y, final = core_output(fwd)
        ctx.save_for_backward(x, dt, A, B, C, initial_state)
        ctx.l, ctx.compute_dtype = l, compute_dtype
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, B, C, initial_state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        grads = ssd_backward(x, dt, A, B, C, dy, ctx.l, ctx.compute_dtype,
                             initial_state, dfinal)
        return (*grads, None, None, None)


def ssd_chunked_kernel(x, dt, A, B, C, chunk_size: int = 256, D=None,
                       initial_state=None, return_final_state: bool = False,
                       compute_dtype=torch.bfloat16):
    """Drop-in for ``ops/ssd.ssd_chunked`` (same arguments, same
    contract as the JAX package's ``ssd_chunked_pallas``), differentiable
    through ``SSDFunction`` on every call.

    On a CUDA tensor: x (b, t, h, p) float32/bfloat16, last axis
    contiguous (batch, time and head strides are read as given, so slices
    of the conv output go in uncopied); dt (b, t, h) fp32; A (h,) fp32;
    B, C (b, t, g, n) in x's dtype, last axis contiguous; initial_state
    (b, h, p, n) fp32 contiguous or None (zeros).  The kernels compute in
    x's dtype, so ``compute_dtype`` must equal it.  Returns y in x's
    dtype (D added afterwards in fp32, as ``_add_D`` in the JAX package)
    [and the final state (b, h, p, n) fp32]."""
    l = _divisor_chunk(x.shape[1], chunk_size)
    y, final = SSDFunction.apply(x, dt, A, B, C, initial_state, l, compute_dtype,
                                 return_final_state)
    if D is not None:
        y = _add_D(y, x, D).to(x.dtype)
    if return_final_state:
        return y, final
    return y
