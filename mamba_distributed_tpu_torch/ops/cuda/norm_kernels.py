"""The RMSNorm family through the hand-written kernels of
``csrc/rms_norm.cu``, and their plain PyTorch versions.

The kernels replace no TPU kernel (the JAX package leaves its norms to
XLA).  They exist so that a row's normed output does not depend on how
many rows share the call: PyTorch's row reductions choose their thread
layout from the row count, which moved a compacted decode tick's bf16
outputs by an ulp against the full-width tick's.  Each kernel gives a row
(for the gated norm, a row's group) one CTA whose summation order is
fixed by the width alone.

* ``add_rms_norm_kernel`` (``add_rms_norm_kernel`` in the source): the
  residual add in ``residual_dtype``, then RMSNorm with fp32 statistics;
  with no residual it is ``rms_norm``;
* ``rms_norm_gated_kernel``: ``rms_norm(x * silu(z))`` per contiguous
  group of ``group_size`` channels;
* ``rms_norm_gated_sumsq_kernel``: each row's sum of squares of
  ``x * silu(z)``, the part of a gated row that a serving mesh's model
  rank holds (``ops/norm.gated_sum_squares``; the model group sums it
  with the row-parallel out_proj's partial product).  Its order is fixed
  as above, so compacted ticks keep their bits at
  ``serving_model_shards > 1`` too.

The plain versions are ops/norm.py's expressions; ``ops/norm.py`` picks
between the two by ``ops/dispatch.use_norm_kernel``.  These wrappers
take CUDA tensors only: they raise on any other (the plain route is the
caller's).  ``build.LAUNCHES`` counts each launch under
``"add_rms_norm"`` (``rms_norm`` included), ``"rms_norm_gated"`` and
``"rms_norm_gated_sumsq"``.
Inputs are fp32 or bf16, (..., d) with a contiguous last axis and rows
that ``reshape(-1, d)`` can view (a strided slice such as the mixer's z
is read in place); outputs are new contiguous tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from mamba_distributed_tpu_torch.ops.cuda import build
from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES

THREADS = 256  # kThreads: threads of every CTA, whatever the row count
_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


# ------------------------------------------------------------ plain versions


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    """RMSNorm in fp32, output cast back to ``x.dtype``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def add_rms_norm_plain(x: torch.Tensor, residual: torch.Tensor | None,
                       weight: torch.Tensor, eps: float = 1e-5,
                       residual_dtype: torch.dtype = torch.float32):
    """``(rms_norm(x + residual) in x.dtype, x + residual)``, the sum in
    ``residual_dtype``."""
    r = x.to(residual_dtype)
    if residual is not None:
        r = r + residual.to(residual_dtype)
    return rms_norm_plain(r, weight, eps).to(x.dtype), r


def rms_norm_gated_plain(x: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                         eps: float = 1e-5, group_size: int | None = None):
    """``rms_norm(x * silu(z))``, per contiguous group of ``group_size``
    channels when given."""
    xf = x.float() * F.silu(z.float())
    d = xf.shape[-1]
    if group_size is None or group_size == d:
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
    else:
        if d % group_size:
            raise ValueError(f"{d} channels do not split into groups of {group_size}")
        xg = xf.reshape(*xf.shape[:-1], d // group_size, group_size)
        var = xg.square().mean(dim=-1, keepdim=True)
        y = (xg * torch.rsqrt(var + eps)).reshape(xf.shape)
    return (y * weight.float()).to(x.dtype)


def rms_norm_gated_sumsq_plain(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Each row's sum of squares of ``x * silu(z)`` in fp32, (..., 1)."""
    return (x.float() * F.silu(z.float())).square().sum(dim=-1, keepdim=True)


# ------------------------------------------------------------------ kernels


@functools.cache
def _lib() -> ctypes.CDLL:
    return declare(build.load("rms_norm"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``rms_norm.cu``) with its C signatures
    declared, after checking its CTA width."""
    lib.mdt_rms_norm_threads.argtypes, lib.mdt_rms_norm_threads.restype = [], _I
    if lib.mdt_rms_norm_threads() != THREADS:
        raise RuntimeError(f"rms_norm.cu runs {lib.mdt_rms_norm_threads()} threads a CTA, "
                           f"this module expects {THREADS}")
    lib.mdt_add_rms_norm.argtypes = [_P, _L, _I, _P, _L, _I, _P, _P, _I, _P, _I, _L, _I,
                                     ctypes.c_float, _P]
    lib.mdt_rms_norm_gated.argtypes = [_P, _L, _I, _P, _L, _I, _P, _P, _I, _L, _I, _I,
                                       ctypes.c_float, _P]
    lib.mdt_rms_norm_gated_sumsq.argtypes = [_P, _L, _I, _P, _L, _I, _P, _L, _I, _P]
    lib.mdt_add_rms_norm.restype = lib.mdt_rms_norm_gated.restype = _I
    lib.mdt_rms_norm_gated_sumsq.restype = _I
    return lib


def _check(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _rows(name: str, label: str, t: torch.Tensor, d: int, device) -> torch.Tensor:
    """``t`` as (rows, d) with a contiguous last axis (a view where one
    exists, else a copy), after the checks the kernel needs."""
    _check(t.device == device, name, f"{label} lies on {t.device}, not {device}")
    _check(t.dtype in _CODE, name, f"{label} is {t.dtype}; the kernel takes fp32 or bf16")
    _check(t.shape[-1] == d, name, f"{label} has {t.shape[-1]} channels, not {d}")
    t2 = t.reshape(-1, d)
    if t2.stride(-1) != 1 or (t2.shape[0] > 1 and t2.stride(0) < d):
        t2 = t2.contiguous()
    return t2


def _weight(name: str, weight: torch.Tensor, d: int, device) -> torch.Tensor:
    _check(tuple(weight.shape) == (d,), name, f"weight shape {tuple(weight.shape)} != {(d,)}")
    _check(weight.device == device, name, f"weight lies on {weight.device}, not {device}")
    return weight.float().contiguous()


def _cuda_only(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} launches a CUDA kernel and got a tensor on "
                         f"{x.device.type!r}; ops/norm.py takes the plain version there")


def add_rms_norm_kernel(x: torch.Tensor, residual: torch.Tensor | None,
                        weight: torch.Tensor, eps: float = 1e-5,
                        residual_dtype: torch.dtype = torch.float32, *, lib=None,
                        keep_residual: bool = True):
    """``add_rms_norm_plain`` on the card: returns (normed in x.dtype, the
    residual sum in ``residual_dtype``, or None with ``keep_residual``
    False).  ``lib``: another build of ``rms_norm.cu`` (through
    ``declare``) to launch instead of the package's."""
    name = "add_rms_norm_kernel"
    _cuda_only(name, x)
    _check(residual_dtype in _CODE, name, f"residual_dtype {residual_dtype} is not fp32 or bf16")
    d = x.shape[-1]
    x2 = _rows(name, "x", x, d, x.device)
    r2 = None if residual is None else _rows(name, "residual", residual, d, x.device)
    _check(r2 is None or r2.shape[0] == x2.shape[0], name,
           f"residual has {r2.shape[0] if r2 is not None else 0} rows, x {x2.shape[0]}")
    w = _weight(name, weight, d, x.device)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    res_out = (torch.empty(x.shape, dtype=residual_dtype, device=x.device)
               if keep_residual else None)
    if x2.shape[0]:
        err = (lib or _lib()).mdt_add_rms_norm(
            x2.data_ptr(), x2.stride(0), _CODE[x.dtype],
            None if r2 is None else r2.data_ptr(), 0 if r2 is None else r2.stride(0),
            _CODE[r2.dtype] if r2 is not None else 0, w.data_ptr(), out.data_ptr(),
            _CODE[x.dtype], None if res_out is None else res_out.data_ptr(),
            _CODE[residual_dtype], x2.shape[0], d, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"add_rms_norm launch failed: cudaError {err}")
        LAUNCHES["add_rms_norm"] += 1
    return out, res_out


def rms_norm_kernel(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5, *, lib=None):
    """``rms_norm_plain`` on the card: ``add_rms_norm_kernel`` with no
    residual, the stream kept in x's own dtype."""
    return add_rms_norm_kernel(x, None, weight, eps, x.dtype, lib=lib, keep_residual=False)[0]


def rms_norm_gated_kernel(x: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                          eps: float = 1e-5, group_size: int | None = None, *, lib=None):
    """``rms_norm_gated_plain`` on the card (output in x.dtype)."""
    name = "rms_norm_gated_kernel"
    _cuda_only(name, x)
    d = x.shape[-1]
    group = d if group_size is None else group_size
    _check(group >= 1 and d % group == 0, name,
           f"{d} channels do not split into groups of {group_size}")
    _check(tuple(z.shape) == tuple(x.shape), name,
           f"z shape {tuple(z.shape)} != x shape {tuple(x.shape)}")
    x2 = _rows(name, "x", x, d, x.device)
    z2 = _rows(name, "z", z, d, x.device)
    w = _weight(name, weight, d, x.device)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x2.shape[0]:
        err = (lib or _lib()).mdt_rms_norm_gated(
            x2.data_ptr(), x2.stride(0), _CODE[x.dtype], z2.data_ptr(), z2.stride(0),
            _CODE[z.dtype], w.data_ptr(), out.data_ptr(), _CODE[x.dtype], x2.shape[0], d,
            group, float(eps), torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"rms_norm_gated launch failed: cudaError {err}")
        LAUNCHES["rms_norm_gated"] += 1
    return out


def _gated_pair(name: str, x: torch.Tensor, z: torch.Tensor):
    _cuda_only(name, x)
    d = x.shape[-1]
    _check(tuple(z.shape) == tuple(x.shape), name,
           f"z shape {tuple(z.shape)} != x shape {tuple(x.shape)}")
    return d, _rows(name, "x", x, d, x.device), _rows(name, "z", z, d, x.device)


def rms_norm_gated_sumsq_kernel(x: torch.Tensor, z: torch.Tensor, *, lib=None) -> torch.Tensor:
    """``rms_norm_gated_sumsq_plain`` on the card: (..., 1) fp32."""
    name = "rms_norm_gated_sumsq_kernel"
    d, x2, z2 = _gated_pair(name, x, z)
    ss = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    if x2.shape[0]:
        err = (lib or _lib()).mdt_rms_norm_gated_sumsq(
            x2.data_ptr(), x2.stride(0), _CODE[x.dtype], z2.data_ptr(), z2.stride(0),
            _CODE[z.dtype], ss.data_ptr(), x2.shape[0], d,
            torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"rms_norm_gated_sumsq launch failed: cudaError {err}")
        LAUNCHES["rms_norm_gated_sumsq"] += 1
    return ss
