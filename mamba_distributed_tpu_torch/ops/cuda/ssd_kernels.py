"""SSD forward through the hand-written Hopper kernel (``csrc/ssd_fwd.cu``).

Counterpart of ``ssd_chunked_pallas`` (mamba_distributed_tpu/ops/pallas/
ssd_kernels.py:598), forward only: the kernel replaces
``_ssd_fused_fwd_kernel`` (ssd_kernels.py:164).  The source's header
states what bounds it on the card and what its design does about that.

``ssd_chunked_kernel`` on a CPU tensor runs the plain ``ops/ssd.py``
formulation (the CPU tests); on a CUDA tensor it launches the kernel or
raises.  ``LAUNCHES`` (shared by every kernel of the port, ``build.py``)
counts the kernel launches, so a run can show that its main path went
through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mamba_distributed_tpu_torch.ops.cuda import build
from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
from mamba_distributed_tpu_torch.ops.dispatch import use_kernel
from mamba_distributed_tpu_torch.ops.ssd import _add_D, _divisor_chunk, ssd_chunked

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (built at first use)."""
    lib = build.load("ssd_fwd")
    lib.mdt_ssd_fwd.argtypes = [_P] * 8 + [_I] * 7 + [_L] * 12 + [_I, _P]
    lib.mdt_ssd_fwd.restype = _I
    lib.mdt_ssd_fwd_supports.argtypes = [_I, _I]
    lib.mdt_ssd_fwd_supports.restype = _I
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssd_chunked_kernel: {msg}")


def ssd_chunked_kernel(x, dt, A, B, C, chunk_size: int = 256, D=None,
                       initial_state=None, return_final_state: bool = False,
                       compute_dtype=torch.bfloat16):
    """Drop-in for ``ops/ssd.ssd_chunked`` (same arguments, same
    contract as the JAX package's ``ssd_chunked_pallas``).

    x (b, t, h, p) float32/bfloat16, last axis contiguous (batch, time
    and head strides are read as given, so slices of the conv output go
    in uncopied); dt (b, t, h) fp32; A (h,) fp32; B, C (b, t, g, n) in
    x's dtype, last axis contiguous; initial_state (b, h, p, n) fp32
    contiguous or None (zeros).  The kernel computes in x's dtype, so
    ``compute_dtype`` must equal it.  Returns y in x's dtype (D added
    afterwards in fp32, as ``_add_D`` in the JAX package) [and the final
    state (b, h, p, n) fp32].
    """
    if not use_kernel("pallas", x):
        return ssd_chunked(x, dt, A, B, C, chunk_size=chunk_size, D=D,
                           initial_state=initial_state,
                           return_final_state=return_final_state,
                           compute_dtype=compute_dtype)
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    _check(x.dtype in _DTYPE_CODE, f"x dtype {x.dtype} not float32/bfloat16")
    _check(compute_dtype == x.dtype,
           f"compute_dtype {compute_dtype} must equal x dtype {x.dtype}")
    _check(B.dtype == x.dtype and C.dtype == x.dtype, "B and C must share x's dtype")
    _check(tuple(B.shape) == (b, t, g, n) and tuple(C.shape) == (b, t, g, n),
           f"B/C shapes {tuple(B.shape)} {tuple(C.shape)}")
    _check(h % g == 0, f"{h} heads do not split into {g} groups")
    _check(dt.dtype == torch.float32 and tuple(dt.shape) == (b, t, h),
           f"dt must be fp32 (b, t, h), got {dt.dtype} {tuple(dt.shape)}")
    _check(A.dtype == torch.float32 and tuple(A.shape) == (h,) and A.is_contiguous(),
           "A must be a contiguous fp32 (h,)")
    for name, v in (("x", x), ("B", B), ("C", C)):
        _check(v.is_cuda and v.device == x.device, f"{name} not on {x.device}")
        _check(v.stride(-1) == 1, f"{name}'s last axis must be contiguous")
    _check(dt.device == x.device and A.device == x.device, "dt/A device")
    if initial_state is not None:
        _check(initial_state.dtype == torch.float32
               and tuple(initial_state.shape) == (b, h, p, n)
               and initial_state.is_contiguous()
               and initial_state.device == x.device,
               "initial_state must be a contiguous fp32 (b, h, p, n) on x's device")
    lib = _lib()
    _check(bool(lib.mdt_ssd_fwd_supports(p, n)),
           f"no kernel instance for headdim={p}, d_state={n}")
    l = _divisor_chunk(t, chunk_size)
    _check(l <= 256, f"chunk {l} > 256")

    y = torch.empty((b, t, h, p), dtype=x.dtype, device=x.device)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.mdt_ssd_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        None if initial_state is None else initial_state.data_ptr(),
        y.data_ptr(), final.data_ptr(),
        b, t, h, p, g, n, l,
        x.stride(0), x.stride(1), x.stride(2),
        dt.stride(0), dt.stride(1), dt.stride(2),
        B.stride(0), B.stride(1), B.stride(2),
        C.stride(0), C.stride(1), C.stride(2),
        _DTYPE_CODE[x.dtype], stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd_fwd launch failed: cudaError {err}")
    LAUNCHES["ssd_fwd"] += 1
    if D is not None:
        y = _add_D(y, x, D).to(x.dtype)
    if return_final_state:
        return y, final
    return y
