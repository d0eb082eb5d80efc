"""Selective scan (Mamba-1) forward and backward through the hand-written
Hopper kernels (``csrc/selective_scan.cu``), their plain PyTorch
versions, and the ``torch.autograd.Function`` around them.

Counterpart of mamba_distributed_tpu/ops/pallas/scan_kernels.py.  Three
kernels, each beside its plain version of the same signature and layout:

* ``m1_scan`` replaces ``_m1_scan_kernel`` (:64): the fp32 core
  ``(u, dt, A, B, C, h0) -> (y, hT)``;
* ``m1_entry_states`` replaces ``_m1_entry_states_kernel`` (:178): the
  state entering each tile of ``T_BLK`` steps, (b, nt, d, n);
* ``m1_bwd`` replaces ``_m1_bwd_kernel`` (:201): the reverse sweep,
  seeded by the final-state cotangent, giving du, ddt (b, t, d), the
  per-batch dA partial (b, d, n), the per-CTA dB and dC partials
  (b, nd, t, n) of ``D_BLK`` channels each, and dh0 (b, d, n).

``SelectiveScanFunction`` (``_m1_core`` with its ``custom_vjp``,
:388-410) runs ``m1_scan`` as its forward and saves (u, dt, A, B, C,
h0); its backward runs ``m1_entry_states``, then ``m1_bwd``, then sums
the partials in PyTorch (dA over batch, dB and dC over the channel
blocks), as the JAX package sums them in XLA.  ``_prep`` (fp32 casts,
``delta_bias``, softplus) runs before it and the D skip and the silu(z)
gate after it, in plain PyTorch that autograd differentiates.

Every wrapper runs its plain version on a CPU tensor (the CPU tests go
through the Function's glue that way) and, on a CUDA tensor, launches
its kernel or raises.  ``build.LAUNCHES`` counts the launches
(``"m1_scan"``, ``"m1_entry_states"``, ``"m1_bwd"``).  The kernels take
d_state 16 only (Mamba-1's), fp32, contiguous.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mamba_distributed_tpu_torch.ops.cuda import build
from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
from mamba_distributed_tpu_torch.ops.dispatch import use_kernel
from mamba_distributed_tpu_torch.ops.scan import (
    _epilogue,
    _h0,
    _prep,
    _step,
    selective_scan_seq,
)

# layout constants of csrc/selective_scan.cu (the library reports its
# own; ``_lib`` checks that they agree)
N_STATE = 16  # kN: the one d_state the kernels take
T_BLK = 8  # kTB: time steps per tile of m1_entry_states and m1_bwd (the entry states' tile axis)
D_BLK = 64  # kBwdThreads: channels per m1_bwd CTA (the dB/dC partials' block axis)

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    """The library with its C signatures declared (built at first use)."""
    lib = build.load("selective_scan")
    for fn in (lib.mdt_m1_state_size, lib.mdt_m1_tile, lib.mdt_m1_bwd_channels):
        fn.argtypes, fn.restype = [], _I
    got = (lib.mdt_m1_state_size(), lib.mdt_m1_tile(), lib.mdt_m1_bwd_channels())
    if got != (N_STATE, T_BLK, D_BLK):
        raise RuntimeError(f"selective_scan.cu layout {got} != {(N_STATE, T_BLK, D_BLK)}")
    lib.mdt_m1_scan.argtypes = [_P] * 8 + [_I] * 4 + [_P]
    lib.mdt_m1_entry_states.argtypes = [_P] * 6 + [_I] * 4 + [_P]
    lib.mdt_m1_bwd.argtypes = [_P] * 14 + [_I] * 4 + [_P]
    for fn in (lib.mdt_m1_scan, lib.mdt_m1_entry_states, lib.mdt_m1_bwd):
        fn.restype = _I
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"selective scan kernels: {msg}")


def _check_inputs(u, dt, A, B, **optional) -> None:
    """Device, dtype, shape and contiguity checks of the inputs and of the
    ``optional`` ones, given as name=(tensor or None, shape)."""
    b, t, d = u.shape
    n = A.shape[-1]
    _check(n == N_STATE, f"d_state {n}: the kernels take d_state {N_STATE} only")
    shapes = {"u": (u, (b, t, d)), "dt": (dt, (b, t, d)), "A": (A, (d, n)),
              "B": (B, (b, t, n))}
    shapes.update({k: v for k, v in optional.items() if v[0] is not None})
    for name, (v, shape) in shapes.items():
        _check(v.dtype == torch.float32 and tuple(v.shape) == shape and v.is_contiguous()
               and v.device == u.device,
               f"{name} must be a contiguous fp32 {shape} on {u.device}, got "
               f"{v.dtype} {tuple(v.shape)} on {v.device}")


def _ptr(v):
    return None if v is None else v.data_ptr()


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


# ---------------------------------------------------------- kernel 4: scan


def m1_scan_plain(u, dt, A, B, C, h0=None):
    """(y (b, t, d), hT (b, d, n)) of the recurrence from ``h0`` (zeros if
    None): u, dt (b, t, d); A (d, n); B, C (b, t, n); all fp32.  The
    oracle's step loop without D, z or dt preprocessing."""
    return selective_scan_seq(u, dt, A, B, C, initial_state=h0, return_final_state=True)


def m1_scan(u, dt, A, B, C, h0=None):
    """``m1_scan_plain`` through kernel 4 on a CUDA tensor."""
    if not use_kernel("pallas", u):
        return m1_scan_plain(u, dt, A, B, C, h0)
    b, t, d = u.shape
    n = A.shape[-1]
    _check_inputs(u, dt, A, B, C=(C, (b, t, n)), h0=(h0, (b, d, n)))
    y = torch.empty((b, t, d), dtype=torch.float32, device=u.device)
    hT = torch.empty((b, d, n), dtype=torch.float32, device=u.device)
    _raise_on(_lib().mdt_m1_scan(u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                                 C.data_ptr(), _ptr(h0), y.data_ptr(), hT.data_ptr(),
                                 b, t, d, n, _stream(u)), "m1_scan")
    LAUNCHES["m1_scan"] += 1
    return y, hT


# ------------------------------------------------- kernel 5: entry states


def m1_entry_states_plain(u, dt, A, B, h0=None):
    """The state entering each tile of ``T_BLK`` steps: (b, ceil(t /
    T_BLK), d, n) fp32, tile 0's being ``h0`` (zeros if None)."""
    b, t, d = u.shape
    h = _h0(h0, b, d, A.shape[-1], u.device)
    states = []
    for i in range(t):
        if i % T_BLK == 0:
            states.append(h)
        h = _step(h, A, dt[:, i], u[:, i], B[:, i])
    return torch.stack(states, dim=1)


def m1_entry_states(u, dt, A, B, h0=None):
    """``m1_entry_states_plain`` through kernel 5 on a CUDA tensor."""
    if not use_kernel("pallas", u):
        return m1_entry_states_plain(u, dt, A, B, h0)
    b, t, d = u.shape
    n = A.shape[-1]
    _check_inputs(u, dt, A, B, h0=(h0, (b, d, n)))
    states = torch.empty((b, -(-t // T_BLK), d, n), dtype=torch.float32, device=u.device)
    _raise_on(_lib().mdt_m1_entry_states(u.data_ptr(), dt.data_ptr(), A.data_ptr(),
                                         B.data_ptr(), _ptr(h0), states.data_ptr(),
                                         b, t, d, n, _stream(u)), "m1_entry_states")
    LAUNCHES["m1_entry_states"] += 1
    return states


# ----------------------------------------------------- kernel 6: backward


def m1_bwd_plain(u, dt, A, B, C, states, dy, dfinal=None):
    """The reverse sweep of kernel 6, tile by tile from ``states`` (what
    ``m1_entry_states`` gives), each tile's states rebuilt from its entry
    state, the cotangent gh seeded by ``dfinal`` (zeros if None).

    Returns du, ddt (b, t, d); the per-batch dA partial (b, d, n); the dB
    and dC partials (b, nd, t, n), each summed over one block of ``D_BLK``
    channels (nd = ceil(d / D_BLK)); dh0 (b, d, n)."""
    b, t, d = u.shape
    n = A.shape[-1]
    nd = -(-d // D_BLK)
    gh = _h0(dfinal, b, d, n, u.device).clone()
    dA = torch.zeros_like(gh)
    du = torch.empty_like(u)
    ddt = torch.empty_like(u)
    dB = torch.zeros((b, nd * D_BLK, t, n), dtype=torch.float32, device=u.device)
    dC = torch.zeros_like(dB)
    for k in reversed(range(states.shape[1])):
        steps = range(k * T_BLK, min(t, (k + 1) * T_BLK))
        hprev, h = {}, states[:, k]
        for i in steps:  # rebuild: hprev[i] = the state entering step i
            hprev[i] = h
            h = _step(h, A, dt[:, i], u[:, i], B[:, i])
        for i in reversed(steps):
            dt_i, u_i, dy_i = dt[:, i, :, None], u[:, i, :, None], dy[:, i, :, None]
            B_i, C_i, hp = B[:, i, None, :], C[:, i, None, :], hprev[i]
            e = torch.exp(A * dt_i)
            gh = gh + C_i * dy_i
            dB[:, :d, i] = gh * dt_i * u_i
            dC[:, :d, i] = (hp * e + dt_i * u_i * B_i) * dy_i
            ddt[:, i] = (gh * (hp * A * e + u_i * B_i)).sum(-1)
            du[:, i] = dt[:, i] * (gh * B_i).sum(-1)
            gh = gh * e
            dA = dA + gh * hp * dt_i
    dB = dB.reshape(b, nd, D_BLK, t, n).sum(2)
    dC = dC.reshape(b, nd, D_BLK, t, n).sum(2)
    return du, ddt, dA, dB, dC, gh


def m1_bwd(u, dt, A, B, C, states, dy, dfinal=None):
    """``m1_bwd_plain`` through kernel 6 on a CUDA tensor."""
    if not use_kernel("pallas", u):
        return m1_bwd_plain(u, dt, A, B, C, states, dy, dfinal)
    b, t, d = u.shape
    n = A.shape[-1]
    nt, nd = -(-t // T_BLK), -(-d // D_BLK)
    _check_inputs(u, dt, A, B, C=(C, (b, t, n)), states=(states, (b, nt, d, n)),
                  dy=(dy, (b, t, d)), dfinal=(dfinal, (b, d, n)))
    dev, f32 = u.device, torch.float32
    du = torch.empty((b, t, d), dtype=f32, device=dev)
    ddt = torch.empty_like(du)
    dA = torch.empty((b, d, n), dtype=f32, device=dev)
    dB = torch.empty((b, nd, t, n), dtype=f32, device=dev)
    dC = torch.empty_like(dB)
    dh0 = torch.empty_like(dA)
    _raise_on(_lib().mdt_m1_bwd(
        u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        states.data_ptr(), dy.data_ptr(), _ptr(dfinal), du.data_ptr(), ddt.data_ptr(),
        dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), dh0.data_ptr(), b, t, d, n,
        _stream(u)), "m1_bwd")
    LAUNCHES["m1_bwd"] += 1
    return du, ddt, dA, dB, dC, dh0


# ------------------------------------------------------- the autograd core


class SelectiveScanFunction(torch.autograd.Function):
    """``_m1_core`` with its ``custom_vjp`` (scan_kernels.py:388-410):
    (u, dt, A, B, C, h0) fp32 -> (y, hT), h0 None for zeros."""

    @staticmethod
    def forward(ctx, u, dt, A, B, C, h0):
        y, hT = m1_scan(u, dt, A, B, C, h0)
        ctx.save_for_backward(u, dt, A, B, C, h0)
        ctx.set_materialize_grads(False)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dfinal):
        u, dt, A, B, C, h0 = ctx.saved_tensors
        dy = torch.zeros_like(u) if dy is None else dy.float().contiguous()
        if dfinal is not None:
            dfinal = dfinal.float().contiguous()
        states = m1_entry_states(u, dt, A, B, h0)
        du, ddt, dA, dB, dC, dh0 = m1_bwd(u, dt, A, B, C, states, dy, dfinal)
        return (du, ddt, dA.sum(0), dB.sum(1), dC.sum(1),
                dh0 if ctx.needs_input_grad[5] else None)


def selective_scan_kernel(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                          delta_softplus: bool = False, initial_state=None,
                          return_final_state: bool = False):
    """Drop-in for ``ops/scan.selective_scan`` (the contract of the JAX
    package's ``selective_scan_pallas``, scan_kernels.py:413-484),
    differentiable through ``SelectiveScanFunction`` on every call:
    plain, seeded (``initial_state``) and with ``return_final_state``.
    Shapes: u/delta (b, t, d); A (d, n); B/C (b, t, n); D (d,); z
    (b, t, d); initial_state (b, d, n).  Returns y in u's dtype [and the
    final state (b, d, n) fp32]."""
    uf, df, Af, Bf, Cf, Df = _prep(u, delta, A, B, C, D, delta_bias, delta_softplus)
    h0 = None if initial_state is None else initial_state.float().contiguous()
    y, h_last = SelectiveScanFunction.apply(
        uf.contiguous(), df.contiguous(), Af.contiguous(), Bf.contiguous(),
        Cf.contiguous(), h0)
    y = _epilogue(y, uf, Df, z, u.dtype)
    if return_final_state:
        return y, h_last
    return y
