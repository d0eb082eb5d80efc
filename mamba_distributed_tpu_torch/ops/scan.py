"""Selective scan (Mamba-1 SSM recurrence), the plain PyTorch formulation.

Counterpart of ``mamba_distributed_tpu/ops/scan.py``.  Recurrence (per
batch, channel d, state n):

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * u_t * B_t
    y_t = <C_t, h_t> + D * u_t           (then y *= silu(z) if gated)

Three functions:

* ``selective_scan_seq``: a step loop over time, the oracle;
* ``selective_scan``: chunked.  Within a chunk of l steps a doubling
  (Hillis-Steele) scan of log2(l) passes combines the (decay, input)
  pairs, as ``lax.associative_scan`` does in the JAX package; between
  chunks the state is carried by a Python loop.  Each chunk body runs
  under ``torch.utils.checkpoint`` (the JAX ``jax.checkpoint``), so the
  backward keeps only the chunk boundaries' states and rebuilds one
  chunk's intermediates at a time.  Memory: every (b, l, d, n) fp32 chunk
  tensor takes b * l * d * n * 4 bytes, at mamba1-280m's widths (d 1536,
  n 16) and the default l 128 that is 12.6 MB per batch row, 402 MB at
  b 32; a pass of the doubling scan holds about four of them at once.
  This is the ``ssm_impl="xla"`` path and the plain version the
  hand-written kernels (ops/cuda/scan_kernels.py) are held to;
* ``selective_state_update``: the O(1) decode step.

All state math runs in fp32 whatever the input dtype; outputs keep the
caller's dtype.  Shapes: u/delta (b, t, d); A (d, n); B/C (b, t, n);
D (d,); z (b, t, d); initial_state (b, d, n).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mamba_distributed_tpu_torch.ops.ssd import _divisor_chunk


def _prep(u, delta, A, B, C, D, delta_bias, delta_softplus):
    """fp32 promotion + delta preprocessing (scan.py:53-65)."""
    uf = u.float()
    df = delta.float()
    if delta_bias is not None:
        df = df + delta_bias.float()
    if delta_softplus:
        df = F.softplus(df)
    Df = None if D is None else D.float()
    return uf, df, A.float(), B.float(), C.float(), Df


def _epilogue(y, uf, Df, z, dtype):
    """D skip and silu(z) gate in fp32, then the caller's dtype."""
    if Df is not None:
        y = y + uf * Df
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(dtype)


def _h0(initial_state, b, d, n, device):
    """The fp32 initial state, zeros when None."""
    if initial_state is None:
        return torch.zeros((b, d, n), dtype=torch.float32, device=device)
    return initial_state.float()


def _step(h, A, dt_i, u_i, B_i):
    """One recurrence step h' = h * exp(dt A) + outer(dt u, B): h (b, d, n),
    A (d, n), dt_i/u_i (b, d), B_i (b, n), all fp32."""
    return h * torch.exp(dt_i[..., None] * A) + (dt_i * u_i)[..., None] * B_i[:, None, :]


def selective_scan_seq(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                       delta_softplus: bool = False, initial_state=None,
                       return_final_state: bool = False):
    """Oracle: a plain step loop over time (scan.py:68-119)."""
    b, t, d = u.shape
    n = A.shape[-1]
    uf, df, Af, Bf, Cf, Df = _prep(u, delta, A, B, C, D, delta_bias, delta_softplus)
    h = _h0(initial_state, b, d, n, u.device)
    ys = []
    for i in range(t):
        h = _step(h, Af, df[:, i], uf[:, i], Bf[:, i])
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, i]))
    y = _epilogue(torch.stack(ys, dim=1), uf, Df, z, u.dtype)
    if return_final_state:
        return y, h
    return y


def _chunk_scan(h0, u_i, dt_i, Af, B_i, C_i):
    """One chunk: doubling scan over the local time axis.

    h0 (b, d, n); u_i/dt_i (b, l, d); Af (d, n); B_i/C_i (b, l, n).
    Returns (y (b, l, d), h_last (b, d, n))."""
    a = torch.exp(dt_i[..., None] * Af)  # (b, l, d, n)
    x = (dt_i * u_i)[..., None] * B_i[:, :, None, :]
    # fold the carried state into the first element
    x = torch.cat([x[:, :1] + h0[:, None] * a[:, :1], x[:, 1:]], dim=1)
    l, k = x.shape[1], 1
    while k < l:
        # element i absorbs the prefix ending at i - k:
        # (a, x)_i <- (a_{i-k} a_i, x_{i-k} a_i + x_i)
        x = torch.cat([x[:, :k], x[:, :-k] * a[:, k:] + x[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], dim=1)
        k *= 2
    return torch.einsum("bldn,bln->bld", x, C_i), x[:, -1]


def selective_scan(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                   delta_softplus: bool = False, initial_state=None,
                   return_final_state: bool = False, chunk_size: int = 128):
    """Production path: chunked doubling scan, each chunk rematerialized
    in the backward (scan.py:147-198)."""
    b, t, d = u.shape
    n = A.shape[-1]
    uf, df, Af, Bf, Cf, Df = _prep(u, delta, A, B, C, D, delta_bias, delta_softplus)
    h = _h0(initial_state, b, d, n, u.device)
    l = _divisor_chunk(t, chunk_size)
    remat = torch.is_grad_enabled()
    ys = []
    for c in range(0, t, l):
        args = (h, uf[:, c:c + l], df[:, c:c + l], Af, Bf[:, c:c + l], Cf[:, c:c + l])
        if remat:
            y_c, h = checkpoint(_chunk_scan, *args, use_reentrant=False)
        else:
            y_c, h = _chunk_scan(*args)
        ys.append(y_c)
    y = _epilogue(torch.cat(ys, dim=1), uf, Df, z, u.dtype)
    if return_final_state:
        return y, h
    return y


def selective_state_update(ssm_state, x_t, dt_t, A, B_t, C_t, D=None, z_t=None,
                           dt_bias=None, dt_softplus: bool = True, out=None):
    """O(1) decode step (scan.py:201-235): ssm_state (b, d, n); x_t/dt_t
    (b, d); A (d, n); B_t/C_t (b, n).  Returns (y_t (b, d) in x_t's
    dtype, new_state (b, d, n) fp32).  With ``out`` the new state is
    written there (it may be ``ssm_state`` itself: an in-place update)."""
    xf = x_t.float()
    dtf = dt_t.float()
    if dt_bias is not None:
        dtf = dtf + dt_bias.float()
    if dt_softplus:
        dtf = F.softplus(dtf)
    h = _step(ssm_state.float(), A.float(), dtf, xf, B_t.float())
    y = torch.einsum("bdn,bn->bd", h, C_t.float())
    if out is not None:
        out.copy_(h)
        h = out
    return _epilogue(y, xf, None if D is None else D.float(), z_t, x_t.dtype), h
