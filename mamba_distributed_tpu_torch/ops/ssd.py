"""SSD chunked scan (Mamba-2), the plain PyTorch formulation.

Counterpart of ``mamba_distributed_tpu/ops/ssd.py``: the sequence splits
into chunks of length l; within a chunk the recurrence is a pair of
(l x n)(n x l) and (l x l)(l x p) products, and the (h, p, n) chunk
states flow between chunks through ``state_passing``.  This is the
version the CPU tests hold against the JAX package, and the version the
hand-written kernel (ops/cuda/ssd_kernels.py) is held against on the
card.

Recurrence (per batch, head h):
    h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * x_t B_t^T
    y_t = h_t C_t + D_h * x_t

Shapes: x (b, t, h, p); dt (b, t, h) (bias added, softplus applied);
A (h,); B, C (b, t, g, n) with group g shared by h/g heads; D (h,) or
(h, p); initial_state (b, h, p, n) fp32.  Decay math runs in fp32; the
products take ``compute_dtype`` inputs and accumulate in fp32.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F


def _divisor_chunk(t: int, chunk_size: int) -> int:
    """Largest chunk size <= chunk_size that divides t (copy of
    ``mamba_distributed_tpu/ops/scan.py:_divisor_chunk``)."""
    l = min(chunk_size, t)
    while t % l != 0:
        l -= 1
    if 4 * l <= min(chunk_size, t):
        warnings.warn(
            f"sequence length {t} has no divisor near chunk_size={chunk_size}; "
            f"falling back to chunk size {l}, which degrades the chunked scan "
            f"toward per-token work — pad the sequence to a multiple of a "
            f"reasonable chunk size instead",
            stacklevel=3,
        )
    return l


def _mm(a: torch.Tensor, b: torch.Tensor, eq: str, cd: torch.dtype):
    """einsum of ``cd``-rounded inputs with fp32 accumulation and output.

    bf16 x bf16 products are exact in fp32, so upcasting the rounded
    inputs gives the "bf16 products, fp32 sums" semantics of the JAX
    package's ``preferred_element_type=float32`` on every device."""
    return torch.einsum(eq, a.to(cd).float(), b.to(cd).float())


def cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inclusive cumulative sum in fp32 (the JAX package's cumsum_mxu
    computes the same prefix sums as a triangular matmul)."""
    return torch.cumsum(x.float(), dim=dim).to(x.dtype)


def reverse_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """out[..., i] = sum_{k >= i} x[..., k] along ``dim``, in fp32."""
    return cumsum(x.float().flip(dim), dim=dim).flip(dim)


def chunk_log_decay(dt: torch.Tensor, A: torch.Tensor, l: int) -> torch.Tensor:
    """In-chunk cumulative log-decay a = cumsum(dt * A) over each chunk
    of length l: dt (b, t, h), A (h,) -> (b, nc, l, h) fp32 (the ``a``
    of ``_chunked_inputs`` in the JAX package's Pallas SSD)."""
    b, t, h = dt.shape
    return cumsum(dt.float().reshape(b, t // l, l, h) * A.float(), dim=2)


def heads_of_groups(v: torch.Tensor, h: int) -> torch.Tensor:
    """(..., g, n) grouped B or C -> (..., h, n): head j reads group
    j * g // h, as the kernels index them (no copy where g == h)."""
    g = v.shape[-2]
    if g == h:
        return v
    lead = v.shape[:-2]
    return (v.unsqueeze(-2).expand(*lead, g, h // g, v.shape[-1])
            .reshape(*lead, h, v.shape[-1]))


def segsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{k in (j, i]} x[..., k] for i >= j, -inf above."""
    l = x.shape[-1]
    cs = cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    return d.masked_fill(~mask, float("-inf"))


def chunk_local(x, dt, A, B, C, chunk_size: int, compute_dtype=torch.bfloat16):
    """Per-chunk compute: intra-chunk outputs and chunk state summaries.

    Returns y_diag (b, nc, l, h, p), states (b, nc, h, p, n),
    chunk_decay (b, nc, h) and off_ctx = (C (b, nc, l, g, n) in the
    compute dtype, exp(a) (b, nc, l, h)).
    """
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[-1]
    hg = h // g
    l = chunk_size
    if t % l:
        raise ValueError(f"chunk {l} does not divide sequence length {t}")
    nc = t // l
    cd = compute_dtype

    dtc = dt.float().reshape(b, nc, l, h)
    xc = x.reshape(b, nc, l, h, p)
    Bc = B.reshape(b, nc, l, g, n)
    Cc = C.reshape(b, nc, l, g, n)

    dA = dtc * A.float()
    dA_cum = cumsum(dA, dim=2)

    G = _mm(Cc, Bc, "bclgn,bcsgn->bcgls", cd)  # (b, nc, g, l, l)
    L_mat = torch.exp(segsum(dA.movedim(2, -1)))  # (b, nc, h, l, l)
    Lg = L_mat.reshape(b, nc, g, hg, l, l)
    M = (G[:, :, :, None] * Lg).to(cd).reshape(b, nc, h, l, l)
    xdt = (xc.float() * dtc[..., None]).to(cd)
    y_diag = _mm(M, xdt, "bchls,bcshp->bclhp", cd)

    decay_states = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)  # (b, nc, l, h)
    xg = ((xc.float() * (decay_states * dtc)[..., None]).to(cd)
          .reshape(b, nc, l, g, hg, p))
    states = _mm(Bc, xg, "bclgn,bclgjp->bcgjpn", cd).reshape(b, nc, h, p, n)
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])
    return y_diag, states, chunk_decay, (Cc.to(cd), torch.exp(dA_cum))


def state_passing(states: torch.Tensor, chunk_decay: torch.Tensor,
                  initial_state: torch.Tensor | None = None):
    """Inter-chunk recurrence.  states (b, nc, h, p, n) fp32, chunk_decay
    (b, nc, h).  Returns (the state entering each chunk, final state).

    As in the JAX package, the recurrence is one lower-triangular
    decay-weighted product over log-space cumulative decays."""
    b, nc, h, p, n = states.shape
    ldc = torch.log(torch.clamp(chunk_decay.float(),
                                min=torch.finfo(torch.float32).tiny))
    cum = cumsum(ldc, dim=1)  # (b, nc, h)
    diff = cum[:, :, None, :] - cum[:, None, :, :]  # (b, c, j, h)
    tri = torch.ones((nc, nc), dtype=torch.bool,
                     device=states.device).tril()[None, :, :, None]
    # mask BEFORE the exp: above the diagonal diff >= 0 could overflow
    W = torch.where(tri, torch.exp(torch.where(tri, diff, -100.0)), 0.0)
    s_cum = torch.einsum("bcjh,bjhpn->bchpn", W.to(states.dtype), states)
    if initial_state is not None:
        s_cum = s_cum + torch.exp(cum)[..., None, None] * initial_state.float()[:, None]
    final_state = s_cum[:, -1]
    s0 = (states.new_zeros((b, 1, h, p, n)) if initial_state is None
          else initial_state.to(states.dtype)[:, None])
    return torch.cat([s0, s_cum[:, :-1]], dim=1), final_state


def _add_D(y: torch.Tensor, x: torch.Tensor, D: torch.Tensor | None):
    """y + D * x in fp32 (D (h,) or (h, p)); returns fp32."""
    if D is None:
        return y
    Df = D.float()
    return y + x.float() * (Df[None, None] if Df.ndim == 2 else Df[None, None, :, None])


def combine_chunk_outputs(y_diag, off_ctx, prev_states, x, D, compute_dtype):
    """Off-diagonal correction through the entering states, plus the D
    skip; output in ``x.dtype``."""
    b, nc, l, h, p = y_diag.shape
    Cc, state_decay = off_ctx
    g = Cc.shape[3]
    n = prev_states.shape[-1]
    prev_g = prev_states.reshape(b, nc, g, h // g, p, n)
    y_off = _mm(Cc, prev_g, "bclgn,bcgjpn->bclgjp", compute_dtype)
    y_off = y_off.reshape(b, nc, l, h, p) * state_decay[..., None]
    y = (y_diag + y_off).reshape(b, nc * l, h, p)
    return _add_D(y, x, D).to(x.dtype)


def ssd_chunked(x, dt, A, B, C, chunk_size: int = 256, D=None,
                initial_state=None, return_final_state: bool = False,
                compute_dtype=torch.bfloat16):
    """Full chunked SSD forward: chunk_local -> state_passing -> combine."""
    t = x.shape[1]
    l = _divisor_chunk(t, chunk_size)
    y_diag, states, chunk_decay, off_ctx = chunk_local(
        x, dt, A, B, C, l, compute_dtype)
    prev_states, final_state = state_passing(states, chunk_decay, initial_state)
    y = combine_chunk_outputs(y_diag, off_ctx, prev_states, x, D, compute_dtype)
    if return_final_state:
        return y, final_state
    return y


def ssd_state_update(ssm_state, x_t, dt_t, A, B_t, C_t, D=None, dt_bias=None,
                     dt_softplus: bool = True, out=None):
    """One decode step (counterpart of ``ops/ssd.py:368``).

    ssm_state (b, h, p, n) fp32; x_t (b, h, p); dt_t (b, h); B_t, C_t
    (b, g, n).  Returns (y_t (b, h, p) in ``x_t.dtype``, new state).
    With ``out`` the new state is written there (it may be ``ssm_state``
    itself: an in-place update of the caller's state) and returned."""
    b, h, p, n = ssm_state.shape
    g = B_t.shape[1]
    xf = x_t.float()
    dtf = dt_t.float()
    if dt_bias is not None:
        dtf = dtf + dt_bias.float()
    if dt_softplus:
        dtf = F.softplus(dtf)
    Bh = B_t.float().repeat_interleave(h // g, dim=1)  # (b, h, n)
    Ch = C_t.float().repeat_interleave(h // g, dim=1)
    decay = torch.exp(dtf * A.float()[None])  # (b, h)
    dBx = torch.einsum("bhp,bhn,bh->bhpn", xf, Bh, dtf)
    if out is None:
        s = ssm_state.float() * decay[:, :, None, None] + dBx
    else:
        s = torch.mul(ssm_state, decay[:, :, None, None], out=out)
        s.add_(dBx)
    y = torch.einsum("bhpn,bhn->bhp", s, Ch)
    y = _add_D(y[:, None], x_t[:, None], D)[:, 0]
    return y.to(x_t.dtype), s
