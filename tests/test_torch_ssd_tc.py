"""The tensor-core SSD forward (``ssd_fwd_tc_kernel``) from the CPU: its
dispatch rule, the views its TMA copies can read, and a plain model of its
arithmetic held against the JAX package's fused SSD kernel in interpret
mode and against the port's plain ``ssd_chunked``.

The kernel itself runs only on the card (``chip_smoke.py`` holds it
against the plain version there).  The model repeats its rounding points
and its split on the CPU, in bf16: per chunk, a = cumsum(dt A) in fp32;
round(C e^a) against round(S) for the carried state; for each 64-row
output block i the blocks j <= i of G = C B^T (fp32 sums of bf16
products), M = round(mask(G e^(a_r - a_c))) and round(x dt), summed in
block order after the state term; the state scaled by e^(a_L), then
increased block by block by round(x_j)^T round(B_j w_j), w = dt
e^(a_L - a), kept in fp32 across the chunks.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_distributed_tpu.ops.pallas import ssd_chunked_pallas
from mamba_distributed_tpu_torch.config import get_preset
from mamba_distributed_tpu_torch.ops.cuda import ssd_kernels as sk
from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
from mamba_distributed_tpu_torch.ops.ssd import (
    _divisor_chunk,
    chunk_log_decay,
    heads_of_groups,
    ssd_chunked,
)

pytestmark = pytest.mark.torch

BF16_TOL = 3e-2  # chip_smoke.TOL[bf16], as max |got - ref| / max |ref|
# the model against the JAX kernel, which rounds at the same points: the
# sums' order (and the cumsum's) moves a rounded operand by a bf16 ulp now
# and then, a few 2^-9 apart
MODEL_TOL = 1e-2
ROWS = 64  # output rows of a CTA
bf16 = torch.bfloat16
f32 = np.float32


def _r(v):
    """Round to bf16 and back (a kernel cast point)."""
    return v.to(bf16).float()


def tc_forward_model(x, dt, A, B, C, chunk, initial_state=None):
    """The tensor-core forward's arithmetic (see the module docstring):
    bf16 x (b, t, h, p), B and C (b, t, g, n); fp32 dt (b, t, h), A (h,),
    initial_state (b, h, p, n) or None.  Returns (y without D in bf16,
    final state fp32)."""
    b, t, h, p = x.shape
    n = B.shape[-1]
    l = _divisor_chunk(t, chunk)
    nc, nrb = t // l, -(-l // ROWS)
    a = chunk_log_decay(dt, A, l)  # (b, nc, l, h)
    S = (torch.zeros((b, h, p, n)) if initial_state is None else initial_state.float())
    y = torch.empty((b, t, h, p))
    tril = torch.ones((l, l), dtype=torch.bool).tril()
    for c in range(nc):
        rows = slice(c * l, (c + 1) * l)
        ac, dtc = a[:, c], dt[:, rows].float()  # (b, l, h)
        xc = x[:, rows].float()
        Bc = heads_of_groups(B[:, rows], h).float()
        Cc = heads_of_groups(C[:, rows], h).float()
        a_last = ac[:, -1]  # (b, h)
        e = torch.exp(ac)
        w = dtc * torch.exp(a_last[:, None] - ac)
        G = torch.einsum("bihn,bjhn->bhij", Cc, Bc)
        diff = (ac[:, :, None] - ac[:, None, :]).permute(0, 3, 1, 2)  # (b, h, i, j)
        M = _r(torch.where(tril, G * torch.exp(torch.where(tril, diff, 0.0)), 0.0))
        xdt = _r(xc * dtc[..., None])
        y_off = torch.einsum("bihn,bhpn->bihp", _r(Cc * e[..., None]), _r(S))
        for ib in range(nrb):
            ri = slice(ROWS * ib, min(ROWS * (ib + 1), l))
            acc = y_off[:, ri]
            for jb in range(ib + 1):
                rj = slice(ROWS * jb, min(ROWS * (jb + 1), l))
                acc = acc + torch.einsum("bhij,bjhp->bihp", M[:, :, ri, rj], xdt[:, rj])
            y[:, c * l + ri.start:c * l + ri.stop] = acc
        S = torch.exp(a_last)[..., None, None] * S
        Bw = _r(Bc * w[..., None])
        for jb in range(nrb):
            rj = slice(ROWS * jb, min(ROWS * (jb + 1), l))
            S = S + torch.einsum("bjhp,bjhn->bhpn", _r(xc[:, rj]), Bw[:, rj])
    return y.to(bf16), S


def _rel(got, ref):
    got, ref = np.asarray(got, f32), np.asarray(ref, f32)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6))


def tc_case(seed, b=2, t=256, h=4, p=64, n=128, g=1, seeded=True):
    """bf16-exact x, B, C as slices of one conv-output-like array (as the
    mixer passes them), dt after softplus, A in -(1..16), a state."""
    rng = np.random.default_rng(seed)
    xbc = torch.from_numpy(rng.standard_normal((b, t, h * p + 2 * g * n)).astype(f32)).to(bf16)
    x = xbc[..., :h * p].reshape(b, t, h, p)
    B = xbc[..., h * p:h * p + g * n].reshape(b, t, g, n)
    C = xbc[..., h * p + g * n:].reshape(b, t, g, n)
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((b, t, h)) - 3.0)).astype(f32))
    A = torch.from_numpy(-np.exp(rng.random(h) * 2.77).astype(f32))
    s0 = torch.from_numpy((0.5 * rng.standard_normal((b, h, p, n))).astype(f32)) if seeded else None
    return x, dt, A, B, C, s0


CASES = [  # (t, chunk, g, n, seeded)
    (256, 256, 1, 128, True),    # one serving chunk: four row blocks
    (256, 64, 2, 128, False),    # four chunks of one row block, two groups
    (300, 128, 1, 128, True),    # l = 100: a ragged second row block
    (48, 256, 1, 64, False),     # t shorter than l
    (384, 128, 2, 64, True),
]


@pytest.mark.parametrize("t,chunk,g,n,seeded", CASES)
def test_tc_model_matches_jax_kernel_and_plain(t, chunk, g, n, seeded):
    """The model within ``MODEL_TOL`` of the JAX package's fused kernel
    (interpret mode, bf16 compute) and within the bf16 tolerance of the
    port's plain ``ssd_chunked``, output and final state."""
    x, dt, A, B, C, s0 = tc_case(t + chunk + g, t=t, g=g, n=n, seeded=seeded)
    j = lambda v: None if v is None else jnp.asarray(v.float().numpy())  # noqa: E731
    jy, js = ssd_chunked_pallas(
        j(x).astype(jnp.bfloat16), j(dt), j(A), j(B).astype(jnp.bfloat16),
        j(C).astype(jnp.bfloat16), chunk_size=chunk, initial_state=j(s0),
        return_final_state=True, compute_dtype=jnp.bfloat16, interpret=True)
    jy, js = np.asarray(jy.astype(jnp.float32)), np.asarray(js)
    py, ps = ssd_chunked(x, dt, A, B, C, chunk_size=chunk, initial_state=s0,
                         return_final_state=True, compute_dtype=bf16)
    my, ms = tc_forward_model(x, dt, A, B, C, chunk, s0)
    assert np.isfinite(my.float().numpy()).all()
    assert _rel(my.float(), jy) < MODEL_TOL
    assert _rel(ms, js) < MODEL_TOL
    assert _rel(my.float(), py.float()) < BF16_TOL
    assert _rel(ms, ps) < BF16_TOL


def test_wrapper_takes_the_plain_version_on_cpu():
    """A CPU tensor never reaches the kernel: the bf16 wrapper returns the
    plain version's bits and launches nothing."""
    x, dt, A, B, C, s0 = tc_case(3, t=128)
    before = dict(LAUNCHES)
    kw = dict(chunk_size=64, initial_state=s0, return_final_state=True, compute_dtype=bf16)
    yk, skk = sk.ssd_chunked_kernel(x, dt, A, B, C, **kw)
    yp, sp = ssd_chunked(x, dt, A, B, C, **kw)
    assert LAUNCHES == before
    assert torch.equal(yk, yp) and torch.equal(skk, sp)


# -------------------------------------------------------------- the rule


@pytest.mark.parametrize("p,n", sorted(sk.BUILT_SHAPES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dispatch_rule_at_every_built_shape(p, n, dtype):
    """bf16 at headdim 64 (d_state 64 or 128) runs the tensor-core kernel;
    headdim 32 and 128, and fp32 at any shape, the CUDA-core kernel."""
    tc = dtype == torch.bfloat16 and p == 64 and n in (64, 128)
    assert sk.ssd_uses_tensor_cores(dtype, p, n) is tc
    assert sk.TC_SHAPES <= sk.BUILT_SHAPES


@pytest.mark.parametrize("preset,tc", [("mamba2-280m", True), ("hybrid-280m", True),
                                       ("mamba2-tiny", False), ("hybrid-tiny", False)])
def test_dispatch_rule_at_the_presets(preset, tc):
    """The 280m presets' (64, 128) take the tensor cores in bf16; the tiny
    presets' headdim 32 the CUDA-core kernel."""
    cfg = get_preset(preset, compute_dtype="bfloat16")
    p, n = cfg.headdim, cfg.effective_d_state
    assert sk.ssd_uses_tensor_cores(cfg.torch_compute_dtype, p, n) is tc


# ------------------------------------------------------- the TMA layout


class _NoLaunch:
    """A stand-in library: every shape is built, and a launch fails the test."""

    def mdt_ssd_fwd_supports(self, p, n):
        return 1

    def __getattr__(self, name):
        raise AssertionError(f"{name} was called")


def _fwd(monkeypatch, x, B, C):
    """The forward wrapper on the kernel route (forced here on CPU tensors)
    with a stand-in library: a ValueError where its checks refuse the
    views, else an AssertionError at the launch."""
    monkeypatch.setattr(sk, "use_kernel", lambda impl, v: True)
    b, t, h, _ = x.shape
    dt = torch.full((b, t, h), 0.1)
    A = -torch.ones(h)
    before = dict(LAUNCHES)
    try:
        sk._ssd_fwd(x, dt, A, B, C, t, None, x.dtype, lib=_NoLaunch())
    finally:
        assert LAUNCHES == before


def _views(dtype=bf16, b=2, t=64, h=2, p=64, n=128, width_pad=0, skip=0):
    """x, B, C as slices of one (b, t, h p + 2 n + width_pad) tensor whose
    data starts ``skip`` elements past an allocation."""
    width = h * p + 2 * n + width_pad
    buf = torch.zeros(skip + b * t * width, dtype=dtype)[skip:].reshape(b, t, width)
    x = buf[..., :h * p].reshape(b, t, h, p)
    B = buf[..., h * p:h * p + n].reshape(b, t, 1, n)
    C = buf[..., h * p + n:h * p + 2 * n].reshape(b, t, 1, n)
    return x, B, C


def test_wrapper_takes_conv_output_slices_to_the_launch(monkeypatch):
    with pytest.raises(AssertionError, match="mdt_ssd_fwd was called"):
        _fwd(monkeypatch, *_views())


def test_wrapper_refuses_a_misaligned_x_and_names_it(monkeypatch):
    with pytest.raises(ValueError, match=r"ssd_fwd: x cannot be read by TMA: its data starts "
                                         r"at byte 2 past a 16-byte boundary"):
        _fwd(monkeypatch, *_views(skip=1))


def test_wrapper_refuses_a_time_stride_tma_cannot_step_and_names_it(monkeypatch):
    """B and C from their own odd-width tensor: a time stride of 257
    elements (514 bytes); x from a good one."""
    x, _, _ = _views()
    b, t = x.shape[:2]
    bc = torch.zeros((b, t, 2 * 128 + 1), dtype=bf16)
    B = bc[..., :128].reshape(b, t, 1, 128)
    C = bc[..., 128:256].reshape(b, t, 1, 128)
    with pytest.raises(ValueError, match=r"ssd_fwd: B cannot be read by TMA: its time stride "
                                         r"is 257 elements \(514 bytes\), not a positive "
                                         r"multiple of 16 bytes"):
        _fwd(monkeypatch, x, B, C)


def test_wrapper_refuses_a_misaligned_c_and_names_it(monkeypatch):
    x, B, _ = _views()
    b, t = x.shape[:2]
    C = torch.zeros(3 + b * t * 128, dtype=bf16)[3:].reshape(b, t, 1, 128)
    with pytest.raises(ValueError, match=r"ssd_fwd: C cannot be read by TMA: its data starts "
                                         r"at byte 6 past a 16-byte boundary"):
        _fwd(monkeypatch, x, B, C)


@pytest.mark.parametrize("dtype,p,n", [(torch.float32, 64, 128), (bf16, 32, 64)])
def test_cuda_core_shapes_take_any_view(monkeypatch, dtype, p, n):
    """fp32, and bf16 at headdim 32, run the CUDA-core kernel, which reads
    through strides without TMA: a misaligned view reaches the launch."""
    with pytest.raises(AssertionError, match="mdt_ssd_fwd was called"):
        _fwd(monkeypatch, *_views(dtype=dtype, p=p, n=n, skip=1))
