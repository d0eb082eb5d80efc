"""The tensor-core SSD chunk states (``ssd_states_tc_kernel``) and the
lane-split Mamba-1 forward scan (``m1_scan_kernel``) from the CPU: the
plain versions they are held to, their dispatch and launch-geometry
rules, the views the chunk states' TMA copies can read, and a plain model
of the scan's lane split.

The kernels run only on the card (``chip_smoke.py`` holds them against
the plain versions there).  Here:

* bf16 ``ssd_chunk_states_plain`` equals the JAX package's
  ``_chunk_states_kernel`` run in interpret mode through its own
  ``pallas_call`` over the JAX ``_chunked_inputs`` and ``_cell_specs``, as
  ``_ssd_pallas_bwd_impl`` launches it; both get the same a = cumsum(dt A)
  (the JAX one), so they differ only where the two libraries' exps differ
  by an ulp in w = dt e^(a_L - a) and round(B w) lands one bf16 ulp apart
  (2^-8 of one term of a sum of l terms), and in summation order:
  ``STATES_TOL`` = 1e-3 of max |S| (these seeds give 0 to 7.1e-7);
* the lane split (4 threads a channel, 4 states each, y the quad's sum
  (p0 + p2) + (p1 + p3) of the lanes' partials) equals ``m1_scan_plain``
  and the JAX ``selective_scan_pallas`` in interpret mode at fp32 1e-4:
  only the summation order of y differs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mamba_distributed_tpu.ops.pallas import ssd_kernels as jsk
from mamba_distributed_tpu.ops.pallas.scan_kernels import selective_scan_pallas
from mamba_distributed_tpu_torch.config import get_preset
from mamba_distributed_tpu_torch.ops.cuda import scan_kernels as mk
from mamba_distributed_tpu_torch.ops.cuda import ssd_kernels as sk
from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES

pytestmark = pytest.mark.torch

bf16 = torch.bfloat16
STATES_TOL = 1e-3  # bf16, as max |port - jax| / max |jax|; see the module docstring
SCAN_TOL = 1e-4  # fp32


# ------------------------------------------------------------ chunk states


def _jax_chunk_states(x, dt, A, B, l):
    """(states (b, nc, h, p, n), a_cum (b, t, h)) of the JAX
    ``_chunk_states_kernel`` in interpret mode, launched as
    ``_ssd_pallas_bwd_impl`` launches it (:456-465)."""
    cells, _, dims = jsk._chunked_inputs(x, dt, A, B, B, l)
    b, nc, l, h, p, g, n = dims
    xhp_spec, dt_spec, bc_spec, st_spec = jsk._cell_specs(h, l, p, n, g)
    states = pl.pallas_call(
        functools.partial(jsk._chunk_states_kernel, compute_dtype=jnp.bfloat16),
        out_shape=jax.ShapeDtypeStruct((b, nc, h, p, n), jnp.float32),
        grid=(b, nc, h),
        in_specs=[xhp_spec, dt_spec, bc_spec],
        out_specs=st_spec,
        interpret=True,
    )(cells["x"], cells["w"], cells["B"])
    a_cum = jnp.moveaxis(cells["a"][..., 0], 2, 3).reshape(b, nc * l, h)  # (b, nc, h, l) cells
    return np.asarray(states), np.array(a_cum)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("l", [64, 128, 256])
@pytest.mark.parametrize("p,n", [(64, 64), (64, 128)])
def test_bf16_chunk_states_plain_match_jax_kernel_in_interpret_mode(p, n, l, g):
    rng = np.random.default_rng(100 * l + 10 * n + g)
    b, h, t = 1, 2 * g, 2 * l
    f32 = np.float32
    x = rng.standard_normal((b, t, h, p)).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)) - 3.0)).astype(f32)
    A = (-np.exp(rng.uniform(0.0, 2.77, h))).astype(f32)
    B = rng.standard_normal((b, t, g, n)).astype(f32)
    xb, Bb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(B, jnp.bfloat16)
    want, a_cum = _jax_chunk_states(xb, jnp.asarray(dt), jnp.asarray(A), Bb, l)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(bf16)
    Bt = torch.from_numpy(np.array(Bb.astype(jnp.float32))).to(bf16)
    got = sk.ssd_chunk_states_plain(xt, torch.from_numpy(dt), torch.from_numpy(a_cum), Bt, l, bf16)
    assert got.shape == want.shape == (b, t // l, h, p, n)
    rel = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
    assert rel <= STATES_TOL, rel


@pytest.mark.parametrize("l", [50, 64, 100, 128, 192, 256])
@pytest.mark.parametrize("p,n", sorted(sk.BUILT_SHAPES))
@pytest.mark.parametrize("dtype", [bf16, torch.float32])
def test_chunk_states_take_the_backwards_route_at_every_built_shape(monkeypatch, p, n, dtype, l):
    """The chunk states follow the backward's one rule: where it says tensor
    cores the wrapper holds x and B to TMA's rules (a misaligned x is
    refused), elsewhere any view reaches the launch."""
    tc = dtype == bf16 and p == 64 and n in (64, 128) and l % 64 == 0
    assert sk.ssd_bwd_uses_tensor_cores(dtype, p, n, l) is tc
    views = _views(dtype=dtype, t=2 * l, p=p, n=n, skip=1)
    if tc:
        with pytest.raises(ValueError, match="ssd_chunk_states: x cannot be read by TMA"):
            _states(monkeypatch, *views, l=l)
    else:
        with pytest.raises(AssertionError, match="mdt_ssd_chunk_states was called"):
            _states(monkeypatch, *views, l=l)


@pytest.mark.parametrize("preset,tc", [("mamba2-280m", True), ("hybrid-280m", True),
                                       ("mamba2-tiny", False), ("hybrid-tiny", False)])
def test_chunk_states_route_at_the_presets(preset, tc):
    """mamba2-280m and hybrid-280m (headdim 64, d_state 128, chunk 256)
    take the tensor-core chunk states in bf16 and not in fp32; the tiny
    presets' headdim 32 never does."""
    cfg = get_preset(preset, compute_dtype="bfloat16")
    p, n, l = cfg.headdim, cfg.effective_d_state, cfg.chunk_size
    assert sk.ssd_bwd_uses_tensor_cores(cfg.torch_compute_dtype, p, n, l) is tc
    assert not sk.ssd_bwd_uses_tensor_cores(torch.float32, p, n, l)


class _NoLaunch:
    """A stand-in library: every shape is built, and a launch fails the test."""

    def mdt_ssd_bwd_supports(self, p, n):
        return 1

    def __getattr__(self, name):
        raise AssertionError(f"{name} was called")


def _states(monkeypatch, x, B, l=64):
    """The chunk-states wrapper on the kernel route (forced here on CPU
    tensors) with a stand-in library: a ValueError where its checks refuse
    the views, else an AssertionError at the launch."""
    monkeypatch.setattr(sk, "use_kernel", lambda impl, v: True)
    b, t, h, _ = x.shape
    dt = torch.full((b, t, h), 0.1)
    a_cum = torch.zeros((b, t, h))
    before = dict(LAUNCHES)
    try:
        sk.ssd_chunk_states_kernel(x, dt, a_cum, B, l, x.dtype, lib=_NoLaunch())
    finally:
        assert LAUNCHES == before


def _views(dtype=bf16, b=2, t=768, h=2, p=64, n=128, skip=0, b_skip=0):
    """x and B as slices of one conv-output-like (b, t, h p + 2 n) tensor
    whose data starts ``skip`` elements past an allocation; B moved
    ``b_skip`` elements along its row (so only B is misaligned)."""
    width = h * p + 2 * n
    buf = torch.zeros(skip + b * t * width, dtype=dtype)[skip:].reshape(b, t, width)
    x = buf[..., :h * p].reshape(b, t, h, p)
    B = buf[..., h * p + b_skip:h * p + b_skip + n].reshape(b, t, 1, n)
    return x, B


def test_chunk_states_take_conv_output_slices_to_the_launch(monkeypatch):
    with pytest.raises(AssertionError, match="mdt_ssd_chunk_states was called"):
        _states(monkeypatch, *_views(), l=256)


def test_chunk_states_refuse_a_misaligned_x_and_name_it(monkeypatch):
    with pytest.raises(ValueError, match=r"ssd_chunk_states: x cannot be read by TMA: its data "
                                         r"starts at byte 2 past a 16-byte boundary"):
        _states(monkeypatch, *_views(skip=1))


def test_chunk_states_refuse_a_misaligned_B_and_name_it(monkeypatch):
    with pytest.raises(ValueError, match=r"ssd_chunk_states: B cannot be read by TMA: its data "
                                         r"starts at byte 6 past a 16-byte boundary"):
        _states(monkeypatch, *_views(b_skip=3))


# --------------------------------------------------- the Mamba-1 forward scan


@pytest.mark.parametrize("b,d,ctas", [(1, 1536, 96), (32, 1536, 3072), (1, 70, 5), (2, 70, 10),
                                      (1, 1000, 63), (32, 1000, 2016)])
def test_m1_scan_geometry(b, d, ctas):
    """16 channels a CTA, 4 threads a channel: the serving chunk of
    mamba1-280m (b 1, d 1536) runs 96 CTAs, twice the 48 one-warp CTAs of
    one thread a channel; a ragged d rounds up."""
    assert (mk.SCAN_CH, mk.SCAN_Q, mk.N_STATE % mk.SCAN_Q) == (16, 4, 0)
    assert mk.m1_scan_ctas(b, d) == ctas
    assert mk.m1_scan_ctas(b, d) >= b * -(-d // 32)


def _lane_split_scan(u, dt, A, B, C, h0):
    """The arithmetic of ``m1_scan_kernel`` in plain torch: e = 2^((A log2
    e) dt), SCAN_Q lanes of N_STATE / SCAN_Q states a channel, each lane's
    partial of <C_i, h_i> summed over its states in order, y the quad's
    reduce-scatter (an xor-2, then an xor-1 shuffle round):
    (p0 + p2) + (p1 + p3)."""
    b, t, d = u.shape
    n = A.shape[-1]
    h = h0.clone()
    a2 = A * 1.4426950408889634
    ys = []
    for i in range(t):
        e = torch.exp2(a2 * dt[:, i, :, None])
        h = h * e + (dt[:, i] * u[:, i])[..., None] * B[:, i, None, :]
        part = (h * C[:, i, None, :]).reshape(b, d, mk.SCAN_Q, n // mk.SCAN_Q)
        acc = part[..., 0]
        for s in range(1, n // mk.SCAN_Q):
            acc = acc + part[..., s]
        ys.append((acc[..., 0] + acc[..., 2]) + (acc[..., 1] + acc[..., 3]))
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("t,d", [(37, 70), (256, 100)])
def test_lane_split_model_matches_plain_and_jax_kernel(t, d):
    rng = np.random.default_rng(t + d)
    b, n, f32 = 2, mk.N_STATE, np.float32
    inp = dict(u=rng.standard_normal((b, t, d)).astype(f32),
               dt=np.log1p(np.exp(rng.standard_normal((b, t, d)) - 3.0)).astype(f32),
               A=(-np.exp(rng.uniform(0.0, 2.77, (d, n)))).astype(f32),
               B=rng.standard_normal((b, t, n)).astype(f32),
               C=rng.standard_normal((b, t, n)).astype(f32),
               h0=(0.5 * rng.standard_normal((b, d, n))).astype(f32))
    a = {k: torch.from_numpy(v) for k, v in inp.items()}
    core = (a["u"], a["dt"], a["A"], a["B"], a["C"])
    y, hT = _lane_split_scan(*core, a["h0"])
    before = dict(LAUNCHES)
    yp, hp = mk.m1_scan(*core, a["h0"])  # a CPU tensor takes the plain version
    assert LAUNCHES == before
    yj, hj = selective_scan_pallas(*(jnp.asarray(inp[k]) for k in ("u", "dt", "A", "B", "C")),
                                   initial_state=jnp.asarray(inp["h0"]),
                                   return_final_state=True, interpret=True)
    for got, ref in ((y, yp), (hT, hp), (y, np.asarray(yj)), (hT, np.asarray(hj))):
        ref = ref.numpy() if isinstance(ref, torch.Tensor) else ref
        rel = float(np.abs(got.numpy() - ref).max() / np.abs(ref).max())
        assert rel <= SCAN_TOL, rel
