"""The tensor-core SSD backward (``ssd_bwd_ds_tc_kernel`` and
``ssd_bwd_tc_kernel``) from the CPU: the plain version of its first
kernel, its dispatch rule, the views its TMA copies can read, and the
glue that adds each chunk's last-row total.

The kernels run only on the card (``chip_smoke.py`` holds them against
``ssd_bwd_plain`` there).  The state cotangent walked by the first kernel
(``ssd_state_cotangents_plain``) is held to the JAX package's Pallas
custom VJP in interpret mode: the cotangent of the state leaving chunk c
is the gradient, with respect to the initial state, of the same loss on
the sequence that starts at chunk c + 1, and the gradient of the initial
state of the whole sequence is dinit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_distributed_tpu.ops.pallas import ssd_chunked_pallas
from mamba_distributed_tpu_torch.config import get_preset
from mamba_distributed_tpu_torch.ops.cuda import ssd_kernels as sk
from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
from mamba_distributed_tpu_torch.ops.ssd import chunk_log_decay, state_passing

pytestmark = pytest.mark.torch

TOL = 1e-4  # fp32, as max |port - jax| / max |jax|
bf16 = torch.bfloat16


def _inputs(seed, t, g, b=2, h=4, p=8, n=16):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        x=rng.standard_normal((b, t, h, p)).astype(f32),
        dt=np.log1p(np.exp(rng.standard_normal((b, t, h)))).astype(f32),
        A=(-np.exp(0.5 * rng.standard_normal(h))).astype(f32),
        B=rng.standard_normal((b, t, g, n)).astype(f32),
        C=rng.standard_normal((b, t, g, n)).astype(f32),
        s0=rng.standard_normal((b, h, p, n)).astype(f32),
        gy=rng.standard_normal((b, t, h, p)).astype(f32),
        gs=rng.standard_normal((b, h, p, n)).astype(f32),
    )


def _jax_dinit(inp, start, chunk):
    """d/d(initial state) of <y, gy> + <final, gs> through the Pallas
    custom VJP (interpret mode) on the sequence from time ``start``."""
    a = {k: jnp.asarray(v[:, start:]) if k in ("x", "dt", "B", "C", "gy") else jnp.asarray(v)
         for k, v in inp.items()}

    def loss(s0):
        y, fin = ssd_chunked_pallas(a["x"], a["dt"], a["A"], a["B"], a["C"], chunk_size=chunk,
                                    initial_state=s0, return_final_state=True,
                                    compute_dtype=jnp.float32, interpret=True)
        return jnp.sum(y * a["gy"]) + jnp.sum(fin * a["gs"])

    return np.asarray(jax.grad(loss)(a["s0"]))


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(got.numpy() - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("g,seeded", [(1, False), (2, True)])
def test_state_cotangents_plain_match_jax_pallas_vjp(g, seeded):
    """dS_c for every chunk and dinit against the JAX VJP at 1e-4; dS of
    the last chunk is the final-state cotangent itself; dgamma_c is
    <dS_c, P_c> of the entering states."""
    chunk, t = 8, 24
    inp = _inputs(31 + g, t=t, g=g)
    a = {k: torch.from_numpy(v) for k, v in inp.items()}
    b, _, h, _ = a["x"].shape
    a4 = chunk_log_decay(a["dt"], a["A"], chunk)
    a_cum = a4.reshape(b, t, h)
    states = sk.ssd_chunk_states_plain(a["x"], a["dt"], a_cum, a["B"], chunk, torch.float32)
    prev, _ = state_passing(states, torch.exp(a4[:, :, -1]), a["s0"] if seeded else None)
    dS, dgamma, dinit = sk.ssd_state_cotangents_plain(a["gy"], a_cum, a["C"], prev, a["gs"],
                                                      chunk, torch.float32)
    nc = t // chunk
    assert dS.shape == prev.shape and dgamma.shape == (b, nc, h)
    assert torch.equal(dS[:, -1], a["gs"])
    for c in range(nc - 1):
        assert _rel(dS[:, c], _jax_dinit(inp, (c + 1) * chunk, chunk)) <= TOL, c
    assert _rel(dinit, _jax_dinit(inp, 0, chunk)) <= TOL
    torch.testing.assert_close(dgamma, (dS * prev).sum((-2, -1)), atol=0, rtol=0)


def test_plain_bwd_takes_its_state_cotangents_from_the_walk():
    """ssd_bwd_plain's dgamma and dinit are those of the walk, bit for bit."""
    chunk, t = 8, 16
    a = {k: torch.from_numpy(v) for k, v in _inputs(5, t=t, g=2).items()}
    b, _, h, _ = a["x"].shape
    a_cum = chunk_log_decay(a["dt"], a["A"], chunk).reshape(b, t, h)
    prev = torch.randn((b, t // chunk, h, 8, 16), generator=torch.Generator().manual_seed(0))
    got = sk.ssd_bwd_plain(a["x"], a["dt"], a_cum, a["B"], a["C"], prev, a["gy"], a["gs"],
                           chunk, torch.float32)
    _, dgamma, dinit = sk.ssd_state_cotangents_plain(a["gy"], a_cum, a["C"], prev, a["gs"],
                                                     chunk, torch.float32)
    assert torch.equal(got[5], dgamma) and torch.equal(got[6], dinit)


# -------------------------------------------------------------- the rule


@pytest.mark.parametrize("l", [50, 64, 100, 128, 192, 256])
@pytest.mark.parametrize("p,n", sorted(sk.BUILT_SHAPES))
@pytest.mark.parametrize("dtype", [bf16, torch.float32])
def test_bwd_dispatch_rule_at_every_built_shape(p, n, dtype, l):
    """bf16 at headdim 64 (d_state 64 or 128) with a chunk that is a
    multiple of 64 runs the tensor-core kernels; other shapes, fp32 and
    ragged chunks the CUDA-core kernel."""
    tc = dtype == bf16 and p == 64 and n in (64, 128) and l % 64 == 0
    assert sk.ssd_bwd_uses_tensor_cores(dtype, p, n, l) is tc


@pytest.mark.parametrize("preset,tc", [("mamba2-280m", True), ("hybrid-280m", True),
                                       ("mamba2-tiny", False), ("hybrid-tiny", False)])
def test_bwd_dispatch_rule_at_the_presets(preset, tc):
    """The 280m presets' (64, 128) at their chunk of 256 take the tensor
    cores in bf16; the tiny presets' headdim 32 the CUDA-core kernel."""
    cfg = get_preset(preset, compute_dtype="bfloat16")
    p, n = cfg.headdim, cfg.effective_d_state
    assert sk.ssd_bwd_uses_tensor_cores(cfg.torch_compute_dtype, p, n, cfg.chunk_size) is tc


# ------------------------------------------------------- the TMA layout


class _NoLaunch:
    """A stand-in library: every shape is built, and a launch fails the test."""

    def mdt_ssd_bwd_supports(self, p, n):
        return 1

    def __getattr__(self, name):
        raise AssertionError(f"{name} was called")


def _bwd(monkeypatch, x, B, C, dy, l=64):
    """The backward wrapper on the kernel route (forced here on CPU tensors)
    with a stand-in library: a ValueError where its checks refuse the
    views, else an AssertionError at the launch."""
    monkeypatch.setattr(sk, "use_kernel", lambda impl, v: True)
    b, t, h, p = x.shape
    n = B.shape[-1]
    dt = torch.full((b, t, h), 0.1)
    a_cum = torch.zeros((b, t, h))
    prev = torch.zeros((b, t // l, h, p, n))
    before = dict(LAUNCHES)
    try:
        sk.ssd_bwd_kernel(x, dt, a_cum, B, C, prev, dy, None, l, x.dtype, lib=_NoLaunch())
    finally:
        assert LAUNCHES == before


def _views(dtype=bf16, b=2, t=128, h=2, p=64, n=128, skip=0):
    """x, B, C as slices of one (b, t, h p + 2 n) tensor whose data starts
    ``skip`` elements past an allocation, and a fresh dy."""
    width = h * p + 2 * n
    buf = torch.zeros(skip + b * t * width, dtype=dtype)[skip:].reshape(b, t, width)
    x = buf[..., :h * p].reshape(b, t, h, p)
    B = buf[..., h * p:h * p + n].reshape(b, t, 1, n)
    C = buf[..., h * p + n:].reshape(b, t, 1, n)
    return x, B, C, torch.zeros((b, t, h, p), dtype=dtype)


def test_bwd_wrapper_takes_conv_output_slices_to_the_launch(monkeypatch):
    with pytest.raises(AssertionError, match="mdt_ssd_bwd was called"):
        _bwd(monkeypatch, *_views())


def test_bwd_wrapper_refuses_a_misaligned_x_and_names_it(monkeypatch):
    with pytest.raises(ValueError, match=r"ssd_bwd: x cannot be read by TMA: its data starts "
                                         r"at byte 2 past a 16-byte boundary"):
        _bwd(monkeypatch, *_views(skip=1))


def test_bwd_wrapper_refuses_a_misaligned_dy_and_names_it(monkeypatch):
    x, B, C, dy = _views()
    dy = torch.zeros(dy.numel() + 4, dtype=bf16)[4:].reshape(dy.shape)
    with pytest.raises(ValueError, match=r"ssd_bwd: dy cannot be read by TMA: its data starts "
                                         r"at byte 8 past a 16-byte boundary"):
        _bwd(monkeypatch, x, B, C, dy)


@pytest.mark.parametrize("dtype,p,n,l", [(torch.float32, 64, 128, 64), (bf16, 32, 64, 64),
                                         (bf16, 64, 128, 32)])
def test_bwd_cuda_core_shapes_take_any_view(monkeypatch, dtype, p, n, l):
    """fp32, bf16 at headdim 32 and a chunk that is no multiple of 64 run
    the CUDA-core kernel, which reads through strides without TMA: a
    misaligned view reaches the launch."""
    with pytest.raises(AssertionError, match="mdt_ssd_bwd was called"):
        _bwd(monkeypatch, *_views(dtype=dtype, p=p, n=n, skip=1), l=l)


# ------------------------------------------------------ the last-row total


def test_row_block_tails_land_on_each_chunks_last_row():
    """Each chunk's row-block partials are summed onto its last row's da;
    every other row keeps its value."""
    gen = torch.Generator().manual_seed(3)
    b, t, h, l = 2, 512, 3, 256
    da = torch.randn((b, t, h), generator=gen)
    tails = torch.randn((b, t // l, h, l // 64), generator=gen)
    want = da.clone()
    for c in range(t // l):
        want[:, c * l + l - 1] += tails[:, c].sum(-1)
    got = da.clone()
    sk.add_row_block_tails(got, tails, l)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
