"""The port's SSD against the JAX package's, on the CPU.

The plain PyTorch ``ssd_chunked`` is held to the JAX Pallas SSD kernel
run in interpret mode (how tests/test_pallas.py runs it on the CPU) at
the JAX suite's own tolerance, and ``ssd_state_update`` to its JAX
counterpart.  Inputs are made from a seed with numpy and handed to
both.  The hand-written CUDA kernel itself runs only on a card; here
its wrapper must take the plain version and launch nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_distributed_tpu.ops.pallas import ssd_chunked_pallas
from mamba_distributed_tpu.ops.ssd import ssd_state_update as jax_state_update
from mamba_distributed_tpu_torch.ops.cuda import ssd_kernels
from mamba_distributed_tpu_torch.ops.ssd import ssd_chunked, ssd_state_update

pytestmark = pytest.mark.torch

TOL = dict(atol=1e-4, rtol=1e-4)  # tests/test_pallas.py's kernel tolerance


def ssd_inputs(seed, b=2, t=64, h=4, p=16, n=16, g=1):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        x=rng.standard_normal((b, t, h, p)).astype(f32),
        dt=np.log1p(np.exp(rng.standard_normal((b, t, h)))).astype(f32),
        A=(-np.exp(0.5 * rng.standard_normal(h))).astype(f32),
        B=rng.standard_normal((b, t, g, n)).astype(f32),
        C=rng.standard_normal((b, t, g, n)).astype(f32),
        D=rng.standard_normal(h).astype(f32),
        s0=rng.standard_normal((b, h, p, n)).astype(f32),
    )


def _jax(inp, chunk, seeded):
    a = {k: jnp.asarray(v) for k, v in inp.items()}
    return ssd_chunked_pallas(
        a["x"], a["dt"], a["A"], a["B"], a["C"], chunk_size=chunk, D=a["D"],
        initial_state=a["s0"] if seeded else None, return_final_state=True,
        compute_dtype=jnp.float32, interpret=True,
    )


def _torch(fn, inp, chunk, seeded):
    a = {k: torch.from_numpy(v) for k, v in inp.items()}
    return fn(a["x"], a["dt"], a["A"], a["B"], a["C"], chunk_size=chunk, D=a["D"],
              initial_state=a["s0"] if seeded else None, return_final_state=True,
              compute_dtype=torch.float32)


@pytest.mark.parametrize(
    "g,chunk,seeded",
    [(1, 16, False), (2, 16, True), (1, 8, True), (2, 32, False), (2, 64, True)],
)
def test_plain_ssd_matches_jax_pallas(g, chunk, seeded):
    """y and the final state agree at 1e-4 over groups, several chunk
    lengths (8 is the shortest pow2 prefill chunk) and a seeded state."""
    inp = ssd_inputs(seed=chunk + g, g=g)
    yj, sj = _jax(inp, chunk, seeded)
    yt, st = _torch(ssd_chunked, inp, chunk, seeded)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **TOL)


def test_ssd_chunk_split_threads_state():
    """Two halves with the carried state == one pass (the chunked-prefill
    contract the serving engine rides on)."""
    a = {k: torch.from_numpy(v) for k, v in ssd_inputs(seed=3, t=64).items()}
    kw = dict(chunk_size=16, return_final_state=True, compute_dtype=torch.float32)
    y, s = ssd_chunked(a["x"], a["dt"], a["A"], a["B"], a["C"], **kw)
    y1, s1 = ssd_chunked(a["x"][:, :32], a["dt"][:, :32], a["A"], a["B"][:, :32],
                         a["C"][:, :32], **kw)
    y2, s2 = ssd_chunked(a["x"][:, 32:], a["dt"][:, 32:], a["A"], a["B"][:, 32:],
                         a["C"][:, 32:], initial_state=s1, **kw)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, **TOL)
    torch.testing.assert_close(s2, s, **TOL)


@pytest.mark.parametrize("g,d_hdim", [(1, False), (2, True)])
def test_ssd_state_update_matches_jax(g, d_hdim):
    rng = np.random.default_rng(7 + g)
    b, h, p, n = 3, 4, 8, 16
    f32 = np.float32
    s = rng.standard_normal((b, h, p, n)).astype(f32)
    x = rng.standard_normal((b, h, p)).astype(f32)
    dt = rng.standard_normal((b, h)).astype(f32)
    A = (-np.exp(rng.standard_normal(h))).astype(f32)
    B = rng.standard_normal((b, g, n)).astype(f32)
    C = rng.standard_normal((b, g, n)).astype(f32)
    D = rng.standard_normal((h, p) if d_hdim else (h,)).astype(f32)
    bias = rng.standard_normal(h).astype(f32)
    yj, sj = jax_state_update(*map(jnp.asarray, (s, x, dt, A, B, C, D)),
                              dt_bias=jnp.asarray(bias), dt_softplus=True)
    T = torch.from_numpy
    yt, st = ssd_state_update(T(s), T(x), T(dt), T(A), T(B), T(C), T(D),
                              dt_bias=T(bias), dt_softplus=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5, rtol=1e-5)
    # the in-place form the decode step uses gives the same numbers
    s_inplace = T(s.copy())
    yi, si = ssd_state_update(s_inplace, T(x), T(dt), T(A), T(B), T(C), T(D),
                              dt_bias=T(bias), out=s_inplace)
    assert si.data_ptr() == s_inplace.data_ptr()
    torch.testing.assert_close(si, st, atol=0, rtol=0)
    torch.testing.assert_close(yi, yt, atol=0, rtol=0)


def test_kernel_wrapper_takes_plain_version_on_cpu():
    """A CPU tensor never reaches the CUDA kernel: the wrapper returns the
    plain version's result bit for bit and its launch count stays 0."""
    a = {k: torch.from_numpy(v) for k, v in ssd_inputs(seed=11, g=2).items()}
    before = dict(ssd_kernels.LAUNCHES)
    kw = dict(chunk_size=16, D=a["D"], initial_state=a["s0"],
              return_final_state=True, compute_dtype=torch.float32)
    yk, sk = ssd_kernels.ssd_chunked_kernel(a["x"], a["dt"], a["A"], a["B"], a["C"], **kw)
    yp, sp = ssd_chunked(a["x"], a["dt"], a["A"], a["B"], a["C"], **kw)
    torch.testing.assert_close(yk, yp, atol=0, rtol=0)
    torch.testing.assert_close(sk, sp, atol=0, rtol=0)
    assert ssd_kernels.LAUNCHES == before
