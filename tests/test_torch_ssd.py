"""The port's SSD against the JAX package's, on the CPU.

The plain PyTorch ``ssd_chunked`` is held to the JAX Pallas SSD kernel
run in interpret mode (how tests/test_pallas.py runs it on the CPU) at
the JAX suite's own tolerance, and ``ssd_state_update`` to its JAX
counterpart.  Inputs are made from a seed with numpy and handed to
both.  The hand-written CUDA kernel itself runs only on a card; here
its wrapper must take the plain version and launch nothing.

The backward: ``SSDFunction`` (kernels 1-3 on a card, their plain
versions here) gives the gradients of the JAX package's Pallas custom
VJP (interpret mode, one seeded case with a final-state cotangent) and
of ``jax.grad`` through the XLA ``ssd_chunked`` (the other cases); the
plain kernel bodies are held to ``chunk_local`` and to torch autograd of
the plain forward; the Mamba-2 mixer's gradients under
``ssm_impl="pallas"`` equal those under ``"xla"``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_distributed_tpu.ops.pallas import ssd_chunked_pallas
from mamba_distributed_tpu.ops.ssd import ssd_chunked as jax_ssd_chunked
from mamba_distributed_tpu.ops.ssd import ssd_state_update as jax_state_update
from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.models.lm import init_lm_params
from mamba_distributed_tpu_torch.models.mamba2 import mamba2_mixer
from mamba_distributed_tpu_torch.ops.cuda import ssd_kernels
from mamba_distributed_tpu_torch.ops.ssd import (
    chunk_local,
    chunk_log_decay,
    ssd_chunked,
    ssd_state_update,
)

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


# ------------------------------------------------------------------ backward

GRAD_KEYS = ("x", "dt", "A", "B", "C", "s0")


def _rel(got, ref):
    """max|port - jax| / max|jax|, the stated gradient tolerance's measure."""
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def _jax_grads(inp, chunk, seeded, with_dfinal, pallas):
    """jax.grad of <y, gy> (+ <final, gs>) w.r.t. x, dt, A, B, C (, s0)."""
    a = {k: jnp.asarray(v) for k, v in inp.items()}

    def loss(x, dt, A, B, C, s0):
        kw = dict(chunk_size=chunk, initial_state=s0 if seeded else None,
                  return_final_state=True, compute_dtype=jnp.float32)
        if pallas:
            y, fin = ssd_chunked_pallas(x, dt, A, B, C, interpret=True, **kw)
        else:
            y, fin = jax_ssd_chunked(x, dt, A, B, C, **kw)
        out = jnp.sum(y * a["gy"])
        return out + jnp.sum(fin * a["gs"]) if with_dfinal else out

    g = jax.grad(loss, argnums=tuple(range(6)))(*(a[k] for k in GRAD_KEYS))
    return dict(zip(GRAD_KEYS, g))


def _port_grads(fn, inp, chunk, seeded, with_dfinal):
    t = {k: torch.from_numpy(v).requires_grad_(k in GRAD_KEYS) for k, v in inp.items()}
    y, fin = fn(t["x"], t["dt"], t["A"], t["B"], t["C"], chunk_size=chunk,
                initial_state=t["s0"] if seeded else None, return_final_state=True,
                compute_dtype=torch.float32)
    assert y.grad_fn is not None and fin.grad_fn is not None
    loss = (y * t["gy"]).sum()
    if with_dfinal:
        loss = loss + (fin * t["gs"]).sum()
    loss.backward()
    return {k: t[k].grad for k in GRAD_KEYS if t[k].grad is not None}


def grad_inputs(seed, t, g, b=2, h=4, p=8, n=16):
    inp = ssd_inputs(seed, b=b, t=t, h=h, p=p, n=n, g=g)
    del inp["D"]
    rng = np.random.default_rng(seed + 100)
    inp["gy"] = rng.standard_normal((b, t, h, p)).astype(np.float32)
    inp["gs"] = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return inp


def test_function_grads_match_jax_pallas_vjp():
    """The Function's six gradients against jax.grad through the JAX
    package's Pallas custom VJP (interpret mode), seeded and with a
    final-state cotangent, at 1e-4 of the largest JAX gradient."""
    inp = grad_inputs(21, t=32, g=2)
    ref = _jax_grads(inp, 8, seeded=True, with_dfinal=True, pallas=True)
    before = dict(ssd_kernels.LAUNCHES)
    got = _port_grads(ssd_kernels.ssd_chunked_kernel, inp, 8, True, True)
    assert ssd_kernels.LAUNCHES == before  # CPU tensors: plain versions, no launch
    assert set(got) == set(GRAD_KEYS)
    for k in GRAD_KEYS:
        assert _rel(got[k], ref[k]) <= 1e-4, k


@pytest.mark.parametrize("t,g,seeded,with_dfinal", [
    (32, 1, False, False),   # g = 1, unseeded, y cotangent only
    (30, 2, True, True),     # t = 30 is no multiple of chunk 8 (l = 6)
    (64, 2, False, True),    # 4 chunks of 16, final-state cotangent only on top
])
def test_function_grads_match_jax_xla(t, g, seeded, with_dfinal):
    inp = grad_inputs(t + g, t=t, g=g)
    chunk = 16 if t == 64 else 8
    ref = _jax_grads(inp, chunk, seeded, with_dfinal, pallas=False)
    got = _port_grads(ssd_kernels.ssd_chunked_kernel, inp, chunk, seeded, with_dfinal)
    for k in got:
        assert _rel(got[k], ref[k]) <= 1e-4, k
    assert ("s0" in got) == seeded


def test_chunk_states_plain_matches_chunk_local():
    """Kernel 2's plain body == the states of the plain forward (fp32)."""
    a = {k: torch.from_numpy(v) for k, v in ssd_inputs(seed=5, g=2).items()}
    l = 16
    b, t, h, _ = a["x"].shape
    a_cum = chunk_log_decay(a["dt"], a["A"], l).reshape(b, t, h)
    got = ssd_kernels.ssd_chunk_states_kernel(a["x"], a["dt"], a_cum, a["B"], l,
                                              torch.float32)
    _, ref, _, _ = chunk_local(a["x"], a["dt"], a["A"], a["B"], a["C"], l,
                               torch.float32)
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.parametrize("seeded", [False, True])
def test_plain_bwd_and_epilogue_match_autograd(seeded):
    """Kernel 2 + state_passing + kernel 3 (plain bodies) + the epilogue
    == torch autograd of the plain ``ssd_chunked``, with a final-state
    cotangent."""
    inp = grad_inputs(9, t=48, g=2)
    got = _port_grads(ssd_kernels.ssd_chunked_kernel, inp, 16, seeded, True)
    ref = _port_grads(ssd_chunked, inp, 16, seeded, True)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], **TOL)


def test_kernel_output_has_grad_fn_and_d_outside():
    """Every call goes through the Function (a grad_fn whenever an input
    requires grad); D is added outside it."""
    a = {k: torch.from_numpy(v) for k, v in ssd_inputs(seed=4).items()}
    x = a["x"].clone().requires_grad_()
    D = a["D"].clone().requires_grad_()
    y = ssd_kernels.ssd_chunked_kernel(x, a["dt"], a["A"], a["B"], a["C"], chunk_size=16,
                                       D=D, compute_dtype=torch.float32)
    assert y.grad_fn is not None
    y.sum().backward()
    torch.testing.assert_close(D.grad, x.detach().sum((0, 1, 3)), **TOL)
    with torch.no_grad():
        assert ssd_kernels.ssd_chunked_kernel(
            a["x"], a["dt"], a["A"], a["B"], a["C"], chunk_size=16,
            compute_dtype=torch.float32).grad_fn is None


def test_mixer_grads_pallas_equal_xla():
    """mamba2_mixer with ssm_impl="pallas" (the Function) gives the
    gradients of "xla" (plain autograd) for its input and every param:
    in_proj carries the x, B, C and dt paths, plus dt_bias, A_log, D."""
    cfg = ModelConfig(d_model=32, n_layer=1, vocab_size=64, headdim=8, chunk_size=16,
                      d_state=16, ngroups=2, compute_dtype="float32")
    base = init_lm_params(cfg, torch.Generator().manual_seed(3))["blocks"]["mixer"]
    u0 = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 32, 32))
                          .astype(np.float32))
    grads = []
    for impl in ("pallas", "xla"):
        c = ModelConfig(**{**cfg.__dict__, "ssm_impl": impl})
        params = {k: (v[0].clone().requires_grad_() if not isinstance(v, dict) else
                      {kk: vv[0].clone().requires_grad_() for kk, vv in v.items()})
                  for k, v in base.items()}
        u = u0.clone().requires_grad_()
        (mamba2_mixer(params, c, u) ** 2).sum().backward()
        flat = {"u": u.grad}
        for k, v in params.items():
            for kk, vv in (v.items() if isinstance(v, dict) else [("", v)]):
                flat[f"{k}.{kk}"] = vv.grad
        grads.append(flat)
    assert set(grads[0]) == set(grads[1])
    for k in grads[1]:
        torch.testing.assert_close(grads[0][k], grads[1][k], **TOL, msg=k)
