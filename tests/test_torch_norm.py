"""The port's RMSNorm family against the JAX package's, on the CPU.

* The plain versions (ops/cuda/norm_kernels.py) equal
  ``mamba_distributed_tpu/ops/norm.py`` at 1e-6 on the same numpy inputs:
  ``rms_norm``, ``add_rms_norm`` (with and without a residual, fp32 and
  bf16 residual streams) and ``rms_norm_gated`` (whole rows and grouped).
* ``ops/norm.py`` takes the plain route on the CPU and, on any device,
  under autograd (``ops/dispatch.use_norm_kernel``): no kernel launch is
  counted, and gradients flow.
* The kernel wrappers refuse a CPU tensor (the plain route is the
  caller's), and the source is registered with the build.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_distributed_tpu.ops import norm as jnorm
from mamba_distributed_tpu_torch.ops import norm
from mamba_distributed_tpu_torch.ops.cuda import build
from mamba_distributed_tpu_torch.ops.cuda import norm_kernels as nk
from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
from mamba_distributed_tpu_torch.ops.dispatch import use_norm_kernel

pytestmark = pytest.mark.torch

TOL = 1e-6


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(ours: torch.Tensor, ref) -> None:
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", [(5, 32), (2, 3, 48)])
def test_rms_norm_equals_jax(shape):
    x, w = _inputs(0, shape, shape[-1:])
    _close(norm.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("with_residual", [True, False])
@pytest.mark.parametrize("residual_dtype", ["float32", "bfloat16"])
def test_add_rms_norm_equals_jax(with_residual, residual_dtype):
    x, r, w = _inputs(1, (4, 3, 32), (4, 3, 32), (32,))
    tdt, jdt = getattr(torch, residual_dtype), getattr(jnp, residual_dtype)
    res_t = torch.from_numpy(r) if with_residual else None
    res_j = jnp.asarray(r) if with_residual else None
    out, s = norm.add_rms_norm(torch.from_numpy(x), res_t, torch.from_numpy(w), 1e-5,
                               residual_dtype=tdt)
    jout, js = jnorm.add_rms_norm(jnp.asarray(x), res_j, jnp.asarray(w), 1e-5,
                                  residual_dtype=jdt)
    assert s.dtype == tdt and out.dtype == torch.float32
    _close(out, jout)
    _close(s, js.astype(jnp.float32))


@pytest.mark.parametrize("group_size", [None, 64, 16])
def test_rms_norm_gated_equals_jax(group_size):
    x, z, w = _inputs(2, (3, 5, 64), (3, 5, 64), (64,))
    ours = norm.rms_norm_gated(torch.from_numpy(x), torch.from_numpy(z), torch.from_numpy(w),
                               1e-5, group_size=group_size)
    ref = jnorm.rms_norm_gated(jnp.asarray(x), jnp.asarray(z), jnp.asarray(w), 1e-5,
                               group_size=group_size)
    _close(ours, ref)


def test_gated_groups_must_divide():
    x, z, w = (torch.from_numpy(a) for a in _inputs(3, (2, 24), (2, 24), (24,)))
    with pytest.raises(ValueError, match="groups of 7"):
        norm.rms_norm_gated(x, z, w, group_size=7)


def test_bf16_inputs_round_like_jax():
    x, z, w = _inputs(4, (6, 32), (6, 32), (32,))
    xb, zb = torch.from_numpy(x).bfloat16(), torch.from_numpy(z).bfloat16()
    ours = norm.rms_norm_gated(xb, zb, torch.from_numpy(w))
    ref = jnorm.rms_norm_gated(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                               jnp.asarray(zb.float().numpy()).astype(jnp.bfloat16),
                               jnp.asarray(w))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref, np.float32))


def test_cpu_and_autograd_take_the_plain_route():
    x, r, w, z = (torch.from_numpy(a) for a in _inputs(5, (3, 16), (3, 16), (16,), (3, 16)))
    before = dict(LAUNCHES)
    assert not use_norm_kernel(x, r, w)
    norm.add_rms_norm(x, r, w)
    norm.rms_norm(x, w)
    norm.rms_norm_gated(x, z, w)
    # under autograd too: gradients reach every input through the plain ops
    leaves = [t.clone().requires_grad_() for t in (x, r, w, z)]
    xl, rl, wl, zl = leaves
    out, s = norm.add_rms_norm(xl, rl, wl)
    (out.sum() + s.sum() + norm.rms_norm_gated(xl, zl, wl).sum()
     + norm.rms_norm(xl, wl).sum()).backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)
    assert LAUNCHES == before


def test_the_rule_reads_grad_mode_and_requires_grad(monkeypatch):
    """The rule on a (faked) CUDA tensor: the kernel unless autograd needs
    the op; an unknown device raises."""

    class FakeCuda:
        def __init__(self, requires_grad=False):
            self.device = torch.device("cuda")
            self.requires_grad = requires_grad

    x, w = FakeCuda(), FakeCuda(requires_grad=True)
    assert use_norm_kernel(x, None)
    with torch.no_grad():
        assert use_norm_kernel(x, w)
    assert not use_norm_kernel(x, w)
    meta = torch.empty(2, device="meta")
    with pytest.raises(ValueError, match="meta"):
        use_norm_kernel(meta)


@pytest.mark.parametrize("call", [
    lambda x, w: nk.add_rms_norm_kernel(x, x, w),
    lambda x, w: nk.rms_norm_kernel(x, w),
    lambda x, w: nk.rms_norm_gated_kernel(x, x, w, group_size=8),
])
def test_kernel_wrappers_refuse_a_cpu_tensor(call):
    x, w = torch.zeros((2, 16)), torch.ones(16)
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="CUDA kernel"):
        call(x, w)
    assert LAUNCHES == before


def test_the_source_is_built_and_counted():
    assert build.SOURCES["rms_norm"].name == "rms_norm.cu"
    assert build.SOURCES["rms_norm"].is_file()
    assert {"add_rms_norm", "rms_norm_gated"} <= set(LAUNCHES)
    text = build.SOURCES["rms_norm"].read_text()
    assert f"kThreads = {nk.THREADS};" in text
    for sym in ("mdt_add_rms_norm", "mdt_rms_norm_gated", "mdt_rms_norm_threads"):
        assert sym in text
