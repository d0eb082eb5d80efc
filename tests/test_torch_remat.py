"""The remat policies "dots" and "mixer" (ops/remat.py) and the
``xla_conv`` causal conv, on the CPU in fp32.

* Under each policy the loss and every gradient equal those under
  "all" within 1e-6 (a Mamba-1 hybrid, and a Mamba-2 hybrid with a MoE,
  an untied head, the blocked loss and ``xla_conv``), and under "mixer"
  equal the JAX package's under "mixer" at 1e-4;
* "mixer" runs each mixer core's forward (the SSD, scan and flash
  forwards' plain versions behind their Functions) once per layer in a
  train step, where "all" and "dots" run it twice;
* "dots" saves the 2-D matrix products: its backward runs only the
  gradient products (two ``aten.mm`` for each of the forward's), where
  "all" runs more;
* ``causal_conv1d(impl="xla_conv")`` equals the JAX ``xla_conv`` and the
  port's "shift" (outputs and final states, seeded and not), and a
  model with ``conv_impl="xla_conv"`` equals JAX's in loss and
  gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mamba_distributed_tpu.config import ModelConfig as JaxConfig
from mamba_distributed_tpu.models import lm as jlm
from mamba_distributed_tpu.ops.conv import causal_conv1d as jax_conv
from mamba_distributed_tpu_torch import convert
from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.models import lm
from mamba_distributed_tpu_torch.ops.conv import causal_conv1d
from mamba_distributed_tpu_torch.ops.cuda import flash_kernels, scan_kernels, ssd_kernels
from mamba_distributed_tpu_torch.training.optimizer import tree_leaves, tree_map

pytestmark = pytest.mark.torch

BASE = dict(d_model=32, n_layer=4, vocab_size=64, headdim=8, chunk_size=16, d_state=16,
            compute_dtype="float32", attn_layer_idx=(1,), attn_num_heads=4,
            attn_num_kv_heads=2, ssm_impl="pallas", attn_impl="pallas")
MODELS = {
    "mamba1-hybrid": dict(BASE, ssm_layer="mamba1", d_state=8),
    "moe-untied-blocked-xla_conv": dict(BASE, d_intermediate=48, moe_num_experts=4,
                                        tie_embeddings=False, loss_impl="blocked",
                                        loss_vocab_blocks=4, conv_impl="xla_conv"),
}
# the plain forward each mixer core's Function runs on a CPU tensor
CORES = ((ssd_kernels, "ssd_chunked"), (scan_kernels, "m1_scan_plain"),
         (flash_kernels, "flash_fwd_plain"))


def _ids(seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 64, (2, 32)))


def _loss_grads(cfg, params):
    p = tree_map(lambda t: t.clone().requires_grad_(), params)
    loss = lm.lm_loss(p, cfg, _ids(1), _ids(2))
    return loss.item(), torch.autograd.grad(loss, tree_leaves(p))


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    kw = MODELS[request.param]
    jcfg = JaxConfig(**{k: v for k, v in kw.items() if k not in ("ssm_impl", "attn_impl")})
    jparams = jax.jit(jlm.init_lm_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return request.param, kw, jcfg, jparams, convert.params_from_jax(
        jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("policy", ["dots", "mixer"])
def test_policies_match_all_and_jax(model, policy, monkeypatch):
    name, kw, jcfg, jparams, params = model
    calls = {}
    for mod, fn in CORES:
        orig = getattr(mod, fn)

        def counted(*a, _orig=orig, _fn=fn, **k):
            calls[_fn] = calls.get(_fn, 0) + 1
            return _orig(*a, **k)

        monkeypatch.setattr(mod, fn, counted)
    runs = {}
    for pol in ("all", policy):
        calls.clear()
        runs[pol] = (*_loss_grads(ModelConfig(**kw, remat_policy=pol), params), dict(calls))
    (l0, g0, c0), (l1, g1, c1) = runs["all"], runs[policy]
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    for a, b in zip(g1, g0):
        assert float((a - b).abs().max()) <= 1e-6 * max(float(b.abs().max()), 1e-30)
    n_attn = len(kw["attn_layer_idx"])
    layers = {"ssd_chunked": 4 - n_attn if kw.get("ssm_layer") != "mamba1" else 0,
              "m1_scan_plain": 4 - n_attn if kw.get("ssm_layer") == "mamba1" else 0,
              "flash_fwd_plain": n_attn}
    want = {k: v * (1 if policy == "mixer" else 2) for k, v in layers.items() if v}
    assert c1 == want and c0 == {k: 2 * v for k, v in layers.items() if v}
    if policy != "mixer":
        return
    # the JAX package under the same policy
    jc = dataclasses.replace(jcfg, remat_policy=policy)
    jloss, jg = jax.jit(jax.value_and_grad(jlm.lm_loss), static_argnums=1)(
        jparams, jc, jnp.asarray(_ids(1).numpy()), jnp.asarray(_ids(2).numpy()))
    assert abs(l1 - float(jloss)) <= 1e-4 * abs(float(jloss))
    for a, j in zip(g1, tree_leaves(convert.params_from_jax(jax.tree.map(np.asarray, jg)))):
        assert float((a - j).abs().max()) <= 1e-4 * max(float(j.abs().max()), 1e-30)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))


def test_dots_saves_the_matrix_products():
    """The backward under "dots" recomputes no ``aten.mm``: it runs the
    two gradient products of each of the forward's, and "all" more."""
    kw = dict(BASE, attn_layer_idx=())
    params = tree_map(lambda t: t.requires_grad_(),
                      lm.init_lm_params(ModelConfig(**kw), torch.Generator().manual_seed(0)))
    counts = {}
    for pol in ("all", "dots"):
        cfg = ModelConfig(**kw, remat_policy=pol)
        fwd, bwd = _CountMM(), _CountMM()
        with fwd:
            loss = lm.lm_loss(params, cfg, _ids(1), _ids(2))
        with bwd:
            torch.autograd.grad(loss, tree_leaves(params))
        counts[pol] = (fwd.n, bwd.n)
    (f_all, b_all), (f_dots, b_dots) = counts["all"], counts["dots"]
    assert f_all == f_dots == 4 * 2 + 1  # in_proj, out_proj a layer; the head
    assert b_dots == 2 * f_dots and b_all > b_dots


@pytest.mark.parametrize("seeded", [False, True])
def test_xla_conv_matches_jax_and_shift(seeded):
    g = np.random.default_rng(4)
    x = g.standard_normal((2, 19, 12)).astype(np.float32)
    w = g.standard_normal((12, 4)).astype(np.float32)
    b = g.standard_normal((12,)).astype(np.float32)
    s0 = g.standard_normal((2, 3, 12)).astype(np.float32) if seeded else None
    jy, js = jax_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), initial_state=(
        None if s0 is None else jnp.asarray(s0)), return_final_state=True, impl="xla_conv")
    t = (lambda a: None if a is None else torch.from_numpy(a))
    for impl in ("xla_conv", "shift"):
        y, s = causal_conv1d(t(x), t(w), t(b), initial_state=t(s0), return_final_state=True,
                             impl=impl)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        assert y.stride(-1) == 1  # the channels contiguous, as the kernels read them
    yb = causal_conv1d(t(x).to(torch.bfloat16), t(w), t(b), impl="xla_conv")
    ys = causal_conv1d(t(x).to(torch.bfloat16), t(w), t(b), impl="shift")
    assert yb.dtype == torch.bfloat16
    torch.testing.assert_close(yb.float(), ys.float(), atol=2e-2, rtol=1e-2)
    with pytest.raises(ValueError, match="conv impl"):
        causal_conv1d(t(x), t(w), impl="fft")
