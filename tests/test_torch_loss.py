"""The port's vocab-blocked cross-entropy (ops/loss.py) against the JAX
package's ``blocked_cross_entropy`` and against the port's dense loss,
on the CPU in fp32 at 1e-4 unless a case says otherwise: the cases of
tests/test_loss.py:15-116 (the op against a naive CE, block-count
invariance, the model's blocked loss against the dense one, tied and
untied, a biased head refused, a bf16 head's gradient dtype, the MoE aux
term, the config's validation), plus the op's value and gradients
against JAX's on the same numpy inputs in fp32 and bf16."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_distributed_tpu.config import ModelConfig as JaxConfig
from mamba_distributed_tpu.models import lm as jlm
from mamba_distributed_tpu.ops.loss import blocked_cross_entropy as jax_blocked
from mamba_distributed_tpu_torch import convert
from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.models import lm
from mamba_distributed_tpu_torch.ops.loss import blocked_cross_entropy
from mamba_distributed_tpu_torch.training.optimizer import tree_leaves, tree_map

pytestmark = pytest.mark.torch

SMALL = dict(d_model=32, n_layer=2, vocab_size=60, d_state=16, chunk_size=8, headdim=8,
             remat=False, loss_vocab_blocks=4, compute_dtype="float32")


def _inputs(seed, b, t, d, V):
    g = np.random.default_rng(seed)
    return (g.standard_normal((b, t, d)).astype(np.float32),
            g.standard_normal((V, d)).astype(np.float32),
            g.integers(0, V, (b, t)).astype(np.int32))


def _naive(n, h, tgt):
    logits = n @ h.t()
    return (torch.logsumexp(logits, -1) - logits.gather(-1, tgt[..., None])[..., 0]).mean()


def _grads(fn, *args):
    args = [torch.from_numpy(a).requires_grad_() for a in args]
    loss = fn(*args)
    return loss, torch.autograd.grad(loss, args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_matches_jax_and_naive(dtype):
    """Value and both gradients against the JAX op on the same inputs (in
    bf16, the compute-dtype round trip of every block's logits; 1e-3 of
    the largest value there, the two packages' fp32 sums meeting bf16
    rounding boundaries apart), and in fp32 against a naive CE."""
    n, h, tgt = _inputs(0, 2, 8, 16, 32)
    cd = getattr(torch, dtype)
    jloss, jg = jax.value_and_grad(
        lambda a, b: jax_blocked(a, b, jnp.asarray(tgt), 4, getattr(jnp, dtype)),
        argnums=(0, 1))(jnp.asarray(n), jnp.asarray(h))
    t = torch.from_numpy(tgt).long()
    loss, g = _grads(lambda a, b: blocked_cross_entropy(a, b, t, 4, cd), n, h)
    tol = 1e-4 if dtype == "float32" else 1e-3
    assert abs(loss.item() - float(jloss)) <= tol * abs(float(jloss))
    for a, b in zip(g, jg):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= tol * np.abs(b).max()
    if dtype == "float32":
        nloss, ng = _grads(lambda a, b: _naive(a, b, t), n, h)
        assert abs(loss.item() - nloss.item()) <= 1e-6 * abs(nloss.item())
        for a, b in zip(g, ng):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_block_count_invariance():
    n, h, tgt = _inputs(3, 1, 6, 8, 24)
    t = torch.from_numpy(tgt).long()
    losses = [blocked_cross_entropy(torch.from_numpy(n), torch.from_numpy(h), t, k,
                                    torch.float32).item() for k in (1, 3, 8)]
    assert max(losses) - min(losses) <= 1e-6 * abs(losses[0])


@pytest.mark.parametrize("tied", [True, False])
def test_model_blocked_matches_dense_and_jax(tied):
    """The model's blocked loss equals its dense loss (the same bf16-free
    logits here) and JAX's blocked loss, value and every gradient."""
    jcfg = JaxConfig(**SMALL, tie_embeddings=tied, loss_impl="blocked")
    jp = jax.jit(jlm.init_lm_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(1).integers(0, 60, (2, 24)).astype(np.int32)
    y = np.random.default_rng(2).integers(0, 60, (2, 24)).astype(np.int32)
    jloss, jg = jax.jit(jax.value_and_grad(jlm.lm_loss), static_argnums=1)(
        jp, jcfg, jnp.asarray(x), jnp.asarray(y))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    res = {}
    for impl in ("dense", "blocked"):
        cfg = ModelConfig(**SMALL, tie_embeddings=tied, loss_impl=impl)
        p = tree_map(lambda t: t.clone().requires_grad_(), params)
        loss = lm.lm_loss(p, cfg, torch.from_numpy(x).long(), torch.from_numpy(y).long())
        res[impl] = (loss.item(), torch.autograd.grad(loss, tree_leaves(p)))
    jleaves = [np.asarray(v) for v in tree_leaves(convert.params_from_jax(
        jax.tree.map(np.asarray, jg)))]
    assert abs(res["blocked"][0] - res["dense"][0]) <= 1e-6 * abs(res["dense"][0])
    assert abs(res["blocked"][0] - float(jloss)) <= 1e-4 * abs(float(jloss))
    for a, b, j in zip(res["blocked"][1], res["dense"][1], jleaves):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
        assert np.abs(a.numpy() - j).max() <= 1e-4 * max(np.abs(j).max(), 1e-30)


def test_biased_head_raises_and_bf16_head_grad_dtype():
    """A biased lm_head under the blocked loss raises a ValueError (not an
    assert); a bf16 head gets a bf16 gradient."""
    cfg = ModelConfig(**SMALL, tie_embeddings=False, loss_impl="blocked")
    p = lm.init_lm_params(cfg, torch.Generator().manual_seed(0))
    assert lm._head_matrix(p, cfg).shape == (64, 32)  # vocab padded to 64
    p["lm_head"]["bias"] = torch.zeros((64,))
    with pytest.raises(ValueError, match="bias-free"):
        lm._head_matrix(p, cfg)
    n, h, tgt = _inputs(7, 1, 6, 8, 24)
    head = torch.from_numpy(h).to(torch.bfloat16).requires_grad_()
    loss = blocked_cross_entropy(torch.from_numpy(n).to(torch.bfloat16), head,
                                 torch.from_numpy(tgt).long(), 4, torch.bfloat16)
    assert torch.autograd.grad(loss, head)[0].dtype == torch.bfloat16


def test_blocked_moe_aux_and_validation():
    cfg = ModelConfig(**dict(SMALL, vocab_size=64), d_intermediate=64, moe_num_experts=2,
                      moe_top_k=1)
    p = lm.init_lm_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x, y = (torch.randint(0, 64, (2, 16), generator=g) for _ in range(2))
    dense = lm.lm_loss(p, cfg, x, y).item()
    blocked = lm.lm_loss(p, dataclasses.replace(cfg, loss_impl="blocked"), x, y).item()
    assert abs(dense - blocked) <= 1e-5
    with pytest.raises(ValueError, match="loss_impl"):
        ModelConfig(**dict(SMALL, loss_impl="bogus"))
    with pytest.raises(ValueError, match="loss_vocab_blocks"):
        ModelConfig(**dict(SMALL, loss_impl="blocked", loss_vocab_blocks=7))
