"""The port's full-sequence attention against the JAX package's, on the
CPU in fp32.

* The plain versions of the three flash kernels (ops/cuda/flash_kernels.py)
  against the JAX Pallas pair kernels run in interpret mode (how
  tests/test_attention_pallas.py runs them) with 64-row blocks: o and
  lse, dq, dk/dv, at t 128, a ragged t 100, and a later query slice
  (tq 64 against tk 128 at offset 64), GQA rep 2, at 1e-4.
* ``blockwise_sdpa_causal`` against JAX's, ragged blocks and an offset.
* ``FlashAttentionFunction`` (through the plain versions on CPU tensors)
  against torch autograd of the port's ``blockwise_sdpa_causal``, and the
  wrappers launch nothing on a CPU tensor.
* ``attention_mixer`` against JAX's (``attn_impl="xla"``), with both of
  the port's ``attn_impl`` values, and ``pack_attention_pages``.

Inputs are made from a seed with numpy and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_distributed_tpu.config import ModelConfig as JaxConfig
from mamba_distributed_tpu.models import attention as jatt
from mamba_distributed_tpu.models import lm as jlm
from mamba_distributed_tpu.ops import blockwise_attention as jbw
from mamba_distributed_tpu.ops.pallas import attention_kernels as jfa
from mamba_distributed_tpu_torch import convert
from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.models import attention as tatt
from mamba_distributed_tpu_torch.ops import blockwise_attention as tbw
from mamba_distributed_tpu_torch.ops.cuda import flash_kernels as fk
from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES

pytestmark = pytest.mark.torch

f32 = np.float32
# (tq, tk, offset): a block multiple, a ragged length, a later query slice
PAIR_CASES = [(128, 128, 0), (100, 100, 0), (64, 128, 64)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(_np(got) - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module", params=PAIR_CASES, ids=lambda c: "tq{}-tk{}-off{}".format(*c))
def pair_case(request):
    """Head-major q, k, v, dO (b 1, nh 4, nkv 2, hd 32) and the JAX
    kernels' forward outputs, with delta = rowsum(dO * o)."""
    tq, tk, off = request.param
    rng = np.random.default_rng(tq + tk + off)
    q = rng.standard_normal((1, 4, tq, 32)).astype(f32)
    k = rng.standard_normal((1, 2, tk, 32)).astype(f32)
    v = rng.standard_normal((1, 2, tk, 32)).astype(f32)
    do = rng.standard_normal((1, 4, tq, 32)).astype(f32)
    o, lse = jfa.flash_pair_fwd(*map(jnp.asarray, (q, k, v)), off, qb=64, kb=64,
                                interpret=True)
    delta = (do * np.asarray(o)).sum(-1)
    return dict(q=q, k=k, v=v, do=do, off=off, o=np.asarray(o), lse=np.asarray(lse),
                delta=delta)


def test_flash_fwd_plain_matches_jax_kernel(pair_case):
    c = pair_case
    o, lse = fk.flash_fwd_plain(_t(c["q"]), _t(c["k"]), _t(c["v"]), c["off"], c["k"].shape[2])
    assert _rel(o, c["o"]) <= 1e-4
    assert _rel(lse, c["lse"]) <= 1e-4
    # the pair API is the same function
    o2, lse2 = fk.flash_pair_fwd(_t(c["q"]), _t(c["k"]), _t(c["v"]), c["off"])
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


def test_flash_bwd_dq_plain_matches_jax_kernel(pair_case):
    c = pair_case
    args = [c[n] for n in ("q", "k", "v", "do", "lse", "delta")]
    ref = jfa.flash_pair_dq(*map(jnp.asarray, args), c["off"], qb=64, kb=64, interpret=True)
    got = fk.flash_pair_dq(*map(_t, args), c["off"])
    assert got.dtype == torch.float32
    assert _rel(got, ref) <= 1e-4


def test_flash_bwd_dkv_plain_matches_jax_kernel(pair_case):
    c = pair_case
    args = [c[n] for n in ("q", "k", "v", "do", "lse", "delta")]
    rk, rv = jfa.flash_pair_dkv(*map(jnp.asarray, args), c["off"], qb=64, kb=64,
                                interpret=True)
    gk, gv = fk.flash_pair_dkv(*map(_t, args), c["off"])
    assert tuple(gk.shape) == tuple(c["k"].shape)
    assert _rel(gk, rk) <= 1e-4
    assert _rel(gv, rv) <= 1e-4


def test_flash_rows_that_see_no_key():
    """offset < 0: the first rows see no key; o is 0 there, lse +inf, and
    their backward contributes nothing."""
    rng = np.random.default_rng(3)
    q, k, v, do = (rng.standard_normal(s).astype(f32)
                   for s in ((1, 2, 8, 32), (1, 1, 8, 32), (1, 1, 8, 32), (1, 2, 8, 32)))
    o, lse = fk.flash_fwd_plain(_t(q), _t(k), _t(v), -3, 8)
    assert torch.all(o[:, :, :3] == 0) and torch.all(torch.isinf(lse[:, :, :3]))
    assert torch.isfinite(lse[:, :, 3:]).all()
    delta = (_t(do) * o).sum(-1)
    dq = fk.flash_bwd_dq_plain(_t(q), _t(k), _t(v), _t(do), lse, delta, -3, 8)
    assert torch.all(dq[:, :, :3] == 0) and torch.isfinite(dq).all()
    # the last keys are seen by no row (j <= i - 3 < 5)
    dk, dv = fk.flash_bwd_dkv_plain(_t(q), _t(k), _t(v), _t(do), lse, delta, -3, 8)
    assert torch.all(dk[:, :, 5:] == 0) and torch.all(dv[:, :, 5:] == 0)


@pytest.mark.parametrize("tq,tk,off,blk", [(64, 64, 0, 16), (48, 96, 48, 32), (40, 40, 0, 16)])
def test_blockwise_sdpa_matches_jax(tq, tk, off, blk):
    rng = np.random.default_rng(tq + blk)
    q = rng.standard_normal((2, tq, 6, 16)).astype(f32)
    k = rng.standard_normal((2, tk, 2, 16)).astype(f32)
    v = rng.standard_normal((2, tk, 2, 16)).astype(f32)
    ref = jbw.blockwise_sdpa_causal(*map(jnp.asarray, (q, k, v)), off, q_block=blk,
                                    k_block=blk)
    got = tbw.blockwise_sdpa_causal(*map(_t, (q, k, v)), off, q_block=blk, k_block=blk)
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("nh,nkv,tq,tk,off", [(4, 4, 40, 40, 0), (6, 2, 24, 56, 32)])
def test_flash_function_grads_match_blockwise_autograd(nh, nkv, tq, tk, off):
    """The Function's forward and q/k/v gradients (its backward glue:
    delta, the dq and dk/dv plain versions, the casts) against autograd
    of the plain blockwise attention; no kernel launches on the CPU."""
    rng = np.random.default_rng(nh + tq)
    arrs = [rng.standard_normal(s).astype(f32)
            for s in ((2, tq, nh, 16), (2, tk, nkv, 16), (2, tk, nkv, 16))]
    do = _t(rng.standard_normal((2, tq, nh, 16)).astype(f32))
    before = dict(LAUNCHES)
    res = []
    for fn in (fk.flash_sdpa_causal, lambda q, k, v, o: tbw.blockwise_sdpa_causal(
            q, k, v, o, q_block=8, k_block=8)):
        q, k, v = (_t(a).requires_grad_() for a in arrs)
        o = fn(q, k, v, off)
        res.append((o.detach(), *torch.autograd.grad((o * do).sum(), (q, k, v))))
    assert LAUNCHES == before
    for got, ref in zip(*res):
        assert _rel(got, _np(ref)) <= 1e-4


HYB = dict(d_model=64, n_layer=2, vocab_size=64, headdim=16, chunk_size=16, d_state=16,
           compute_dtype="float32", attn_layer_idx=(1,), attn_num_heads=4,
           attn_num_kv_heads=2, kv_page_tokens=8)


@pytest.fixture(scope="module")
def mixer_pair():
    jcfg = JaxConfig(**HYB, attn_impl="xla")
    jparams = jlm.init_lm_params(jax.random.PRNGKey(2), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    return (jcfg, jax.tree.map(lambda a: a[0], jparams["attn_blocks"]["mixer"]),
            {k: {kk: vv[0] for kk, vv in v.items()}
             for k, v in tparams["attn_blocks"]["mixer"].items()})


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_attention_mixer_matches_jax(mixer_pair, attn_impl):
    jcfg, jp, tp = mixer_pair
    u = np.random.default_rng(7).standard_normal((2, 40, 64)).astype(f32)
    yj, (kj, vj) = jatt.attention_mixer(jp, jcfg, jnp.asarray(u), return_final_state=True)
    cfg = ModelConfig(**HYB, attn_impl=attn_impl)
    yt, (kt, vt) = tatt.attention_mixer(tp, cfg, _t(u), return_final_state=True)
    assert _rel(yt, yj) <= 1e-4
    assert _rel(kt, kj) <= 1e-5 and _rel(vt, vj) <= 1e-5
    assert torch.equal(tatt.attention_mixer(tp, cfg, _t(u)), yt)


@pytest.mark.parametrize("t,max_len", [(20, 21), (16, 40)])
def test_pack_attention_pages_matches_jax(t, max_len):
    rng = np.random.default_rng(t)
    k, v = (rng.standard_normal((3, t, 2, 8)).astype(f32) for _ in range(2))
    ref = jatt.pack_attention_pages(JaxConfig(**HYB), jnp.asarray(k), jnp.asarray(v), max_len)
    got = tatt.pack_attention_pages(ModelConfig(**HYB), _t(k), _t(v), max_len)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
