"""The port's paged attention against the JAX package's, on the CPU.

* ``rope_angles``/``apply_rope`` (full and partial rotary) at 1e-6.
* The plain decode and prefill attention of ops/cuda/attention_kernels.py
  against the JAX Pallas kernels run in interpret mode (how
  tests/test_paged_attention.py runs them), at the shapes and ragged
  mixes of that file plus a GQA rep of 3, at 1e-5; rows with nothing
  cached are exactly 0, and the prefill write leaves every page but the
  trash page 0 bit-identical to the JAX kernel's.
* ``attention_mixer_step``/``attention_mixer_chunk`` against JAX
  (``attn_impl="xla"``, and ``"pallas"`` once at the smallest shape), at
  1e-5 with the pages.
* The kernel wrappers take the plain version on a CPU tensor and launch
  nothing.

Inputs are made from a seed with numpy and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_distributed_tpu.config import ModelConfig as JaxConfig
from mamba_distributed_tpu.models import attention as jatt
from mamba_distributed_tpu.ops.pallas.attention_kernels import (
    ragged_paged_decode_attention as jax_decode,
)
from mamba_distributed_tpu.ops.pallas.attention_kernels import (
    ragged_paged_prefill_attention as jax_prefill,
)
from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.models import attention as tatt
from mamba_distributed_tpu_torch.ops.cuda import attention_kernels as kern
from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES

pytestmark = pytest.mark.torch

TOL = dict(atol=1e-5, rtol=1e-5)
f32 = np.float32


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("rot,per_row", [(16, False), (16, True), (8, True), (8, False)])
def test_rope_matches_jax(rot, per_row):
    rng = np.random.default_rng(rot + per_row)
    x = rng.standard_normal((2, 5, 3, 16)).astype(f32)
    pos = rng.integers(0, 3000, (2, 5) if per_row else (5,)).astype(np.int32)
    aj = jatt.rope_angles(jnp.asarray(pos), rot, 10000.0)
    at = tatt.rope_angles(_t(pos), rot, 10000.0)
    np.testing.assert_allclose(_np(at), np.asarray(aj), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(tatt.apply_rope(_t(x), at)),
                               np.asarray(jatt.apply_rope(jnp.asarray(x), aj)),
                               atol=1e-6, rtol=1e-6)


def decode_case(seed, S=4, nh=8, nkv=2, hd=32, pg=8, W=4, P=17, lens=(5, 0, None, 17)):
    """q, pages, disjoint tables (page 0 = trash) and a ragged kv_len mix
    (None = a full table), as in tests/test_paged_attention.paged_case."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, nh, hd)).astype(f32)
    kp = rng.standard_normal((P, nkv, pg, hd)).astype(f32)
    vp = rng.standard_normal((P, nkv, pg, hd)).astype(f32)
    tbl = (1 + rng.permutation(P - 1)[:S * W]).reshape(S, W).astype(np.int32)
    lens = [W * pg if n is None else min(n, W * pg) for n in lens]
    kv_len = np.asarray((lens * (1 + S // len(lens)))[:S], np.int32)
    return q, kp, vp, tbl, kv_len


@pytest.mark.parametrize("shapes", [
    dict(),                                   # GQA rep 4
    dict(nh=4, nkv=4),                        # MHA rep 1
    dict(nh=8, nkv=1, hd=64),                 # MQA rep 8
    dict(S=6, W=2, pg=16, P=24),              # fewer, bigger pages
    dict(nh=6, nkv=2, lens=(0, 12, None, 8)),  # rep 3, an exact page multiple
])
def test_decode_plain_matches_jax_kernel(shapes):
    q, kp, vp, tbl, kv_len = decode_case(len(shapes), **shapes)
    ref = np.asarray(jax_decode(*map(jnp.asarray, (q, kp, vp, tbl, kv_len)),
                                interpret=True))
    before = dict(LAUNCHES)
    got = _np(kern.ragged_paged_decode_attention(*map(_t, (q, kp, vp, tbl, kv_len))))
    assert LAUNCHES == before  # a CPU tensor takes the plain version
    live = kv_len > 0
    np.testing.assert_allclose(got[live], ref[live], **TOL)
    assert (got[~live] == 0).all() and (ref[~live] == 0).all()


def prefill_case(seed, b=3, c=16, nh=8, nkv=2, hd=32, pg=8, W=8, P=29,
                 lens=(0, 5, 17), reals=(16, 11, 16)):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, c, nh, hd)).astype(f32)
    kc = rng.standard_normal((b, c, nkv, hd)).astype(f32)
    vc = rng.standard_normal((b, c, nkv, hd)).astype(f32)
    kp = rng.standard_normal((P, nkv, pg, hd)).astype(f32)
    vp = rng.standard_normal((P, nkv, pg, hd)).astype(f32)
    tbl = (1 + rng.permutation(P - 1)[:b * W]).reshape(b, W).astype(np.int32)
    lengths = np.asarray((list(lens) * (1 + b // len(lens)))[:b], np.int32)
    creal = np.asarray((list(reals) * (1 + b // len(reals)))[:b], np.int32)
    return q, kc, vc, kp, vp, tbl, lengths, creal


# the ragged mixes of tests/test_paged_attention.py::test_prefill_kernel_matches_lax
@pytest.mark.parametrize("case", [
    dict(lens=(0, 5, 17), reals=(16, 11, 16)),
    dict(lens=(0, 9, 0), reals=(0, 16, 7)),
    dict(lens=(12,), reals=(16,), b=2),
    dict(lens=(48,), reals=(16,), b=2, W=8),
    dict(nh=4, nkv=1, hd=64, pg=16, W=4, lens=(3, 20), reals=(16, 16)),
    dict(lens=(12, 4), reals=(0, 16), b=2),
])
def test_prefill_plain_matches_jax_kernel(case):
    inp = prefill_case(7, **case)
    ro, rkp, rvp = map(np.asarray, jax_prefill(*map(jnp.asarray, inp), interpret=True))
    before = dict(LAUNCHES)
    go, gkp, gvp = map(_np, kern.ragged_paged_prefill_attention(*map(_t, inp)))
    assert LAUNCHES == before
    c = inp[0].shape[1]
    for r, n in enumerate(inp[7]):
        np.testing.assert_allclose(go[r, c - n:], ro[r, c - n:], **TOL)
    assert not np.isnan(go).any()
    np.testing.assert_array_equal(gkp[1:], rkp[1:])
    np.testing.assert_array_equal(gvp[1:], rvp[1:])


def _cfgs(**kw):
    base = dict(d_model=64, n_layer=2, vocab_size=64, headdim=32, d_state=32,
                chunk_size=16, compute_dtype="float32", attn_layer_idx=(1,),
                attn_num_heads=4, attn_num_kv_heads=2, kv_page_tokens=8,
                kv_slot_tokens=64, prefill_chunk_tokens=16, **kw)
    return JaxConfig(**base, remat=False), ModelConfig(**base)


def _mixer_params(jcfg, seed):
    import jax

    jp = jatt.init_attention_params(jax.random.PRNGKey(seed), jcfg)
    return jp, jax.tree.map(lambda a: _t(np.asarray(a)), jp)


def _pages(seed, P, jcfg):
    rng = np.random.default_rng(seed)
    shape = (P, jcfg.effective_attn_num_kv_heads, jcfg.kv_page_tokens,
             jcfg.effective_attn_head_dim)
    return (rng.standard_normal(shape).astype(f32), rng.standard_normal(shape).astype(f32))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_attention_mixer_step_matches_jax(impl):
    jcfg, cfg = _cfgs(attn_impl=impl)
    jp, tp = _mixer_params(jcfg, 0)
    b, W = 3, 8
    kp, vp = _pages(1, 1 + b * W, jcfg)
    tbl = (1 + np.arange(b * W, dtype=np.int32)).reshape(b, W)
    lengths = np.asarray([0, 5, 12], np.int32)
    rng = np.random.default_rng(2)
    kv_j = (jnp.asarray(kp), jnp.asarray(vp))
    kv_t = (_t(kp), _t(vp))
    ptr = kv_t[0].data_ptr()
    for i, mask in enumerate(([True, True, True], [True, False, True], None)):
        u = rng.standard_normal((b, 64)).astype(f32)
        wm = None if mask is None else np.asarray(mask)
        yj, kv_j = jatt.attention_mixer_step(
            jp, jcfg, jnp.asarray(u), kv_j, jnp.asarray(tbl), jnp.asarray(lengths + i),
            write_mask=None if wm is None else jnp.asarray(wm))
        yt, kv_t = tatt.attention_mixer_step(
            tp, cfg, _t(u), kv_t, _t(tbl), _t(lengths + i),
            write_mask=None if wm is None else _t(wm))
        np.testing.assert_allclose(_np(yt), np.asarray(yj), **TOL)
        for a, c in zip(kv_t, kv_j):
            np.testing.assert_allclose(_np(a)[1:], np.asarray(c)[1:], **TOL)
    # the pages were written in place
    assert kv_t[0].data_ptr() == ptr


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_attention_mixer_chunk_matches_jax(impl):
    jcfg, cfg = _cfgs(attn_impl=impl)
    jp, tp = _mixer_params(jcfg, 3)
    b, c, W = 2, 16, 8
    kp, vp = _pages(4, 1 + b * W, jcfg)
    tbl = (1 + np.arange(b * W, dtype=np.int32)).reshape(b, W)
    lengths = np.asarray([0, 13], np.int32)
    rng = np.random.default_rng(5)
    u = rng.standard_normal((b, c, 64)).astype(f32)
    mask = np.ones((b, c), f32)
    mask[0, :6] = 0.0  # left pad of a first chunk
    yj, kvj = jatt.attention_mixer_chunk(
        jp, jcfg, jnp.asarray(u), (jnp.asarray(kp), jnp.asarray(vp)), jnp.asarray(tbl),
        jnp.asarray(lengths), token_mask=jnp.asarray(mask))
    kv_t = (_t(kp), _t(vp))
    yt, kvt = tatt.attention_mixer_chunk(tp, cfg, _t(u), kv_t, _t(tbl), _t(lengths),
                                         token_mask=_t(mask))
    assert kvt[0] is kv_t[0] and kvt[1] is kv_t[1]  # written in place
    np.testing.assert_allclose(_np(yt)[0, 6:], np.asarray(yj)[0, 6:], **TOL)
    np.testing.assert_allclose(_np(yt)[1], np.asarray(yj)[1], **TOL)
    for a, r in zip(kvt, kvj):
        np.testing.assert_allclose(_np(a)[1:], np.asarray(r)[1:], **TOL)


def test_page_helpers_match_jax():
    jcfg, cfg = _cfgs()
    assert tatt.attention_page_count(cfg, 17) == jatt.attention_page_count(jcfg, 17) == 3
    tj, lj = jatt.attention_page_meta(jcfg, 2, 20)
    tt, lt = tatt.attention_page_meta(cfg, 2, 20)
    np.testing.assert_array_equal(_np(tt), np.asarray(tj))
    np.testing.assert_array_equal(_np(lt), np.asarray(lj))
    kj, _ = jatt.init_attention_state(jcfg, 2, 20)
    kt, _ = tatt.init_attention_state(cfg, 2, 20)
    assert tuple(kt.shape) == kj.shape and kt.dtype == torch.float32
    kp, vp = _pages(6, 7, jcfg)
    tbl = np.asarray([[3, 1, 6], [2, 5, 4]], np.int32)
    live = np.asarray([1, 3], np.int32)
    for a, r in zip(tatt.gather_kv_pages(_t(kp), _t(vp), _t(tbl), _t(live)),
                    jatt.gather_kv_pages(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
                                         jnp.asarray(live))):
        np.testing.assert_array_equal(_np(a), np.asarray(r))
