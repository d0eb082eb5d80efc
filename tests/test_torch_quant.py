"""The port's int8 serving against the JAX package's, on the CPU in fp32.

* ``ops/quant.py``: per-channel codes and scales EQUAL to the JAX ones
  (both axes, the embedding, a whole ``hybrid-tiny`` tree, idempotent),
  ``kv_quantize``/``kv_requant`` equal at .5 ties and clips, and
  ``assert_stream_close`` as the JAX test drives it.
* The config's dtype knobs and the decode cast's selectivity; ``linear``
  with column and row scales at 1e-4.
* Int8 KV pages: ``init_attention_state`` and ``pack_attention_pages``
  equal; the plain decode and prefill attention against the JAX kernels'
  int8 branches in interpret mode (outputs at 1e-4, written pages equal
  on every page but the trash page 0); ``_chunk_page_scales`` equal;
  ``attention_mixer_step``/``attention_mixer_chunk`` against JAX for
  ``attn_impl`` "xla" and "pallas" (outputs at 1e-4, scales at 1e-5
  relative, codes within 1: the two packages' fp32 projections differ in
  the last bit, which can move a code across a rounding boundary).
* Greedy ``generate()`` streams equal to the JAX ``generate()``'s with
  int8 weights (hybrid-tiny with int8 pages too, mamba2-tiny, a
  cut-down Mamba-1), and the port's int8 hybrid engine equal to its own
  ``generate(decode_rows=capacity)`` with no page leaked.
* The build-time kernel shape check (``ops/dispatch.check_kernel_shapes``)
  and the residual rescale helper against the JAX init.

Inputs are made from a seed with numpy and handed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_distributed_tpu.config import ModelConfig as JaxConfig
from mamba_distributed_tpu.inference import generate as jax_generate
from mamba_distributed_tpu.inference.generate import _decode_params as jax_decode_params
from mamba_distributed_tpu.models import attention as jatt
from mamba_distributed_tpu.models import common as jcommon
from mamba_distributed_tpu.models import init_lm_params as jax_init
from mamba_distributed_tpu.models.mamba1 import init_mamba1_params as jax_init_m1
from mamba_distributed_tpu.models.mamba2 import init_mamba2_params as jax_init_m2
from mamba_distributed_tpu.ops import quant as jquant
from mamba_distributed_tpu.ops.pallas.attention_kernels import (
    ragged_paged_decode_attention as jax_decode,
)
from mamba_distributed_tpu.ops.pallas.attention_kernels import (
    ragged_paged_prefill_attention as jax_prefill,
)
from mamba_distributed_tpu_torch import convert
from mamba_distributed_tpu_torch.config import ModelConfig, get_preset, get_train_preset
from mamba_distributed_tpu_torch.inference.generate import _decode_params, generate
from mamba_distributed_tpu_torch.models import attention as tatt
from mamba_distributed_tpu_torch.models.common import linear, out_proj_rescale
from mamba_distributed_tpu_torch.ops import quant
from mamba_distributed_tpu_torch.ops.cuda import attention_kernels as kern
from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
from mamba_distributed_tpu_torch.ops.dispatch import check_kernel_shapes
from mamba_distributed_tpu_torch.serving import GenerationRequest, ServingEngine
from mamba_distributed_tpu_torch.training import Trainer

pytestmark = pytest.mark.torch

TOL = dict(atol=1e-4, rtol=1e-4)
f32 = np.float32


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _prompt(seed, t, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, t).astype(np.int64)


# ------------------------------------------------------------ ops/quant.py


@pytest.mark.parametrize("axis", [-1, -2])
def test_quantize_channels_equals_jax(axis):
    w = np.random.default_rng(1).standard_normal((3, 24, 40)).astype(f32)
    w[1, :, 5] = 0.0  # an all-zero column: the scale floor
    got = quant.quantize_channels(_t(w), axis)
    want = jquant.quantize_channels(jnp.asarray(w), axis)
    assert got["kernel"].dtype == torch.int8
    np.testing.assert_array_equal(_np(got["kernel"]), np.asarray(want["kernel"]))
    np.testing.assert_array_equal(_np(got["scale"]), np.asarray(want["scale"]))
    # the round trip is within half a step of each channel
    err = np.abs(_np(quant.dequantize(got)) - w)
    assert (err <= 0.5 * _np(got["scale"]) * (1 + 1e-6)).all()
    plain = _t(w)
    assert quant.dequantize(plain) is plain and not quant.is_quantized(plain)
    emb = np.random.default_rng(2).standard_normal((64, 32)).astype(f32) * 0.02
    ge, we = quant.quantize_embedding(_t(emb)), jquant.quantize_embedding(jnp.asarray(emb))
    assert tuple(ge["scale"].shape) == (64, 1)
    for k in ("kernel", "scale"):
        np.testing.assert_array_equal(_np(ge[k]), np.asarray(we[k]))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    else:
        yield path, tree


def _pair(kw, seed=2):
    """(JAX config, JAX params, port config, port params) of one tree."""
    jcfg = JaxConfig(**{**kw, "remat": False})
    jparams = jax_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jparams, ModelConfig(**kw), convert.params_from_jax(
        jax.tree.map(np.asarray, jparams))


M1 = dict(d_model=32, n_layer=2, vocab_size=64, ssm_layer="mamba1", d_state=8,
          compute_dtype="float32", prefill_chunk_tokens=16, serving_weight_dtype="int8")


@pytest.fixture(scope="module")
def hybrid_tiny():
    """hybrid-tiny in fp32 with int8 weights and int8 KV pages."""
    return _pair(dict(get_preset("hybrid-tiny").__dict__, compute_dtype="float32",
                      serving_weight_dtype="int8", kv_page_dtype="int8"))


@pytest.fixture(scope="module")
def mamba1():
    """A cut-down Mamba-1 (as tests/test_torch_mamba1.py builds one), int8 weights."""
    return _pair(M1)


def test_quantize_serving_params_equals_jax_and_is_idempotent(hybrid_tiny):
    _, jparams, _, params = hybrid_tiny
    got = quant.quantize_serving_params(params)
    want = dict(_leaves(jax.tree.map(np.asarray, jquant.quantize_serving_params(jparams))))
    leaves = dict(_leaves(got))
    assert set(leaves) == set(want)
    for path, leaf in leaves.items():
        np.testing.assert_array_equal(_np(leaf), want[path], err_msg=str(path))
    assert quant.is_quantized(got["embedding"])
    for name in ("in_proj", "out_proj"):
        assert quant.is_quantized(got["blocks"]["mixer"][name])
    assert not quant.is_quantized(got["blocks"]["mixer"]["conv"])
    assert quant.is_quantized(got["attn_blocks"]["mixer"]["wqkv"])
    again = quant.quantize_serving_params(got)
    for (p, a), (_, b) in zip(_leaves(again), _leaves(got)):
        assert a is b, p


def test_kv_quantize_and_requant_equal_jax_at_ties_and_clips():
    x = np.asarray([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.6, -300.0, 0.0, 3.49],
                   f32)
    for scale in (1.0, 0.5, 0.013):
        np.testing.assert_array_equal(
            _np(quant.kv_quantize(_t(x * scale), scale)),
            np.asarray(jquant.kv_quantize(jnp.asarray(x * scale), scale)))
    q = np.asarray([1, 3, 5, -1, -3, -5, 127, -127, 100, 0], np.int8)
    for ratio in (0.5, 1.0, 2.0, 0.0, 0.3):
        np.testing.assert_array_equal(
            _np(quant.kv_requant(_t(q), ratio)),
            np.asarray(jquant.kv_requant(jnp.asarray(q), ratio)))


def test_assert_stream_close_reports_disagreement():
    class Sentinel:
        def __init__(self):
            self.events = []

        def record_event(self, kind, **kw):
            self.events.append({"kind": kind, **kw})

    class Metrics:
        greedy_token_disagreements = 0

        def record_greedy_disagreement(self, n):
            self.greedy_token_disagreements += n

    assert quant.assert_stream_close([1, 2, 3], [1, 2, 3]) == 0
    sent, met = Sentinel(), Metrics()
    with pytest.raises(AssertionError, match="diverge at 2/4"):
        quant.assert_stream_close([1, 2, 9, 9], [1, 2, 3, 4], sentinel=sent, metrics=met,
                                  label="t")
    assert met.greedy_token_disagreements == 2
    assert sent.events[-1]["kind"] == "quant_token_disagreement"
    assert sent.events[-1]["first_divergence"] == 2
    assert quant.assert_stream_close([1, 2, 9, 9], [1, 2, 3, 4],
                                     min_token_agreement=0.5) == 2
    with pytest.raises(AssertionError, match="logits"):
        quant.assert_stream_close([1, 2], [1, 2], got_logits=np.zeros((2, 4)),
                                  want_logits=np.ones((2, 4)))


# ------------------------------------------------- config and decode cast


def test_config_dtype_knobs():
    with pytest.raises(ValueError, match="serving_weight_dtype"):
        ModelConfig(serving_weight_dtype="fp8")
    with pytest.raises(ValueError, match="kv_page_dtype"):
        ModelConfig(kv_page_dtype="int4")
    cfg = ModelConfig(kv_page_dtype="int8", serving_weight_dtype="int8")
    assert cfg.kv_quantized and not ModelConfig().kv_quantized
    assert quant.apply_dtype_overrides(ModelConfig(), "int8", "int8") == cfg
    assert quant.apply_dtype_overrides(cfg) is cfg


def test_decode_cast_quant_selectivity(mamba1):
    """Conv, dt_proj and the SSM scalars never quantize; dt_proj takes
    the compute-dtype cast; the default leaves the tree unquantized; the
    quantized leaves equal the JAX decode cast's."""
    jcfg, jparams, cfg, params = mamba1
    jcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    dp = _decode_params(params, dataclasses.replace(cfg, compute_dtype="bfloat16"))
    mixer = dp["blocks"]["mixer"]
    assert quant.is_quantized(mixer["in_proj"]) and quant.is_quantized(mixer["x_proj"])
    assert quant.is_quantized(mixer["out_proj"]) and quant.is_quantized(dp["embedding"])
    assert not quant.is_quantized(mixer["conv"]) and mixer["conv"]["kernel"].dtype == torch.float32
    assert not quant.is_quantized(mixer["dt_proj"])
    assert mixer["dt_proj"]["kernel"].dtype == torch.bfloat16
    assert mixer["A_log"].dtype == torch.float32
    jdp = jax.tree.map(np.asarray, jax_decode_params(jparams, jcfg))
    for name in ("in_proj", "x_proj", "out_proj"):
        for k in ("kernel", "scale"):
            np.testing.assert_array_equal(_np(mixer[name][k]), jdp["blocks"]["mixer"][name][k])
    dp0 = _decode_params(params, dataclasses.replace(cfg, serving_weight_dtype="bf16"))
    assert not any(quant.is_quantized(x) for x in (dp0["embedding"],
                                                   dp0["blocks"]["mixer"]["in_proj"]))
    assert quant.param_bytes(_decode_params(params, cfg)) < 0.5 * quant.param_bytes(dp0)


@pytest.mark.parametrize("axis,bias", [(-1, False), (-1, True), (-2, False), (-2, True)])
def test_linear_int8_matches_jax(axis, bias):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((24, 40)).astype(f32) * 0.2
    x = rng.standard_normal((2, 5, 24)).astype(f32)
    jp = dict(jquant.quantize_channels(jnp.asarray(w), axis))
    if bias:
        jp["bias"] = jnp.asarray(rng.standard_normal(40).astype(f32))
    tp = {k: _t(np.asarray(v)) for k, v in jp.items()}
    want = np.asarray(jcommon.linear(jp, jnp.asarray(x), jnp.float32))
    got = _np(linear(tp, _t(x), torch.float32))
    np.testing.assert_allclose(got, want, **TOL)


# ------------------------------------------------------------ int8 KV pages


def _cfgs(**kw):
    base = dict(d_model=64, n_layer=2, vocab_size=64, headdim=32, d_state=32,
                chunk_size=16, compute_dtype="float32", attn_layer_idx=(1,),
                attn_num_heads=4, attn_num_kv_heads=2, kv_page_tokens=8,
                kv_slot_tokens=64, prefill_chunk_tokens=16, kv_page_dtype="int8", **kw)
    return JaxConfig(**base, remat=False), ModelConfig(**base)


def test_int8_state_and_packing_equal_jax():
    jcfg, cfg = _cfgs()
    for a, b in zip(tatt.init_attention_state(cfg, 2, 20),
                    jatt.init_attention_state(jcfg, 2, 20)):
        assert a.dtype == {np.dtype(np.int8): torch.int8,
                           np.dtype(f32): torch.float32}[np.asarray(b).dtype]
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    rng = np.random.default_rng(4)
    k = rng.standard_normal((2, 19, 2, 16)).astype(f32)
    v = rng.standard_normal((2, 19, 2, 16)).astype(f32) * 3
    got = tatt.pack_attention_pages(cfg, _t(k), _t(v), 27)
    want = jatt.pack_attention_pages(jcfg, jnp.asarray(k), jnp.asarray(v), 27)
    assert len(got) == 4 and got[0].dtype == torch.int8
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def int8_pool(rng, P, nkv, pg, hd):
    """Garbage int8 codes in [-127, 127] and positive scales."""
    pages = [rng.integers(-127, 128, (P, nkv, pg, hd)).astype(np.int8) for _ in range(2)]
    scales = [(rng.random((P, nkv)) * 0.05 + 0.001).astype(f32) for _ in range(2)]
    return pages, scales


@pytest.mark.parametrize("nh", [2, 6, 8])  # GQA rep 1, 3, 4
def test_decode_plain_int8_matches_jax_kernel(nh):
    """The rows of tests/test_quant_serving.py::test_ragged_decode_kernel_vs_lax_int8:
    a dead row, a mid-page length and a multi-page length."""
    rng = np.random.default_rng(nh)
    S, W, nkv, pg, hd = 3, 4, 2, 8, 16
    P = 1 + S * W
    (kq, vq), (ks, vs) = int8_pool(rng, P, nkv, pg, hd)
    tbl = (1 + rng.permutation(P - 1)).reshape(S, W).astype(np.int32)
    kv_len = np.asarray([0, 5, 29], np.int32)
    q = rng.standard_normal((S, nh, hd)).astype(f32)
    args = (q, kq, vq, tbl, kv_len)
    ref = np.asarray(jax_decode(*map(jnp.asarray, args), k_scale=jnp.asarray(ks),
                                v_scale=jnp.asarray(vs), interpret=True))
    before = dict(LAUNCHES)
    got = _np(kern.ragged_paged_decode_attention(*map(_t, args), _t(ks), _t(vs)))
    assert LAUNCHES == before  # a CPU tensor takes the plain version
    live = kv_len > 0
    np.testing.assert_allclose(got[live], ref[live], **TOL)
    assert (got[~live] == 0).all()


def prefill_int8_case(seed, b=3, c=16, nh=8, nkv=2, hd=32, pg=8, W=8, P=29,
                      lens=(0, 5, 17), reals=(16, 11, 16), stale=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, c, nh, hd)).astype(f32)
    kc = rng.standard_normal((b, c, nkv, hd)).astype(f32)
    vc = rng.standard_normal((b, c, nkv, hd)).astype(f32)
    (kp, vp), (kso, vso) = int8_pool(rng, P, nkv, pg, hd)
    tbl = (1 + rng.permutation(P - 1)[:b * W]).reshape(b, W).astype(np.int32)
    lengths = np.asarray((list(lens) * (1 + b // len(lens)))[:b], np.int32)
    if stale:
        # recycled pages (no token of their row before this chunk): a
        # stale scale far above the fresh rows'
        fresh = tbl[np.arange(W)[None, :] * pg >= lengths[:, None]]
        kso[fresh] *= 1000
        vso[fresh] *= 1000
    creal = np.asarray((list(reals) * (1 + b // len(reals)))[:b], np.int32)
    real = np.arange(c)[None, :] >= (c - creal)[:, None]
    ksn, vsn, _ = jatt._chunk_page_scales(
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(real), jnp.asarray(tbl),
        jnp.asarray(lengths), jnp.asarray(creal), jnp.asarray(kso), jnp.asarray(vso), pg)
    return (q, kc, vc, kp, vp, tbl, lengths, creal,
            kso, vso, np.asarray(ksn), np.asarray(vsn)), real


@pytest.mark.parametrize("case", [
    # the mixes of tests/test_torch_attention.py::test_prefill_plain_matches_jax_kernel
    dict(lens=(0, 5, 17), reals=(16, 11, 16)),
    dict(lens=(0, 9, 0), reals=(0, 16, 7)),
    dict(lens=(12,), reals=(16,), b=2),
    dict(lens=(48,), reals=(16,), b=2, W=8),
    dict(nh=4, nkv=1, hd=64, pg=16, W=4, lens=(3, 20), reals=(16, 16)),
    dict(lens=(12, 4), reals=(0, 16), b=2),
    # a page-straddling resume, a fresh row with a left pad, an all-pad row
    dict(lens=(6, 0, 30), reals=(16, 10, 0)),
    # recycled pages: stale scales and garbage codes
    dict(lens=(0, 8, 3), reals=(16, 12, 16), stale=True),
])
def test_prefill_plain_int8_matches_jax_kernel(case):
    inp, real = prefill_int8_case(11, **case)
    j = dict(zip(("k_scale_old", "v_scale_old", "k_scale_new", "v_scale_new"),
                 map(jnp.asarray, inp[8:])))
    ro, rkp, rvp = map(np.asarray, jax_prefill(*map(jnp.asarray, inp[:8]), **j,
                                               interpret=True))
    before = dict(LAUNCHES)
    scales = [_t(a) for a in inp[8:]]
    go, gkp, gvp = map(_np, kern.ragged_paged_prefill_attention(*map(_t, inp[:8]), *scales))
    assert LAUNCHES == before
    np.testing.assert_allclose(go[real], ro[real], **TOL)
    assert not np.isnan(go).any()
    np.testing.assert_array_equal(gkp[1:], rkp[1:])
    np.testing.assert_array_equal(gvp[1:], rvp[1:])
    for a, b in zip(scales, inp[8:]):  # read, never written
        np.testing.assert_array_equal(_np(a), b)
    # the port's scale plan equals the JAX one on every page but the trash page
    kn, vn = tatt._chunk_page_scales(*map(_t, (inp[1], inp[2], real, inp[5], inp[6],
                                               inp[7], inp[8], inp[9])), inp[3].shape[2])
    np.testing.assert_array_equal(_np(kn)[1:], inp[10][1:])
    np.testing.assert_array_equal(_np(vn)[1:], inp[11][1:])


def _close_pages(got, want):
    """int8 codes within 1 and scales within 1e-5 relative, page 0 aside."""
    gk, gv, gks, gvs = map(_np, got)
    wk, wv, wks, wvs = map(np.asarray, want)
    for a, b in ((gk, wk), (gv, wv)):
        assert np.abs(a[1:].astype(np.int32) - b[1:].astype(np.int32)).max() <= 1
    np.testing.assert_allclose(gks[1:], wks[1:], rtol=1e-5, atol=0)
    np.testing.assert_allclose(gvs[1:], wvs[1:], rtol=1e-5, atol=0)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_attention_mixer_int8_matches_jax(impl):
    """A chunk on garbage pages (a mid-page resume and a fresh row with a
    left pad), then three decode steps, one with a masked row: outputs,
    codes and scales against JAX; the masked row's pages stay as they
    were, only the trash page moves."""
    jcfg, cfg = _cfgs(attn_impl=impl)
    jp = jatt.init_attention_params(jax.random.PRNGKey(0), jcfg)
    tp = jax.tree.map(lambda a: _t(np.asarray(a)), jp)
    rng = np.random.default_rng(6)
    b, c, W = 2, 16, 8
    pages, scales = int8_pool(rng, 1 + b * W, 2, 8, 16)
    kv_np = (*pages, *scales)
    kv_j = tuple(map(jnp.asarray, kv_np))
    kv_t = tuple(map(_t, kv_np))
    tbl = (1 + np.arange(b * W, dtype=np.int32)).reshape(b, W)
    lengths = np.asarray([5, 0], np.int32)
    u = rng.standard_normal((b, c, 64)).astype(f32)
    mask = np.ones((b, c), f32)
    mask[1, :6] = 0.0
    j_chunk = jax.jit(jatt.attention_mixer_chunk, static_argnums=1)
    j_step = jax.jit(jatt.attention_mixer_step, static_argnums=1)
    yj, kv_j = j_chunk(jp, jcfg, jnp.asarray(u), kv_j, jnp.asarray(tbl),
                       jnp.asarray(lengths), token_mask=jnp.asarray(mask))
    yt, kv_out = tatt.attention_mixer_chunk(tp, cfg, _t(u), kv_t, _t(tbl), _t(lengths),
                                            token_mask=_t(mask))
    assert all(a is b_ for a, b_ in zip(kv_out, kv_t))  # written in place
    np.testing.assert_allclose(_np(yt)[0], np.asarray(yj)[0], **TOL)
    np.testing.assert_allclose(_np(yt)[1, 6:], np.asarray(yj)[1, 6:], **TOL)
    _close_pages(kv_t, kv_j)
    lengths = lengths + mask.sum(1).astype(np.int32)
    for i, wm in enumerate(([True, True], [True, False], None)):
        ut = rng.standard_normal((b, 64)).astype(f32)
        wm = None if wm is None else np.asarray(wm)
        before = [x.clone() for x in kv_t]
        yj, kv_j = j_step(
            jp, jcfg, jnp.asarray(ut), kv_j, jnp.asarray(tbl), jnp.asarray(lengths + i),
            write_mask=None if wm is None else jnp.asarray(wm))
        yt, _ = tatt.attention_mixer_step(tp, cfg, _t(ut), kv_t, _t(tbl), _t(lengths + i),
                                          write_mask=None if wm is None else _t(wm))
        np.testing.assert_allclose(_np(yt), np.asarray(yj), **TOL)
        _close_pages(kv_t, kv_j)
        if wm is not None and not wm[1]:
            rows = tbl[1]
            for a, bf in zip(kv_t, before):
                assert torch.equal(a[rows], bf[rows])


# ---------------------------------------------------------- whole slices


@pytest.mark.parametrize("name,lens", [
    ("hybrid-tiny", (150,)),      # int8 weights and int8 pages; a left pad and two chunks
    ("mamba2-tiny", (9, 150)),    # int8 weights; one-shot and chunked
    ("mamba1", (9, 40)),          # int8 weights; one-shot and chunked
])
def test_int8_generate_matches_jax_greedy(name, lens, request):
    if name == "mamba2-tiny":
        pair = _pair(dict(get_preset(name).__dict__, compute_dtype="float32",
                          serving_weight_dtype="int8"))
    else:
        pair = request.getfixturevalue(name.replace("-", "_"))
    jcfg, jparams, cfg, params = pair
    for i, t in enumerate(lens):
        p = _prompt(70 + i, t, vocab=cfg.vocab_size)
        want = jax_generate(jparams, jcfg, jnp.asarray(p[None].astype(np.int32)),
                            jax.random.PRNGKey(0), max_new_tokens=8, top_k=1)
        got = generate(params, cfg, torch.from_numpy(p)[None], max_new_tokens=8, top_k=1)
        assert got[0].tolist() == np.asarray(want)[0].tolist(), t


def test_int8_hybrid_engine_matches_generate():
    """Three sampled requests (one, two and four chunks) through a 2-slot
    int8 hybrid engine: every stream equals the port's solo generate()
    at the engine's row count; no page leaks."""
    cfg = ModelConfig(d_model=32, n_layer=2, vocab_size=64, headdim=8, chunk_size=16,
                      d_state=16, compute_dtype="float32", attn_layer_idx=(1,),
                      attn_num_heads=4, attn_num_kv_heads=2, kv_page_tokens=8,
                      kv_slot_tokens=64, prefill_chunk_tokens=16,
                      prefill_tokens_per_tick=16, kv_page_dtype="int8",
                      serving_weight_dtype="int8")
    from mamba_distributed_tpu_torch.models.lm import init_lm_params

    params = init_lm_params(cfg, torch.Generator().manual_seed(3))
    reqs = [GenerationRequest(prompt_ids=_prompt(80 + i, t), max_new_tokens=n, top_k=5,
                              temperature=0.8, seed=20 + i)
            for i, (t, n) in enumerate(((9, 6), (27, 5), (53, 7)))]
    eng = ServingEngine(params, cfg, capacity=2, max_top_k=5, tokens_per_tick=2,
                        device="cpu")
    assert len(eng.pool["state"]["attn_blocks"]) == 4
    results = eng.run(reqs)
    for r, res in zip(reqs, results):
        want = generate(params, cfg, torch.from_numpy(r.prompt_ids)[None], seed=r.seed,
                        max_new_tokens=r.max_new_tokens, top_k=5, temperature=0.8,
                        decode_rows=2)[0, len(r.prompt_ids):]
        assert res.new_tokens.tolist() == want.tolist()
    assert eng.page_pool.pages_in_use == 0


# ------------------------------------------------ shape check, rescale helper


def test_kernel_shape_check_refuses_unbuilt_shapes_at_build_time():
    bad = ModelConfig(d_model=32, n_layer=2, vocab_size=64, headdim=8, d_state=16,
                      chunk_size=16, ssm_impl="pallas")
    with pytest.raises(ValueError, match=r"\(headdim, d_state\)=\(8, 16\); built"):
        ServingEngine({}, bad, device="cuda")
    with pytest.raises(ValueError, match=r"\(8, 16\)"):
        Trainer(get_train_preset("mamba2-tiny", model=bad), device="cuda")
    with pytest.raises(ValueError, match="d_state=32; built: \\[16\\]"):
        check_kernel_shapes(dataclasses.replace(get_preset("mamba1-280m"), d_state=32,
                                                ssm_impl="pallas"))
    with pytest.raises(ValueError, match="flash kernels are not built for head dim 48"):
        check_kernel_shapes(get_preset("hybrid-280m", attn_head_dim=48))
    with pytest.raises(ValueError, match="GQA rep 65"):
        check_kernel_shapes(get_preset("hybrid-280m", attn_num_heads=130,
                                       attn_num_kv_heads=2, attn_head_dim=64))
    # the plain versions serve any shape: "xla", and a CPU build
    check_kernel_shapes(dataclasses.replace(bad, ssm_impl="xla"))
    check_kernel_shapes(get_preset("hybrid-280m", attn_head_dim=48, attn_impl="xla"))
    ServingEngine(convert.params_from_jax(jax.tree.map(np.asarray, jax_init(
        jax.random.PRNGKey(0), JaxConfig(**dict(bad.__dict__, remat=False))))), bad,
        device="cpu")
    for name in ("mamba2-tiny", "hybrid-tiny", "mamba2-280m", "hybrid-280m", "mamba1-280m"):
        check_kernel_shapes(get_preset(name, ssm_impl="pallas"))


@pytest.mark.parametrize("d_intermediate", [0, 64])
def test_out_proj_rescale_matches_jax_init(d_intermediate):
    """The helper against the depth rescale the JAX init applies, read
    back from the out-projection's range: U(+-1/sqrt(fan_in)) / rescale,
    whose max |w| over 2,048+ draws is within 0.5% of its bound."""
    n_layer = 3
    want = out_proj_rescale(n_layer, d_intermediate)
    assert want == pytest.approx(((2 if d_intermediate else 1) * n_layer) ** 0.5)
    base = dict(d_model=32, n_layer=n_layer, d_intermediate=d_intermediate, headdim=8,
                d_state=16, vocab_size=64)
    inits = [(jax_init_m2, JaxConfig(**base)),
             (jax_init_m1, JaxConfig(**base, ssm_layer="mamba1")),
             (jatt.init_attention_params, JaxConfig(**base, attn_layer_idx=(1,),
                                                    attn_num_heads=4))]
    for init, jcfg in inits:
        w = np.asarray(init(jax.random.PRNGKey(1), jcfg)["out_proj"]["kernel"])
        got = (1.0 / np.sqrt(w.shape[0])) / np.abs(w).max()
        assert got == pytest.approx(want, rel=5e-3), init.__module__
