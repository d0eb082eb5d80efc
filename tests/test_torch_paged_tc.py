"""The tensor-core paged prefill attend (``rpp_attend_tc_kernel``) from the
CPU: its dispatch rule, the pool layout its TMA copies need, and a plain
model of its arithmetic held against the JAX package's prefill kernel in
interpret mode and against the port's plain version.

The kernel itself runs only on the card (``chip_smoke.py`` holds it
against the plain version there).  Here the rule and the check are plain
Python over dtypes, shapes, strides and addresses, and the model repeats
the kernel's rounding points on the CPU: 64-key tiles inside one page,
scores from bf16 q and bf16 (or int8 codes, exact in bf16) keys with
the page's K scale applied to the fp32 score, an online softmax in fp32,
and P (times the page's V scale for int8 pages) rounded to bf16 for the
PV product.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_distributed_tpu.models import attention as jatt
from mamba_distributed_tpu.ops.pallas.attention_kernels import (
    ragged_paged_prefill_attention as jax_prefill,
)
from mamba_distributed_tpu_torch.config import get_preset
from mamba_distributed_tpu_torch.models.attention import _attn_dims
from mamba_distributed_tpu_torch.ops.cuda import attention_kernels as ak
from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES

pytestmark = pytest.mark.torch

# the bf16 tolerance of the kernel checks (chip_smoke.TOL), as max |got -
# ref| / max |ref|
BF16_TOL = 3e-2
# the model against the JAX kernel, which rounds only q, the written K/V
# and (bf16 pages) p: a few bf16 roundings (2^-9 relative each) of the
# model's P, P * v_scale and output apart; the port's plain version, which
# also rounds each dequantized code * scale to bf16, is held to BF16_TOL
MODEL_TOL = 5e-3
f32 = np.float32


# -------------------------------------------------------------- the rule


@pytest.mark.parametrize("dtype,hd,pg,tc", [
    (torch.bfloat16, 64, 64, True),     # hybrid-280m
    (torch.bfloat16, 32, 64, True),
    (torch.bfloat16, 128, 128, True),
    (torch.bfloat16, 64, 192, True),
    (torch.float32, 64, 64, False),     # fp32 would be TF32 on the tensor cores
    (torch.bfloat16, 48, 64, False),    # head dim not built for wgmma
    (torch.bfloat16, 16, 64, False),
    (torch.bfloat16, 64, 32, False),    # a 64-key tile would cross a page
    (torch.bfloat16, 64, 96, False),
    (torch.bfloat16, 32, 8, False),
])
def test_dispatch_rule(dtype, hd, pg, tc):
    assert ak.rpp_uses_tensor_cores(dtype, hd, pg) is tc


@pytest.mark.parametrize("preset,tc", [("hybrid-280m", True), ("hybrid-tiny", False)])
def test_dispatch_rule_at_the_presets(preset, tc):
    """hybrid-280m's serving shapes (bf16, head dim 64, pages of 64) take
    the tensor-core attend; hybrid-tiny's pages of 32 take the CUDA-core
    one, as does any fp32 compute."""
    cfg = get_preset(preset, compute_dtype="bfloat16")
    _, _, hd, _ = _attn_dims(cfg)
    assert ak.rpp_uses_tensor_cores(cfg.torch_compute_dtype, hd, cfg.kv_page_tokens) is tc
    assert not ak.rpp_uses_tensor_cores(torch.float32, hd, cfg.kv_page_tokens)


# ------------------------------------------------------- the pool layout


class _NoLaunch:
    """A stand-in library that fails the test if the wrapper calls into it."""

    def __getattr__(self, name):
        raise AssertionError(f"{name} was called")


def _prefill(monkeypatch, k_pages, v_pages, dtype=torch.bfloat16):
    """The prefill wrapper on the kernel route (forced here on CPU tensors)
    with a stand-in library: it raises a ValueError where its checks
    refuse the inputs, else an AssertionError at the launch."""
    monkeypatch.setattr(ak, "use_kernel", lambda impl, x: True)
    P, nkv, pg, hd = k_pages.shape
    b, c, nh = 1, 8, 2 * nkv
    q = torch.zeros((b, c, nh, hd), dtype=dtype)
    kc = torch.zeros((b, c, nkv, hd), dtype=dtype)
    tbl = torch.arange(1, 3, dtype=torch.int32).reshape(b, 2)
    lens = torch.zeros(b, dtype=torch.int32)
    scales = ([torch.ones((P, nkv)) for _ in range(4)] if k_pages.dtype == torch.int8
              else [])
    before = dict(LAUNCHES)
    try:
        ak.ragged_paged_prefill_attention(q, kc, kc, k_pages, v_pages, tbl, lens, lens + c,
                                          *scales, lib=_NoLaunch())
    finally:
        assert LAUNCHES == before


def _misaligned(dtype, skip, shape=(5, 2, 64, 32)):
    """A contiguous pool that starts ``skip`` elements past an allocation."""
    pool = torch.zeros(skip + math.prod(shape), dtype=dtype)[skip:].reshape(shape)
    assert pool.is_contiguous() and pool.data_ptr() % 16 == skip * pool.element_size()
    return pool


@pytest.mark.parametrize("dtype,skip,bad", [(torch.bfloat16, 1, "k_pages"),
                                            (torch.int8, 3, "v_pages")])
def test_prefill_wrapper_refuses_a_misaligned_pool_and_names_it(monkeypatch, dtype, skip, bad):
    pools = {"k_pages": torch.zeros(5, 2, 64, 32, dtype=dtype)}
    pools["v_pages"] = pools["k_pages"].clone()
    pools[bad] = _misaligned(dtype, skip)
    off = skip * pools[bad].element_size()
    with pytest.raises(ValueError, match=rf"ragged_paged_prefill_attention: {bad} cannot be "
                                         rf"read by TMA: its data starts at byte {off} past a "
                                         rf"16-byte boundary"):
        _prefill(monkeypatch, pools["k_pages"], pools["v_pages"])


def test_prefill_wrapper_refuses_a_non_contiguous_pool_and_names_it(monkeypatch):
    bad = torch.zeros(2, 5, 64, 32, dtype=torch.bfloat16).transpose(0, 1)
    with pytest.raises(ValueError, match=r"k_pages must be contiguous"):
        _prefill(monkeypatch, bad, torch.zeros(5, 2, 64, 32, dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_prefill_wrapper_takes_a_fresh_pool_to_the_launch(monkeypatch, dtype):
    pool = torch.zeros(5, 2, 64, 32, dtype=dtype)
    with pytest.raises(AssertionError, match="mdt_rpp_fwd was called"):
        _prefill(monkeypatch, pool, pool.clone())


def test_fp32_prefill_takes_any_pool_start(monkeypatch):
    """fp32 q runs the CUDA-core attend, which reads the pools without TMA:
    a misaligned pool passes the checks and reaches the launch."""
    pool = _misaligned(torch.float32, 1)
    with pytest.raises(AssertionError, match="mdt_rpp_fwd was called"):
        _prefill(monkeypatch, pool, pool.clone(), dtype=torch.float32)


# -------------------------------------------- a plain model of the kernel


def tc_attend_model(q, k_pages, v_pages, page_table, lengths, chunk_real,
                    k_scale=None, v_scale=None):
    """The tensor-core attend's arithmetic over the pool as the write left
    it: per row and KV head, 64-key tiles inside one page; s = (bf16 q .
    k) * sm_scale, where int8 codes are exact in bf16 and the page's
    ``k_scale`` multiplies sm_scale; masked to kpos <= qpos and kpos <
    total; online softmax in fp32 with den summing the unrounded p; PV
    from p (times the page's ``v_scale`` for int8 pages) rounded to bf16;
    out = acc / max(den, 1e-30) in bf16.  Tiles past a query's position
    are fully masked for it and change nothing, so the model walks every
    tile up to the row's total."""
    b, c, nh, hd = q.shape
    nkv, pg = k_pages.shape[1], k_pages.shape[2]
    rep, W, tile = nh // nkv, page_table.shape[1], ak.TC_KEYS
    sm_scale = 1.0 / math.sqrt(hd)
    out = torch.zeros((b, c, nh, hd))
    for r in range(b):
        ln, creal = int(lengths[r]), int(chunk_real[r])
        total = min(ln + creal, W * pg)
        qpos = (ln + torch.arange(c) - (c - creal)).clamp(min=0)
        for g in range(nkv):
            qg = q[r, :, g * rep:(g + 1) * rep].to(torch.bfloat16).float()   # (c, rep, hd)
            m = torch.full((c, rep), float("-inf"))
            den = torch.zeros((c, rep))
            acc = torch.zeros((c, rep, hd))
            for k0 in range(0, total, tile):
                phys, t0 = int(page_table[r, k0 // pg]), k0 % pg
                kt = k_pages[phys, g, t0:t0 + tile].float()
                vt = v_pages[phys, g, t0:t0 + tile].float()
                kmul = sm_scale * (1.0 if k_scale is None else float(k_scale[phys, g]))
                s = torch.einsum("crh,kh->crk", qg, kt) * kmul
                kpos = k0 + torch.arange(tile)
                keep = (kpos[None, None, :] <= qpos[:, None, None]) & (kpos < total)
                s = torch.where(keep, s, float("-inf"))
                m_new = torch.maximum(m, s.amax(dim=-1))
                alpha = torch.where(m > float("-inf"), torch.exp(m - m_new), 0.0)
                p = torch.where(s > float("-inf"), torch.exp(s - m_new[..., None]), 0.0)
                den = den * alpha + p.sum(dim=-1)
                if v_scale is not None:
                    p = p * float(v_scale[phys, g])
                pv = torch.einsum("crk,kh->crh", p.to(torch.bfloat16).float(), vt)
                acc = acc * alpha[..., None] + pv
                m = m_new
            out[r, :, g * rep:(g + 1) * rep] = acc / den.clamp(min=1e-30)[..., None]
    return out.to(torch.bfloat16)


def _rel(got, ref):
    got, ref = np.asarray(got, f32), np.asarray(ref, f32)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6))


def _bf16(rng, shape):
    """Standard normal values that bf16 holds exactly, as fp32."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(f32))
    return x.to(torch.bfloat16).float().numpy()


def tiny_case(seed, quant, lens, reals, b=3, c=64, nh=4, nkv=2, hd=32, pg=64, W=4,
              stale=False):
    """A chunk at hybrid-tiny's attention widths (4 query / 2 KV heads of 32)
    on pages of 64 tokens: bf16-exact fp32 q and chunk K/V, a garbage pool
    (int8 codes and scales, or bf16-exact values), disjoint tables, and for
    int8 the new scales of the JAX package's ``_chunk_page_scales``."""
    rng = np.random.default_rng(seed)
    P = 1 + b * W
    q, kc, vc = (_bf16(rng, (b, c, n, hd)) for n in (nh, nkv, nkv))
    tbl = (1 + rng.permutation(P - 1)[:b * W]).reshape(b, W).astype(np.int32)
    lengths = np.asarray(lens, np.int32)
    creal = np.asarray(reals, np.int32)
    if not quant:
        kp, vp = (_bf16(rng, (P, nkv, pg, hd)) for _ in range(2))
        return (q, kc, vc, kp, vp, tbl, lengths, creal), ()
    kp, vp = (rng.integers(-127, 128, (P, nkv, pg, hd)).astype(np.int8) for _ in range(2))
    kso, vso = ((rng.random((P, nkv)) * 0.05 + 0.001).astype(f32) for _ in range(2))
    if stale:
        fresh = tbl[np.arange(W)[None, :] * pg >= lengths[:, None]]
        kso[fresh] *= 1000
        vso[fresh] *= 1000
    real = np.arange(c)[None, :] >= (c - creal)[:, None]
    ksn, vsn, _ = jatt._chunk_page_scales(
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(real), jnp.asarray(tbl),
        jnp.asarray(lengths), jnp.asarray(creal), jnp.asarray(kso), jnp.asarray(vso), pg)
    return (q, kc, vc, kp, vp, tbl, lengths, creal), (kso, vso, np.asarray(ksn),
                                                      np.asarray(vsn))


MIXES = [
    dict(lens=(0, 40, 100), reals=(64, 50, 30)),    # fresh, mid-page resume, a third tile
    dict(lens=(0, 64, 130), reals=(0, 64, 64)),     # a row with chunk_real 0, page edges
]


@pytest.mark.parametrize("quant,case", [
    *((True, m) for m in MIXES),
    (True, dict(lens=(0, 8, 3), reals=(64, 60, 64), stale=True)),   # recycled pages
    *((False, m) for m in MIXES),
])
def test_tc_model_matches_jax_kernel_and_plain(quant, case):
    """The model of the tensor-core rounding within ``MODEL_TOL`` of the
    JAX package's prefill kernel (interpret mode; int8: its int8 branch,
    which keeps p in fp32 and dequantizes in fp32) and within the bf16
    tolerance of the port's plain version (bf16 q; int8: a gather
    dequantized into bf16).  For int8 pages rounding P * v_scale to bf16
    moves each PV term by at most 2^-9 relative; every other difference
    is summation order."""
    inp, scales = tiny_case(5, quant, **case)
    b, c = inp[0].shape[:2]
    real = np.arange(c)[None, :] >= (c - inp[7])[:, None]
    j_scales = dict(zip(("k_scale_old", "v_scale_old", "k_scale_new", "v_scale_new"),
                        map(jnp.asarray, scales)))
    if quant:
        pages = [jnp.asarray(a) for a in inp[3:5]]
    else:
        pages = [jnp.asarray(a).astype(jnp.bfloat16) for a in inp[3:5]]
    ro, rkp, rvp = jax_prefill(*map(jnp.asarray, inp[:3]), *pages,
                               *map(jnp.asarray, inp[5:8]), **j_scales, interpret=True)
    ro = np.asarray(ro.astype(jnp.float32))

    # the port's plain version, in bf16 (pages bf16 or int8), writes the same pages
    t = [torch.from_numpy(np.array(a)) for a in inp]
    qb, kcb, vcb = (x.to(torch.bfloat16) for x in t[:3])
    kp, vp = (x if quant else x.to(torch.bfloat16) for x in t[3:5])
    tscales = [torch.from_numpy(np.array(s)) for s in scales]
    before = dict(LAUNCHES)
    po, pkp, pvp = ak.ragged_paged_prefill_attention(qb, kcb, vcb, kp, vp, *t[5:8], *tscales)
    assert LAUNCHES == before  # a CPU tensor takes the plain version
    np.testing.assert_array_equal(pkp[1:].float().numpy(),
                                  np.asarray(rkp[1:].astype(jnp.float32)))
    np.testing.assert_array_equal(pvp[1:].float().numpy(),
                                  np.asarray(rvp[1:].astype(jnp.float32)))

    ks, vs = (tscales[2], tscales[3]) if quant else (None, None)
    mo = tc_attend_model(qb, pkp, pvp, *t[5:8], ks, vs).float().numpy()
    assert np.isfinite(mo[real]).all()
    assert _rel(mo[real], ro[real]) < MODEL_TOL
    assert _rel(mo[real], po.float().numpy()[real]) < BF16_TOL
