"""The split-K paged decode (``rpa_split_kernel``) from the CPU: a plain
model of its arithmetic held against the JAX package's decode kernel in
interpret mode and against the port's plain version, its split rule, and
the wrapper's workspace glue.

The kernel itself runs only on the card (``chip_smoke.py`` holds it
against the plain version there).  The model repeats its arithmetic on the
CPU: each row's pages cut into ranges of ``rpa_split_pages`` whole pages;
inside a range, steps of the kernel's key count that never cross a page,
dealt in turn to the range's four warps; fp32 scores (int8 pages: the
page's K scale times sm_scale); each warp's running maximum taken per
step, p rounded to V's dtype against it (int8 pages: p unrounded, times
the page's V scale); each warp's (m, den, acc) in fp32, merged in warp
order into the range's, the ranges merged in range order, each with
weights exp(m_part - m_all); out = acc / max(den, 1e-30).  The JAX kernel
keeps one running maximum over whole pages instead, so the two round p
against different maxima: a bf16 difference, held to the bf16 tolerance.
"""

from __future__ import annotations

import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_distributed_tpu.ops.pallas.attention_kernels import (
    ragged_paged_decode_attention as jax_decode,
)
from mamba_distributed_tpu_torch.config import get_preset
from mamba_distributed_tpu_torch.models.attention import _attn_dims
from mamba_distributed_tpu_torch.ops.cuda import attention_kernels as ak
from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES

pytestmark = pytest.mark.torch

# chip_smoke.TOL, as max |got - ref| / max |ref|: fp32 differs by
# summation order only; bf16 and int8 pages also by where p is rounded
TOL = {"fp32": 1e-4, "bf16": 3e-2, "int8": 3e-2}
WARPS = 4  # warps of a range's CTA (``kDecWarps``)
f32 = np.float32


def kernel_step_keys(page_dtype: torch.dtype, hd: int) -> int:
    """Keys per step of the kernel's page walk: 4 per lane group, 32 / Lk
    groups, Lk the lanes that cover a key's hd elements at 16 bytes a lane
    (8 bytes of int8 codes), rounded up to a power of two."""
    vn = 4 if page_dtype == torch.float32 else 8
    lanes = 1
    while lanes * vn < hd:
        lanes *= 2
    return 4 * (32 // lanes)


def _merge(parts, rep, hd):
    """(m, den, acc) partials merged in order with weights exp(m - m_all)
    (a partial with m = -inf adds nothing)."""
    ninf = float("-inf")
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    dsum, asum = torch.zeros(rep), torch.zeros(rep, hd)
    for m, den, acc in parts:
        f = torch.where(m > ninf, torch.exp(m - mx), 0.0)
        dsum = dsum + den * f
        asum = asum + acc * f[:, None]
    return mx, dsum, asum


def split_decode_model(q, k_pages, v_pages, page_table, kv_len, k_scale=None, v_scale=None,
                       *, splits=None, step=None, warps=WARPS):
    """The split decode's arithmetic (see the module docstring) on CPU
    tensors: ``splits`` page ranges (default: the kernel's rule) walked in
    steps of ``step`` keys (default: the kernel's) dealt to ``warps``
    warps.  Returns (S, nh, hd) in q's dtype."""
    S, nh, hd = q.shape
    nkv, pg = k_pages.shape[1], k_pages.shape[2]
    W = page_table.shape[1]
    rep = nh // nkv
    quant = k_scale is not None
    pps = (ak.rpa_split_pages(S, nkv, W) if splits is None else -(-W // splits))
    n_ranges = -(-W // pps)
    step = kernel_step_keys(k_pages.dtype, hd) if step is None else step
    sm_scale = 1.0 / math.sqrt(hd)
    ninf = float("-inf")
    out = torch.zeros((S, nh, hd))
    for s in range(S):
        live = min(int(kv_len[s]), W * pg)
        for g in range(nkv):
            qg = q[s, g * rep:(g + 1) * rep].float()
            ranges = []
            for r in range(n_ranges):
                lo, hi = r * pps * pg, min((r + 1) * pps * pg, live)
                steps, k = [], lo  # (first key, end) of each step
                while k < hi:
                    e = min(k + step, (k // pg + 1) * pg, hi)
                    steps.append((k, e))
                    k = e
                warp_parts = []
                for w in range(warps):
                    m = torch.full((rep,), ninf)
                    den, acc = torch.zeros(rep), torch.zeros(rep, hd)
                    for k, e in steps[w::warps]:
                        j = k // pg
                        phys, t0 = int(page_table[s, j]), k - j * pg
                        kt = k_pages[phys, g, t0:t0 + e - k].float()
                        vt = v_pages[phys, g, t0:t0 + e - k].float()
                        kmul = sm_scale * (float(k_scale[phys, g]) if quant else 1.0)
                        sc = (qg @ kt.T) * kmul
                        m_new = torch.maximum(m, sc.amax(-1))
                        alpha = torch.where(m > ninf, torch.exp(m - m_new), 0.0)
                        p = torch.exp(sc - m_new[:, None])
                        den = den * alpha + p.sum(-1)
                        pv = (p * float(v_scale[phys, g]) if quant
                              else p.to(v_pages.dtype).float())
                        acc = acc * alpha[:, None] + pv @ vt
                        m = m_new
                    warp_parts.append((m, den, acc))
                ranges.append(_merge(warp_parts, rep, hd))
            _, dsum, asum = _merge(ranges, rep, hd)
            out[s, g * rep:(g + 1) * rep] = asum / dsum.clamp(min=1e-30)[:, None]
    return out.to(q.dtype)


def _rel(got, ref):
    got, ref = np.asarray(got, f32), np.asarray(ref, f32)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6))


def decode_case(seed, pages, S=5, nh=6, nkv=2, hd=32, pg=8, W=6,
                lens=(0, 1, 13, 16, None)):
    """A ragged decode mix at GQA rep 3 (hybrid-280m's): kv_len 0, 1,
    mid-page, an exact page multiple and a full table (None), disjoint
    tables (page 0 = trash); values that bf16 holds exactly; ``pages``
    "fp32", "bf16" or "int8" (codes and positive scales).  Returns numpy
    arrays (q, k_pages, v_pages, table, kv_len[, k_scale, v_scale])."""
    rng = np.random.default_rng(seed)
    P = 1 + S * W

    def bf16_exact(shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(f32))
        return x.to(torch.bfloat16).float().numpy()

    q = bf16_exact((S, nh, hd))
    tbl = (1 + rng.permutation(P - 1)[:S * W]).reshape(S, W).astype(np.int32)
    kv_len = np.asarray([W * pg if n is None else n for n in lens], np.int32)
    if pages == "int8":
        kp, vp = (rng.integers(-127, 128, (P, nkv, pg, hd)).astype(np.int8) for _ in range(2))
        ks, vs = ((rng.random((P, nkv)) * 0.05 + 0.001).astype(f32) for _ in range(2))
        return q, kp, vp, tbl, kv_len, ks, vs
    kp, vp = (bf16_exact((P, nkv, pg, hd)) for _ in range(2))
    return q, kp, vp, tbl, kv_len


def _torch_args(case, pages):
    """The case as CPU tensors in the decode's dtypes: bf16 q and pages,
    fp32 q and pages, or bf16 q with int8 pages and fp32 scales."""
    t = [torch.from_numpy(np.array(a)) for a in case]
    if pages == "fp32":
        return t
    t[0] = t[0].to(torch.bfloat16)
    if pages == "bf16":
        t[1], t[2] = t[1].to(torch.bfloat16), t[2].to(torch.bfloat16)
    return t


def _jax(case, pages):
    a = [jnp.asarray(x) for x in case]
    if pages != "fp32":
        a[0] = a[0].astype(jnp.bfloat16)
    if pages == "bf16":
        a[1], a[2] = a[1].astype(jnp.bfloat16), a[2].astype(jnp.bfloat16)
    ref = jax_decode(*a[:5], *a[5:], interpret=True)
    return np.asarray(ref.astype(jnp.float32))


@pytest.mark.parametrize("pages", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("splits", [1, 2, 3, 6])
def test_split_model_matches_jax_kernel_and_plain(pages, splits):
    """Over split counts 1 to W (6 pages a slot: ranges of 6, 3, 2 and 1
    pages, several of them empty for the short rows), the model agrees
    with the JAX kernel (interpret mode) and with the port's plain version
    within the tolerance of the page type, and emits zeros for kv_len 0."""
    case = decode_case(splits, pages)
    kv_len = case[4]
    live = kv_len > 0
    ref = _jax(case, pages)
    args = _torch_args(case, pages)
    before = dict(LAUNCHES)
    plain = ak.ragged_paged_decode_attention(*args).float().numpy()
    assert LAUNCHES == before  # a CPU tensor takes the plain version
    got = split_decode_model(*args, splits=splits).float().numpy()
    assert np.isfinite(got).all()
    assert (got[~live] == 0).all() and (ref[~live] == 0).all()
    assert _rel(got[live], ref[live]) < TOL[pages]
    assert _rel(got[live], plain[live]) < TOL[pages]


@pytest.mark.parametrize("pages,hd", [("bf16", 64), ("int8", 64), ("fp32", 64), ("bf16", 128)])
def test_split_model_at_the_kernel_steps(pages, hd):
    """The kernel's own split rule and step (8 slots of 16 pages: 8 ranges
    of two pages; steps of 16 keys at hd 64 in bf16 and int8, 8 in fp32 and
    at hd 128) against the JAX kernel."""
    case = decode_case(hd, pages, S=8, nh=12, nkv=4, hd=hd, pg=64, W=16,
                       lens=(0, 37, 128, 1024, 1, 500, 64, 999))
    ref = _jax(case, pages)
    got = split_decode_model(*_torch_args(case, pages)).float().numpy()
    live = case[4] > 0
    assert (got[~live] == 0).all()
    assert _rel(got[live], ref[live]) < TOL[pages]


def test_one_range_with_page_steps_is_the_jax_walk():
    """With one range, one warp and steps of a whole page the model's
    running maximum is the JAX kernel's (per page), so in fp32 the two
    differ by summation order alone."""
    case = decode_case(7, "fp32")
    ref = _jax(case, "fp32")
    got = split_decode_model(*_torch_args(case, "fp32"), splits=1, step=8, warps=1).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("page_dtype,hd,step", [
    (torch.bfloat16, 64, 16), (torch.int8, 64, 16), (torch.float32, 64, 8),
    (torch.bfloat16, 128, 8), (torch.bfloat16, 32, 32), (torch.float32, 128, 4),
    (torch.bfloat16, 36, 16),
])
def test_kernel_step_keys(page_dtype, hd, step):
    assert kernel_step_keys(page_dtype, hd) == step


# ------------------------------------------------------------ the split rule


@pytest.mark.parametrize("preset,capacity,splits,pages", [
    ("hybrid-280m", 8, 8, 2),     # 4 KV heads: 32 (slot, head) pairs, 256 CTAs
    ("hybrid-280m", 64, 2, 8),    # 256 pairs: two ranges of 8 pages
    ("hybrid-280m", 1, 16, 1),
    ("hybrid-tiny", 8, 16, 1),    # 2 KV heads
    ("hybrid-tiny", 128, 2, 8),
])
def test_split_rule_at_the_hybrid_presets(preset, capacity, splits, pages):
    cfg = get_preset(preset)
    _, nkv, _, _ = _attn_dims(cfg)
    W = cfg.kv_pages_per_slot
    assert ak.rpa_splits(capacity, nkv, W) == splits
    assert ak.rpa_split_pages(capacity, nkv, W) == pages


@pytest.mark.parametrize("S", [1, 2, 3, 8, 16, 64, 256, 1024])
@pytest.mark.parametrize("nkv", [1, 2, 4, 8])
@pytest.mark.parametrize("W", [1, 2, 5, 16, 33, 64, 200])
def test_split_rule_covers_the_table_with_nonempty_ranges(S, nkv, W):
    pps, splits = ak.rpa_split_pages(S, nkv, W), ak.rpa_splits(S, nkv, W)
    assert 1 <= splits <= W
    assert (splits - 1) * pps < W <= splits * pps
    # whole-page ranges keep more than half the ranges the rule aims at:
    # enough for SPLIT_TARGET_CTAS CTAs, at most one a page
    aim = min(W, -(-ak.SPLIT_TARGET_CTAS // (S * nkv)))
    assert aim >= splits and 2 * splits > aim


# ------------------------------------------------------- the wrapper's glue


class _Recorder:
    """A stand-in library: records the decode's arguments, launches nothing."""

    def __init__(self):
        self.calls = []
        self.mdt_rpa_fwd = lambda *a: self.calls.append(a) or 0


@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_wrapper_passes_the_rule_and_its_workspace(monkeypatch, pages):
    """On the kernel route (forced here on CPU tensors, with a stand-in
    library and stream) the wrapper passes the split count of the rule and
    an fp32 workspace of splits * S * nh * (hd + 2) floats, and counts one
    launch."""
    monkeypatch.setattr(ak, "use_kernel", lambda impl, x: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    sizes = []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        out = empty(*shape, **kw)
        sizes.append((out.data_ptr(), out.numel(), out.dtype))
        return out

    monkeypatch.setattr(torch, "empty", recording_empty)
    case = decode_case(3, pages)
    args = _torch_args(case, pages)
    S, nh, hd = args[0].shape
    nkv, W = args[1].shape[1], args[3].shape[1]
    lib = _Recorder()
    key = "ragged_decode_int8" if pages == "int8" else "ragged_decode"
    before = LAUNCHES[key]
    out = ak.ragged_paged_decode_attention(*args, lib=lib)
    assert LAUNCHES[key] == before + 1
    assert out.shape == (S, nh, hd) and out.dtype == args[0].dtype
    (call,) = lib.calls
    splits = ak.rpa_splits(S, nkv, W)
    assert call[9:16] == (S, nh, nkv, hd, args[1].shape[2], W, splits)
    assert (call[8], splits * S * nh * (hd + 2), torch.float32) in sizes
    # split_rows: the rule of another row count, its workspace sized to it
    lib.calls.clear()
    ak.ragged_paged_decode_attention(*args, lib=lib, split_rows=64)
    (call,) = lib.calls
    pinned = ak.rpa_splits(64, nkv, W)
    assert pinned != splits and call[15] == pinned
    assert (call[8], pinned * S * nh * (hd + 2), torch.float32) in sizes


def test_pinned_split_reproduces_the_full_launch_rows():
    """Two rows of an 8-row decode, launched alone with the split count
    of 8 rows (what the serving engine's compacted tick does), give the
    8-row launch's rows bit for bit in the kernel's arithmetic (fp32, so
    that no rounding of the output hides a difference); with the rule of
    2 rows, another split count, they differ."""
    gen = torch.Generator().manual_seed(7)
    S, nh, nkv, hd, pg, W = 8, 12, 4, 64, 16, 16
    P = 1 + S * W
    kp = torch.randn((P, nkv, pg, hd), generator=gen)
    vp = torch.randn((P, nkv, pg, hd), generator=gen)
    q = torch.randn((S, nh, hd), generator=gen)
    tbl = torch.arange(1, P, dtype=torch.int32).reshape(S, W)
    lens = torch.tensor([250, 31, 199, 256, 7, 120, 64, 180], dtype=torch.int32)
    full = split_decode_model(q, kp, vp, tbl, lens)
    rows = [2, 5]
    pinned, own = ak.rpa_splits(S, nkv, W), ak.rpa_splits(len(rows), nkv, W)
    assert pinned != own
    part = split_decode_model(q[rows], kp, vp, tbl[rows], lens[rows], splits=pinned)
    assert torch.equal(part, full[rows])
    other = split_decode_model(q[rows], kp, vp, tbl[rows], lens[rows], splits=own)
    assert not torch.equal(other, full[rows])
