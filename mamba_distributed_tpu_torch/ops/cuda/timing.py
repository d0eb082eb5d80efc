"""Timing, bounds and timed cases of the hand kernels on the card, shared
by ``chip_smoke.py`` and ``profile_flash.py``.

The rates are the H100 SXM data sheet's; a kernel's bound is the larger
of its bytes over the memory rate and its operations over the dense
bf16 tensor-core rate.  The paged-prefill cases (``rpp_case``) are the
inputs of ``ragged_paged_prefill_attention``, made on the card from a
``torch.Generator``.  Nothing here touches the card at import time.
"""

from __future__ import annotations

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms of ``fn`` over ``iters`` calls after ``warmup`` calls, by
    CUDA events around the whole loop."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> dict[str, float]:
    """Device ms per call of each kernel ``fn`` launches, by ``torch.profiler``
    over ``iters`` calls after one warm-up call: the kernels' own time,
    where ``cuda_ms`` also counts the gaps of a loop whose host side is
    slower than its kernels."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def bound(nbytes, flops) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for moving ``nbytes`` and
    doing ``flops`` bf16 operations on the card."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def rel_err(got, ref) -> tuple[float, float]:
    """(max |got - ref|, that over max |ref|)."""
    err = float((got.float() - ref.float()).abs().max())
    return err, err / max(float(ref.float().abs().max()), 1e-6)


# ----------------------------------------------------- paged prefill cases

# the timed paged prefill: the second 256-token chunk of a 700-token
# prompt at hybrid-280m's attention (b, c, nh, nkv, pg, W, lengths,
# chunk_real)
RPP_TIMED = (1, 256, 12, 4, 64, 16, [188], [256])


def paged_pool(gen, P, nkv, pg, hd, dtype):
    """Random K and V page pools (P, nkv, pg, hd) on the card."""
    shape = (P, nkv, pg, hd)
    return (torch.randn(shape, generator=gen, device="cuda").to(dtype),
            torch.randn(shape, generator=gen, device="cuda").to(dtype))


def disjoint_table(gen, rows, W, P):
    """Disjoint per-row pages of [1, P) (the allocator's invariant)."""
    perm = 1 + torch.randperm(P - 1, generator=gen, device="cuda")[:rows * W]
    return perm.reshape(rows, W).to(torch.int32)


def int8_pool(gen, P, nkv, pg, hd):
    """Random int8 K/V pages in [-127, 127] and positive (P, nkv) fp32
    scales, as an int8 pool holds them."""
    shape = (P, nkv, pg, hd)
    pages = [torch.randint(-127, 128, shape, generator=gen, device="cuda").to(torch.int8)
             for _ in range(2)]
    scales = [torch.rand((P, nkv), generator=gen, device="cuda") * 0.05 + 0.001
              for _ in range(2)]
    return pages, scales


def rpp_case(gen, b, c, nh, nkv, pg, W, lens, reals, dtype, quant, stale=False, hd=64):
    """The arguments of ``ragged_paged_prefill_attention`` for one mix, and
    the (b, c) mask of real chunk rows.  Int8 pages (``quant``) take old
    scales from the pool and new ones from ``models/attention.
    _chunk_page_scales``; ``stale``: pages holding no token of their row
    before this chunk carry old scales 1000x too large, as recycled pages
    do."""
    from mamba_distributed_tpu_torch.models.attention import _chunk_page_scales

    P = 1 + b * W
    q = torch.randn((b, c, nh, hd), generator=gen, device="cuda").to(dtype)
    kc = torch.randn((b, c, nkv, hd), generator=gen, device="cuda").to(dtype)
    vc = torch.randn((b, c, nkv, hd), generator=gen, device="cuda").to(dtype)
    tbl = disjoint_table(gen, b, W, P)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    cr = torch.tensor(reals, dtype=torch.int32, device="cuda")
    real = torch.arange(c, device="cuda")[None, :] >= (c - cr)[:, None]
    if quant:
        (kp, vp), (kso, vso) = int8_pool(gen, P, nkv, pg, hd)
        if stale:
            col = torch.arange(W, device="cuda")[None, :] * pg
            fresh = tbl[col >= ln[:, None]].long()
            kso[fresh] *= 1000
            vso[fresh] *= 1000
        scales = [kso, vso, *_chunk_page_scales(kc, vc, real, tbl, ln, cr, kso, vso, pg)]
    else:
        (kp, vp), scales = paged_pool(gen, P, nkv, pg, hd, dtype), []
    return (q, kc, vc, kp, vp, tbl, ln, cr, *scales), real


def rpp_work(args) -> tuple[int, int]:
    """(bytes, flops) of one batch-1 paged prefill on ``rpp_case``'s
    arguments: the prefix pages read, the chunk's rows written, the chunk
    K/V, q and o, the table and lengths, and for int8 pages the old and
    new scales of the write window's pages and the new ones of the prefix
    pages before it; the causal multiply-adds of the chunk's queries
    (2 hd-long products per (query, key) pair)."""
    q, kc, _, kp, _, tbl, ln, cr, *scales = args
    _, c, nh, hd = q.shape
    nkv, pg = kp.shape[1], kp.shape[2]
    lens, reals = int(ln[0]), int(cr[0])
    total = lens + reals
    e, qe = kp.element_size(), q.element_size()
    kv_row = nkv * hd * e
    window = (total - 1) // pg - lens // pg + 1
    live_pages = -(-total // pg)
    nbytes = (lens * 2 * kv_row          # prefix pages read
              + reals * 2 * kv_row       # pages written
              + c * 2 * nkv * hd * qe    # chunk K/V
              + 2 * c * nh * hd * qe     # q, o
              + tbl.numel() * 4 + 8
              + ((4 * window + 2 * (live_pages - window)) * nkv * 4 if scales else 0))
    flops = 4 * nh * hd * sum(p + 1 for p in range(lens, total))
    return nbytes, flops
