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


# ------------------------------------------------------------ SSD forward

# the timed SSD forward: the serving chunk step (b 1, one 256-token chunk,
# seeded) and one layer of the trainer's micro-batch (b 32, t 1024), at
# mamba2-280m's widths: (b, t, chunk, g, seeded)
SSD_TIMED = ((1, 256, 256, 1, True), (32, 1024, 256, 1, False))


def ssd_inputs(gen, b, t, g, dtype, seeded, h=24, p=64, n=128):
    """The SSD forward's inputs on the card at mamba2-280m's widths (24
    heads of 64, d_state 128) unless given: x, B, C as slices of one (b,
    t, h*p + 2*g*n) conv-output-like tensor (so the kernel reads them
    through strides, as in the mixer), dt after softplus, A in -(1..16),
    D ones, an initial state when ``seeded``."""
    dev = "cuda"
    di = h * p
    xbc = torch.randn((b, t, di + 2 * g * n), generator=gen, device=dev).to(dtype)
    x = xbc[..., :di].reshape(b, t, h, p)
    B = xbc[..., di:di + g * n].reshape(b, t, g, n)
    C = xbc[..., di + g * n:].reshape(b, t, g, n)
    dt = torch.nn.functional.softplus(
        torch.randn((b, t, h), generator=gen, device=dev) - 3.0)
    A = -torch.exp(torch.rand((h,), generator=gen, device=dev) * 2.77)  # -(1..16)
    s0 = (0.5 * torch.randn((b, h, p, n), generator=gen, device=dev)) if seeded else None
    D = torch.ones((h,), device=dev)
    return dict(x=x, dt=dt, A=A, B=B, C=C, D=D, initial_state=s0)


def ssd_work(b, t, h, g, p, n, l, dtype, seeded):
    """(bytes, flops) the SSD forward needs: each input read once, each
    output written once; multiply-adds of the causal (lower-triangle)
    intra-chunk products, the carried-state product and the state update."""
    e = torch.finfo(dtype).bits // 8
    nbytes = (b * t * h * p * e * 2  # x, y
              + b * t * h * 4 + h * 4  # dt, A
              + 2 * b * t * g * n * e  # B, C
              + b * h * p * n * 4 * (2 if seeded else 1))  # initial, final state
    nc = t // l
    macs = b * h * nc * ((n + p) * l * (l + 1) // 2 + 2 * l * p * n)
    return nbytes, 2 * macs



# ------------------------------------------------------------ paged decode

# the timed paged decode: 8 slots of hybrid-280m's attention (12 query / 4
# KV heads of 64, pages of 64, 16 pages a slot) at ragged lengths:
# (S, nh, nkv, hd, pg, W, kv_len)
RPA_TIMED = (8, 12, 4, 64, 64, 16, [0, 37, 128, 1024, 1, 500, 64, 999])


def rpa_case(gen, S, nh, nkv, hd, pg, W, lens, dtype, quant):
    """The arguments of ``ragged_paged_decode_attention`` for one mix: q,
    a bf16/fp32 pool (or int8 pages and scales), disjoint tables."""
    P = 1 + S * W
    if quant:
        (kp, vp), scales = int8_pool(gen, P, nkv, pg, hd)
    else:
        (kp, vp), scales = paged_pool(gen, P, nkv, pg, hd, dtype), []
    q = torch.randn((S, nh, hd), generator=gen, device="cuda").to(dtype)
    tbl = disjoint_table(gen, S, W, P)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return (q, kp, vp, tbl, kv_len, *scales)


def rpa_work(args) -> tuple[int, int]:
    """(bytes, flops) of one paged decode on ``rpa_case``'s arguments: the
    live tokens' K and V, q and o, the table and lengths, and for int8
    pages the live pages' two scales; 2 hd-long products per (query head,
    live key)."""
    q, kp, _, tbl, kv_len, *scales = args
    S, nh, hd = q.shape
    nkv, pg = kp.shape[1], kp.shape[2]
    tokens = int(kv_len.sum())
    live_pages = int(((kv_len + pg - 1) // pg).sum())
    nbytes = (2 * tokens * nkv * hd * kp.element_size() + 2 * S * nh * hd * q.element_size()
              + tbl.numel() * 4 + S * 4 + (2 * live_pages * nkv * 4 if scales else 0))
    return nbytes, 4 * tokens * nh * hd


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
