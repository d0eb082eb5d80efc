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
    slower than its kernels.  A profile that now and then records no
    kernel is taken again; after three such, the CUDA events' time is
    returned under a key that says so."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        per = {e.key: e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
        if per:
            return per
    return {"event timer (the profiler recorded no kernel)": cuda_ms(fn, iters)}


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


def ssd_bwd_work(b, t, h, g, p, n, l, dtype, seeded, dfinal):
    """(bytes, flops) of kernel 2 and of kernel 3, each input read once
    and each output written once; kernel 3's multiply-adds are the
    causal halves of G, dM, du, dB, dC plus the four l x p x n products
    of the state terms (dy P, B dS, w dS, dy^T eC)."""
    e = torch.finfo(dtype).bits // 8
    nc = t // l
    xs, bs, ts, ss = b * t * h * p * e, b * t * g * n * e, b * t * h * 4, b * nc * h * p * n * 4
    st_bytes = b * h * p * n * 4
    k2 = (xs + 2 * ts + bs + ss, 2 * b * h * nc * l * p * n)
    k3_bytes = (3 * xs + 4 * ts + 2 * bs + ss + st_bytes * (2 if dfinal else 1)
                + 2 * b * t * h * n * 4 + b * nc * h * 4)
    macs = b * h * nc * (l * (l + 1) // 2 * (3 * n + 2 * p) + 4 * l * p * n)
    return k2, (k3_bytes, 2 * macs)


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



# ------------------------------------------------ selective scan (Mamba-1)

# the H100's fp32 peak from the table (67 TFLOP/s, 128 FMA lanes per SM)
# and its exp rate: the SFU evaluates 16 exp2 per SM and clock, 1/8 of
# the FMA lanes' 33.5 T FMA/s
H100_FP32_FLOPS = 67e12
H100_EXP_PER_S = H100_FP32_FLOPS / 2 / 8


def m1_inputs(gen, b, t, d, seeded, n=16):
    """The fp32 core inputs of the scan at init-like scales: dt =
    softplus(N(-3, 1)), A = -(1..16), B, C ~ N(0, 1)."""
    dev = "cuda"
    u = torch.randn((b, t, d), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(torch.randn((b, t, d), generator=gen, device=dev) - 3.0)
    A = -torch.exp(torch.rand((d, n), generator=gen, device=dev) * 2.77)
    B = torch.randn((b, t, n), generator=gen, device=dev)
    C = torch.randn((b, t, n), generator=gen, device=dev)
    h0 = 0.5 * torch.randn((b, d, n), generator=gen, device=dev) if seeded else None
    return u, dt, A, B, C, h0


# the TPU kernel's t-tile at the train layer's shapes (t 1024, d 1536:
# 512-channel blocks from _pick_blocks, then the 4 MB cap on its rebuilt
# states, scan_kernels.py:296-302); the bounds count the entry states
# passed from kernel 5 to kernel 6 at this tile, not at the port's T_BLK
TPU_M1_T_TILE = 128


def m1_work(b, t, d, n, seeded, dfinal):
    """(bytes, exps, flops) of kernels 4, 5 and 6 on these shapes: each of
    the scan's inputs read once and each of its outputs written once
    (kernel 6's as the backward defines them: du, ddt (b, t, d), dA (d,
    n), dB and dC (b, t, n), dh0 when seeded), the entry states written by
    kernel 5 and read by kernel 6 at the TPU kernel's tile; one exp per
    (b, t, d, n) cell each, what the recurrence needs (kernel 6 evaluates
    it twice); the fp32 operations of the recurrence per cell (6 forward:
    the exp's argument, the update's multiply and multiply-add, the
    readout's multiply-add; 4 without the readout; 20 backward).  None of
    it depends on the port's T_BLK or D_BLK."""
    io, bc, st, a = b * t * d * 4, b * t * n * 4, b * d * n * 4, d * n * 4
    entry = b * -(-t // TPU_M1_T_TILE) * d * n * 4
    cells = b * t * d * n
    h0 = st if seeded else 0
    k4 = (3 * io + a + 2 * bc + h0 + st, cells, 6 * cells)
    k5 = (2 * io + a + bc + h0 + entry, cells, 4 * cells)
    k6 = (5 * io + 2 * a + 4 * bc + entry + (st if dfinal else 0) + h0, cells, 20 * cells)
    return k4, k5, k6


def m1_bound(nbytes, exps, flops):
    """(bound ms, "bytes" or "operations"): the operations' time is the
    larger of the exps over the SFU rate and the rest over the fp32 peak
    (the two pipes run side by side)."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = max(exps / H100_EXP_PER_S, flops / H100_FP32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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
