"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py              # the whole run (one card)
    python3 chip_smoke.py --kernels-only

Phases, each of which fails the run (nonzero exit, no result line):

1. build every CUDA kernel of the port from the sources in the checkout
   (one nvcc per source, all started together);
2. hold each kernel against its plain PyTorch version on the card, in
   fp32 with TF32 off and in bf16, and time both at its main path's
   shapes, beside a bound from the bytes and operations the work needs
   and, for attention, a PyTorch SDPA call on the pre-gathered cache
   view: ``ssd_fwd`` at mamba2-280m's (24 heads, headdim 64, d_state
   128); ``ssd_chunk_states`` and ``ssd_bwd`` (the SSD backward) over g 1
   and 2, seeded and not, with and without a final-state cotangent, then
   the whole ``SSDFunction``'s gradients against torch autograd of the
   plain forward, timed at one layer of the mamba2-280m train step (b 8,
   t 1024, chunk 256); ``rpa_fwd`` (paged decode) and ``rpp_fwd`` (fused
   page write + chunk prefill) at hybrid-280m's (12 query / 4 KV heads,
   head dim 64, pages of 64 tokens, 16 pages per slot) over ragged
   length mixes, with the written pages compared bit for bit;
3. serve requests on a full-width mamba2-280m ``ServingEngine`` (64
   layers, bf16, ``ssm_impl="pallas"``, random weights from a seeded
   ``torch.Generator``): prompts of 12 and 100 tokens take the one-shot
   prefill, 300 and 700 the chunked prefill; then on a full-width
   hybrid-280m engine (64 layers, 8 of them attention over the paged
   KV cache), where every prompt takes the chunked prefill.  One greedy
   request's stream must equal the port's solo ``generate()``, and a
   hybrid engine must end with no KV page in use;
4. train a full-width, full-depth mamba2-280m (bf16, pallas, remat)
   through the port's ``Trainer`` for 3 optimizer steps at seq 1024 on
   synthetic shards (micro-batch 32, or 16 if 32 does not fit), with
   validation; every loss and grad norm must be finite.  At 4 layers of
   the same width, one train step's loss and gradients with "pallas"
   must match "xla" (fp32 and bf16), and ten steps on one repeated batch
   must lower the loss;
5. print the serving and training numbers beside the card's name and
   power limit, one ``{"kernels": [...]}`` line, and last ``{"ok": true,
   "device": ...}``.

Before each serving and training run the kernels' launch counts are
zeroed, and after it every kernel of that path must have launched.

It imports nothing of JAX or of the JAX package, and exits nonzero when
no card is visible or the port's package is not beside it.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16
# kernel-vs-plain tolerances, as max|kernel - plain| / max|plain|:
# fp32 differs only by summation order; bf16 also by where each side
# rounds (the kernel at the TPU kernel's cast points, the plain version
# at ops/ssd.py's), a few bf16 ulps (2^-8 relative each)
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# a 4-layer train step, pallas against xla: in bf16 the two formulations
# round at different points and the differences compound through four
# layers and the backward (about 1e-2 on every gradient leaf in a CPU
# rehearsal at width 128-256), so bf16 gets a wider bound; fp32 keeps 1e-4
TRAIN_TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-2}


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ----------------------------------------------------------------- SSD kernel


def ssd_inputs(gen, b, t, g, dtype, seeded, h=24, p=64, n=128):
    """x, B, C as slices of one (b, t, h*p + 2*g*n) conv-output-like
    tensor (so the kernel reads them through strides, as in the mixer)."""
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


def check_ssd(gen):
    from mamba_distributed_tpu_torch.ops.cuda import ssd_kernels
    from mamba_distributed_tpu_torch.ops.ssd import ssd_chunked

    cases = [  # (dtype, b, t, chunk, g, seeded)
        (torch.float32, 1, 8, 256, 1, False),
        (torch.float32, 2, 128, 64, 2, True),
        (torch.float32, 1, 512, 256, 1, True),
        (torch.bfloat16, 1, 8, 256, 1, False),
        (torch.bfloat16, 2, 128, 64, 2, True),
        (torch.bfloat16, 1, 512, 256, 2, True),
        # the chunked-prefill step of the serving path (timed below)
        (torch.bfloat16, 1, 256, 256, 1, True),
    ]
    row = None
    for dtype, b, t, chunk, g, seeded in cases:
        inp = ssd_inputs(gen, b, t, g, dtype, seeded)
        kw = dict(chunk_size=chunk, return_final_state=True, compute_dtype=dtype)
        yk, sk = ssd_kernels.ssd_chunked_kernel(**inp, **kw)
        yp, sp = ssd_chunked(**inp, **kw)
        torch.cuda.synchronize()
        errs = []
        for got, ref in ((yk, yp), (sk, sp)):
            if not torch.isfinite(got).all():
                raise SystemExit(f"ssd_fwd: non-finite output ({dtype}, t={t})")
            err = float((got.float() - ref.float()).abs().max())
            scale = max(float(ref.float().abs().max()), 1e-6)
            errs.append((err, err / scale))
        worst = max(r for _, r in errs)
        l = min(chunk, t)
        print(f"check ssd_fwd {str(dtype)[6:]} b={b} t={t} l={l} g={g} "
              f"seeded={seeded}: y max_abs_err={errs[0][0]:.3e} (rel {errs[0][1]:.2e}), "
              f"state max_abs_err={errs[1][0]:.3e} (rel {errs[1][1]:.2e}), "
              f"tol rel {TOL[dtype]:.0e}", flush=True)
        if worst > TOL[dtype]:
            raise SystemExit(f"ssd_fwd disagrees with the plain version: rel {worst:.3e}")
        if dtype is torch.bfloat16 and t == 256 and chunk == 256:
            ms = cuda_ms(lambda: ssd_kernels.ssd_chunked_kernel(**inp, **kw), 20)
            plain_ms = cuda_ms(lambda: ssd_chunked(**inp, **kw), 5)
            nbytes, flops = ssd_work(b, t, 24, g, 64, 128, l, dtype, seeded)
            bound_ms = max(nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS) * 1e3
            bound_by = ("bytes" if nbytes / H100_BYTES_PER_S > flops / H100_BF16_FLOPS
                        else "operations")
            print(f"time ssd_fwd bf16 b=1 t=256 l=256 h=24 seeded: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}: "
                  f"{nbytes} B, {flops} FLOP)", flush=True)
            row = dict(name="ssd_fwd", route="cuda",
                       source="mamba_distributed_tpu_torch/ops/cuda/csrc/ssd_fwd.cu",
                       replaces="mamba_distributed_tpu/ops/pallas/ssd_kernels.py:164",
                       launches=None, max_abs_err=errs[0][0], ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return row


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


def check_ssd_bwd(gen):
    """Kernels 2 and 3 against their plain versions (same inputs, the
    plain entering states fed to both), then the whole SSDFunction's
    gradients against torch autograd of the plain ``ssd_chunked``; the
    last case, one layer of the mamba2-280m train step, is timed."""
    from mamba_distributed_tpu_torch.ops.cuda import ssd_kernels as sk
    from mamba_distributed_tpu_torch.ops.ssd import (
        _divisor_chunk,
        chunk_log_decay,
        ssd_chunked,
        state_passing,
    )

    cases = [  # (dtype, b, t, chunk, g, seeded, dfinal)
        (torch.float32, 1, 64, 64, 1, False, False),
        (torch.float32, 2, 512, 256, 2, True, True),
        (torch.float32, 1, 300, 128, 2, False, True),  # l = 100: ragged row blocks
        (torch.bfloat16, 1, 64, 64, 1, False, False),
        (torch.bfloat16, 2, 512, 256, 2, True, True),
        (torch.bfloat16, 1, 300, 128, 1, True, False),
        (torch.bfloat16, 8, 1024, 256, 1, False, False),  # one train-step layer (timed)
    ]
    names = ("dx", "ddt_direct", "da", "dB_h", "dC_h", "dgamma", "dinit")
    rows, failures = [None, None], []
    for dtype, b, t, chunk, g, seeded, dfin in cases:
        inp = ssd_inputs(gen, b, t, g, dtype, seeded)
        x, dt, A, B, C, s0 = (inp[k] for k in ("x", "dt", "A", "B", "C", "initial_state"))
        h, p, n = x.shape[2], x.shape[3], B.shape[3]
        l = _divisor_chunk(t, chunk)
        a4 = chunk_log_decay(dt, A, l)
        a_cum = a4.reshape(b, t, h).contiguous()
        st_k = sk.ssd_chunk_states_kernel(x, dt, a_cum, B, l, dtype)
        st_p = sk.ssd_chunk_states_plain(x, dt, a_cum, B, l, dtype)
        prev, _ = state_passing(st_p, torch.exp(a4[:, :, -1]), s0)
        prev = prev.contiguous()
        dy = torch.randn((b, t, h, p), generator=gen, device="cuda").to(dtype)
        dfinal = torch.randn((b, h, p, n), generator=gen, device="cuda") if dfin else None
        args = (x, dt, a_cum, B, C, prev, dy, dfinal, l, dtype)
        got = sk.ssd_bwd_kernel(*args)
        ref = sk.ssd_bwd_plain(*args)
        torch.cuda.synchronize()
        tag = f"{str(dtype)[6:]} b={b} t={t} l={l} g={g} seeded={seeded} dfinal={dfin}"
        err2, rel2 = rel_err(st_k, st_p)
        errs = {nm: rel_err(a, r) for nm, a, r in zip(names, got, ref)}
        worst = max([rel2] + [r for _, r in errs.values()])
        finite = all(bool(torch.isfinite(v).all()) for v in (st_k, *got))
        print(f"check ssd_chunk_states {tag}: max_abs_err={err2:.3e} (rel {rel2:.2e}); "
              f"ssd_bwd rel " + " ".join(f"{k} {r:.2e}" for k, (_, r) in errs.items())
              + f"; tol rel {TOL[dtype]:.0e}", flush=True)
        if not finite or worst > TOL[dtype]:
            failures.append(f"ssd_chunk_states/ssd_bwd {tag}: finite={finite}, rel {worst:.3e}")

        if b * t <= 1024:  # the whole Function against autograd of the plain forward
            failures += function_grads(sk, ssd_chunked, inp, dy, dfinal, chunk, dtype, tag)
        if b == 8:
            ms2 = cuda_ms(lambda: sk.ssd_chunk_states_kernel(x, dt, a_cum, B, l, dtype), 20)
            plain2 = cuda_ms(lambda: sk.ssd_chunk_states_plain(x, dt, a_cum, B, l, dtype), 5)
            ms3 = cuda_ms(lambda: sk.ssd_bwd_kernel(*args), 5, 1)
            plain3 = cuda_ms(lambda: sk.ssd_bwd_plain(*args), 3, 1)
            (b2, f2), (b3, f3) = ssd_bwd_work(b, t, h, g, p, n, l, dtype, seeded, dfin)
            for i, (nm, ms, plain, nb, fl, err, line) in enumerate((
                    ("ssd_chunk_states", ms2, plain2, b2, f2, err2, 61),
                    ("ssd_bwd", ms3, plain3, b3, f3, max(e for e, _ in errs.values()), 299))):
                bound_ms, bound_by = bound(nb, fl)
                print(f"time {nm} bf16 b={b} t={t} l={l} h={h} (one layer of the "
                      f"mamba2-280m train step): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                      f"bound {bound_ms:.6f} ms ({bound_by}: {nb} B, {fl} FLOP)", flush=True)
                rows[i] = dict(name=nm, route="cuda",
                               source="mamba_distributed_tpu_torch/ops/cuda/csrc/ssd_bwd.cu",
                               replaces=f"mamba_distributed_tpu/ops/pallas/ssd_kernels.py:{line}",
                               launches=None, max_abs_err=err, ms=ms, plain_ms=plain,
                               bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    if failures:
        raise SystemExit("SSD backward checks failed:\n" + "\n".join(failures))
    return rows


def function_grads(sk, ssd_chunked, inp, dy, dfinal, chunk, dtype, tag):
    """Gradients of x, dt, A, B, C (and the initial state) through
    ``ssd_chunked_kernel`` (SSDFunction: kernels 1-3) and through torch
    autograd of the plain ``ssd_chunked``, same inputs, same cotangents.
    x, B and C are slices of one leaf, as in the mixer."""
    grads = []
    for fn in (sk.ssd_chunked_kernel, ssd_chunked):
        x, B, C = inp["x"], inp["B"], inp["C"]
        xbc = torch.cat([x.flatten(2), B.flatten(2), C.flatten(2)], -1).detach().requires_grad_()
        b, t, h, p = x.shape
        g, n = B.shape[2], B.shape[3]
        xs = xbc[..., :h * p].reshape(b, t, h, p)
        Bs = xbc[..., h * p:h * p + g * n].reshape(b, t, g, n)
        Cs = xbc[..., h * p + g * n:].reshape(b, t, g, n)
        leaves = {"xBC": xbc, "dt": inp["dt"].detach().requires_grad_(),
                  "A": inp["A"].detach().requires_grad_()}
        s0 = inp["initial_state"]
        if s0 is not None:
            leaves["initial_state"] = s0.detach().requires_grad_()
        y, final = fn(xs, leaves["dt"], leaves["A"], Bs, Cs, chunk_size=chunk, D=inp["D"],
                      initial_state=leaves.get("initial_state"), return_final_state=True,
                      compute_dtype=dtype)
        loss = (y.float() * dy.float()).sum()
        if dfinal is not None:
            loss = loss + (final * dfinal).sum()
        loss.backward()
        grads.append({k: v.grad for k, v in leaves.items()})
    torch.cuda.synchronize()
    errs = {k: rel_err(grads[0][k], grads[1][k]) for k in grads[1]}
    worst = max(r for _, r in errs.values())
    print(f"check SSDFunction grads vs plain autograd {tag}: rel "
          + " ".join(f"{k} {r:.2e}" for k, (_, r) in errs.items()), flush=True)
    ok = worst <= TOL[dtype] and all(bool(torch.isfinite(v).all()) for v in grads[0].values())
    return [] if ok else [f"SSDFunction grads {tag}: rel {worst:.3e}"]


# ---------------------------------------------------- paged attention kernels


def rel_err(got, ref):
    err = float((got.float() - ref.float()).abs().max())
    return err, err / max(float(ref.float().abs().max()), 1e-6)


def paged_pool(gen, P, nkv, pg, hd, dtype):
    shape = (P, nkv, pg, hd)
    return (torch.randn(shape, generator=gen, device="cuda").to(dtype),
            torch.randn(shape, generator=gen, device="cuda").to(dtype))


def disjoint_table(gen, rows, W, P):
    """Disjoint per-row pages of [1, P) (the allocator's invariant)."""
    perm = 1 + torch.randperm(P - 1, generator=gen, device="cuda")[:rows * W]
    return perm.reshape(rows, W).to(torch.int32)


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_rpa(gen):
    """Paged decode: kernel vs plain over ragged kv_len mixes (0, mid-page,
    an exact page multiple, a full table); the bf16 hybrid-280m case at
    8 slots is timed."""
    from mamba_distributed_tpu_torch.ops.cuda import attention_kernels as ak

    cases = [  # (dtype, nh, nkv, pg, W, kv_len of the 8 slots)
        (torch.float32, 12, 4, 64, 16, [0, 37, 128, 1024, 1, 500, 64, 999]),
        (torch.bfloat16, 12, 4, 64, 16, [0, 37, 128, 1024, 1, 500, 64, 999]),
        (torch.float32, 16, 4, 8, 16, [0, 5, 16, 128, 77, 8, 1, 100]),
        (torch.bfloat16, 16, 4, 8, 16, [0, 5, 16, 128, 77, 8, 1, 100]),
    ]
    hd, S, row = 64, 8, None
    for dtype, nh, nkv, pg, W, lens in cases:
        P = 1 + S * W
        kp, vp = paged_pool(gen, P, nkv, pg, hd, dtype)
        q = torch.randn((S, nh, hd), generator=gen, device="cuda").to(dtype)
        tbl = disjoint_table(gen, S, W, P)
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        args = (q, kp, vp, tbl, kv_len)
        got = ak.ragged_paged_decode_attention(*args)
        ref = ak.ragged_paged_decode_attention_plain(*args)
        torch.cuda.synchronize()
        empty = kv_len == 0
        if not torch.isfinite(got).all() or got[empty].abs().max() != 0:
            raise SystemExit(f"rpa_fwd: non-finite output or a nonzero empty row ({dtype})")
        err, rel = rel_err(got[~empty], ref[~empty])
        print(f"check rpa_fwd {str(dtype)[6:]} S={S} nh={nh} nkv={nkv} pg={pg} W={W} "
              f"kv_len={lens}: max_abs_err={err:.3e} (rel {rel:.2e}), "
              f"tol rel {TOL[dtype]:.0e}", flush=True)
        if rel > TOL[dtype]:
            raise SystemExit(f"rpa_fwd disagrees with the plain version: rel {rel:.3e}")
        if dtype is torch.bfloat16 and pg == 64:
            ms = cuda_ms(lambda: ak.ragged_paged_decode_attention(*args), 50)
            plain_ms = cuda_ms(lambda: ak.ragged_paged_decode_attention_plain(*args), 10)
            # yardstick: SDPA over the pre-gathered contiguous view (the
            # page gather is not timed), heads expanded to nh
            kk, vv = ak.gather_kv_pages(kp, vp, tbl)
            kk = kk.transpose(1, 2).repeat_interleave(nh // nkv, dim=1).contiguous()
            vv = vv.transpose(1, 2).repeat_interleave(nh // nkv, dim=1).contiguous()
            mask = (torch.arange(W * pg, device="cuda") < kv_len.clamp(min=1)[:, None])
            qq = q[:, :, None]
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mask[:, None, None]), 50)
            e = torch.finfo(dtype).bits // 8
            tokens = int(kv_len.sum())
            nbytes = (2 * tokens * nkv * hd * e + 2 * S * nh * hd * e
                      + tbl.numel() * 4 + S * 4)
            bound_ms, bound_by = bound(nbytes, 4 * tokens * nh * hd)
            print(f"time rpa_fwd bf16 S={S} kv_len={lens}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, SDPA on the pre-gathered view (no page gather) "
                  f"{library_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, "
                  f"{4 * tokens * nh * hd} FLOP)", flush=True)
            row = dict(name="rpa_fwd", route="cuda",
                       source="mamba_distributed_tpu_torch/ops/cuda/csrc/ragged_paged_attention.cu",
                       replaces="mamba_distributed_tpu/ops/pallas/attention_kernels.py:525",
                       launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    return row


def check_rpp(gen):
    """Fused page write + chunk prefill: kernel vs plain over the ragged
    mixes of tests/test_paged_attention.py (positions scaled by 8 to
    pages of 64) and the second 256-token chunk of a 700-token prompt
    (ln = 188, the timed case).  Output rows at real query positions
    agree within the tolerance; every page but the trash page 0 is
    bit-identical."""
    from mamba_distributed_tpu_torch.ops.cuda import attention_kernels as ak

    hd = 64
    mixes = [  # (b, c, nh, nkv, pg, W, lengths, chunk_real)
        (3, 128, 12, 4, 64, 8, [0, 40, 136], [128, 88, 128]),
        (3, 128, 12, 4, 64, 8, [0, 72, 0], [0, 128, 56]),
        (2, 128, 12, 4, 64, 8, [96, 96], [128, 128]),
        (2, 128, 12, 4, 64, 8, [384, 384], [128, 128]),
        (2, 128, 4, 1, 128, 4, [24, 160], [128, 128]),
        (2, 128, 12, 4, 64, 8, [96, 32], [0, 128]),
        (1, 256, 12, 4, 64, 16, [188], [256]),
    ]
    row = None
    for dtype in (torch.float32, torch.bfloat16):
        for b, c, nh, nkv, pg, W, lens, reals in mixes:
            P = 1 + b * W
            kp, vp = paged_pool(gen, P, nkv, pg, hd, dtype)
            q = torch.randn((b, c, nh, hd), generator=gen, device="cuda").to(dtype)
            kc = torch.randn((b, c, nkv, hd), generator=gen, device="cuda").to(dtype)
            vc = torch.randn((b, c, nkv, hd), generator=gen, device="cuda").to(dtype)
            tbl = disjoint_table(gen, b, W, P)
            ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
            cr = torch.tensor(reals, dtype=torch.int32, device="cuda")
            kp2, vp2 = kp.clone(), vp.clone()
            got, gk, gv = ak.ragged_paged_prefill_attention(q, kc, vc, kp, vp, tbl, ln, cr)
            ref, rk, rv = ak.ragged_paged_prefill_attention_plain(
                q, kc, vc, kp2, vp2, tbl, ln, cr)
            torch.cuda.synchronize()
            if not (torch.equal(gk[1:], rk[1:]) and torch.equal(gv[1:], rv[1:])):
                raise SystemExit(f"rpp_fwd wrote pages unlike the plain version "
                                 f"({dtype}, lengths {lens}, chunk_real {reals})")
            real = torch.arange(c, device="cuda")[None, :] >= (c - cr)[:, None]
            if not torch.isfinite(got[real]).all():
                raise SystemExit(f"rpp_fwd: non-finite output ({dtype}, lengths {lens})")
            err, rel = rel_err(got[real], ref[real]) if bool(real.any()) else (0.0, 0.0)
            print(f"check rpp_fwd {str(dtype)[6:]} b={b} c={c} nh={nh} nkv={nkv} pg={pg} "
                  f"W={W} lengths={lens} chunk_real={reals}: max_abs_err={err:.3e} "
                  f"(rel {rel:.2e}), tol rel {TOL[dtype]:.0e}; pages bit-identical",
                  flush=True)
            if rel > TOL[dtype]:
                raise SystemExit(f"rpp_fwd disagrees with the plain version: rel {rel:.3e}")
            if dtype is torch.bfloat16 and c == 256:
                args = (q, kc, vc, kp, vp, tbl, ln, cr)
                ms = cuda_ms(lambda: ak.ragged_paged_prefill_attention(*args), 50)
                plain_ms = cuda_ms(lambda: ak.ragged_paged_prefill_attention_plain(*args), 10)
                # yardstick: causal SDPA over the pre-gathered view of
                # prefix + chunk (no page gather, no page write)
                total = lens[0] + reals[0]
                kk, vv = ak.gather_kv_pages(kp, vp, tbl)
                kk = kk[:, :total].transpose(1, 2).repeat_interleave(nh // nkv, dim=1)
                vv = vv[:, :total].transpose(1, 2).repeat_interleave(nh // nkv, dim=1)
                kk, vv = kk.contiguous(), vv.contiguous()
                qq = q.transpose(1, 2).contiguous()
                qpos = lens[0] + torch.arange(c, device="cuda")
                mask = torch.arange(total, device="cuda")[None, :] <= qpos[:, None]
                library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    qq, kk, vv, attn_mask=mask), 50)
                e = torch.finfo(dtype).bits // 8
                kv_row = nkv * hd * e
                nbytes = (lens[0] * 2 * kv_row      # prefix pages read
                          + reals[0] * 2 * kv_row   # pages written
                          + c * 2 * kv_row          # chunk K/V
                          + 2 * c * nh * hd * e     # q, o
                          + tbl.numel() * 4 + 8)
                flops = 4 * nh * hd * sum(p + 1 for p in range(lens[0], total))
                bound_ms, bound_by = bound(nbytes, flops)
                print(f"time rpp_fwd bf16 b=1 c=256 lengths={lens} chunk_real={reals}: "
                      f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA on the "
                      f"pre-gathered view (no page gather or write) {library_ms:.4f} ms, "
                      f"bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, {flops} FLOP)",
                      flush=True)
                row = dict(name="rpp_fwd", route="cuda",
                           source="mamba_distributed_tpu_torch/ops/cuda/csrc/"
                                  "ragged_paged_attention.cu",
                           replaces="mamba_distributed_tpu/ops/pallas/attention_kernels.py:722",
                           launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    return row


# ------------------------------------------------------------ serving path


def serve(preset: str, path_kernels: tuple[str, ...]):
    """Serve 8 requests on a full-width engine of ``preset``; returns the
    launch counts of the run.  Every kernel in ``path_kernels`` (keys of
    ``build.LAUNCHES``) must have launched in it."""
    from mamba_distributed_tpu_torch.config import get_preset
    from mamba_distributed_tpu_torch.inference.generate import generate
    from mamba_distributed_tpu_torch.models.lm import init_lm_params, init_lm_state
    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
    from mamba_distributed_tpu_torch.serving import GenerationRequest, ServingEngine
    from mamba_distributed_tpu_torch.serving.prefill import (
        cast_decode_params,
        chunk_inputs,
        plan_chunks,
        prefill_chunk,
    )

    cfg = get_preset(preset, ssm_impl="pallas", compute_dtype="bfloat16")
    hybrid = bool(cfg.attn_layer_idx)
    params = init_lm_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
    capacity, new = 8, 32
    lens = [12, 100, 300, 700, 12, 100, 300, 700]
    prompt_gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (t,), generator=prompt_gen).numpy()
               for t in lens]

    def requests():
        # request 0 is greedy: its stream is checked against generate()
        return [GenerationRequest(prompt_ids=p.copy(), max_new_tokens=new,
                                  top_k=1 if i == 0 else 50, seed=i)
                for i, p in enumerate(prompts)]

    # warm-up run (cuBLAS handles, allocator), not counted
    ServingEngine(params, cfg, capacity=capacity).run(requests()[:2])
    torch.cuda.synchronize()

    eng = ServingEngine(params, cfg, capacity=capacity)
    reqs = requests()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t0 = time.perf_counter()
    ids = [eng.submit(r) for r in reqs]
    tracked = {t.request_id: t for t in eng.scheduler}
    decode_ticks = []
    while eng.pending:
        prefill_pending = bool(eng.scheduler.depth or eng._prefill_queue)
        ts = time.perf_counter()
        events = eng.step()
        if events and not prefill_pending:
            decode_ticks.append(time.perf_counter() - ts)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    results = [eng.results[i] for i in ids]

    n_tokens = sum(len(r.new_tokens) for r in results)
    for r in results:
        if len(r.new_tokens) != new or not (0 <= r.new_tokens.min() and
                                            r.new_tokens.max() < cfg.vocab_size):
            raise SystemExit(f"request {r.request_id}: bad stream {r.new_tokens}")
    for k in path_kernels:
        if launches[k] < 1:
            raise SystemExit(f"the {preset} serving path launched no {k} kernel")
    if hybrid and eng.page_pool.pages_in_use:
        raise SystemExit(f"{eng.page_pool.pages_in_use} KV pages leaked")
    ttft = sorted((tracked[i].t_first_token - tracked[i].t_submit) * 1e3 for i in ids)

    solo = generate(params, cfg, torch.from_numpy(prompts[0])[None], seed=0,
                    max_new_tokens=new, top_k=1, decode_rows=capacity)
    solo = solo[0, len(prompts[0]):].tolist()
    if solo != results[0].new_tokens.tolist():
        raise SystemExit(f"engine greedy stream {results[0].new_tokens.tolist()} != "
                         f"generate() {solo}")

    # prefill cost per token: the second 256-token chunk step of the
    # 700-token prompt, batch 1 (a hybrid's pages hold its first 188)
    dparams = cast_decode_params(params, cfg)
    plan = plan_chunks(700, cfg.effective_prefill_chunk_tokens)
    cids, cmask = chunk_inputs(prompts[3], plan, 1, device=eng.device)
    st = init_lm_state(cfg, 1, max_len=cfg.kv_slot_tokens if hybrid else 0,
                       device=eng.device)
    if hybrid:
        st["attn_meta"] = (st["attn_meta"][0],
                           torch.tensor([plan.real_tokens(0)], dtype=torch.int32,
                                        device=eng.device))
    with torch.no_grad():
        chunk_ms = cuda_ms(lambda: prefill_chunk(dparams, cids, cmask, st, cfg), 3, 1)
    card = smi()
    print(f"serve {preset} n_layer={cfg.n_layer} bf16 capacity={capacity}: "
          f"{len(reqs)} requests, prompts {lens}, {n_tokens} new tokens in "
          f"{wall:.3f} s = {n_tokens / wall:.1f} tokens/s [{card}]")
    print(f"serve {preset} TTFT ms: min {ttft[0]:.1f} median {ttft[len(ttft) // 2]:.1f} "
          f"max {ttft[-1]:.1f} [{card}]")
    print(f"serve {preset} prefill: {chunk_ms / 256:.4f} ms per token "
          f"(one 256-token chunk step, batch 1: {chunk_ms:.2f} ms) [{card}]")
    if decode_ticks:
        dt = sorted(decode_ticks)
        print(f"serve {preset} decode: {dt[len(dt) // 2] * 1e3:.2f} ms per tick (median of "
              f"{len(dt)} decode-only ticks, {eng.tokens_per_tick} sub-steps x "
              f"{capacity} slots) [{card}]")
    print(f"serve {preset} launches during the run: {launches}; greedy stream == "
          f"generate(): True" + ("; KV pages in use at the end: 0" if hybrid else ""))
    return launches


# ------------------------------------------------------------ training path


def mm_out_dtype_has_grad() -> str:
    """Whether autograd differentiates ``torch.mm(..., out_dtype=fp32)``
    (the serving head's fp32-logit GEMM, models/common.mm_f32)."""
    a = torch.randn((4, 8), device="cuda", dtype=torch.bfloat16, requires_grad=True)
    b = torch.randn((8, 4), device="cuda", dtype=torch.bfloat16)
    try:
        torch.mm(a, b, out_dtype=torch.float32).sum().backward()
    except (RuntimeError, NotImplementedError) as e:
        return f"no ({type(e).__name__}: {str(e).splitlines()[0][:120]})"
    return "yes"


def train_checks(card: str):
    """At 4 layers of mamba2-280m's width: one step's loss and gradients
    with ssm_impl="pallas" (the SSD Function, kernels 1-3) against "xla"
    (autograd of the plain forward), in fp32 (TF32 off) and bf16, same
    params and batch; then ten AdamW steps on one repeated bf16 batch
    (warmup 1) must lower the loss."""
    from mamba_distributed_tpu_torch.config import get_preset, get_train_preset
    from mamba_distributed_tpu_torch.models.lm import init_lm_params
    from mamba_distributed_tpu_torch.training.optimizer import AdamW, tree_leaves, tree_map
    from mamba_distributed_tpu_torch.training.train_step import loss_and_grads, make_train_step

    gen = torch.Generator().manual_seed(5)
    x = torch.randint(0, 50257, (1, 8, 1024), generator=gen).cuda()
    y = torch.randint(0, 50257, (1, 8, 1024), generator=gen).cuda()
    for dtype in ("float32", "bfloat16"):
        res = {}
        for impl in ("pallas", "xla"):
            model = get_preset("mamba2-280m", n_layer=4, ssm_impl=impl, compute_dtype=dtype)
            cfg = get_train_preset("mamba2-280m", model=model, micro_batch_size=8,
                                   total_batch_size=8 * 1024)
            params = tree_map(lambda t: t.requires_grad_(), init_lm_params(
                model, torch.Generator(device="cuda").manual_seed(11), device="cuda"))
            loss, grads = loss_and_grads(params, cfg, x, y)
            res[impl] = (float(loss), tree_leaves(grads))
        tol = TRAIN_TOL[getattr(torch, dtype)]
        loss_rel = abs(res["pallas"][0] - res["xla"][0]) / abs(res["xla"][0])
        grad_rel = max(rel_err(a, b)[1] for a, b in zip(res["pallas"][1], res["xla"][1]))
        finite = all(bool(torch.isfinite(g).all()) for g in res["pallas"][1])
        print(f"train check 4-layer mamba2-280m {dtype} b=8 t=1024: loss pallas "
              f"{res['pallas'][0]:.6f} xla {res['xla'][0]:.6f} (rel {loss_rel:.2e}), worst "
              f"grad leaf rel {grad_rel:.2e}, tol rel {tol:.0e} [{card}]", flush=True)
        if not finite or loss_rel > tol or grad_rel > tol:
            raise SystemExit(f"pallas and xla train steps disagree ({dtype})")

    model = get_preset("mamba2-280m", n_layer=4, ssm_impl="pallas", compute_dtype="bfloat16")
    cfg = get_train_preset("mamba2-280m", model=model, micro_batch_size=8,
                           total_batch_size=8 * 1024, warmup_steps=1)
    params = tree_map(lambda t: t.requires_grad_(), init_lm_params(
        model, torch.Generator(device="cuda").manual_seed(12), device="cuda"))
    step = make_train_step(cfg, AdamW(cfg, params))
    losses = [float(step(params, x, y)[0]) for _ in range(10)]
    print(f"train check 4-layer mamba2-280m bf16, one batch repeated, warmup 1: losses "
          + " ".join(f"{v:.4f}" for v in losses), flush=True)
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"the repeated-batch loss did not fall: {losses}")


def train_run(card: str) -> dict:
    """Full-width, full-depth mamba2-280m (64 layers, bf16, pallas, remat)
    through the port's Trainer: 3 optimizer steps at seq 1024 and
    micro-batch 32 (16 if 32 does not fit), accum 1, with the validation
    at steps 0 and 2, on synthetic shards under build/chip_smoke/.
    Returns the launch counts of the run."""
    import shutil

    from mamba_distributed_tpu_torch.config import DataConfig, get_preset, get_train_preset
    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
    from mamba_distributed_tpu_torch.training import Trainer

    root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    shutil.rmtree(root / "log", ignore_errors=True)
    model = get_preset("mamba2-280m", ssm_impl="pallas", compute_dtype="bfloat16", remat=True)
    for micro in (32, 16):
        cfg = get_train_preset(
            "mamba2-280m", model=model, micro_batch_size=micro, total_batch_size=micro * 1024,
            val_steps=2, log_dir=str(root / "log"),
            data=DataConfig(data_dir=str(root / "data"), synthetic_tokens_per_shard=1 << 20))
        trainer = Trainer(cfg, device="cuda")
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        torch.cuda.reset_peak_memory_stats()
        try:
            trainer.run(max_steps=3)
        except torch.cuda.OutOfMemoryError:
            print(f"train run: micro-batch {micro} does not fit in device memory; halving",
                  flush=True)
            trainer.finish()
            del trainer
            torch.cuda.empty_cache()
            continue
        break
    else:
        raise SystemExit("train run: micro-batch 16 does not fit either")
    launches = dict(LAUNCHES)
    trainer.finish()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    hist = [trainer.history[s] for s in range(3)]
    if not all(math.isfinite(v) for h in hist for v in h):
        raise SystemExit(f"non-finite loss or grad norm: {hist}")
    for k in ("ssd_fwd", "ssd_chunk_states", "ssd_bwd"):
        if launches[k] < 1:
            raise SystemExit(f"the mamba2-280m train path launched no {k} kernel")
    recs = [json.loads(s) for s in (root / "log" / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in recs if r["kind"] == "train"]
    vals = [r["loss"] for r in recs if r["kind"] == "val"]
    print(f"train mamba2-280m n_layer=64 bf16 pallas remat micro={micro} seq=1024 accum=1: "
          f"losses {[round(h[0], 6) for h in hist]}, grad norms {[round(h[1], 4) for h in hist]}, "
          f"val {vals}", flush=True)
    for r in steps:
        print(f"train step {r['step']}: {r['step_ms']} ms, {r['tokens_per_sec']} tokens/s, "
              f"MFU {r['mfu']} (model), {r.get('mfu_hw')} (hardware) [{card}]", flush=True)
    print(f"train peak device memory (max_memory_allocated): {peak_gb:.2f} GiB [{card}]")
    print(f"train launches during the run: {launches}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels, skip the serving and training runs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from mamba_distributed_tpu_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log)]
        print(f"ptxas {name}: {len(regs)} kernel instances, registers {min(regs)}-{max(regs)}, "
              f"spill stores up to {max(spills)} bytes")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [check_ssd(gen), *check_ssd_bwd(gen), check_rpa(gen), check_rpp(gen)]
    if not args.kernels_only:
        card = smi()
        ssd_launches = serve("mamba2-280m", ("ssd_fwd",))
        launches = serve("hybrid-280m", ("ssd_fwd", "ragged_decode", "ragged_prefill"))
        torch.cuda.empty_cache()
        print(f"torch.mm(..., out_dtype=torch.float32) differentiable: "
              f"{mm_out_dtype_has_grad()}", flush=True)
        train_launches = train_run(card)
        train_checks(card)
        # each kernel's launches on its own path: the mamba2 serving run
        # for ssd_fwd, the training run for the backward kernels, the
        # hybrid serving run for the attention kernels
        for row, n in zip(rows, (ssd_launches["ssd_fwd"], train_launches["ssd_chunk_states"],
                                 train_launches["ssd_bwd"], launches["ragged_decode"],
                                 launches["ragged_prefill"])):
            row["launches"] = n
    print(smi())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
