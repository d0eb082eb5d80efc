"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py              # the whole run (one card)
    python3 chip_smoke.py --kernels-only

Phases, each of which fails the run (nonzero exit, no result line):

1. build every CUDA kernel of the port from the sources in the checkout
   (one nvcc per source, all started together), fail if a tensor-core
   flash instance spills registers (``-Xptxas -v``), and hold the Python
   tables of built shapes (``ops/dispatch.check_kernel_shapes``) against
   each library's own answers;
2. hold each kernel against its plain PyTorch version on the card, in
   fp32 with TF32 off and in bf16, and time both at its main path's
   shapes, beside a bound from the bytes and operations the work needs
   and, for attention, a PyTorch SDPA call: ``ssd_fwd`` at mamba2-280m's
   (24 heads, headdim 64, d_state 128); ``ssd_chunk_states`` and
   ``ssd_bwd`` (the SSD backward) over g 1 and 2, seeded and not, with
   and without a final-state cotangent, then the whole ``SSDFunction``'s
   gradients against torch autograd of the plain forward, timed at one
   layer of the mamba2-280m train step (b 8, t 1024, chunk 256);
   ``rpa_fwd`` (paged decode) and ``rpp_fwd`` (fused page write + chunk
   prefill) at hybrid-280m's (12 query / 4 KV heads, head dim 64, pages
   of 64 tokens, 16 pages per slot) over ragged length mixes, with the
   written pages compared bit for bit, each with bf16/fp32 pages and
   with int8 pages and scales (``rpa_fwd_int8``, ``rpp_fwd_int8``: the
   int8 branches, stale scales on recycled pages included); ``flash_fwd``, ``flash_bwd_dq``
   and ``flash_bwd_dkv`` (flash attention) over t 1024 and 1000, GQA rep
   1 and 3, offsets 0, positive and negative, head dims 32, 64 and 128,
   ragged edges of the tensor-core kernels' TMA boxes (tk 133, tq 1,
   tk_valid < tk), strided views and contiguous copies, two launches of
   the bf16 forward and dk/dv bit for bit,
   then the whole ``FlashAttentionFunction``'s gradients against torch
   autograd of the plain blockwise attention, timed at one attention
   layer of the hybrid-280m train step (b 32, t 1024); ``m1_scan``,
   ``m1_entry_states`` and ``m1_bwd`` (the Mamba-1 selective scan, fp32
   only) over d 1536, 1000 and a ragged 70, t 1024, 1000, 256 and 37,
   seeded and not, with and without a final-state cotangent, then the
   whole ``SelectiveScanFunction``'s gradients against torch autograd of
   the plain ``selective_scan_seq``, ``m1_scan`` timed at the serving
   chunk (b 1, t 256) and all three at one layer of the mamba1-280m
   train step (b 32, t 1024);
3. serve requests on a full-width mamba2-280m ``ServingEngine`` (64
   layers, bf16, ``ssm_impl="pallas"``, random weights from a seeded
   ``torch.Generator``): prompts of 12 and 100 tokens take the one-shot
   prefill, 300 and 700 the chunked prefill; then on a full-width
   hybrid-280m engine (64 layers, 8 of them attention over the paged
   KV cache), where every prompt takes the chunked prefill.  One greedy
   request's stream must equal the port's solo ``generate()``, and a
   hybrid engine must end with no KV page in use.  On the hybrid
   engine's weights the one-shot prefill (full-sequence attention
   through ``flash_fwd``) must agree with the chunked one, and a greedy
   ``generate(length_bucketing=False)`` runs through it; then on a
   full-width mamba1-280m engine (d_inner 1536, d_state 16), whose
   one-shot and chunked (seeded) prefills go through ``m1_scan``; and
   between them a second hybrid-280m engine with int8 weights and int8
   KV pages, whose paged attention runs the int8 branches (its greedy
   stream equal to ``generate()``'s, no page leaked), printed beside
   the bf16 hybrid run: resident weight and KV bytes, greedy agreement
   (not gated), tokens/s, TTFT, chunk step and decode tick;
4. train a full-width, full-depth mamba2-280m, hybrid-280m, then
   mamba1-280m (bf16, pallas, remat) through the port's ``Trainer`` for
   3 optimizer steps at seq 1024 on synthetic shards (micro-batch 32, or
   16 if 32 does not fit), with validation; every loss and grad norm
   must be finite.  At 4 layers of the same width (attention at layers 1
   and 3 for the hybrid), for each of the three, one train step's loss
   and gradients with "pallas" must match "xla" (fp32 and bf16), and ten
   steps on one repeated batch must lower the loss;
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
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from mamba_distributed_tpu_torch.ops.cuda.timing import (
    H100_BF16_FLOPS,
    H100_BYTES_PER_S,
    bound,
    cuda_ms,
    rel_err,
)

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


def paged_pool(gen, P, nkv, pg, hd, dtype):
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


def check_rpa(gen):
    """Paged decode: kernel vs plain over ragged kv_len mixes (0, mid-page,
    an exact page multiple, a full table), with bf16/fp32 pages and with
    int8 pages and scales; the bf16 hybrid-280m case at 8 slots is timed
    for each (rows ``rpa_fwd`` and ``rpa_fwd_int8``)."""
    from mamba_distributed_tpu_torch.ops.cuda import attention_kernels as ak

    cases = [  # (dtype, nh, nkv, pg, W, kv_len of the 8 slots)
        (torch.float32, 12, 4, 64, 16, [0, 37, 128, 1024, 1, 500, 64, 999]),
        (torch.bfloat16, 12, 4, 64, 16, [0, 37, 128, 1024, 1, 500, 64, 999]),
        (torch.float32, 16, 4, 8, 16, [0, 5, 16, 128, 77, 8, 1, 100]),
        (torch.bfloat16, 16, 4, 8, 16, [0, 5, 16, 128, 77, 8, 1, 100]),
    ]
    hd, S, rows = 64, 8, {}
    for quant in (False, True):
        name = "rpa_fwd_int8" if quant else "rpa_fwd"
        for dtype, nh, nkv, pg, W, lens in cases:
            P = 1 + S * W
            if quant:
                (kp, vp), scales = int8_pool(gen, P, nkv, pg, hd)
            else:
                (kp, vp), scales = paged_pool(gen, P, nkv, pg, hd, dtype), []
            q = torch.randn((S, nh, hd), generator=gen, device="cuda").to(dtype)
            tbl = disjoint_table(gen, S, W, P)
            kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
            args = (q, kp, vp, tbl, kv_len, *scales)
            got = ak.ragged_paged_decode_attention(*args)
            ref = ak.ragged_paged_decode_attention_plain(*args)
            torch.cuda.synchronize()
            empty = kv_len == 0
            if not torch.isfinite(got).all() or got[empty].abs().max() != 0:
                raise SystemExit(f"{name}: non-finite output or a nonzero empty row ({dtype})")
            err, rel = rel_err(got[~empty], ref[~empty])
            print(f"check {name} {str(dtype)[6:]} S={S} nh={nh} nkv={nkv} pg={pg} W={W} "
                  f"kv_len={lens}: max_abs_err={err:.3e} (rel {rel:.2e}), "
                  f"tol rel {TOL[dtype]:.0e}", flush=True)
            if rel > TOL[dtype]:
                raise SystemExit(f"{name} disagrees with the plain version: rel {rel:.3e}")
            if dtype is torch.bfloat16 and pg == 64:
                ms = cuda_ms(lambda: ak.ragged_paged_decode_attention(*args), 50)
                plain_ms = cuda_ms(lambda: ak.ragged_paged_decode_attention_plain(*args), 10)
                # yardstick: SDPA over the pre-gathered contiguous view
                # (int8 pages: dequantized; the gather is not timed),
                # heads expanded to nh
                kk, vv = ak.gather_kv_pages(kp, vp, tbl, None, *scales, dtype=dtype)
                kk = kk.transpose(1, 2).repeat_interleave(nh // nkv, dim=1).contiguous()
                vv = vv.transpose(1, 2).repeat_interleave(nh // nkv, dim=1).contiguous()
                mask = (torch.arange(W * pg, device="cuda") < kv_len.clamp(min=1)[:, None])
                qq = q[:, :, None]
                library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    qq, kk, vv, attn_mask=mask[:, None, None]), 50)
                e = kp.element_size()
                tokens = int(kv_len.sum())
                live_pages = int(((kv_len + pg - 1) // pg).sum())
                nbytes = (2 * tokens * nkv * hd * e + 2 * S * nh * hd * q.element_size()
                          + tbl.numel() * 4 + S * 4 + (2 * live_pages * nkv * 4 if quant else 0))
                bound_ms, bound_by = bound(nbytes, 4 * tokens * nh * hd)
                pages = "int8 pages" if quant else "bf16 pages"
                print(f"time {name} bf16 q, {pages}, S={S} kv_len={lens}: kernel {ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms, SDPA on the pre-gathered view (no page gather"
                      f"{' or dequant' if quant else ''}) {library_ms:.4f} ms, bound "
                      f"{bound_ms:.6f} ms ({bound_by}: {nbytes} B, {4 * tokens * nh * hd} FLOP)",
                      flush=True)
                rows[name] = dict(
                    name=name, route="cuda",
                    source="mamba_distributed_tpu_torch/ops/cuda/csrc/ragged_paged_attention.cu",
                    replaces="mamba_distributed_tpu/ops/pallas/attention_kernels.py:525",
                    launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    return rows["rpa_fwd"], rows["rpa_fwd_int8"]


def check_rpp(gen):
    """Fused page write + chunk prefill: kernel vs plain over the ragged
    mixes of tests/test_paged_attention.py (positions scaled by 8 to
    pages of 64) and the second 256-token chunk of a 700-token prompt
    (ln = 188, the timed case), with bf16/fp32 pages and with int8 pages
    (plus, for int8, a mix whose pages with no prior token of their row
    carry stale scales 1000x too large, as recycled pages do; the new
    scales come from ``models/attention._chunk_page_scales``).  Output rows at real query
    positions agree within the tolerance; every page but the trash page
    0 is bit-identical, and the kernel leaves the four scale arrays as
    it found them.  Rows ``rpp_fwd`` and ``rpp_fwd_int8``."""
    from mamba_distributed_tpu_torch.models.attention import _chunk_page_scales
    from mamba_distributed_tpu_torch.ops.cuda import attention_kernels as ak

    hd = 64
    mixes = [  # (b, c, nh, nkv, pg, W, lengths, chunk_real, stale old scales)
        (3, 128, 12, 4, 64, 8, [0, 40, 136], [128, 88, 128], False),
        (3, 128, 12, 4, 64, 8, [0, 72, 0], [0, 128, 56], False),
        (2, 128, 12, 4, 64, 8, [96, 96], [128, 128], False),
        (2, 128, 12, 4, 64, 8, [384, 384], [128, 128], False),
        (2, 128, 4, 1, 128, 4, [24, 160], [128, 128], False),
        (2, 128, 12, 4, 64, 8, [96, 32], [0, 128], False),
        (1, 256, 12, 4, 64, 16, [188], [256], False),
    ]
    int8_mixes = mixes + [(3, 128, 12, 4, 64, 8, [0, 64, 100], [128, 100, 60], True)]
    rows = {}
    for quant, dtype in ((False, torch.float32), (False, torch.bfloat16),
                         (True, torch.float32), (True, torch.bfloat16)):
        name = "rpp_fwd_int8" if quant else "rpp_fwd"
        for b, c, nh, nkv, pg, W, lens, reals, stale in (int8_mixes if quant else mixes):
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
                    # recycled pages: those holding no token of their row
                    # before this chunk carry a stale scale 1000x too large
                    col = torch.arange(W, device="cuda")[None, :] * pg
                    fresh = tbl[col >= ln[:, None]].long()
                    kso[fresh] *= 1000
                    vso[fresh] *= 1000
                scales = [kso, vso, *_chunk_page_scales(kc, vc, real, tbl, ln, cr, kso, vso,
                                                        pg)]
            else:
                (kp, vp), scales = paged_pool(gen, P, nkv, pg, hd, dtype), []
            kept = [t.clone() for t in scales]
            kp2, vp2 = kp.clone(), vp.clone()
            got, gk, gv = ak.ragged_paged_prefill_attention(q, kc, vc, kp, vp, tbl, ln, cr,
                                                            *scales)
            ref, rk, rv = ak.ragged_paged_prefill_attention_plain(
                q, kc, vc, kp2, vp2, tbl, ln, cr, *scales)
            torch.cuda.synchronize()
            if not (torch.equal(gk[1:], rk[1:]) and torch.equal(gv[1:], rv[1:])):
                raise SystemExit(f"{name} wrote pages unlike the plain version "
                                 f"({dtype}, lengths {lens}, chunk_real {reals})")
            if not all(torch.equal(a, k) for a, k in zip(scales, kept)):
                raise SystemExit(f"{name} changed a scale array it only reads")
            if not torch.isfinite(got[real]).all():
                raise SystemExit(f"{name}: non-finite output ({dtype}, lengths {lens})")
            err, rel = rel_err(got[real], ref[real]) if bool(real.any()) else (0.0, 0.0)
            print(f"check {name} {str(dtype)[6:]} b={b} c={c} nh={nh} nkv={nkv} pg={pg} "
                  f"W={W} lengths={lens} chunk_real={reals}{' stale scales' if stale else ''}: "
                  f"max_abs_err={err:.3e} (rel {rel:.2e}), tol rel {TOL[dtype]:.0e}; pages "
                  f"bit-identical{', scales read only' if quant else ''}", flush=True)
            if rel > TOL[dtype]:
                raise SystemExit(f"{name} disagrees with the plain version: rel {rel:.3e}")
            if dtype is torch.bfloat16 and c == 256:
                args = (q, kc, vc, kp, vp, tbl, ln, cr, *scales)
                ms = cuda_ms(lambda: ak.ragged_paged_prefill_attention(*args), 50)
                plain_ms = cuda_ms(lambda: ak.ragged_paged_prefill_attention_plain(*args), 10)
                # yardstick: causal SDPA over the pre-gathered view of
                # prefix + chunk (int8: dequantized; no page gather,
                # dequant or write)
                total = lens[0] + reals[0]
                kk, vv = ak.gather_kv_pages(kp, vp, tbl, None, *scales[2:], dtype=dtype)
                kk = kk[:, :total].transpose(1, 2).repeat_interleave(nh // nkv, dim=1)
                vv = vv[:, :total].transpose(1, 2).repeat_interleave(nh // nkv, dim=1)
                kk, vv = kk.contiguous(), vv.contiguous()
                qq = q.transpose(1, 2).contiguous()
                qpos = lens[0] + torch.arange(c, device="cuda")
                mask = torch.arange(total, device="cuda")[None, :] <= qpos[:, None]
                library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    qq, kk, vv, attn_mask=mask), 50)
                e, qe = kp.element_size(), q.element_size()
                kv_row = nkv * hd * e
                # int8: the old and new scales of the write window's pages,
                # the new ones of the prefix pages before it
                window = (total - 1) // pg - lens[0] // pg + 1
                live_pages = -(-total // pg)
                nbytes = (lens[0] * 2 * kv_row      # prefix pages read
                          + reals[0] * 2 * kv_row   # pages written
                          + c * 2 * nkv * hd * qe   # chunk K/V
                          + 2 * c * nh * hd * qe    # q, o
                          + tbl.numel() * 4 + 8
                          + ((4 * window + 2 * (live_pages - window)) * nkv * 4
                             if quant else 0))
                flops = 4 * nh * hd * sum(p + 1 for p in range(lens[0], total))
                bound_ms, bound_by = bound(nbytes, flops)
                pages = "int8 pages" if quant else "bf16 pages"
                print(f"time {name} bf16 q, {pages}, b=1 c=256 lengths={lens} chunk_real="
                      f"{reals}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA on the "
                      f"pre-gathered view (no page gather, dequant or write) {library_ms:.4f} "
                      f"ms, bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, {flops} FLOP)",
                      flush=True)
                rows[name] = dict(
                    name=name, route="cuda",
                    source="mamba_distributed_tpu_torch/ops/cuda/csrc/ragged_paged_attention.cu",
                    replaces="mamba_distributed_tpu/ops/pallas/attention_kernels.py:722",
                    launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    return rows["rpp_fwd"], rows["rpp_fwd_int8"]


def check_kernel_tables() -> None:
    """The Python tables of built shapes (what ``ops/dispatch.
    check_kernel_shapes`` refuses by) against each library's own answers."""
    from mamba_distributed_tpu_torch.ops.cuda import (
        attention_kernels,
        flash_kernels,
        scan_kernels,
        ssd_kernels,
    )

    dims = (8, 16, 32, 48, 64, 96, 128, 192, 256)
    for name, fn in (("ssd_fwd", ssd_kernels._fwd_lib().mdt_ssd_fwd_supports),
                     ("ssd_bwd", ssd_kernels._bwd_lib().mdt_ssd_bwd_supports)):
        built = {(p, n) for p in dims for n in dims if fn(p, n)}
        if built != ssd_kernels.BUILT_SHAPES:
            raise SystemExit(f"{name} is built for {sorted(built)}, the table says "
                             f"{sorted(ssd_kernels.BUILT_SHAPES)}")
    fl = flash_kernels._lib()
    built = tuple(hd for hd in range(8, 257, 8) if fl.mdt_flash_supports(hd))
    if built != flash_kernels.HEAD_DIMS:
        raise SystemExit(f"flash is built for head dims {built}, the table says "
                         f"{flash_kernels.HEAD_DIMS}")
    ak = attention_kernels._lib()
    got = (ak.mdt_rpa_max_rep(), ak.mdt_rpa_max_head_dim())
    if got != (attention_kernels.MAX_REP, attention_kernels.MAX_HEAD_DIM):
        raise SystemExit(f"ragged paged limits {got} != the table's "
                         f"{(attention_kernels.MAX_REP, attention_kernels.MAX_HEAD_DIM)}")
    n_state = scan_kernels._lib().mdt_m1_state_size()
    if n_state != scan_kernels.N_STATE:
        raise SystemExit(f"selective scan d_state {n_state} != {scan_kernels.N_STATE}")
    print(f"check kernel shape tables: SSD (headdim, d_state) {sorted(ssd_kernels.BUILT_SHAPES)}, "
          f"flash head dims {flash_kernels.HEAD_DIMS}, paged rep <= {got[0]} and head dim <= "
          f"{got[1]}, scan d_state {n_state}: each equals its library's answers", flush=True)


# ------------------------------------------------------ flash attention kernels


def flash_inputs(gen, b, tq, tk, nh, nkv, hd, dtype):
    """Head-major q, k, v as transposed views of qkv-projection-like
    (b, t, heads * hd) tensors (so the kernels read them through strides,
    as in the mixer), and a dO of q's shape."""
    dev = "cuda"
    qx = torch.randn((b, tq, nh * hd), generator=gen, device=dev).to(dtype)
    kvx = torch.randn((b, tk, 2 * nkv * hd), generator=gen, device=dev).to(dtype)
    qt = qx.reshape(b, tq, nh, hd).transpose(1, 2)
    kt = kvx[..., :nkv * hd].reshape(b, tk, nkv, hd).transpose(1, 2)
    vt = kvx[..., nkv * hd:].reshape(b, tk, nkv, hd).transpose(1, 2)
    do = torch.randn((b, nh, tq, hd), generator=gen, device=dev).to(dtype)
    return qt, kt, vt, do


def check_flash(gen, micro: int):
    """Kernels 7-9 against their plain versions (the backward fed the
    plain lse and delta), in fp32 (TF32 off) and bf16, over t 1024 and a
    ragged 1000, GQA rep 1 and 3, offset 0 and a later query slice
    (tq < tk), head dims 64, 32 (hybrid-tiny) and 128; ragged cases for
    the tensor-core kernels' TMA zero fill and partial-tile masks (tk not
    a multiple of 8, tq 1, hd 32 and 128 at tq != tk, tk_valid < tk); the
    mixer's strided views and contiguous head-major copies; two launches
    of the bf16 forward and dk/dv bit-identical; then the whole
    FlashAttentionFunction's gradients against torch autograd of the
    plain ``blockwise_sdpa_causal``; then one attention layer of the
    hybrid-280m train step (b ``micro``, t 1024, 12/4 heads, hd 64,
    bf16), checked and timed beside PyTorch's SDPA forward and backward,
    and dq + dk/dv timed together beside SDPA's backward."""
    from mamba_distributed_tpu_torch.ops.blockwise_attention import blockwise_sdpa_causal
    from mamba_distributed_tpu_torch.ops.cuda import flash_kernels as fk
    from mamba_distributed_tpu_torch.ops.cuda.flash_kernels import flash_work

    cases = [  # (b, tq, tk, nh, nkv, hd, offset)
        (1, 1024, 1024, 12, 4, 64, 0),
        (2, 1000, 1000, 4, 4, 64, 0),
        (1, 256, 1024, 12, 4, 64, 768),
        (2, 1000, 1000, 4, 2, 32, 0),
        (1, 200, 300, 8, 4, 128, 100),
        (1, 64, 128, 4, 2, 64, -16),  # rows that see no key: o 0, lse +inf
        # ragged edges of the tensor-core kernels' TMA boxes and masks
        (1, 77, 133, 4, 2, 64, 56),  # tk not a multiple of 8
        (2, 1, 300, 4, 2, 64, 299),  # one query row
        (1, 100, 250, 4, 2, 32, 150),
        (2, 65, 190, 6, 3, 128, 125),
        (1, 130, 200, 4, 2, 64, 70, 163),  # tk_valid < tk
    ]
    failures = []

    def check_one(dtype, b, tq, tk, nh, nkv, hd, off, tk_valid=None, contiguous=False):
        tk_valid = tk if tk_valid is None else tk_valid
        qt, kt, vt, do = flash_inputs(gen, b, tq, tk, nh, nkv, hd, dtype)
        if contiguous:
            qt, kt, vt = (x.contiguous() for x in (qt, kt, vt))
        o_k, lse_k = fk.flash_fwd(qt, kt, vt, off, tk_valid)
        o_p, lse_p = fk.flash_fwd_plain(qt, kt, vt, off, tk_valid)
        delta = (do.float() * o_p.float()).sum(-1).contiguous()
        bwd = (qt, kt, vt, do, lse_p, delta, off, tk_valid)
        dq_k = fk.flash_bwd_dq(*bwd)
        dq_p = fk.flash_bwd_dq_plain(*bwd)
        dk_k, dv_k = fk.flash_bwd_dkv(*bwd)
        dk_p, dv_p = fk.flash_bwd_dkv_plain(*bwd)
        # the redesigned kernels sum in a fixed order: a second launch
        # gives the same bits
        o_2, lse_2 = fk.flash_fwd(qt, kt, vt, off, tk_valid)
        dk_2, dv_2 = fk.flash_bwd_dkv(*bwd)
        torch.cuda.synchronize()
        same = all(bool(torch.equal(a, c)) for a, c in
                   ((o_k, o_2), (lse_k, lse_2), (dk_k, dk_2), (dv_k, dv_2)))
        seen = torch.isfinite(lse_p)
        same_inf = bool(torch.equal(torch.isfinite(lse_k), seen))
        errs = {"o": rel_err(o_k, o_p), "lse": rel_err(lse_k[seen], lse_p[seen]),
                "dq": rel_err(dq_k, dq_p), "dk": rel_err(dk_k, dk_p), "dv": rel_err(dv_k, dv_p)}
        finite = all(bool(torch.isfinite(t).all()) for t in (o_k, dq_k, dk_k, dv_k))
        worst = max(r for _, r in errs.values())
        tag = (f"{str(dtype)[6:]} b={b} tq={tq} tk={tk} nh={nh} nkv={nkv} hd={hd} offset={off}"
               + (f" tk_valid={tk_valid}" if tk_valid != tk else "")
               + (" contiguous" if contiguous else " strided views"))
        print(f"check flash {tag}: rel " + " ".join(f"{k} {r:.2e}" for k, (_, r) in errs.items())
              + f" (no-key rows alike: {same_inf}; fwd, dkv bit-identical over 2 launches: "
              f"{same}); tol rel {TOL[dtype]:.0e}", flush=True)
        if not (finite and same_inf and same) or worst > TOL[dtype]:
            failures.append(f"flash kernels {tag}: finite={finite}, inf rows alike={same_inf}, "
                            f"deterministic={same}, rel {worst:.3e}")
        return (qt, kt, vt, do, o_p, lse_p, delta), errs

    for dtype in (torch.float32, torch.bfloat16):
        for case in cases:
            check_one(dtype, *case)
        for case in (cases[0], cases[6], cases[9]):
            check_one(dtype, *case, contiguous=True)
        # the whole Function against autograd of the plain blockwise path
        for b, tq, tk, nh, nkv, hd, off in ((1, 1000, 1000, 12, 4, 64, 0),
                                            (2, 256, 512, 4, 2, 32, 256)):
            qt, kt, vt, do = flash_inputs(gen, b, tq, tk, nh, nkv, hd, dtype)
            grads = []
            for fn in (fk.flash_sdpa_causal, blockwise_sdpa_causal):
                q, k, v = (t.transpose(1, 2).detach().requires_grad_() for t in (qt, kt, vt))
                o = fn(q, k, v, off)
                grads.append(torch.autograd.grad(
                    (o.float() * do.transpose(1, 2).float()).sum(), (q, k, v)))
            torch.cuda.synchronize()
            errs = {n: rel_err(a, r) for n, a, r in zip(("dq", "dk", "dv"), *grads)}
            worst = max(r for _, r in errs.values())
            tag = f"{str(dtype)[6:]} b={b} tq={tq} tk={tk} nh={nh} nkv={nkv} hd={hd} offset={off}"
            print(f"check FlashAttentionFunction grads vs blockwise autograd {tag}: rel "
                  + " ".join(f"{k} {r:.2e}" for k, (_, r) in errs.items()), flush=True)
            if worst > TOL[dtype] or not all(bool(torch.isfinite(g).all()) for g in grads[0]):
                failures.append(f"FlashAttentionFunction grads {tag}: rel {worst:.3e}")
    if failures:
        raise SystemExit("flash attention checks failed:\n" + "\n".join(failures))

    # one attention layer of the hybrid-280m train step, checked and timed
    b, t, nh, nkv, hd = micro, 1024, 12, 4, 64
    dtype = torch.bfloat16
    (qt, kt, vt, do, o_p, lse_p, delta), errs = check_one(dtype, b, t, t, nh, nkv, hd, 0)
    if failures:
        raise SystemExit("flash attention checks failed:\n" + "\n".join(failures))
    bwd = (qt, kt, vt, do, lse_p, delta, 0, t)
    timed = (
        ("flash_fwd", lambda: fk.flash_fwd(qt, kt, vt, 0, t),
         lambda: fk.flash_fwd_plain(qt, kt, vt, 0, t), errs["o"][0], 65),
        ("flash_bwd_dq", lambda: fk.flash_bwd_dq(*bwd), lambda: fk.flash_bwd_dq_plain(*bwd),
         errs["dq"][0], 127),
        ("flash_bwd_dkv", lambda: fk.flash_bwd_dkv(*bwd), lambda: fk.flash_bwd_dkv_plain(*bwd),
         max(errs["dk"][0], errs["dv"][0]), 171),
    )
    # library yardstick: SDPA on contiguous head-major copies; the
    # backward row is autograd of that call (dq, dk and dv together)
    qc, kc, vc = (x.contiguous().requires_grad_() for x in (qt, kt, vt))
    sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        qc, kc, vc, is_causal=True, enable_gqa=True), 10)
    out = F.scaled_dot_product_attention(qc, kc, vc, is_causal=True, enable_gqa=True)
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(out, (qc, kc, vc), do, retain_graph=True), 10)
    rows = []
    for (nm, kern, plain, err, line), (nb, fl), lib in zip(
            timed, flash_work(b, t, t, nh, nkv, hd, 0, dtype), (sdpa_fwd, sdpa_bwd, sdpa_bwd)):
        ms = cuda_ms(kern, 10)
        plain_ms = cuda_ms(plain, 3, 1)
        bound_ms, bound_by = bound(nb, fl)
        print(f"time {nm} bf16 b={b} t={t} nh={nh} nkv={nkv} hd={hd} (one attention layer of "
              f"the hybrid-280m train step): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"SDPA {'forward' if nm == 'flash_fwd' else 'backward (dq, dk, dv together)'} "
              f"{lib:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}: {nb} B, {fl} FLOP)",
              flush=True)
        if nm == "flash_bwd_dkv":
            both = cuda_ms(lambda: (fk.flash_bwd_dq(*bwd), fk.flash_bwd_dkv(*bwd)), 10)
            print(f"time flash_bwd_dq + flash_bwd_dkv bf16 b={b} t={t} nh={nh} nkv={nkv} "
                  f"hd={hd} (the port's whole backward kernel work): {both:.4f} ms, SDPA "
                  f"backward (dq, dk, dv together) {lib:.4f} ms", flush=True)
        rows.append(dict(name=nm, route="cuda",
                         source="mamba_distributed_tpu_torch/ops/cuda/csrc/flash_attention.cu",
                         replaces=f"mamba_distributed_tpu/ops/pallas/attention_kernels.py:{line}",
                         launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=lib))
    del qc, kc, vc, out
    torch.cuda.empty_cache()
    return rows


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
    dt = F.softplus(torch.randn((b, t, d), generator=gen, device=dev) - 3.0)
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


def m1_layout_extra(b, t, d, n):
    """Bytes the port's layout moves beyond ``m1_work``'s count: the entry
    states at T_BLK steps in place of the TPU tile (written by kernel 5,
    read by kernel 6), and kernel 6's per-batch dA and per-CTA dB/dC
    partials in place of the summed dA, dB, dC."""
    from mamba_distributed_tpu_torch.ops.cuda.scan_kernels import D_BLK, T_BLK

    entry = b * (-(-t // T_BLK) - -(-t // TPU_M1_T_TILE)) * d * n * 4
    parts = (b - 1) * d * n * 4 + 2 * b * (-(-d // D_BLK) - 1) * t * n * 4
    return entry, parts


def m1_bound(nbytes, exps, flops):
    """(bound ms, "bytes" or "operations"): the operations' time is the
    larger of the exps over the SFU rate and the rest over the fp32 peak
    (the two pipes run side by side)."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = max(exps / H100_EXP_PER_S, flops / H100_FP32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_m1(gen):
    """Kernels 4-6 against their plain versions in fp32 (the core is
    fp32-only, as on the TPU) over ragged tiles and channel blocks, d 1536
    and 1000, t 1024, 1000 and 256, seeded or not, with and without a
    final-state cotangent (kernel 6 fed the plain entry states), then the
    whole ``selective_scan_kernel`` (SelectiveScanFunction, D, z, softplus)
    against torch autograd of the plain ``selective_scan_seq``.  Timed:
    kernel 4 at the serving chunk (b 1, t 256, seeded, final state) and
    kernels 4-6 at one layer of the mamba1-280m train step (b 32, t 1024);
    the rows' errors are at the timed inputs."""
    from mamba_distributed_tpu_torch.ops.cuda import scan_kernels as sk
    from mamba_distributed_tpu_torch.ops.scan import selective_scan_seq

    tol = TOL[torch.float32]
    cases = [  # (b, t, d, seeded, dfinal)
        (3, 37, 70, True, True),  # ragged tile and channel block
        (2, 1024, 1536, False, False),
        (2, 1000, 1000, True, True),
        (1, 256, 1536, True, False),  # the serving chunk step
        (8, 1024, 1536, False, True),  # train-step widths at b 8
    ]
    names = ("du", "ddt", "dA", "dB", "dC", "dh0")
    failures = []
    for b, t, d, seeded, dfin in cases:
        u, dt, A, B, C, h0 = m1_inputs(gen, b, t, d, seeded)
        dy = torch.randn((b, t, d), generator=gen, device="cuda")
        dfinal = torch.randn((b, d, 16), generator=gen, device="cuda") if dfin else None
        got = [*sk.m1_scan(u, dt, A, B, C, h0), sk.m1_entry_states(u, dt, A, B, h0)]
        ref = [*sk.m1_scan_plain(u, dt, A, B, C, h0), sk.m1_entry_states_plain(u, dt, A, B, h0)]
        got += sk.m1_bwd(u, dt, A, B, C, ref[2], dy, dfinal)
        ref += sk.m1_bwd_plain(u, dt, A, B, C, ref[2], dy, dfinal)
        torch.cuda.synchronize()
        errs = {nm: rel_err(a, r) for nm, a, r in zip(("y", "hT", "states", *names), got, ref)}
        worst = max(r for _, r in errs.values())
        finite = all(bool(torch.isfinite(v).all()) for v in got)
        tag = f"fp32 b={b} t={t} d={d} seeded={seeded} dfinal={dfin}"
        print(f"check m1_scan/m1_entry_states/m1_bwd {tag}: rel "
              + " ".join(f"{k} {r:.2e}" for k, (_, r) in errs.items())
              + f"; tol rel {tol:.0e}", flush=True)
        if not finite or worst > tol:
            failures.append(f"m1 kernels {tag}: finite={finite}, rel {worst:.3e}")
        if b * t <= 2048:
            failures += m1_function_grads(sk.selective_scan_kernel, selective_scan_seq,
                                          gen, b, t, d, seeded, dfin, tag)
    if failures:
        raise SystemExit("selective scan checks failed:\n" + "\n".join(failures))

    # kernel 4 at the serving chunk step
    u, dt, A, B, C, h0 = m1_inputs(gen, 1, 256, 1536, True)
    errs = [rel_err(a, r) for a, r in zip(sk.m1_scan(u, dt, A, B, C, h0),
                                          sk.m1_scan_plain(u, dt, A, B, C, h0))]
    err, rel = max(e for e, _ in errs), max(r for _, r in errs)
    if rel > tol:
        raise SystemExit(f"m1_scan at the serving chunk: rel {rel:.3e} > {tol:.0e}")
    ms = cuda_ms(lambda: sk.m1_scan(u, dt, A, B, C, h0), 50)
    plain_ms = cuda_ms(lambda: sk.m1_scan_plain(u, dt, A, B, C, h0), 3, 1)
    (nb, ne, nf), _, _ = m1_work(1, 256, 1536, 16, True, False)
    bound_ms, bound_by = m1_bound(nb, ne, nf)
    print(f"time m1_scan fp32 b=1 t=256 d=1536 seeded (the serving chunk step, "
          f"{-(-1536 // 32)} CTAs): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by}: {nb} B, {ne} exp, {nf} FLOP)", flush=True)
    rows = [dict(name="m1_scan", route="cuda",
                 source="mamba_distributed_tpu_torch/ops/cuda/csrc/selective_scan.cu",
                 replaces="mamba_distributed_tpu/ops/pallas/scan_kernels.py:64",
                 launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=None)]

    # kernels 4-6 at one layer of the train step
    b, t, d = 32, 1024, 1536
    u, dt, A, B, C, _ = m1_inputs(gen, b, t, d, False)
    dy = torch.randn((b, t, d), generator=gen, device="cuda")
    states = sk.m1_entry_states_plain(u, dt, A, B)
    timed = (
        ("m1_scan", lambda: sk.m1_scan(u, dt, A, B, C),
         lambda: sk.m1_scan_plain(u, dt, A, B, C), None),
        ("m1_entry_states", lambda: sk.m1_entry_states(u, dt, A, B),
         lambda: sk.m1_entry_states_plain(u, dt, A, B), 178),
        ("m1_bwd", lambda: sk.m1_bwd(u, dt, A, B, C, states, dy),
         lambda: sk.m1_bwd_plain(u, dt, A, B, C, states, dy), 201),
    )
    for (nm, kern, plain, line), (nb, ne, nf) in zip(timed, m1_work(b, t, d, 16, False, False)):
        ref, out = plain(), kern()
        if not isinstance(ref, tuple):
            ref, out = (ref,), (out,)
        errs = [rel_err(a, r) for a, r in zip(out, ref)]
        err, rel = max(e for e, _ in errs), max(r for _, r in errs)
        del ref, out
        if rel > tol:
            raise SystemExit(f"{nm} at the train layer: rel {rel:.3e} > {tol:.0e}")
        ms = cuda_ms(kern, 10)
        plain_ms = cuda_ms(plain, 2, 1)
        bound_ms, bound_by = m1_bound(nb, ne, nf)
        print(f"time {nm} fp32 b={b} t={t} d={d} (one layer of the mamba1-280m train step): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
              f"({bound_by}: {nb} B, {ne} exp, {nf} FLOP), max_abs_err {err:.3e} "
              f"(rel {rel:.2e})", flush=True)
        if line is not None:
            rows.append(dict(name=nm, route="cuda",
                             source="mamba_distributed_tpu_torch/ops/cuda/csrc/selective_scan.cu",
                             replaces=f"mamba_distributed_tpu/ops/pallas/scan_kernels.py:{line}",
                             launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    entry, parts = m1_layout_extra(b, t, d, 16)
    print(f"m1 layout at b={b} t={t} d={d}: beyond the bounds' bytes, the entry states at "
          f"{sk.T_BLK}-step tiles add {entry} B (written by m1_entry_states, read by "
          f"m1_bwd) and the per-batch dA and per-{sk.D_BLK}-channel dB/dC partials add "
          f"{parts} B (m1_bwd)", flush=True)
    del u, dt, dy, states
    torch.cuda.empty_cache()
    return rows


def m1_function_grads(kernel_fn, seq_fn, gen, b, t, d, seeded, dfin, tag):
    """Gradients of u, delta, A, B, C, D, z, delta_bias (and h0) through
    ``selective_scan_kernel`` (the Function: kernels 4-6) and through torch
    autograd of the plain ``selective_scan_seq``, same inputs, same
    cotangents."""
    dev, n = "cuda", 16
    inp = dict(u=torch.randn((b, t, d), generator=gen, device=dev),
               delta=torch.randn((b, t, d), generator=gen, device=dev) - 3.0,
               A=-torch.exp(torch.rand((d, n), generator=gen, device=dev) * 2.77),
               B=torch.randn((b, t, n), generator=gen, device=dev),
               C=torch.randn((b, t, n), generator=gen, device=dev),
               D=torch.randn((d,), generator=gen, device=dev),
               z=torch.randn((b, t, d), generator=gen, device=dev),
               delta_bias=0.1 * torch.randn((d,), generator=gen, device=dev))
    if seeded:
        inp["initial_state"] = 0.5 * torch.randn((b, d, n), generator=gen, device=dev)
    dy = torch.randn((b, t, d), generator=gen, device=dev)
    dfinal = torch.randn((b, d, n), generator=gen, device=dev) if dfin else None
    grads = []
    for fn in (kernel_fn, seq_fn):
        leaves = {k: v.detach().clone().requires_grad_() for k, v in inp.items()}
        y, final = fn(**leaves, delta_softplus=True, return_final_state=True)
        loss = (y * dy).sum()
        if dfinal is not None:
            loss = loss + (final * dfinal).sum()
        loss.backward()
        grads.append({k: v.grad for k, v in leaves.items()})
    torch.cuda.synchronize()
    errs = {k: rel_err(grads[0][k], grads[1][k]) for k in grads[1]}
    worst = max(r for _, r in errs.values())
    print(f"check SelectiveScanFunction grads vs plain autograd {tag}: rel "
          + " ".join(f"{k} {r:.2e}" for k, (_, r) in errs.items()), flush=True)
    ok = worst <= TOL[torch.float32] and all(
        bool(torch.isfinite(v).all()) for v in grads[0].values())
    return [] if ok else [f"SelectiveScanFunction grads {tag}: rel {worst:.3e}"]


# ------------------------------------------------------------ serving path


def serve(preset: str, path_kernels: tuple[str, ...], **overrides) -> dict:
    """Serve 8 requests on a full-width engine of ``preset`` (config
    fields ``overrides``, e.g. the int8 knobs); returns the run's launch
    counts, the greedy stream and the serving numbers.  Every kernel in
    ``path_kernels`` (keys of ``build.LAUNCHES``) must have launched in
    it."""
    from mamba_distributed_tpu_torch.config import get_preset
    from mamba_distributed_tpu_torch.inference.generate import generate
    from mamba_distributed_tpu_torch.models.lm import init_lm_params, init_lm_state
    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
    from mamba_distributed_tpu_torch.ops.quant import param_bytes
    from mamba_distributed_tpu_torch.serving import GenerationRequest, ServingEngine
    from mamba_distributed_tpu_torch.serving.prefill import (
        cast_decode_params,
        chunk_inputs,
        plan_chunks,
        prefill_chunk,
    )

    cfg = get_preset(preset, ssm_impl="pallas", compute_dtype="bfloat16", **overrides)
    hybrid = bool(cfg.attn_layer_idx)
    tag = f"{preset}{' int8' if overrides else ''}"
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
    dtypes = (f"weights {cfg.serving_weight_dtype}, KV pages {cfg.kv_page_dtype}"
              if overrides else "bf16")
    print(f"serve {tag} n_layer={cfg.n_layer} {dtypes} capacity={capacity}: "
          f"{len(reqs)} requests, prompts {lens}, {n_tokens} new tokens in "
          f"{wall:.3f} s = {n_tokens / wall:.1f} tokens/s [{card}]")
    print(f"serve {tag} TTFT ms: min {ttft[0]:.1f} median {ttft[len(ttft) // 2]:.1f} "
          f"max {ttft[-1]:.1f} [{card}]")
    print(f"serve {tag} prefill: {chunk_ms / 256:.4f} ms per token "
          f"(one 256-token chunk step, batch 1: {chunk_ms:.2f} ms) [{card}]")
    tick_ms = None
    if decode_ticks:
        dt = sorted(decode_ticks)
        tick_ms = dt[len(dt) // 2] * 1e3
        print(f"serve {tag} decode: {tick_ms:.2f} ms per tick (median of "
              f"{len(dt)} decode-only ticks, {eng.tokens_per_tick} sub-steps x "
              f"{capacity} slots) [{card}]")
    print(f"serve {tag} launches during the run: {launches}; greedy stream == "
          f"generate(): True" + ("; KV pages in use at the end: 0" if hybrid else ""))
    if hybrid and not overrides:
        hybrid_one_shot(params, cfg, dparams, prompts[3][:512], new, card)
    kv = eng.pool["state"].get("attn_blocks", ())
    return dict(launches=launches, greedy=results[0].new_tokens.tolist(),
                tokens_per_s=n_tokens / wall, ttft_ms=ttft[len(ttft) // 2],
                chunk_ms=chunk_ms, tick_ms=tick_ms, weight_bytes=param_bytes(dparams),
                kv_bytes=sum(t.numel() * t.element_size() for t in kv))


def serve_int8(bf16: dict) -> dict:
    """The int8 hybrid serving run (int8 weights and int8 KV pages, the
    same requests), against the bf16 hybrid run ``bf16`` of this call:
    the int8 branches of both paged kernels must launch; resident weight
    and KV pool bytes, the greedy agreement with bf16 (printed, not
    gated) and the serving numbers side by side."""
    card = smi()
    q8 = serve("hybrid-280m", ("ssd_fwd", "ragged_decode_int8", "ragged_prefill_int8"),
               kv_page_dtype="int8", serving_weight_dtype="int8")
    if q8["launches"]["ragged_decode"] or q8["launches"]["ragged_prefill"]:
        raise SystemExit("the int8 hybrid run launched a bf16 paged kernel")
    a, b = q8["greedy"], bf16["greedy"]
    agree = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
    print(f"serve hybrid-280m int8 vs bf16: resident decode weights {q8['weight_bytes']} B vs "
          f"{bf16['weight_bytes']} B ({q8['weight_bytes'] / bf16['weight_bytes']:.3f}x), KV "
          f"pool {q8['kv_bytes']} B vs {bf16['kv_bytes']} B "
          f"({q8['kv_bytes'] / bf16['kv_bytes']:.3f}x) [{card}]")
    print(f"serve hybrid-280m int8 vs bf16 greedy stream: first {agree} of {len(a)} tokens "
          f"agree (information, not gated)")
    for key in ("tokens_per_s", "ttft_ms", "chunk_ms", "tick_ms"):
        print(f"serve hybrid-280m {key}: int8 {q8[key]}, bf16 {bf16[key]} [{card}]")
    return q8


def hybrid_one_shot(params, cfg, dparams, prompt, new: int, card: str) -> None:
    """The hybrid one-shot prefill (the full-sequence attention through
    kernel 7, K/V packed into pages): its last-position logits against
    the chunked prefill's (two 256-token chunks through kernel 11) within
    the bf16 tolerance, then one greedy ``generate(length_bucketing=False)``."""
    from mamba_distributed_tpu_torch.inference.generate import generate
    from mamba_distributed_tpu_torch.models.lm import lm_prefill
    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
    from mamba_distributed_tpu_torch.serving.prefill import chunked_prefill

    ids = torch.from_numpy(prompt)[None]
    t = ids.shape[1]
    before = LAUNCHES["flash_fwd"]
    with torch.no_grad():
        one, _ = lm_prefill(dparams, cfg, ids.cuda(), max_len=t + new)
        chunked, _ = chunked_prefill(dparams, cfg, ids, max_len=t + new)
    err, rel = rel_err(one, chunked)
    out = generate(params, cfg, ids, seed=0, max_new_tokens=new, top_k=1,
                   length_bucketing=False)[0, t:]
    ran = LAUNCHES["flash_fwd"] - before
    print(f"serve {cfg.n_layer}-layer hybrid one-shot prefill ({t} tokens) vs chunked: last "
          f"logits max_abs_err={err:.3e} (rel {rel:.2e}), tol rel {TOL[torch.bfloat16]:.0e}; "
          f"greedy generate(length_bucketing=False) {out.tolist()[:8]}...; flash_fwd "
          f"launches {ran} [{card}]", flush=True)
    if rel > TOL[torch.bfloat16] or ran < 1 or not (0 <= int(out.min()) and
                                                    int(out.max()) < cfg.vocab_size):
        raise SystemExit("the hybrid one-shot prefill disagrees with the chunked one")


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


def train_checks(card: str, preset: str = "mamba2-280m", **layers):
    """At 4 layers of ``preset``'s width (``layers`` overrides the layer
    fields, e.g. a hybrid's attention layers): one step's loss and
    gradients with ssm_impl and attn_impl "pallas" (the SSD Function,
    kernels 1-3, and the flash Function, kernels 7-9) against "xla"
    (autograd of the plain forwards), in fp32 (TF32 off) and bf16, same
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
            model = get_preset(preset, n_layer=4, ssm_impl=impl, attn_impl=impl,
                               compute_dtype=dtype, **layers)
            cfg = get_train_preset(preset, model=model, micro_batch_size=8,
                                   total_batch_size=8 * 1024)
            params = tree_map(lambda t: t.requires_grad_(), init_lm_params(
                model, torch.Generator(device="cuda").manual_seed(11), device="cuda"))
            loss, grads = loss_and_grads(params, cfg, x, y)
            res[impl] = (float(loss), tree_leaves(grads))
        tol = TRAIN_TOL[getattr(torch, dtype)]
        loss_rel = abs(res["pallas"][0] - res["xla"][0]) / abs(res["xla"][0])
        grad_rel = max(rel_err(a, b)[1] for a, b in zip(res["pallas"][1], res["xla"][1]))
        finite = all(bool(torch.isfinite(g).all()) for g in res["pallas"][1])
        print(f"train check 4-layer {preset} {dtype} b=8 t=1024 {layers}: loss pallas "
              f"{res['pallas'][0]:.6f} xla {res['xla'][0]:.6f} (rel {loss_rel:.2e}), worst "
              f"grad leaf rel {grad_rel:.2e}, tol rel {tol:.0e} [{card}]", flush=True)
        if not finite or loss_rel > tol or grad_rel > tol:
            raise SystemExit(f"pallas and xla train steps disagree ({dtype})")

    model = get_preset(preset, n_layer=4, ssm_impl="pallas", compute_dtype="bfloat16", **layers)
    cfg = get_train_preset(preset, model=model, micro_batch_size=8,
                           total_batch_size=8 * 1024, warmup_steps=1)
    params = tree_map(lambda t: t.requires_grad_(), init_lm_params(
        model, torch.Generator(device="cuda").manual_seed(12), device="cuda"))
    step = make_train_step(cfg, AdamW(cfg, params))
    losses = [float(step(params, x, y)[0]) for _ in range(10)]
    print(f"train check 4-layer {preset} bf16, one batch repeated, warmup 1: losses "
          + " ".join(f"{v:.4f}" for v in losses), flush=True)
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"the repeated-batch loss did not fall: {losses}")


def train_run(card: str, preset: str, path_kernels: tuple[str, ...]) -> tuple[dict, int]:
    """Full-width, full-depth ``preset`` (64 layers, bf16, pallas, remat)
    through the port's Trainer: 3 optimizer steps at seq 1024 and
    micro-batch 32 (16 if 32 does not fit), accum 1, with the validation
    at steps 0 and 2, on synthetic shards under build/chip_smoke/.  Every
    kernel in ``path_kernels`` must have launched.  Returns the launch
    counts of the run and its micro-batch."""
    import shutil

    from mamba_distributed_tpu_torch.config import DataConfig, get_preset, get_train_preset
    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
    from mamba_distributed_tpu_torch.training import Trainer

    root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    shutil.rmtree(root / "log", ignore_errors=True)
    model = get_preset(preset, ssm_impl="pallas", compute_dtype="bfloat16", remat=True)
    for micro in (32, 16):
        cfg = get_train_preset(
            preset, model=model, micro_batch_size=micro, total_batch_size=micro * 1024,
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
    for k in path_kernels:
        if launches[k] < 1:
            raise SystemExit(f"the {preset} train path launched no {k} kernel")
    recs = [json.loads(s) for s in (root / "log" / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in recs if r["kind"] == "train"]
    vals = [r["loss"] for r in recs if r["kind"] == "val"]
    print(f"train {preset} n_layer=64 bf16 pallas remat micro={micro} seq=1024 accum=1: "
          f"losses {[round(h[0], 6) for h in hist]}, grad norms {[round(h[1], 4) for h in hist]}, "
          f"val {vals}", flush=True)
    for r in steps:
        print(f"train {preset} step {r['step']}: {r['step_ms']} ms, {r['tokens_per_sec']} tokens/s, "
              f"MFU {r['mfu']} (model), {r.get('mfu_hw')} (hardware) [{card}]", flush=True)
    print(f"train {preset} peak device memory (max_memory_allocated): {peak_gb:.2f} GiB "
          f"[{card}]")
    print(f"train {preset} launches during the run: {launches}")
    return launches, micro


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
        inst = build.ptxas_instances(log)
        regs, spills = [r for _, r, _ in inst], [sp for _, _, sp in inst]
        print(f"ptxas {name}: {len(regs)} kernel instances, registers {min(regs)}-{max(regs)}, "
              f"spill stores up to {max(spills)} bytes")
    # the tensor-core flash forward and dk/dv instances must not spill
    # (the fp32 CUDA-core ones are printed beside them)
    flash = build.ptxas_instances(logs["flash_attention"])
    for kname, regs, sp in flash:
        if "flash_fwd" in kname or "flash_bwd_dkv" in kname:
            print(f"ptxas flash_attention {kname}: {regs} registers, {sp} bytes spill stores")
    tc = [(k, sp) for k, _, sp in flash if "_tc_kernel" in k]
    if len(tc) != 6 or any(sp for _, sp in tc):
        raise SystemExit(f"tensor-core flash instances (6 expected) spill registers: {tc}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_kernel_tables()
    rpa, rpa_int8 = check_rpa(gen)
    rpp, rpp_int8 = check_rpp(gen)
    rows = [check_ssd(gen), *check_ssd_bwd(gen), rpa, rpp, *check_flash(gen, micro=32),
            *check_m1(gen), rpa_int8, rpp_int8]
    if not args.kernels_only:
        card = smi()
        ssd_launches = serve("mamba2-280m", ("ssd_fwd",))["launches"]
        hybrid = serve("hybrid-280m", ("ssd_fwd", "ragged_decode", "ragged_prefill"))
        launches = hybrid["launches"]
        q8_launches = serve_int8(hybrid)["launches"]
        m1_launches = serve("mamba1-280m", ("m1_scan",))["launches"]
        torch.cuda.empty_cache()
        print(f"torch.mm(..., out_dtype=torch.float32) differentiable: "
              f"{mm_out_dtype_has_grad()}", flush=True)
        ssd_train = ("ssd_fwd", "ssd_chunk_states", "ssd_bwd")
        train_launches, _ = train_run(card, "mamba2-280m", ssd_train)
        train_checks(card)
        flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
        hyb_launches, micro = train_run(card, "hybrid-280m", ssd_train + flash)
        if micro != 32:
            print(f"note: the flash kernels were timed at micro-batch 32, the hybrid train "
                  f"run took {micro}")
        train_checks(card, "hybrid-280m", attn_layer_idx=(1, 3))
        m1_train = ("m1_scan", "m1_entry_states", "m1_bwd")
        m1_train_launches, _ = train_run(card, "mamba1-280m", m1_train)
        train_checks(card, "mamba1-280m")
        # each kernel's launches on its own path: the mamba2 serving run
        # for ssd_fwd, the mamba2 training run for the SSD backward
        # kernels, the hybrid serving run for the paged attention kernels,
        # the hybrid training run for the flash kernels, the mamba1
        # serving run for m1_scan, the mamba1 training run for the scan
        # backward kernels, the int8 hybrid serving run for the int8
        # branches of the paged attention kernels
        for row, n in zip(rows, (ssd_launches["ssd_fwd"], train_launches["ssd_chunk_states"],
                                 train_launches["ssd_bwd"], launches["ragged_decode"],
                                 launches["ragged_prefill"], *(hyb_launches[k] for k in flash),
                                 m1_launches["m1_scan"], m1_train_launches["m1_entry_states"],
                                 m1_train_launches["m1_bwd"], q8_launches["ragged_decode_int8"],
                                 q8_launches["ragged_prefill_int8"]), strict=True):
            row["launches"] = n
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s from the build to here", flush=True)
    print(smi())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
