"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py              # the whole run (one card)
    python3 chip_smoke.py --kernels-only

Phases, each of which fails the run (nonzero exit, no result line):

1. build every CUDA kernel of the port from the sources in the checkout
   (one nvcc per source, all started together);
2. hold each kernel against its plain PyTorch version on the card at
   the serving paths' shapes, in fp32 with TF32 off and in bf16, and
   time both, beside a bound from the bytes and operations the work
   needs and, for attention, a PyTorch SDPA call on the pre-gathered
   cache view: ``ssd_fwd`` at mamba2-280m's (24 heads, headdim 64,
   d_state 128); ``rpa_fwd`` (paged decode) and ``rpp_fwd`` (fused page
   write + chunk prefill) at hybrid-280m's (12 query / 4 KV heads,
   head dim 64, pages of 64 tokens, 16 pages per slot) over ragged
   length mixes, with the written pages compared bit for bit;
3. serve requests on a full-width mamba2-280m ``ServingEngine`` (64
   layers, bf16, ``ssm_impl="pallas"``, random weights from a seeded
   ``torch.Generator``): prompts of 12 and 100 tokens take the one-shot
   prefill, 300 and 700 the chunked prefill; then on a full-width
   hybrid-280m engine (64 layers, 8 of them attention over the paged
   KV cache), where every prompt takes the chunked prefill.  Before
   each run the kernels' launch counts are zeroed, and after it every
   kernel of that path must have launched.  One greedy request's stream
   must equal the port's solo ``generate()``, and a hybrid engine must
   end with no KV page in use;
4. print the serving numbers, the card's name and power limit, one
   ``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.

It imports nothing of JAX or of the JAX package, and exits nonzero when
no card is visible or the port's package is not beside it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16
# kernel-vs-plain tolerances, as max|kernel - plain| / max|plain|:
# fp32 differs only by summation order; bf16 also by where each side
# rounds (the kernel at the TPU kernel's cast points, the plain version
# at ops/ssd.py's), a few bf16 ulps (2^-8 relative each)
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels, skip the serving run")
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [check_ssd(gen), check_rpa(gen), check_rpp(gen)]
    if not args.kernels_only:
        ssd_launches = serve("mamba2-280m", ("ssd_fwd",))
        launches = serve("hybrid-280m", ("ssd_fwd", "ragged_decode", "ragged_prefill"))
        # each kernel's launches on its own path: the mamba2 run for
        # ssd_fwd, the hybrid run for the attention kernels
        for row, n in zip(rows, (ssd_launches["ssd_fwd"], launches["ragged_decode"],
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
