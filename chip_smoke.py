"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py              # the whole run (one card)
    python3 chip_smoke.py --kernels-only

Phases, each of which fails the run (nonzero exit, no result line):

1. build every CUDA kernel of the port from the sources in the checkout
   (one nvcc per source, all started together);
2. hold each kernel against its plain PyTorch version on the card at
   the serving path's shapes (mamba2-280m: 24 heads, headdim 64,
   d_state 128), in fp32 with TF32 off and in bf16, and time both;
3. serve requests on a full-width mamba2-280m ``ServingEngine`` (64
   layers, bf16, ``ssm_impl="pallas"``, random weights from a seeded
   ``torch.Generator``): prompts of 12 and 100 tokens take the one-shot
   prefill, 300 and 700 the chunked prefill.  The kernels' launch
   counts are zeroed just before and read just after; every kernel of
   the path must have launched.  One greedy request's stream must equal
   the port's solo ``generate()``;
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


# ------------------------------------------------------------ serving path


def serve():
    from mamba_distributed_tpu_torch.config import get_preset
    from mamba_distributed_tpu_torch.inference.generate import generate
    from mamba_distributed_tpu_torch.models.lm import init_lm_params, init_lm_state
    from mamba_distributed_tpu_torch.ops.cuda import ssd_kernels
    from mamba_distributed_tpu_torch.serving import GenerationRequest, ServingEngine
    from mamba_distributed_tpu_torch.serving.prefill import (
        cast_decode_params,
        chunk_inputs,
        plan_chunks,
        prefill_chunk,
    )

    cfg = get_preset("mamba2-280m", ssm_impl="pallas", compute_dtype="bfloat16")
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
    for k in ssd_kernels.LAUNCHES:
        ssd_kernels.LAUNCHES[k] = 0
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
    launches = dict(ssd_kernels.LAUNCHES)
    results = [eng.results[i] for i in ids]

    n_tokens = sum(len(r.new_tokens) for r in results)
    for r in results:
        if len(r.new_tokens) != new or not (0 <= r.new_tokens.min() and
                                            r.new_tokens.max() < cfg.vocab_size):
            raise SystemExit(f"request {r.request_id}: bad stream {r.new_tokens}")
    if launches["ssd_fwd"] < 1:
        raise SystemExit("the serving path launched no ssd_fwd kernel")
    ttft = sorted((tracked[i].t_first_token - tracked[i].t_submit) * 1e3 for i in ids)

    solo = generate(params, cfg, torch.from_numpy(prompts[0])[None], seed=0,
                    max_new_tokens=new, top_k=1, decode_rows=capacity)
    solo = solo[0, len(prompts[0]):].tolist()
    if solo != results[0].new_tokens.tolist():
        raise SystemExit(f"engine greedy stream {results[0].new_tokens.tolist()} != "
                         f"generate() {solo}")

    # prefill cost per token: one chunked-prefill step (256 tokens, batch 1)
    dparams = cast_decode_params(params, cfg)
    plan = plan_chunks(700, cfg.effective_prefill_chunk_tokens)
    cids, cmask = chunk_inputs(prompts[3], plan, 1, device=eng.device)
    st = init_lm_state(cfg, 1, device=eng.device)
    with torch.no_grad():
        chunk_ms = cuda_ms(lambda: prefill_chunk(dparams, cids, cmask, st, cfg), 3, 1)
    card = smi()
    print(f"serve mamba2-280m n_layer={cfg.n_layer} bf16 capacity={capacity}: "
          f"{len(reqs)} requests, prompts {lens}, {n_tokens} new tokens in "
          f"{wall:.3f} s = {n_tokens / wall:.1f} tokens/s [{card}]")
    print(f"serve TTFT ms: min {ttft[0]:.1f} median {ttft[len(ttft) // 2]:.1f} "
          f"max {ttft[-1]:.1f} [{card}]")
    print(f"serve prefill: {chunk_ms / 256:.4f} ms per token "
          f"(one 256-token chunk step, batch 1: {chunk_ms:.2f} ms) [{card}]")
    if decode_ticks:
        dt = sorted(decode_ticks)
        print(f"serve decode: {dt[len(dt) // 2] * 1e3:.2f} ms per tick (median of "
              f"{len(dt)} decode-only ticks, {eng.tokens_per_tick} sub-steps x "
              f"{capacity} slots) [{card}]")
    print(f"serve launches during the run: {launches}; greedy stream == generate(): True")
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
    row = check_ssd(gen)
    if not args.kernels_only:
        launches = serve()
        row["launches"] = launches["ssd_fwd"]
    print(smi())
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
