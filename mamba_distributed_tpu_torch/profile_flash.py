"""The tensor-core attention kernels on the card, against another build of
their sources.

    python3 -m mamba_distributed_tpu_torch.profile_flash [--baseline DIR]

Builds ``ops/cuda/csrc/flash_attention.cu`` and
``ops/cuda/csrc/ragged_paged_attention.cu`` and, with ``--baseline``, the
same two files of the checkout at DIR (e.g. the parent commit, unpacked
with ``git archive`` under ``build/archive/``), all with
``build.NVCC_FLAGS``, and prints the count of ``HGMMA`` instructions in
each kernel of this tree's builds (``cuobjdump -sass``).  Then checks
that both builds agree with the plain versions and times them, in turns
baseline, this tree, this tree, baseline:

* at one attention layer of the hybrid-280m train step (b 32, t 1024,
  12 query / 4 KV heads, hd 64, bf16, q/k/v the mixer's strided views)
  ``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv`` and dq + dk/dv
  together: ms, achieved TFLOP/s over the causal FLOPs of
  ``flash_kernels.flash_work`` and the share of the bound;
* the paged prefill (page write + attend, ``rpp_fwd``) at the timed case
  of ``chip_smoke.check_rpp`` (``timing.RPP_TIMED``: b 1, a 256-token
  chunk after 188 tokens), bf16 q with bf16 pages and with int8 pages:
  ms and the share of the bound of ``timing.rpp_work``, and each kernel's
  device time per call from ``torch.profiler`` (the event timer also
  counts the wrapper's host time when the kernels are shorter);

each beside the card's name and power limit.  ``chip_smoke.py`` times
SDPA beside the same kernels.  Exits nonzero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

from mamba_distributed_tpu_torch.ops.cuda import attention_kernels as ak
from mamba_distributed_tpu_torch.ops.cuda import build
from mamba_distributed_tpu_torch.ops.cuda import flash_kernels as fk
from mamba_distributed_tpu_torch.ops.cuda.timing import (
    RPP_TIMED,
    bound,
    cuda_ms,
    device_ms,
    rel_err,
    rpp_case,
    rpp_work,
)
from mamba_distributed_tpu_torch.profile_serving import card_name

CSRC = Path("mamba_distributed_tpu_torch/ops/cuda/csrc")
# the two sources, by library name, and how each build declares its C API
SOURCES = {"flash_attention": fk.declare, "ragged_paged_attention": ak.declare}
ITERS = 20
# one attention layer of the hybrid-280m train step: micro-batch 32
B, T, NH, NKV, HD = 32, 1024, 12, 4, 64


def hgmma_counts(lib: Path) -> dict[str, int]:
    """HGMMA instructions per kernel in the library's SASS (``cuobjdump
    -sass``, beside ``nvcc``)."""
    sass = subprocess.run([str(Path(build.nvcc_path()).with_name("cuobjdump")), "-sass",
                           str(lib)], capture_output=True, text=True, check=True).stdout
    return {chunk.split("\n", 1)[0].strip(): len(re.findall(r"\bHGMMA\.", chunk))
            for chunk in sass.split("Function : ")[1:]}


def build_libs(baseline: Path | None) -> dict[str, dict[str, ctypes.CDLL | None]]:
    """{"this tree": {source: None (the package's own build)}, and with a
    baseline, "baseline": {source: its declared build}}, all built in
    parallel."""
    procs = {}
    if baseline is not None:
        for name in SOURCES:
            src = baseline / CSRC / f"{name}.cu"
            out = build.BUILD_DIR / f"libbaseline_{name}_{build.source_digest(src)}.so"
            procs[name] = (out, build.start_nvcc(src, out))
    build.build_all(list(SOURCES))
    libs: dict[str, dict[str, ctypes.CDLL | None]] = {"this tree": dict.fromkeys(SOURCES)}
    if procs:
        libs["baseline"] = {}
        for name, (out, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed for the baseline's {name}.cu:\n{log}")
            libs["baseline"][name] = SOURCES[name](ctypes.CDLL(str(out)))
    return libs


def time_turns(kernels, work, libs, order, shape, card) -> None:
    """Time each kernel with each build in the turns of ``order``."""
    for name, fn in kernels.items():
        nbytes, flops = work[name]
        bound_ms, bound_by = bound(nbytes, flops)
        times: dict[str, list[float]] = {}
        for who in order:
            times.setdefault(who, []).append(cuda_ms(lambda: fn(libs[who]), ITERS))
        for who, ms in times.items():
            best = min(ms)
            print(f"time {name} {shape} {who}: " + ", ".join(f"{x:.4f}" for x in ms)
                  + f" ms; {flops / best / 1e9:.1f} TFLOP/s, {bound_ms / best:.4f} of the bound "
                  f"({bound_ms:.6f} ms, {bound_by}) [{card}]", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, help="checkout whose two sources to time too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_flash: no CUDA device visible", file=sys.stderr)
        return 2
    card = card_name()
    libs = build_libs(args.baseline)
    for src in SOURCES:
        for name, n in hgmma_counts(build.library_path(src)).items():
            if n:
                print(f"SASS HGMMA instructions, this tree: {name}: {n}")
    order = ["baseline", "this tree", "this tree", "baseline"] if len(libs) > 1 else ["this tree"]

    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((B, T, (NH + 2 * NKV) * HD), generator=gen, device="cuda").bfloat16()
    qt = qkv[..., :NH * HD].reshape(B, T, NH, HD).transpose(1, 2)
    kt = qkv[..., NH * HD:(NH + NKV) * HD].reshape(B, T, NKV, HD).transpose(1, 2)
    vt = qkv[..., (NH + NKV) * HD:].reshape(B, T, NKV, HD).transpose(1, 2)
    do = torch.randn((B, NH, T, HD), generator=gen, device="cuda").bfloat16()
    o_p, lse_p = fk.flash_fwd_plain(qt, kt, vt, 0, T)
    delta = (do.float() * o_p.float()).sum(-1).contiguous()
    dq_p = fk.flash_bwd_dq_plain(qt, kt, vt, do, lse_p, delta, 0, T)
    dk_p, dv_p = fk.flash_bwd_dkv_plain(qt, kt, vt, do, lse_p, delta, 0, T)
    bwd = (qt, kt, vt, do, lse_p, delta, 0, T)
    for who, lib in libs.items():
        lib = lib["flash_attention"]
        o, lse = fk.flash_fwd(qt, kt, vt, 0, T, lib=lib)
        dq = fk.flash_bwd_dq(*bwd, lib=lib)
        dk, dv = fk.flash_bwd_dkv(*bwd, lib=lib)
        errs = [rel_err(a, r)[1] for a, r in
                ((o, o_p), (lse, lse_p), (dq, dq_p), (dk, dk_p), (dv, dv_p))]
        print(f"check {who}: rel o {errs[0]:.2e} lse {errs[1]:.2e} dq {errs[2]:.2e} "
              f"dk {errs[3]:.2e} dv {errs[4]:.2e} (tol 3e-02)", flush=True)
        if max(errs) > 3e-2:
            raise SystemExit(f"{who}: the flash kernels disagree with the plain versions")

    def flash(lib):
        return lib["flash_attention"]

    kernels = {
        "flash_fwd": lambda lib: fk.flash_fwd(qt, kt, vt, 0, T, lib=flash(lib)),
        "flash_bwd_dq": lambda lib: fk.flash_bwd_dq(*bwd, lib=flash(lib)),
        "flash_bwd_dkv": lambda lib: fk.flash_bwd_dkv(*bwd, lib=flash(lib)),
        "flash_bwd_dq + flash_bwd_dkv": lambda lib: (fk.flash_bwd_dq(*bwd, lib=flash(lib)),
                                                     fk.flash_bwd_dkv(*bwd, lib=flash(lib))),
    }
    (fb, ff), (qb, qf), (kb, kf) = fk.flash_work(B, T, T, NH, NKV, HD, 0, torch.bfloat16)
    # the pair reads q, k, v, dO, lse and delta once between them
    shared = 2 * qt.numel() * 2 + 2 * kt.numel() * 2 + 2 * B * NH * T * 4
    work = {"flash_fwd": (fb, ff), "flash_bwd_dq": (qb, qf), "flash_bwd_dkv": (kb, kf),
            "flash_bwd_dq + flash_bwd_dkv": (qb + kb - shared, qf + kf)}
    time_turns(kernels, work, libs, order, f"bf16 b={B} t={T} nh={NH} nkv={NKV} hd={HD}", card)
    del qkv, qt, kt, vt, do, o_p, lse_p, delta, dq_p, dk_p, dv_p, bwd
    torch.cuda.empty_cache()

    # the paged prefill: each build on its own copy of the same pages
    for pages, quant in (("bf16 pages", False), ("int8 pages", True)):
        args, real = rpp_case(gen, *RPP_TIMED, torch.bfloat16, quant)
        q, kc, vc, kp, vp, tbl, ln, cr, *scales = args
        ref, _, _ = ak.ragged_paged_prefill_attention_plain(
            q, kc, vc, kp.clone(), vp.clone(), tbl, ln, cr, *scales)
        for who, lib in libs.items():
            got, _, _ = ak.ragged_paged_prefill_attention(
                q, kc, vc, kp.clone(), vp.clone(), tbl, ln, cr, *scales,
                lib=lib["ragged_paged_attention"])
            rel = rel_err(got[real], ref[real])[1]
            print(f"check rpp_fwd {pages} {who}: rel {rel:.2e} (tol 3e-02)", flush=True)
            if rel > 3e-2:
                raise SystemExit(f"{who}: rpp_fwd ({pages}) disagrees with the plain version")
        name = "rpp_fwd_int8" if quant else "rpp_fwd"
        shape = f"bf16 q, {pages}, b=1 c=256 lengths=[188] chunk_real=[256]"
        time_turns({name: lambda lib: ak.ragged_paged_prefill_attention(
                        *args, lib=lib["ragged_paged_attention"])},
                   {name: rpp_work(args)}, libs, order, shape, card)
        for who, lib in libs.items():
            per = device_ms(lambda: ak.ragged_paged_prefill_attention(
                *args, lib=lib["ragged_paged_attention"]))
            print(f"device {name} {shape} {who}: {sum(per.values()):.4f} ms a call ("
                  + ", ".join(f"{k.removeprefix('void (anonymous namespace)::')[:48]} {v:.4f}"
                             for k, v in per.items()) + f") [{card}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
