"""The flash attention kernels on the card, against another build of their
source.

    python3 -m mamba_distributed_tpu_torch.profile_flash [--baseline DIR]

Builds ``ops/cuda/csrc/flash_attention.cu`` and, with ``--baseline``,
the same file of the checkout at DIR (e.g. the parent commit, unpacked
with ``git archive`` under ``build/archive/``), both with
``build.NVCC_FLAGS``, and prints the count of ``HGMMA`` instructions in
each kernel of this tree's build (``cuobjdump -sass``).  Then, at one
attention layer of the hybrid-280m train step (b 32, t 1024, 12 query /
4 KV heads, hd 64, bf16, q/k/v the mixer's strided views), checks that
both builds agree with the plain versions, and times ``flash_fwd``,
``flash_bwd_dq``, ``flash_bwd_dkv`` and dq + dk/dv together, in turns
baseline, this tree, this tree, baseline: ms, achieved TFLOP/s over the
causal FLOPs of ``flash_kernels.flash_work`` and the share of the bound,
beside the card's name and power limit.  ``chip_smoke.py`` times SDPA
beside the same kernels.  Exits nonzero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import re
import subprocess
import sys
from pathlib import Path

import torch

from mamba_distributed_tpu_torch.ops.cuda import build
from mamba_distributed_tpu_torch.ops.cuda import flash_kernels as fk
from mamba_distributed_tpu_torch.ops.cuda.timing import bound, cuda_ms, rel_err
from mamba_distributed_tpu_torch.profile_serving import card_name

SRC = Path("mamba_distributed_tpu_torch/ops/cuda/csrc/flash_attention.cu")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, help="checkout whose flash_attention.cu to time too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_flash: no CUDA device visible", file=sys.stderr)
        return 2
    card = card_name()
    base_proc = None
    if args.baseline is not None:
        src = args.baseline / SRC
        digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
        base_out = build.BUILD_DIR / f"libbaseline_flash_{digest}.so"
        base_proc = build.start_nvcc(src, base_out)
    libs = {"this tree": None}  # None: the package's own build
    build.build_all(["flash_attention"])
    if base_proc is not None:
        log, _ = base_proc.communicate()
        if base_proc.returncode != 0:
            raise SystemExit(f"nvcc failed for the baseline:\n{log}")
        libs["baseline"] = fk.declare(ctypes.CDLL(str(base_out)))
    for name, n in hgmma_counts(build.library_path("flash_attention")).items():
        print(f"SASS HGMMA instructions, this tree: {name}: {n}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((B, T, (NH + 2 * NKV) * HD), generator=gen, device="cuda").bfloat16()
    qt = qkv[..., :NH * HD].reshape(B, T, NH, HD).transpose(1, 2)
    kt = qkv[..., NH * HD:(NH + NKV) * HD].reshape(B, T, NKV, HD).transpose(1, 2)
    vt = qkv[..., (NH + NKV) * HD:].reshape(B, T, NKV, HD).transpose(1, 2)
    do = torch.randn((B, NH, T, HD), generator=gen, device="cuda").bfloat16()
    o_p, lse_p = fk.flash_fwd_plain(qt, kt, vt, 0, T)
    delta = (do.float() * o_p.float()).sum(-1).contiguous()
    dk_p, dv_p = fk.flash_bwd_dkv_plain(qt, kt, vt, do, lse_p, delta, 0, T)
    bwd = (qt, kt, vt, do, lse_p, delta, 0, T)
    for who, lib in libs.items():
        o, lse = fk.flash_fwd(qt, kt, vt, 0, T, lib=lib)
        dk, dv = fk.flash_bwd_dkv(*bwd, lib=lib)
        errs = [rel_err(a, r)[1] for a, r in ((o, o_p), (lse, lse_p), (dk, dk_p), (dv, dv_p))]
        print(f"check {who}: rel o {errs[0]:.2e} lse {errs[1]:.2e} dk {errs[2]:.2e} "
              f"dv {errs[3]:.2e} (tol 3e-02)", flush=True)
        if max(errs) > 3e-2:
            raise SystemExit(f"{who}: the flash kernels disagree with the plain versions")

    kernels = {
        "flash_fwd": lambda lib: fk.flash_fwd(qt, kt, vt, 0, T, lib=lib),
        "flash_bwd_dq": lambda lib: fk.flash_bwd_dq(*bwd, lib=lib),
        "flash_bwd_dkv": lambda lib: fk.flash_bwd_dkv(*bwd, lib=lib),
        "flash_bwd_dq + flash_bwd_dkv": lambda lib: (fk.flash_bwd_dq(*bwd, lib=lib),
                                                     fk.flash_bwd_dkv(*bwd, lib=lib)),
    }
    (fb, ff), (qb, qf), (kb, kf) = fk.flash_work(B, T, T, NH, NKV, HD, 0, torch.bfloat16)
    # the pair reads q, k, v, dO, lse and delta once between them
    shared = 2 * qt.numel() * 2 + 2 * kt.numel() * 2 + 2 * B * NH * T * 4
    work = {"flash_fwd": (fb, ff), "flash_bwd_dq": (qb, qf), "flash_bwd_dkv": (kb, kf),
            "flash_bwd_dq + flash_bwd_dkv": (qb + kb - shared, qf + kf)}
    order = ["baseline", "this tree", "this tree", "baseline"] if len(libs) > 1 else ["this tree"]
    shape = f"bf16 b={B} t={T} nh={NH} nkv={NKV} hd={HD}"
    for name, fn in kernels.items():
        nbytes, flops = work[name]
        bound_ms, _ = bound(nbytes, flops)
        times: dict[str, list[float]] = {}
        for who in order:
            times.setdefault(who, []).append(cuda_ms(lambda: fn(libs[who]), ITERS))
        for who, ms in times.items():
            best = min(ms)
            print(f"time {name} {shape} {who}: " + ", ".join(f"{x:.4f}" for x in ms)
                  + f" ms; {flops / best / 1e9:.1f} TFLOP/s, {bound_ms / best:.4f} of the bound "
                  f"({bound_ms:.6f} ms) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
