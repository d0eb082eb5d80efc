"""The hand kernels redesigned for the tensor cores and the split decode,
on the card, against another build of their sources.

    python3 -m mamba_distributed_tpu_torch.profile_flash [--baseline DIR]

Builds ``ops/cuda/csrc/flash_attention.cu``,
``ops/cuda/csrc/ragged_paged_attention.cu`` and ``ops/cuda/csrc/ssd_fwd.cu``
and, with ``--baseline``, the same three files of the checkout at DIR (e.g.
the parent commit, unpacked with ``git archive`` under ``build/archive/``),
all with ``build.NVCC_FLAGS``, and prints the count of ``HGMMA``
instructions in each kernel of this tree's builds (``cuobjdump -sass``).
Then checks that both builds agree with the plain versions and times
them, in turns baseline, this tree, this tree, baseline:

* at one attention layer of the hybrid-280m train step (b 32,
  t 1024, 12 query / 4 KV heads, hd 64, bf16, q/k/v the mixer's strided
  views) ``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv`` and dq + dk/dv
  together: ms, achieved TFLOP/s over the causal FLOPs of
  ``flash_kernels.flash_work`` and the share of the bound;
* the paged prefill (page write + attend, ``rpp_fwd``) at the
  timed case of ``chip_smoke.check_rpp`` (``timing.RPP_TIMED``: b 1, a
  256-token chunk after 188 tokens), bf16 q with bf16 pages and with int8
  pages: ms and the share of the bound of ``timing.rpp_work``, and each
  kernel's device time per call from ``torch.profiler`` (the event timer
  also counts the wrapper's host time when the kernels are shorter);
* the paged decode (``rpa_fwd``, ``rpa_fwd_int8``) at
  ``timing.RPA_TIMED`` (8 slots of hybrid-280m's attention at ragged
  lengths), bf16 q with bf16 and with int8 pages: device time per call
  (``torch.profiler``) beside the bound of ``timing.rpa_work``; a
  baseline without the split decode's C API (``mdt_rpa_splits``) is
  called through the single-pass decode's;
* the SSD forward (``ssd_fwd``) at ``timing.SSD_TIMED`` (the
  serving chunk, b 1 t 256, and one layer of the trainer's micro-batch, b
  32 t 1024, at mamba2-280m's widths, bf16): device time per call beside
  the bound of ``timing.ssd_work``;

each beside the card's name and power limit.  ``chip_smoke.py`` times
SDPA beside the attention kernels.  Exits nonzero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import sys
from pathlib import Path

import torch

from mamba_distributed_tpu_torch.ops.cuda import attention_kernels as ak
from mamba_distributed_tpu_torch.ops.cuda import build
from mamba_distributed_tpu_torch.ops.cuda import flash_kernels as fk
from mamba_distributed_tpu_torch.ops.cuda import ssd_kernels as sk
from mamba_distributed_tpu_torch.ops.cuda.timing import (
    RPA_TIMED,
    RPP_TIMED,
    SSD_TIMED,
    bound,
    cuda_ms,
    device_ms,
    rel_err,
    rpa_case,
    rpa_work,
    rpp_case,
    rpp_work,
    ssd_inputs,
    ssd_work,
)
from mamba_distributed_tpu_torch.ops.ssd import _divisor_chunk, ssd_chunked
from mamba_distributed_tpu_torch.profile_serving import card_name

CSRC = Path("mamba_distributed_tpu_torch/ops/cuda/csrc")
# the sources, by library name, and how each build declares its C API
SOURCES = {"flash_attention": fk.declare, "ragged_paged_attention": ak.declare,
           "ssd_fwd": sk.declare_fwd}
ITERS = 20
# one attention layer of the hybrid-280m train step: micro-batch 32
B, T, NH, NKV, HD = 32, 1024, 12, 4, 64


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


def device_call_ms(fn) -> float:
    """Device ms per call of everything ``fn`` launches (``torch.profiler``)."""
    return sum(device_ms(fn, ITERS).values())


def time_turns(kernels, work, libs, order, shape, card, timer=None, what="") -> None:
    """Time each kernel with each build in the turns of ``order``, by CUDA
    events around a loop of calls, or by ``timer`` (e.g. ``device_call_ms``)."""
    for name, fn in kernels.items():
        nbytes, flops = work[name]
        bound_ms, bound_by = bound(nbytes, flops)
        times: dict[str, list[float]] = {}
        for who in order:
            call = lambda: fn(libs[who])  # noqa: E731
            times.setdefault(who, []).append(
                timer(call) if timer is not None else cuda_ms(call, ITERS))
        for who, ms in times.items():
            best = min(ms)
            print(f"time {name} {shape} {who}: " + ", ".join(f"{x:.4f}" for x in ms)
                  + f" ms{what}; {flops / best / 1e9:.1f} TFLOP/s, {bound_ms / best:.4f} of the "
                  f"bound ({bound_ms:.6f} ms, {bound_by}) [{card}]", flush=True)


# the single-pass decode's C API (before the split decode), for a baseline
# build that lacks ``mdt_rpa_splits``
_V, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SINGLE_PASS_RPA = [_V] * 8 + [_I] * 6 + [_L] * 2 + [_F, _I, _I, _V]


def decode(lib, args):
    """``ragged_paged_decode_attention`` through the build ``lib`` (None:
    the package's), by the single-pass decode's C API where the build has
    no split decode."""
    if lib is None or hasattr(lib, "mdt_rpa_splits"):
        return ak.ragged_paged_decode_attention(*args, lib=lib)
    q, kp, vp, tbl, kv_len, *scales = args
    ks, vs = scales if scales else (None, None)
    S, nh, hd = q.shape
    out = torch.empty_like(q)
    lib.mdt_rpa_fwd.argtypes = SINGLE_PASS_RPA
    err = lib.mdt_rpa_fwd(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tbl.data_ptr(), kv_len.data_ptr(),
        None if ks is None else ks.data_ptr(), None if vs is None else vs.data_ptr(),
        out.data_ptr(), S, nh, kp.shape[1], hd, kp.shape[2], tbl.shape[1], q.stride(0),
        q.stride(1), 1.0 / math.sqrt(hd), 1 if q.dtype == torch.bfloat16 else 0,
        2 if kp.dtype == torch.int8 else (1 if kp.dtype == torch.bfloat16 else 0),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the baseline's rpa_fwd failed: cudaError {err}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, help="checkout whose three sources to time too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_flash: no CUDA device visible", file=sys.stderr)
        return 2
    card = card_name()
    libs = build_libs(args.baseline)
    for src in SOURCES:
        for name, n in build.hgmma_counts(build.library_path(src)).items():
            if n:
                print(f"SASS HGMMA instructions, this tree: {name}: {n}")
    order = ["baseline", "this tree", "this tree", "baseline"] if len(libs) > 1 else ["this tree"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for group in (time_flash, time_rpp, time_rpa, time_ssd):
        group(gen, libs, order, card)
        torch.cuda.empty_cache()
    return 0


def time_flash(gen, libs, order, card) -> None:
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


def time_rpp(gen, libs, order, card) -> None:
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


def time_rpa(gen, libs, order, card) -> None:
    """The paged decode at ``RPA_TIMED``, bf16 q with bf16 and int8 pages."""
    S, nh, nkv, hd, pg, W, lens = RPA_TIMED
    for pages, quant in (("bf16 pages", False), ("int8 pages", True)):
        args = rpa_case(gen, S, nh, nkv, hd, pg, W, lens, torch.bfloat16, quant)
        ref = ak.ragged_paged_decode_attention_plain(*args)
        live = args[4] > 0
        for who, lib in libs.items():
            got = decode(lib["ragged_paged_attention"], args)
            rel = rel_err(got[live], ref[live])[1]
            print(f"check rpa_fwd {pages} {who}: rel {rel:.2e} (tol 3e-02)", flush=True)
            if rel > 3e-2:
                raise SystemExit(f"{who}: rpa_fwd ({pages}) disagrees with the plain version")
        name = "rpa_fwd_int8" if quant else "rpa_fwd"
        shape = (f"bf16 q, {pages}, S={S} kv_len={lens} "
                 f"({ak.rpa_splits(S, nkv, W)} splits in this tree)")
        time_turns({name: lambda lib: decode(lib["ragged_paged_attention"], args)},
                   {name: rpa_work(args)}, libs, order, shape, card, device_call_ms,
                   " of device time a call")


def time_ssd(gen, libs, order, card) -> None:
    """The SSD forward at ``SSD_TIMED``: the serving chunk, the trainer's layer."""
    for b, t, chunk, g, seeded in SSD_TIMED:
        inp = ssd_inputs(gen, b, t, g, torch.bfloat16, seeded)
        l = _divisor_chunk(t, chunk)
        fwd = (inp["x"], inp["dt"], inp["A"], inp["B"], inp["C"], l, inp["initial_state"],
               torch.bfloat16)
        yp, sp = ssd_chunked(**{k: v for k, v in inp.items() if k != "D"}, chunk_size=chunk,
                             return_final_state=True, compute_dtype=torch.bfloat16)
        for who, lib in libs.items():
            y, s = sk._ssd_fwd(*fwd, lib=lib["ssd_fwd"])
            rel = max(rel_err(y, yp)[1], rel_err(s, sp)[1])
            print(f"check ssd_fwd b={b} t={t} {who}: rel {rel:.2e} (tol 3e-02)", flush=True)
            if rel > 3e-2:
                raise SystemExit(f"{who}: ssd_fwd disagrees with the plain version")
        shape = (f"bf16 b={b} t={t} l={l} h=24 p=64 n=128 "
                 f"{'seeded' if seeded else 'unseeded'} ({-(-l // 64) * 24 * b} CTAs in this "
                 f"tree, {24 * b} in the CUDA-core kernel)")
        time_turns({"ssd_fwd": lambda lib: sk._ssd_fwd(*fwd, lib=lib["ssd_fwd"])},
                   {"ssd_fwd": ssd_work(b, t, 24, g, 64, 128, l, torch.bfloat16, seeded)},
                   libs, order, shape, card, device_call_ms, " of device time a call")
        del inp, fwd, yp, sp


if __name__ == "__main__":
    sys.exit(main())
