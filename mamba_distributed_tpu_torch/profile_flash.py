"""The redesigned hand kernels (tensor cores, the split decode, the
Mamba-1 scans) on the card, against another build of their sources.

    python3 -m mamba_distributed_tpu_torch.profile_flash [--baseline DIR]

Builds the five sources ``ops/cuda/csrc/flash_attention.cu``,
``ragged_paged_attention.cu``, ``ssd_fwd.cu``, ``ssd_bwd.cu`` and
``selective_scan.cu`` and, with ``--baseline``, the same five files of the
checkout at DIR (e.g. the parent commit, unpacked with ``git archive``
under ``build/archive/``), all with ``build.NVCC_FLAGS``, and prints the
count of ``HGMMA`` instructions in each kernel of this tree's builds
(``cuobjdump -sass``).  Then checks that both builds agree with the plain
versions and times them, in turns baseline, this tree, this tree,
baseline, in six groups:

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
* the SSD chunk states (``ssd_chunk_states``) and the SSD backward
  (``ssd_bwd``, the state cotangent and the cell gradients) at one layer
  of the mamba2-280m train step (b 32, t 1024, l 256, bf16): device time
  per call beside the bounds of ``timing.ssd_bwd_work``; a baseline
  without the tensor-core route's C API (``mdt_ssd_bwd_uses_tc``) is
  called through the CUDA-core route's;
* the Mamba-1 scan kernels at fp32, d 1536: ``m1_scan`` at the serving
  chunk (b 1, t 256, seeded) and at one layer of the mamba1-280m train
  step (b 32, t 1024), ``m1_entry_states`` and ``m1_bwd`` at the train
  layer: device time per call beside the bounds of ``timing.m1_work``;
  the two builds' ``m1_entry_states`` must agree bit for bit; a baseline
  without ``m1_scan``'s geometry entry points is declared through the
  older C API;

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
from mamba_distributed_tpu_torch.ops.cuda import scan_kernels as mk
from mamba_distributed_tpu_torch.ops.cuda import ssd_kernels as sk
from mamba_distributed_tpu_torch.ops.cuda.timing import (
    RPA_TIMED,
    RPP_TIMED,
    SSD_TIMED,
    bound,
    cuda_ms,
    device_ms,
    m1_bound,
    m1_inputs,
    m1_work,
    rel_err,
    rpa_case,
    rpa_work,
    rpp_case,
    rpp_work,
    ssd_bwd_work,
    ssd_inputs,
    ssd_work,
)
from mamba_distributed_tpu_torch.ops.ssd import (
    _divisor_chunk,
    chunk_log_decay,
    ssd_chunked,
    state_passing,
)
from mamba_distributed_tpu_torch.profile_serving import card_name

_V, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# the CUDA-core route's C API of ssd_bwd.cu (before the tensor-core route),
# for a baseline build that lacks ``mdt_ssd_bwd_uses_tc``
SINGLE_ROUTE_SSD_BWD = [_V] * 15 + [_I] * 7 + [_L] * 12 + [_I, _V]


def declare_ssd_bwd(lib):
    """A build of ``ssd_bwd.cu`` with its C API declared, either route's."""
    if hasattr(lib, "mdt_ssd_bwd_uses_tc"):
        return sk.declare_bwd(lib)
    lib.mdt_ssd_bwd.argtypes = SINGLE_ROUTE_SSD_BWD
    lib.mdt_ssd_bwd.restype = _I
    return lib


def ssd_bwd(lib, args):
    """``ssd_bwd_kernel`` through the build ``lib`` (None: the package's),
    by the CUDA-core route's C API where the build has no tensor-core
    route."""
    if lib is None or hasattr(lib, "mdt_ssd_bwd_uses_tc"):
        return sk.ssd_bwd_kernel(*args, lib=lib)
    x, dt, a_cum, B, C, prev, dy, dfinal, l, _ = args
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    f32 = dict(dtype=torch.float32, device=x.device)
    outs = (torch.empty_like(x), torch.empty((b, t, h), **f32), torch.empty((b, t, h), **f32),
            torch.empty((b, t, h, n), **f32), torch.empty((b, t, h, n), **f32),
            torch.empty((b, t // l, h), **f32), torch.empty((b, h, p, n), **f32))
    err = lib.mdt_ssd_bwd(
        x.data_ptr(), dt.data_ptr(), a_cum.data_ptr(), B.data_ptr(), C.data_ptr(),
        prev.data_ptr(), dy.data_ptr(), None if dfinal is None else dfinal.data_ptr(),
        *(o.data_ptr() for o in outs), b, t, h, p, g, n, l,
        *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3],
        1 if x.dtype == torch.bfloat16 else 0, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the baseline's ssd_bwd failed: cudaError {err}")
    return outs


def declare_scan(lib):
    """A build of ``selective_scan.cu`` with its C API declared; a build
    without ``m1_scan``'s geometry entry points (before the lane-split
    scan: the same three calls) is declared without them, after checking
    the layout constants it has."""
    if hasattr(lib, "mdt_m1_scan_ctas"):
        return mk.declare(lib)
    consts = (lib.mdt_m1_state_size, lib.mdt_m1_tile, lib.mdt_m1_bwd_channels)
    for fn in consts:
        fn.argtypes, fn.restype = [], _I
    got = tuple(fn() for fn in consts)
    if got != (mk.N_STATE, mk.T_BLK, mk.D_BLK):
        raise SystemExit(f"the baseline's selective_scan.cu layout {got} differs")
    lib.mdt_m1_scan.argtypes = [_V] * 8 + [_I] * 4 + [_V]
    lib.mdt_m1_entry_states.argtypes = [_V] * 6 + [_I] * 4 + [_V]
    lib.mdt_m1_bwd.argtypes = [_V] * 14 + [_I] * 4 + [_V]
    for fn in (lib.mdt_m1_scan, lib.mdt_m1_entry_states, lib.mdt_m1_bwd):
        fn.restype = _I
    return lib


CSRC = Path("mamba_distributed_tpu_torch/ops/cuda/csrc")
# the sources, by library name, and how each build declares its C API
SOURCES = {"flash_attention": fk.declare, "ragged_paged_attention": ak.declare,
           "ssd_fwd": sk.declare_fwd, "ssd_bwd": declare_ssd_bwd,
           "selective_scan": declare_scan}
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


def time_turns(kernels, work, libs, order, shape, card, timer=None, what="",
               bound_fn=bound) -> None:
    """Time each kernel with each build in the turns of ``order``, by CUDA
    events around a loop of calls, or by ``timer`` (e.g. ``device_call_ms``),
    beside ``bound_fn(*work[name])``, whose last item is the FLOPs."""
    for name, fn in kernels.items():
        flops = work[name][-1]
        bound_ms, bound_by = bound_fn(*work[name])
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
    ap.add_argument("--baseline", type=Path, help="checkout whose five sources to time too")
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
    for group in (time_flash, time_rpp, time_rpa, time_ssd, time_ssd_bwd, time_m1):
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



def time_ssd_bwd(gen, libs, order, card) -> None:
    """The SSD chunk states and backward at one layer of the mamba2-280m
    train step."""
    b, t, l, g, bf16 = 32, 1024, 256, 1, torch.bfloat16
    inp = ssd_inputs(gen, b, t, g, bf16, False)
    x, dt, A, B, C = (inp[k] for k in ("x", "dt", "A", "B", "C"))
    h, p, n = x.shape[2], x.shape[3], B.shape[3]
    a4 = chunk_log_decay(dt, A, l)
    a_cum = a4.reshape(b, t, h).contiguous()
    states = sk.ssd_chunk_states_plain(x, dt, a_cum, B, l, bf16)
    for who, lib in libs.items():
        got = sk.ssd_chunk_states_kernel(x, dt, a_cum, B, l, bf16, lib=lib["ssd_bwd"])
        rel = rel_err(got, states)[1]
        print(f"check ssd_chunk_states b={b} t={t} {who}: rel {rel:.2e} (tol 3e-02)", flush=True)
        if rel > 3e-2:
            raise SystemExit(f"{who}: ssd_chunk_states disagrees with the plain version")
    del got
    k2, k3 = ssd_bwd_work(b, t, h, g, p, n, l, bf16, False, False)
    states_fn = lambda lib: sk.ssd_chunk_states_kernel(  # noqa: E731
        x, dt, a_cum, B, l, bf16, lib=lib["ssd_bwd"])
    time_turns({"ssd_chunk_states": states_fn}, {"ssd_chunk_states": k2}, libs, order,
               f"bf16 b={b} t={t} l={l} h={h} p={p} n={n} ({h * (t // l) * b} CTAs in both "
               f"builds)", card, device_call_ms, " of device time a call")
    prev, _ = state_passing(states, torch.exp(a4[:, :, -1]), None)
    del states
    dy = torch.randn((b, t, h, p), generator=gen, device="cuda").to(bf16)
    args = (x, dt, a_cum, B, C, prev.contiguous(), dy, None, l, bf16)
    ref = sk.ssd_bwd_plain(*args)
    for who, lib in libs.items():
        got = ssd_bwd(lib["ssd_bwd"], args)
        rel = max(rel_err(a, r)[1] for a, r in zip(got, ref, strict=True))
        print(f"check ssd_bwd b={b} t={t} {who}: rel {rel:.2e} (tol 3e-02)", flush=True)
        if rel > 3e-2:
            raise SystemExit(f"{who}: ssd_bwd disagrees with the plain version")
    del ref, got
    torch.cuda.empty_cache()
    shape = (f"bf16 b={b} t={t} l={l} h={h} p={p} n={n} ({l // 64 * h * b * t // l} CTAs of "
             f"the cell kernel in this tree, {h * b} in the CUDA-core kernel)")
    time_turns({"ssd_bwd": lambda lib: ssd_bwd(lib["ssd_bwd"], args)}, {"ssd_bwd": k3},
               libs, order, shape, card, device_call_ms, " of device time a call")
    for who, lib in libs.items():
        per = device_ms(lambda: ssd_bwd(lib["ssd_bwd"], args))
        print(f"device ssd_bwd {who}: " + ", ".join(
            f"{k.removeprefix('void (anonymous namespace)::')[:48]} {v:.4f}"
            for k, v in per.items()) + f" [{card}]", flush=True)


def time_m1(gen, libs, order, card) -> None:
    """The Mamba-1 scan kernels: ``m1_scan`` at the serving chunk and at
    one layer of the mamba1-280m train step, the backward's two kernels at
    the train layer."""
    d, n, tol = 1536, 16, 1e-4
    for b, t, seeded in ((1, 256, True), (32, 1024, False)):
        u, dt, A, B, C, h0 = m1_inputs(gen, b, t, d, seeded)
        ref = mk.m1_scan_plain(u, dt, A, B, C, h0)
        for who, lib in libs.items():
            got = mk.m1_scan(u, dt, A, B, C, h0, lib=lib["selective_scan"])
            rel = max(rel_err(a, r)[1] for a, r in zip(got, ref, strict=True))
            print(f"check m1_scan b={b} t={t} d={d} {who}: rel {rel:.2e} (tol {tol:.0e})",
                  flush=True)
            if rel > tol:
                raise SystemExit(f"{who}: m1_scan disagrees with the plain version")
        del ref, got
        shape = (f"fp32 b={b} t={t} d={d} n={n} {'seeded' if seeded else 'unseeded'} "
                 f"({mk.m1_scan_ctas(b, d)} CTAs in this tree, {b * -(-d // 32)} of one thread "
                 f"a channel before)")
        time_turns({"m1_scan": lambda lib: mk.m1_scan(u, dt, A, B, C, h0,
                                                     lib=lib["selective_scan"])},
                   {"m1_scan": m1_work(b, t, d, n, seeded, False)[0]}, libs, order, shape,
                   card, device_call_ms, " of device time a call", bound_fn=m1_bound)
    b, t = 32, 1024
    u, dt, A, B, C, _ = m1_inputs(gen, b, t, d, False)
    dy = torch.randn((b, t, d), generator=gen, device="cuda")
    states = mk.m1_entry_states_plain(u, dt, A, B)
    ref = mk.m1_bwd_plain(u, dt, A, B, C, states, dy)
    built = {}
    for who, lib in libs.items():
        scan = lib["selective_scan"]
        got = (mk.m1_entry_states(u, dt, A, B, lib=scan),
               *mk.m1_bwd(u, dt, A, B, C, states, dy, lib=scan))
        built[who] = got[0]
        rel = max(rel_err(a, r)[1] for a, r in zip(got, (states, *ref), strict=True))
        print(f"check m1_entry_states, m1_bwd b={b} t={t} d={d} {who}: rel {rel:.2e} "
              f"(tol {tol:.0e})", flush=True)
        if rel > tol:
            raise SystemExit(f"{who}: the Mamba-1 backward disagrees with the plain version")
    if "baseline" in built:
        same = bool(torch.equal(built["baseline"], built["this tree"]))
        print(f"check m1_entry_states b={b} t={t} d={d}: this tree's and the baseline's "
              f"bit-identical: {same}", flush=True)
        if not same:
            raise SystemExit("m1_entry_states differs from the baseline's build")
    del ref, got, built
    _, k5, k6 = m1_work(b, t, d, n, False, False)
    time_turns({"m1_entry_states": lambda lib: mk.m1_entry_states(
                    u, dt, A, B, lib=lib["selective_scan"]),
                "m1_bwd": lambda lib: mk.m1_bwd(u, dt, A, B, C, states, dy,
                                                lib=lib["selective_scan"])},
               {"m1_entry_states": k5, "m1_bwd": k6}, libs, order,
               f"fp32 b={b} t={t} d={d} n={n}", card, device_call_ms,
               " of device time a call", bound_fn=m1_bound)


if __name__ == "__main__":
    sys.exit(main())
