"""Where the training path's time goes on the card.

    python3 -m mamba_distributed_tpu_torch.profile_training [--preset mamba1-280m]
        [--micro-batch-size 32]

Builds the full-width, full-depth preset (mamba2-280m by default, or
any training preset, e.g. hybrid-280m or mamba1-280m: 64 layers, bf16,
``ssm_impl="pallas"``, ``attn_impl="auto"``, remat, random weights from
a seeded generator), runs one
warm-up train step (AdamW, accum 1, seq 1024) on random token ids, times
one step without the profiler, and traces one with ``torch.profiler``:
the host wall time, the device busy time (sum of kernel times on the one
stream), the busy share, the launch count, the device time of the
hand-written SSD kernels, of the hand-written flash attention kernels,
of the GEMMs and of every other kernel, and the kernels that take the
most device time, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from mamba_distributed_tpu_torch.config import TRAIN_PRESETS, get_preset, get_train_preset
from mamba_distributed_tpu_torch.models.lm import init_lm_params
from mamba_distributed_tpu_torch.profile_serving import card_name, report_kernels
from mamba_distributed_tpu_torch.training.optimizer import AdamW, tree_map
from mamba_distributed_tpu_torch.training.train_step import make_train_step


def _groups(prof) -> dict[str, float]:
    """Device ms of the hand-written SSD, selective-scan and flash kernels,
    the GEMMs, the rest."""
    out = {"hand SSD kernels": 0.0, "hand scan kernels": 0.0, "hand flash kernels": 0.0,
           "GEMMs": 0.0, "other kernels": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        name = e.key.lower()
        if "ssd_" in name.split("<")[0]:
            key = "hand SSD kernels"
        elif "m1_" in name.split("<")[0]:
            key = "hand scan kernels"
        elif "flash_" in name.split("<")[0]:
            key = "hand flash kernels"
        elif any(s in name for s in ("gemm", "xmma", "cutlass", "cublas", "nvjet", "sm90_")):
            key = "GEMMs"
        else:
            key = "other kernels"
        out[key] += e.self_device_time_total / 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="mamba2-280m", choices=sorted(TRAIN_PRESETS))
    ap.add_argument("--micro-batch-size", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_training needs a CUDA device")
    card = card_name()
    b, t = args.micro_batch_size, 1024
    name = args.preset
    model = get_preset(name, ssm_impl="pallas", compute_dtype="bfloat16", remat=True)
    cfg = get_train_preset(name, model=model, micro_batch_size=b, total_batch_size=b * t)
    params = tree_map(lambda p: p.requires_grad_(), init_lm_params(
        model, torch.Generator(device="cuda").manual_seed(0), device="cuda"))
    step = make_train_step(cfg, AdamW(cfg, params))
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randint(0, model.vocab_size, (1, b, t), generator=gen, device="cuda")
    y = torch.randint(0, model.vocab_size, (1, b, t), generator=gen, device="cuda")
    step(params, x, y)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(params, x, y)
    torch.cuda.synchronize()
    print(f"{name} train step (micro {b}, seq {t}) without the profiler: wall "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms [{card}]")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_kernels(f"{name} train step (micro {b}, seq {t})", prof, wall, card, top=12)
    print("  by group: " + ", ".join(f"{k} {v:.2f} ms" for k, v in _groups(prof).items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
