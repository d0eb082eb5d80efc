"""Where the training path's time goes on the card.

    python3 -m mamba_distributed_tpu_torch.profile_training [--preset mamba1-280m]
        [--micro-batch-size 32] [--seq-len 1024] [--remat-policy mixer]
        [--loss-impl blocked]
    python3 -m mamba_distributed_tpu_torch.profile_training --preset hybrid-7b \
        --n-layer 8 --micro-batch-size 4 --seq-len 4096

Builds the full-width preset (mamba2-280m by default, or any training
preset, e.g. hybrid-280m, mamba1-280m or hybrid-7b; full depth unless
``--n-layer`` cuts it, keeping the attention layers below the cut;
bf16, ``ssm_impl="pallas"``, ``attn_impl="auto"``, remat under
``--remat-policy``, the loss of ``--loss-impl``, random weights from a
seeded generator), runs one
warm-up train step (AdamW, accum 1) on random token ids, times
one step without the profiler, prints the peak device memory of the
steps, and traces one with ``torch.profiler``:
the host wall time, the device busy time (sum of kernel times on the one
stream), the busy share, the launch count, the device time of the
hand-written SSD kernels, of the hand-written flash attention kernels,
of the GEMMs and of every other kernel, each hand-written kernel's own
device time and launches, and the kernels that take the most device
time, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from mamba_distributed_tpu_torch.config import (
    TRAIN_PRESETS,
    MeshConfig,
    get_preset,
    get_train_preset,
)
from mamba_distributed_tpu_torch.models.lm import init_lm_params
from mamba_distributed_tpu_torch.profile_serving import card_name, report_kernels
from mamba_distributed_tpu_torch.training.optimizer import AdamW, tree_map
from mamba_distributed_tpu_torch.training.train_step import make_train_step


def _kernels(prof) -> tuple[dict[str, float], list[tuple[str, float, int]]]:
    """Device ms of the hand-written SSD, selective-scan and flash kernels,
    the GEMMs, the rest; and (name, device ms, launches) of every
    hand-written kernel instance."""
    groups = {"hand SSD kernels": 0.0, "hand scan kernels": 0.0, "hand flash kernels": 0.0,
              "GEMMs": 0.0, "other kernels": 0.0}
    hand = {"ssd": "hand SSD kernels", "m1": "hand scan kernels", "flash": "hand flash kernels"}
    instances = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / 1e3
        name = e.key.removeprefix("void ").removeprefix("(anonymous namespace)::").split("(")[0]
        if name.split("_")[0] in hand:
            key = hand[name.split("_")[0]]
            instances.append((name, ms, e.count))
        elif any(s in e.key.lower() for s in ("gemm", "xmma", "cutlass", "cublas", "nvjet",
                                              "sm90_")):
            key = "GEMMs"
        else:
            key = "other kernels"
        groups[key] += ms
    return groups, sorted(instances, key=lambda x: -x[1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="mamba2-280m", choices=sorted(TRAIN_PRESETS))
    ap.add_argument("--micro-batch-size", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--n-layer", type=int, default=None)
    ap.add_argument("--remat-policy", choices=["all", "dots", "mixer"], default="all")
    ap.add_argument("--loss-impl", choices=["dense", "blocked"], default="dense")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_training needs a CUDA device")
    card = card_name()
    b, t = args.micro_batch_size, args.seq_len
    depth = {}
    if args.n_layer is not None:
        depth = dict(n_layer=args.n_layer, attn_layer_idx=tuple(
            i for i in get_preset(args.preset).attn_layer_idx if i < args.n_layer))
    model = get_preset(args.preset, ssm_impl="pallas", compute_dtype="bfloat16", remat=True,
                       remat_policy=args.remat_policy, loss_impl=args.loss_impl, **depth)
    name = (f"{args.preset} ({model.n_layer} layers, remat {args.remat_policy}, "
            f"{args.loss_impl} loss)")
    # one process on one card, whatever mesh the preset names
    cfg = get_train_preset(args.preset, model=model, micro_batch_size=b,
                           total_batch_size=b * t, seq_len=t, mesh=MeshConfig())
    params = tree_map(lambda p: p.requires_grad_(), init_lm_params(
        model, torch.Generator(device="cuda").manual_seed(0), device="cuda"))
    step = make_train_step(cfg, AdamW(cfg, params))
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randint(0, model.vocab_size, (1, b, t), generator=gen, device="cuda")
    y = torch.randint(0, model.vocab_size, (1, b, t), generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    step(params, x, y)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(params, x, y)
    torch.cuda.synchronize()
    print(f"{name} train step (micro {b}, seq {t}) without the profiler: wall "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms, peak device memory "
          f"(max_memory_allocated) {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"[{card}]")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_kernels(f"{name} train step (micro {b}, seq {t})", prof, wall, card, top=12)
    groups, instances = _kernels(prof)
    print("  by group: " + ", ".join(f"{k} {v:.2f} ms" for k, v in groups.items()))
    print("  hand kernels: " + ", ".join(f"{k} {ms:.2f} ms ({n}x)" for k, ms, n in instances))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
