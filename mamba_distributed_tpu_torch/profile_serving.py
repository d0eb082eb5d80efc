"""Where the serving path's time goes on the card.

    python3 -m mamba_distributed_tpu_torch.profile_serving [PRESET ...]

For each preset (default: mamba2-280m, hybrid-280m and mamba1-280m),
builds the
full-width ``ServingEngine`` (bf16, ``ssm_impl="pallas"``, random weights
from a seeded generator, capacity 8), fills every slot, and traces with
``torch.profiler`` (a) one decode-only engine step (``tokens_per_tick``
sub-steps over 8 slots) and (b) one 256-token chunked-prefill step at
batch 1 (for a hybrid, the second chunk of a 700-token prompt, after 188
cached tokens).  For each it prints
the host wall time, the device busy time (sum of kernel times on the one
stream), the busy share, the kernel launch count and the kernels that
take the most device time, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from mamba_distributed_tpu_torch.config import PRESETS, get_preset
from mamba_distributed_tpu_torch.models.lm import init_lm_params, init_lm_state
from mamba_distributed_tpu_torch.serving import GenerationRequest, ServingEngine
from mamba_distributed_tpu_torch.serving.prefill import (
    cast_decode_params,
    chunk_inputs,
    plan_chunks,
    prefill_chunk,
)


def card_name() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def report_kernels(label: str, prof, wall_s: float, card: str, top: int = 8) -> None:
    # kernel events only (CPU-side ops would count their kernels twice)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"{label}: wall {wall_s * 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms "
          f"({100 * busy_us / 1e3 / (wall_s * 1e3):.1f}% of wall), "
          f"{launches} kernel launches [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")


def profile_preset(preset: str, card: str) -> None:
    cfg = get_preset(preset, ssm_impl="pallas")
    hybrid = bool(cfg.attn_layer_idx)
    params = init_lm_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
    rng = np.random.default_rng(0)
    eng = ServingEngine(params, cfg, capacity=8, tokens_per_tick=8)
    for i in range(8):
        eng.submit(GenerationRequest(prompt_ids=rng.integers(0, cfg.vocab_size, 12),
                                     max_new_tokens=64, seed=i))
    eng.step()  # admissions + first tick: warm-up
    while eng.scheduler.depth or eng._prefill_queue:
        eng.step()  # a hybrid's prompts all take the chunk budget
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    print(f"{preset} decode tick without the profiler: wall "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms [{card}]")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()  # decode only: every slot is decoding
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_kernels(f"{preset} decode tick ({eng.tokens_per_tick} sub-steps x 8 slots)", prof,
            wall, card)

    dparams = cast_decode_params(params, cfg)
    plan = plan_chunks(700, cfg.effective_prefill_chunk_tokens)
    ids, mask = chunk_inputs(rng.integers(0, cfg.vocab_size, 700), plan, 1, device="cuda")
    state = init_lm_state(cfg, 1, max_len=cfg.kv_slot_tokens if hybrid else 0,
                          device="cuda")
    if hybrid:
        state["attn_meta"] = (state["attn_meta"][0],
                              torch.tensor([plan.real_tokens(0)], dtype=torch.int32,
                                           device="cuda"))
    with torch.no_grad():
        prefill_chunk(dparams, ids, mask, state, cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prefill_chunk(dparams, ids, mask, state, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    report_kernels(f"{preset} chunked-prefill step (256 tokens, batch 1)", prof, wall, card)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("presets", nargs="*", metavar="PRESET",
                    default=["mamba2-280m", "hybrid-280m", "mamba1-280m"],
                    help=f"any of {sorted(PRESETS)}")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA device")
    card = card_name()
    for preset in args.presets:
        profile_preset(preset, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
