"""Timing and bounds of the hand kernels on the card, shared by
``chip_smoke.py`` and ``profile_flash.py``.

The rates are the H100 SXM data sheet's; a kernel's bound is the larger
of its bytes over the memory rate and its operations over the dense
bf16 tensor-core rate.  Nothing here touches the card at import time.
"""

from __future__ import annotations

import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms of ``fn`` over ``iters`` calls after ``warmup`` calls, by
    CUDA events around the whole loop."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for moving ``nbytes`` and
    doing ``flops`` bf16 operations on the card."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def rel_err(got, ref) -> tuple[float, float]:
    """(max |got - ref|, that over max |ref|)."""
    err = float((got.float() - ref.float()).abs().max())
    return err, err / max(float(ref.float().abs().max()), 1e-6)
