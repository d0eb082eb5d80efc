"""Which version of a kernel a call runs: one rule, used everywhere.

Counterpart of ``mamba_distributed_tpu/ops/pallas/common.py``
(``resolve_interpret``/``on_tpu``), where a Pallas kernel runs compiled
on a TPU and interpreted elsewhere.  Here:

* ``impl="xla"``: the plain PyTorch version, on any device;
* ``impl="pallas"`` (or ``"auto"``, which ``attn_impl`` defaults to) and
  a CUDA tensor: the hand-written kernel.  It launches or it raises;
  nothing falls back to the plain version;
* ``impl="pallas"``/``"auto"`` and a CPU tensor: the plain version (the
  CPU tests).

``cfg.ssm_impl`` and ``cfg.attn_impl`` both go through this rule.
"""

from __future__ import annotations

import torch


def use_kernel(impl: str, x: torch.Tensor) -> bool:
    """True when ``x`` must go through the hand-written CUDA kernel."""
    if impl == "xla":
        return False
    if impl not in ("pallas", "auto"):
        raise ValueError(f"impl must be 'xla', 'pallas' or 'auto', got {impl!r}")
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(
        f"no kernel or plain route for a tensor on {x.device.type!r}"
    )
