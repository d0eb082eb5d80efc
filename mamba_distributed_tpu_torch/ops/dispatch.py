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

``cfg.ssm_impl`` and ``cfg.attn_impl`` both go through this rule, and
``check_kernel_shapes`` refuses, when a CUDA engine, ``generate()`` or
trainer is built, a config whose kernels were not built for its shapes.

The RMSNorm kernels (ops/norm.py), which no knob selects, follow a rule
of their own (``use_norm_kernel``): the kernel on a CUDA tensor when
autograd does not need the op, the plain expression under autograd and
on the CPU.  One case is named and takes a composite on the card too:
the gated norm of a row that spans a tensor group (Mamba-2 at
``ngroups = 1`` under tensor parallelism), whose sum of squares is
all-reduced over the group, which the kernel, normalising its local
row, does not do.  (Serving over a mesh fuses that norm into the
row-parallel out_proj; its part's sum of squares asks the rule above.)
A kernel that fails to build or launch raises.
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


def use_norm_kernel(x: torch.Tensor, *others: torch.Tensor | None) -> bool:
    """True when a norm of ``x`` (with ``others``, its other inputs, None
    allowed) must go through its hand-written kernel: ``x`` lies on a
    CUDA device and autograd does not need the op (grad mode is off, or
    no input requires grad).  The train step keeps the plain expression,
    whose backward autograd takes.  The gated norm of a row that spans a
    tensor group does not ask: it takes its composite (module
    docstring)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel or plain route for a tensor on {x.device.type!r}")
    return not (torch.is_grad_enabled()
                and any(t is not None and t.requires_grad for t in (x, *others)))


def check_kernel_shapes(cfg) -> None:
    """Raise ``ValueError`` when ``cfg`` resolves to a hand-written kernel
    that was not built for its shapes, naming the shape and the built
    set.  Called where a CUDA ``ServingEngine``, ``generate()`` or
    ``Trainer`` is built, so the refusal comes at build time and not at
    the first launch; a CPU build takes the plain versions and needs no
    check.  The tables live beside each wrapper."""
    # deferred: the wrapper modules import this one
    from mamba_distributed_tpu_torch.ops.cuda import (
        attention_kernels,
        flash_kernels,
        scan_kernels,
        ssd_kernels,
    )

    n = cfg.effective_d_state
    if cfg.ssm_impl == "pallas" and cfg.ssm_layer == "mamba2":
        if (cfg.headdim, n) not in ssd_kernels.BUILT_SHAPES:
            raise ValueError(
                f"ssm_impl='pallas': the SSD kernels are not built for (headdim, "
                f"d_state)=({cfg.headdim}, {n}); built: {sorted(ssd_kernels.BUILT_SHAPES)}")
    if cfg.ssm_impl == "pallas" and cfg.ssm_layer == "mamba1":
        if n != scan_kernels.N_STATE:
            raise ValueError(
                f"ssm_impl='pallas': the selective-scan kernels are not built for "
                f"d_state={n}; built: [{scan_kernels.N_STATE}]")
    if cfg.attn_layer_idx and cfg.attn_impl != "xla":
        hd = cfg.effective_attn_head_dim
        rep = cfg.effective_attn_num_heads // cfg.effective_attn_num_kv_heads
        if hd not in flash_kernels.HEAD_DIMS:
            raise ValueError(
                f"attn_impl={cfg.attn_impl!r}: the flash kernels are not built for "
                f"head dim {hd}; built: {list(flash_kernels.HEAD_DIMS)}")
        if rep > attention_kernels.MAX_REP or hd > attention_kernels.MAX_HEAD_DIM:
            raise ValueError(
                f"attn_impl={cfg.attn_impl!r}: the ragged paged kernels are not built "
                f"for GQA rep {rep} with head dim {hd}; built: rep <= "
                f"{attention_kernels.MAX_REP}, head dim <= {attention_kernels.MAX_HEAD_DIM}")
