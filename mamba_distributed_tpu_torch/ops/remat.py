"""Per-block activation checkpointing with the JAX package's save
policies (``_remat``, models/lm.py:342-353 there).

- ``"all"``: save only the block's input; the backward recomputes the
  whole block, the mixers' forward kernels included.
- ``"dots"`` (``dots_with_no_batch_dims_saveable``): save the outputs of
  the 2-D matrix products, which are ``aten.mm`` and ``aten.addmm`` for
  the port's ``linear`` and Mamba-1's ``dt_proj``; the batched products
  (``bmm``: the MoE dispatch and expert products, the plain SSD and
  attention) and every elementwise op are recomputed.  PyTorch's
  selective checkpointing sees these aten ops.
- ``"mixer"`` (``save_only_these_names("mixer_out")``): save only each
  mixer core's output, so the backward never runs the SSD, scan or
  flash forward again.  Those cores are ``torch.autograd.Function``s
  whose forward launches a hand kernel through ``ctypes``, which no
  dispatch mode sees.  So their forwards call ``core_output``: while a
  block's forward runs, it keeps what the forward kernel returned; while
  the block is recomputed, it hands that back instead of launching it
  again.  The Function still runs on recompute, so its backward gets
  the inputs it saves (recomputed from the saved block input).  What is
  kept per layer: the SSD's y without D (b, t, h, p) in the compute dtype
  and, only where the caller asked for it, its final state; the
  selective scan's fp32 y (b, t, d_inner) and final state (b, d_inner,
  n); the flash forward's o (b, nh, t, hd) and fp32 lse (b, nh, t).
  Under ``ssm_impl="xla"`` the core is plain autograd with nothing to
  skip, and ``"mixer"`` recomputes it as ``"all"`` does.
"""

from __future__ import annotations

import functools
import threading

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

# the 2-D matrix products that "dots" saves
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


# the record or replay of the block being run, per thread: the forward
# runs on the caller's thread, a recompute on the autograd engine's
_state = threading.local()


class _CoreOutputs:
    """The mixer-core outputs of one checkpointed block, in call order."""

    def __init__(self):
        self.outputs: list = []
        self.next: int | None = None  # None while recording


class _Use:
    """Context of one block's forward (record) or of its recomputes
    (replay, re-entered on each one)."""

    def __init__(self, saved: _CoreOutputs, replay: bool):
        self.saved, self.replay = saved, replay

    def __enter__(self):
        self.prev = getattr(_state, "saved", None)
        if self.replay:
            self.saved.next = 0
        _state.saved = self.saved

    def __exit__(self, *exc):
        _state.saved = self.prev


def core_output(fn):
    """``fn()``: the forward kernel of a mixer core (a tuple of tensors,
    or None in place of an output the caller does not need).  Inside a
    block checkpointed with ``"mixer"`` its outputs are kept on the
    block's forward and returned, without calling ``fn``, on the block's
    recompute; elsewhere ``fn()`` simply runs."""
    saved = getattr(_state, "saved", None)
    if saved is None:
        return fn()
    if saved.next is not None:
        out = saved.outputs[saved.next]
        saved.next += 1
        return out
    out = fn()
    saved.outputs.append(out)
    return out


def _mixer_contexts():
    saved = _CoreOutputs()
    return _Use(saved, False), _Use(saved, True)


def remat_block(fn, policy: str, *args):
    """``fn(*args)`` checkpointed as one block under ``policy`` ("all",
    "dots" or "mixer"); non-reentrant, so ``fn`` may return a tuple."""
    if policy == "all":
        return checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    elif policy == "mixer":
        context_fn = _mixer_contexts
    else:
        raise ValueError(f"unknown remat policy {policy!r}")
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)
