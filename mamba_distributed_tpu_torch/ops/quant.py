"""Symmetric per-channel int8 quantization for the serving path
(counterpart of ``mamba_distributed_tpu/ops/quant.py``, all of it).

Weights.  A quantized leaf is a dict ``{"kernel": int8, "scale": fp32}``
whose scale keeps the kernel's rank with the reduced axis sized 1, so
``models/common.linear`` reads the orientation off the shape:

  * column-scaled kernels (``in_proj``, ``wqkv``, ``fc1``, ``lm_head``)
    scale per OUTPUT column: ``y = (x @ q) * scale``;
  * row-scaled kernels (``out_proj``, ``x_proj``, ``fc2``) scale per
    INPUT row: ``y = (x * scale) @ q``;
  * the embedding (V, d) scales per vocab row: one scale family serves
    the lookup (``q[ids] * scale[ids]``) and the tied head (``(x @ q.T)
    * scale``).

What quantizes: the matmul kernels that go through ``linear`` and the
embedding.  Conv kernels, mamba1's ``dt_proj``, biases, norm weights and
the SSM scalars stay as the decode cast leaves them.

KV pages.  ``kv_quantize`` and ``kv_requant`` are the per-(page, KV
head) page math that the plain paged attention (models/attention.py,
ops/cuda/attention_kernels.py) shares; the CUDA kernels repeat it in
registers (``rintf``, IEEE division, clip to +-127), so the pages both
write are bit-identical.

Rounding is ``torch.round`` (half to even, as ``jnp.round``) of a true
division, so codes and scales equal the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# int8 symmetric range: scales map the per-channel absmax onto +-127
Q_MAX = 127.0
# scale floor: an all-zero channel must not divide by zero (its codes are
# all zero anyway, so any finite scale round-trips it exactly)
SCALE_EPS = 1e-12

# (path-suffix pattern, channel axis from the end) of the kernels that
# ``linear`` consumes: -1 = per output column, -2 = per input row
_QUANT_RULES: tuple[tuple[tuple[str, ...], int], ...] = (
    (("mixer", "in_proj", "kernel"), -1),
    (("mixer", "out_proj", "kernel"), -2),
    (("mixer", "x_proj", "kernel"), -2),
    (("mixer", "wqkv", "kernel"), -1),
    (("mlp", "fc1", "kernel"), -1),
    (("mlp", "fc2", "kernel"), -2),
    (("lm_head", "kernel"), -1),
)


def quant_axis(names: list[str]) -> int | None:
    """Channel (scale) axis from the end for a param path, or None when
    the leaf does not quantize.  ``names`` is the tree path."""
    for pattern, ax in _QUANT_RULES:
        if tuple(names[-len(pattern):]) == pattern:
            return ax
    return None


def quantize_channels(w: torch.Tensor, axis: int) -> dict:
    """Symmetric per-channel int8 of a kernel whose channel axis is
    ``axis`` (from the end): the absmax runs over the OTHER of the two
    trailing axes, leading (layer) axes are kept.  Returns ``{"kernel":
    int8, "scale": fp32}``, the scale keeping the kernel's rank."""
    r = w.ndim
    ax = axis % r
    red = r - 1 if ax == r - 2 else r - 2
    wf = w.float()
    absmax = wf.abs().amax(dim=red, keepdim=True)
    scale = torch.clamp(absmax / Q_MAX, min=SCALE_EPS)
    q = torch.clamp(torch.round(wf / scale), -Q_MAX, Q_MAX)
    return {"kernel": q.to(torch.int8), "scale": scale}


def quantize_embedding(emb: torch.Tensor) -> dict:
    """(V, d) embedding -> per-vocab-row int8 with scale (V, 1)."""
    return quantize_channels(emb, 0)


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and "scale" in leaf and "kernel" in leaf


def quantize_serving_params(params: dict) -> dict:
    """Quantize an fp32 master tree for serving: every ``linear``-routed
    kernel named by ``_QUANT_RULES`` becomes ``{"kernel": int8, "scale":
    fp32}`` (a bias beside it rides along), and the embedding becomes
    the same dict form.  Everything else passes through.  Idempotent:
    a leaf that is already quantized is kept as it is."""

    def walk(tree, names):
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, v in tree.items():
            if is_quantized(v):
                out[k] = v
            elif k == "embedding" and not isinstance(v, dict):
                out[k] = quantize_embedding(v)
            elif (isinstance(v, dict) and "kernel" in v and not isinstance(v["kernel"], dict)
                  and (ax := quant_axis([*names, k, "kernel"])) is not None):
                out[k] = {**{kk: vv for kk, vv in v.items() if kk != "kernel"},
                          **quantize_channels(v["kernel"], ax)}
            else:
                out[k] = walk(v, (*names, k))
        return out

    return walk(params, ())


def apply_dtype_overrides(cfg, weight_dtype: str | None = None,
                          kv_dtype: str | None = None):
    """``cfg`` with the serving dtype knobs replaced where given (the one
    place the profilers' ``--weight-dtype``/``--kv-dtype`` land)."""
    kw = {}
    if weight_dtype:
        kw["serving_weight_dtype"] = weight_dtype
    if kv_dtype:
        kw["kv_page_dtype"] = kv_dtype
    return dataclasses.replace(cfg, **kw) if kw else cfg


def dequantize(leaf):
    """A quantized leaf back in fp32 (tests and error bounds; the serving
    paths fold the scale into the product instead)."""
    if is_quantized(leaf):
        return leaf["kernel"].float() * leaf["scale"]
    return leaf


def param_bytes(params) -> int:
    """Resident bytes of a (possibly quantized) param tree."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    return params.numel() * params.element_size()


# --------------------------------------------------------------------- KV


def kv_requant(q_old: torch.Tensor, ratio) -> torch.Tensor:
    """Old int8 page rows under a new scale: ``round(q_old * old/new)``,
    clipped (the ratio is <= 1 wherever the page has prior content; the
    clip guards garbage rows).  Returns fp32 codes."""
    return torch.clamp(torch.round(q_old.float() * ratio), -Q_MAX, Q_MAX)


def kv_quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """Fresh K/V rows quantized under the page's (new) scale; fp32 codes."""
    return torch.clamp(torch.round(x.float() / scale), -Q_MAX, Q_MAX)


# ----------------------------------------------------------------- parity


def assert_stream_close(
    got_tokens,
    want_tokens,
    got_logits=None,
    want_logits=None,
    *,
    rtol: float = 2e-2,
    atol: float = 5e-2,
    min_token_agreement: float = 1.0,
    sentinel=None,
    metrics=None,
    label: str = "",
) -> int:
    """The quantized-parity checker: toleranced stream agreement.

    The comparison is prefix-based: once one token differs, the tails
    are conditioned on different contexts, so agreement is the matched
    prefix over the compared length.  ``min_token_agreement=1.0`` asks
    for exact greedy agreement.  A disagreement is reported to the
    optional ``sentinel`` (one ``quant_token_disagreement`` event
    through its ``record_event``) and ``metrics`` (its
    ``record_greedy_disagreement``); the port has neither yet, so both
    stay None there.  ``got_logits``/``want_logits`` are compared with
    ``np.allclose(rtol, atol)`` over the matched prefix.  Returns the
    number of disagreeing tail tokens."""
    got = np.asarray(got_tokens).reshape(-1)
    want = np.asarray(want_tokens).reshape(-1)
    suffix = f" ({label})" if label else ""
    if got.shape != want.shape:
        raise AssertionError(f"stream lengths differ{suffix}: {got.shape} vs {want.shape}")
    n = len(got)
    neq = np.nonzero(got != want)[0]
    matched = int(neq[0]) if len(neq) else n
    disagreed = n - matched
    if disagreed:
        if sentinel is not None:
            sentinel.record_event(
                "quant_token_disagreement", label=label, first_divergence=matched,
                compared=n, got=int(got[matched]), want=int(want[matched]))
        if metrics is not None:
            metrics.record_greedy_disagreement(disagreed)
    agreement = matched / n if n else 1.0
    if agreement < min_token_agreement:
        raise AssertionError(
            f"token streams diverge at {matched}/{n}{suffix}: got[{matched}]="
            f"{got[matched]} want[{matched}]={want[matched]} (agreement "
            f"{agreement:.3f} < {min_token_agreement})")
    if got_logits is not None and want_logits is not None and matched:
        gl = np.asarray(got_logits, np.float32)[:matched]
        wl = np.asarray(want_logits, np.float32)[:matched]
        if not np.allclose(gl, wl, rtol=rtol, atol=atol):
            worst = float(np.max(np.abs(gl - wl)))
            raise AssertionError(
                f"logits diverge beyond tolerance over the matched prefix{suffix}: "
                f"max abs diff {worst:.4g} (rtol={rtol}, atol={atol})")
    return disagreed
