"""Recurrent generation with top-k sampling (counterpart of
``mamba_distributed_tpu/inference/generate.py``).

Prefill builds the O(1) decode state (one-shot over the pow2 bucket, or
chunk by chunk for long prompts and for every hybrid prompt through the
same chunk step the serving engine runs; ``length_bucketing=False``
prefills one-shot, unpadded, hybrids included); the decode loop then
samples one token per ``lm_step``.

Sampling.  ``jax.random`` bits cannot be reproduced in PyTorch, so the
port draws its own: the uniform that picks step i's token of a request
comes from ``step_uniform(seed, i)`` alone (a splitmix64 hash), and the
token is the first top-k entry whose cumulative probability exceeds it.
The serving engine derives the same draw from the same (seed, step), so
a request's stream does not depend on what shares its batch.

Rows.  On a card, a matmul or a row reduction over (S, d) may take
another kernel, and so another summation order, for another row count
S.  Bit-identical streams therefore need the same row count on both
sides: ``decode_rows`` pads the decode batch with idle rows, and a solo
call with ``decode_rows=capacity`` reproduces a ``ServingEngine`` of that
capacity token for token.

Meshes.  ``generate(mesh=)`` runs on a serving mesh
(parallel/mesh.serving_mesh; every rank calls it): the weights cut over
its model and stage axes as the engine cuts them, each rank's decode
batch the rows a data rank of the engine runs (``decode_rows / data``),
so a solo call with ``mesh=engine.mesh, decode_rows=capacity`` is the
engine's computation.  A data-only mesh cuts no weights and is dropped
after the rows are set, as the JAX package drops it.
"""

from __future__ import annotations

import torch

from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.inference.bucketing import (
    next_pow2_bucket,
    pad_to_bucket,
    use_chunked_prefill,
)
from mamba_distributed_tpu_torch.models.lm import lm_prefill, lm_step
from mamba_distributed_tpu_torch.ops.dispatch import check_kernel_shapes
from mamba_distributed_tpu_torch.ops.quant import quantize_serving_params

_MASK64 = (1 << 64) - 1


def step_uniform(seed: int, i: int) -> float:
    """The uniform in [0, 1) behind step ``i`` of a request seeded
    ``seed``: splitmix64 of (seed, i), cut to 24 bits so the value is
    exact in fp32."""
    z = (seed * 0x9E3779B97F4A7C15 + (i + 1) * 0xD1B54A32D192ED03) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    z ^= z >> 31
    return (z >> 40) / float(1 << 24)


def vocab_pad_mask(cfg: ModelConfig, device=None) -> torch.Tensor:
    """(V_padded,) additive mask: 0 for real tokens, -inf for the
    vocab-padding rows (whose tied logits would be 0.0)."""
    mask = torch.zeros((cfg.vocab_size_padded,), dtype=torch.float32, device=device)
    mask[cfg.vocab_size:] = float("-inf")
    return mask


def top_k_sample(logits: torch.Tensor, u: torch.Tensor, k: int,
                 temperature: torch.Tensor, row_top_k: torch.Tensor) -> torch.Tensor:
    """Per-row top-k draw: logits (S, V) fp32, u (S,) uniforms,
    temperature (S,), row_top_k (S,) in [1, k] -> tokens (S,).

    Entries past a row's own top-k are masked out of the softmax; the
    token is the first of the row's sorted top-k whose cumulative
    probability exceeds u.  Every op is per row."""
    vals, idx = torch.topk(logits, k, dim=-1)
    col = torch.arange(k, device=logits.device)[None, :]
    vals = vals.masked_fill(col >= row_top_k[:, None], float("-inf"))
    probs = torch.softmax(vals / temperature[:, None], dim=-1)
    choice = (probs.cumsum(dim=-1) < u[:, None]).sum(dim=-1)
    choice = torch.minimum(choice, row_top_k - 1)
    return idx.gather(1, choice[:, None])[:, 0]


def _decode_params(params: dict, cfg: ModelConfig) -> dict:
    """Pre-cast matmul kernels + embedding to the compute dtype (decode
    reads every weight per token, so it reads them once in bf16): the
    mixers', the MLP's, an untied ``lm_head``'s and the MoE experts'
    ``w1``/``w2`` (which ``_moe_mlp`` casts at use anyway, so their values
    do not change).  Conv kernels, the MoE router (routed in fp32),
    biases, norm weights and SSM scalars stay fp32.  Already-cast params
    pass through unchanged (same tensors), so a caller may cast once and
    hand the result to both the engine and ``generate()``.

    ``cfg.serving_weight_dtype="int8"`` first quantizes the ``linear``
    kernels (the mixers', the MLP's and an untied head's) and the
    embedding from the fp32 masters (ops/quant.py); the cast then leaves
    the int8 codes and their fp32 scales alone.  mamba1's ``dt_proj`` and
    the MoE experts do not quantize and take the compute-dtype cast, as
    in the JAX package.  The engine and ``generate()`` share this one cast."""
    cd = cfg.torch_compute_dtype
    if cfg.serving_weight_dtype == "int8":
        params = quantize_serving_params(params)

    def cast(tree, parent=None):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = cast(v, k)
            elif k == "scale" or not v.is_floating_point():
                out[k] = v
            elif (k == "embedding" or parent == "moe"
                  or (k == "kernel" and parent not in ("conv", "router"))):
                out[k] = v.to(cd)
            else:
                out[k] = v
        return out

    return cast(params)


def _pad_rows(state: dict, logits: torch.Tensor, rows: int):
    """Pad the decode batch to ``rows`` idle rows: zero carries and
    logits; for a hybrid, a table row of the trash page 0 and length 0
    (the idle rows write and read the trash page only)."""
    conv, ssm = state["blocks"]
    b = logits.shape[0]
    if rows == b:
        return state, logits
    pconv = conv.new_zeros((conv.shape[0], rows, *conv.shape[2:]))
    pssm = ssm.new_zeros((ssm.shape[0], rows, *ssm.shape[2:]))
    pconv[:, :b] = conv
    pssm[:, :b] = ssm
    plog = logits.new_zeros((rows, logits.shape[1]))
    plog[:b] = logits
    padded = {**state, "blocks": (pconv, pssm)}
    if "attn_meta" in state:
        tbl, lengths = state["attn_meta"]
        ptbl = tbl.new_zeros((rows, tbl.shape[1]))
        plen = lengths.new_zeros((rows,))
        ptbl[:b] = tbl
        plen[:b] = lengths
        padded["attn_meta"] = (ptbl, plen)
    return padded, plog


def decode_micro(cfg: ModelConfig, mesh, width: int) -> int | None:
    """Microbatches of the GPipe decode clock for a launch of ``width``
    lanes (parallel/pipeline.pipelined_decode_layers), or None for the
    layer walk: the clock runs where JAX's engine runs it
    (``_pipeline_micro``), a pure-SSM stack on a mesh whose only axis
    above 1 is the stage axis, at ``stage`` microbatches when the width
    divides, else 1."""
    if (mesh is None or mesh.stage <= 1 or cfg.attn_layer_idx or mesh.model > 1
            or mesh.data > 1):
        return None
    return mesh.stage if width % mesh.stage == 0 else 1


def decode_loop(params: dict, cfg: ModelConfig, state: dict, last_logits,
                seeds, max_new_tokens: int, top_k: int, temperature: float,
                eos_id: int | None, rows: int, mesh=None) -> torch.Tensor:
    """(prefill state, last logits) -> (b, max_new_tokens) tokens.
    ``params`` are decode-cast; ``state`` is updated in place.  On a
    serving ``mesh`` the params and state are this rank's part."""
    b = last_logits.shape[0]
    dev = last_logits.device
    state, logits = _pad_rows(state, last_logits, max(rows, b))
    rows = logits.shape[0]
    pad_mask = vocab_pad_mask(cfg, dev)
    row_top_k = torch.full((rows,), top_k, dtype=torch.int64, device=dev)
    temp = torch.full((rows,), temperature, dtype=torch.float32, device=dev)
    done = torch.zeros((rows,), dtype=torch.bool, device=dev)
    mesh_kw = ({} if mesh is None else
               dict(tp=mesh.tp, stage=mesh.stage_ctx, pipeline=decode_micro(cfg, mesh, rows)))
    out = []
    for i in range(max_new_tokens):
        u = [step_uniform(s, i) for s in seeds] + [0.5] * (rows - b)
        tok = top_k_sample(logits + pad_mask,
                           torch.tensor(u, dtype=torch.float32, device=dev),
                           top_k, temp, row_top_k)
        if eos_id is not None:
            # finished rows keep emitting eos_id for the rest of the budget
            tok = torch.where(done, eos_id, tok)
            done = done | (tok == eos_id)
        out.append(tok[:b])
        if i + 1 < max_new_tokens:
            logits, state = lm_step(params, cfg, state, tok, **mesh_kw)
    return torch.stack(out, dim=1)


@torch.no_grad()
def generate(params: dict, cfg: ModelConfig, prompt_ids, seed: int = 0,
             max_new_tokens: int = 32, top_k: int = 50,
             temperature: float = 1.0, eos_id: int | None = None,
             length_bucketing: bool = True,
             decode_rows: int | None = None, prefix_cache=None,
             drafter=None, mesh=None) -> torch.Tensor:
    """prompt_ids (b, t) -> (b, t + max_new_tokens) tokens, on the
    device of ``params`` (fp32 masters, decode-cast here).

    Row r of the batch samples with seed ``seed + r``.  Prompts longer
    than ``cfg.effective_prefill_chunk_tokens`` prefill chunk by chunk
    through the serving chunk step; shorter ones prefill one-shot over
    their pow2 bucket (``length_bucketing=False`` prefills unpadded).
    Hybrid prompts of any length take the chunk step when chunked
    prefill is on; with ``length_bucketing=False`` or chunking off they
    prefill one-shot and unpadded through the full-sequence attention,
    their K/V packed into a private paged cache of capacity ``t +
    max_new_tokens``, as the JAX ``_generate_impl`` does.
    ``decode_rows`` pads the decode batch (see the module docstring).

    ``prefix_cache`` (a serving/prefix_cache.PrefixCache; pure-SSM,
    batch 1) reuses carry snapshots: an exact-prompt full hit skips the
    prefill (one-shot and chunked layouts), a chunked partial hit
    resumes at the first uncached chunk, and chunked prefills store
    their boundaries back.  A cache an engine warmed serves here too
    (same keys and layouts).  The one-shot path only looks up, as the
    JAX package's does, so hit and miss counts match on a shared cache.
    Hybrid configs ignore the cache (their entries pin an engine's
    pages).

    ``cfg.spec_tokens > 0`` routes greedy (``top_k=1``) batch-1 calls
    through the speculative path (serving/spec_decode.spec_generate): the
    draft -> verify -> accept/rollback loop of the engine's spec tick, so
    its stream equals a spec engine's (``decode_rows=capacity`` sets the
    verify's row count).  ``drafter`` overrides the config's (a
    ``Drafter``; ``spec_drafter="model"`` needs one) and moves only the
    acceptance rate.  Sampled or batched calls take the normal path.

    ``mesh`` (a ``ServingMesh``; every rank of it calls this) runs on the
    mesh as the module docstring says; ``params`` may then be the fp32
    masters or this rank's ``serving/prefill.ServingShard``."""
    emb = params["embedding"]
    dev = (emb["kernel"] if isinstance(emb, dict) else emb).device
    prompt = torch.as_tensor(prompt_ids, dtype=torch.int64).to(dev)
    if prompt.ndim == 1:
        prompt = prompt[None]
    b, t = prompt.shape
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if not 1 <= top_k <= cfg.vocab_size_padded:
        raise ValueError(f"top_k={top_k} out of range")
    if mesh is not None:
        # a data rank's rows; then a data-only mesh cuts nothing
        decode_rows = decode_rows // mesh.data if decode_rows else None
        if mesh.model == 1 and mesh.stage == 1:
            mesh = None
    if cfg.spec_tokens > 0 and top_k == 1 and b == 1 and length_bucketing:
        # deferred import: serving imports this module
        from mamba_distributed_tpu_torch.serving.spec_decode import spec_generate

        return spec_generate(params, cfg, prompt, max_new_tokens=max_new_tokens,
                             eos_id=eos_id, prefix_cache=prefix_cache, drafter=drafter,
                             decode_rows=decode_rows, mesh=mesh)
    if dev.type == "cuda":
        check_kernel_shapes(cfg)
    # deferred import: serving imports this module
    from mamba_distributed_tpu_torch.serving.prefill import serving_shard

    dparams = serving_shard(params, cfg, mesh)
    tp, stage = (None, None) if mesh is None else (mesh.tp, mesh.stage_ctx)
    chunk = cfg.effective_prefill_chunk_tokens
    hybrid = bool(cfg.attn_layer_idx)
    if length_bucketing and ((chunk > 0) if hybrid else use_chunked_prefill(t, chunk)):
        # deferred import: serving imports this module
        from mamba_distributed_tpu_torch.serving.prefill import chunked_prefill

        logits, state = chunked_prefill(dparams, cfg, prompt.cpu(),
                                        max_len=t + max_new_tokens if hybrid else 0,
                                        prefix_cache=None if hybrid else prefix_cache,
                                        mesh=mesh)
    elif (prefix_cache is not None and not hybrid and b == 1 and length_bucketing
          and (hit := prefix_cache.lookup(prompt[0].cpu().numpy(), None)) is not None):
        # one-shot full hit: decode from a clone (the decode writes its
        # state in place) of the snapshot an engine's admission stored
        entry = hit[0]
        logits = entry.logits
        state = {"blocks": tuple(x.clone() for x in entry.state["blocks"])}
    else:
        if length_bucketing and not hybrid:
            ids, mask = pad_to_bucket(prompt, next_pow2_bucket(t))
        else:
            ids, mask = prompt, None
        logits, state = lm_prefill(dparams, cfg, ids, max_len=t + max_new_tokens,
                                   token_mask=mask, tp=tp, stage=stage)
    new = decode_loop(dparams, cfg, state, logits, [seed + r for r in range(b)],
                      max_new_tokens, top_k, temperature, eos_id,
                      rows=decode_rows or b, mesh=mesh)
    return torch.cat([prompt, new], dim=1)
