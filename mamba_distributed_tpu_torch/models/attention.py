"""Causal GQA self-attention with RoPE (counterpart of
``mamba_distributed_tpu/models/attention.py``): the full-sequence mixer
of training and one-shot prefill, and the hybrid stack's decode step and
prefill chunk over a paged KV cache.

GQA layout: one packed ``wqkv`` projection, ``nh`` query heads sharing
``nkv`` KV heads; rotary embedding (rotate-half) on the leading
``rotary_dim`` channels of each head.

Decode state is a PAGED KV cache with per-row lengths, as in the JAX
package:

  k_pages / v_pages  (P, nkv, page, hd)  physical pages, head-major; page
                                         0 is the trash page that masked
                                         rows write into
  page_table         (b, W) int32        row r's logical page j lives in
                                         physical page table[r, j]
  lengths            (b,) int32          tokens cached per row

Rows at different positions share one batch (per-row RoPE angles, masks
and writes).  Where the JAX package returns new page arrays, the port
writes the pages IN PLACE: the caller's tensors are updated and returned.

``cfg.attn_impl`` picks the attention (ops/dispatch.py).  The
full-sequence ``attention_mixer`` runs the flash kernels behind their
autograd Function (ops/cuda/flash_kernels.py) under "pallas"/"auto",
whose plain versions serve a CPU tensor, and the blockwise online
softmax that autograd differentiates (ops/blockwise_attention.py) under
"xla".  The paged mixers run the hand-written ragged paged kernels on a
CUDA tensor, or their plain versions (ops/cuda/attention_kernels.py).
The sequence-parallel branches of the JAX mixer (ring and Ulysses) are
not ported.
"""

from __future__ import annotations

import math

import torch

from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.models.common import init_linear, linear
from mamba_distributed_tpu_torch.ops.blockwise_attention import blockwise_sdpa_causal
from mamba_distributed_tpu_torch.ops.cuda.attention_kernels import (
    _sdpa_positions,
    gather_kv_pages,
    ragged_paged_decode_attention,
    ragged_paged_decode_attention_plain,
    ragged_paged_prefill_attention,
    ragged_paged_prefill_attention_plain,
)
from mamba_distributed_tpu_torch.ops.cuda.flash_kernels import flash_sdpa_causal

__all__ = [
    "_sdpa_positions", "apply_rope", "attention_mixer", "attention_mixer_chunk",
    "attention_mixer_step", "attention_page_count", "attention_page_meta",
    "gather_kv_pages", "init_attention_params", "init_attention_state",
    "pack_attention_pages", "rope_angles",
]


def _attn_dims(cfg: ModelConfig):
    nh = cfg.effective_attn_num_heads
    nkv = cfg.effective_attn_num_kv_heads
    hd = cfg.effective_attn_head_dim
    # -1 => full head dim; 0 => no rotary
    rot = hd if cfg.attn_rotary_dim < 0 else cfg.attn_rotary_dim
    return nh, nkv, hd, rot


def init_attention_params(cfg: ModelConfig, generator: torch.Generator,
                          n_layers: int, device=None) -> dict:
    """Layer-stacked (n_layers, ...) attention params, fp32: ``wqkv``
    (d, (nh + 2 nkv) hd) and ``out_proj`` (nh hd, d), the latter scaled
    by 1/sqrt(n_layer) (one residual per block: no MLP)."""
    nh, nkv, hd, _ = _attn_dims(cfg)
    lead = (n_layers,)
    params = {
        "wqkv": init_linear(cfg.d_model, (nh + 2 * nkv) * hd, generator,
                            cfg.proj_bias, lead, device),
        "out_proj": init_linear(nh * hd, cfg.d_model, generator, cfg.proj_bias,
                                lead, device),
    }
    if cfg.rescale_prenorm_residual:
        params["out_proj"]["kernel"] /= math.sqrt(cfg.n_layer)
    return params


def rope_angles(positions: torch.Tensor, rotary_dim: int, theta: float) -> torch.Tensor:
    """Integer positions (any shape) -> positions.shape + (rotary_dim/2,)
    fp32 angles."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                                             device=positions.device) / rotary_dim))
    return positions.float()[..., None] * inv_freq


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the leading ``2 * angles.shape[-1]`` channels of each head
    (rotate-half: pairs (x[i], x[i + rot/2])), in fp32, cast back to x's
    dtype; the tail past the rotary slice passes through.  x (b, t, h,
    hd); angles (t, rot/2) shared by the batch or (b, t, rot/2) per row."""
    rot = 2 * angles.shape[-1]
    xf = x[..., :rot].float()
    x1, x2 = xf[..., :rot // 2], xf[..., rot // 2:]
    if angles.ndim == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)
    if rot < x.shape[-1]:
        return torch.cat([out, x[..., rot:]], dim=-1)
    return out


def _split_qkv(qkv: torch.Tensor, cfg: ModelConfig):
    """(b, t, (nh + 2 nkv) hd) -> q (b, t, nh, hd), k, v (b, t, nkv, hd),
    views of ``qkv``."""
    nh, nkv, hd, _ = _attn_dims(cfg)
    b, t, _ = qkv.shape
    q = qkv[..., :nh * hd].reshape(b, t, nh, hd)
    k = qkv[..., nh * hd:(nh + nkv) * hd].reshape(b, t, nkv, hd)
    v = qkv[..., (nh + nkv) * hd:].reshape(b, t, nkv, hd)
    return q, k, v


def attention_mixer(params: dict, cfg: ModelConfig, u: torch.Tensor,
                    return_final_state: bool = False):
    """Full-sequence causal attention (models/attention.py:120-182 of the
    JAX package, without its sequence-parallel branches): u (b, t, d) ->
    y (b, t, d).  RoPE at positions 0..t-1, then the flash kernels
    ("pallas"/"auto") or the blockwise online softmax ("xla").  With
    ``return_final_state`` the raw (k, v) (b, t, nkv, hd) of the whole
    sequence come back too, for ``pack_attention_pages``."""
    nh, _, hd, rot = _attn_dims(cfg)
    b, t, _ = u.shape
    cd = cfg.torch_compute_dtype
    q, k, v = _split_qkv(linear(params["wqkv"], u, cd), cfg)
    if rot > 0:
        angles = rope_angles(torch.arange(t, device=u.device), rot, cfg.rope_theta)
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    attend = blockwise_sdpa_causal if cfg.attn_impl == "xla" else flash_sdpa_causal
    out = attend(q, k, v)
    y = linear(params["out_proj"], out.reshape(b, t, nh * hd), cd)
    if return_final_state:
        return y, (k, v)
    return y


def attention_page_count(cfg: ModelConfig, max_len: int) -> int:
    """Pages needed per row for ``max_len`` tokens (at least one)."""
    return max(1, -(-max_len // cfg.kv_page_tokens))


def init_attention_state(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Empty paged KV cache of one attention layer: (k_pages, v_pages) of
    shape (1 + batch * W, nkv, page, hd) in the compute dtype, page 0 the
    trash page (W = ``attention_page_count(cfg, max_len)``)."""
    _, nkv, hd, _ = _attn_dims(cfg)
    P = 1 + batch * attention_page_count(cfg, max_len)
    shape = (P, nkv, cfg.kv_page_tokens, hd)
    dtype = cfg.torch_compute_dtype
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def attention_page_meta(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Identity page table + zero lengths for a private (non-pooled) paged
    cache: row r owns physical pages [1 + r W, 1 + (r + 1) W)."""
    W = attention_page_count(cfg, max_len)
    tbl = 1 + torch.arange(batch * W, dtype=torch.int32, device=device).reshape(batch, W)
    return tbl, torch.zeros((batch,), dtype=torch.int32, device=device)


def pack_attention_pages(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
                         max_len: int):
    """(b, t, nkv, hd) full-sequence K/V -> identity-paged head-major
    (k_pages, v_pages) of capacity ``max_len`` (the one-shot prefill's
    state packing, models/attention.py:295-328, bf16/fp32 pages): row r's
    tokens fill pages [1 + r W, 1 + (r + 1) W), page 0 the trash page."""
    b, t, nkv, hd = k.shape
    pg = cfg.kv_page_tokens
    W = attention_page_count(cfg, max_len)

    def pack(x):
        pages = x.new_zeros((1 + b * W, nkv, pg, hd))
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, W * pg - t))
        pages[1:] = x.reshape(b, W, pg, nkv, hd).transpose(2, 3).reshape(b * W, nkv, pg, hd)
        return pages

    return pack(k), pack(v)


def attention_mixer_step(params: dict, cfg: ModelConfig, u_t: torch.Tensor, kv,
                         page_table: torch.Tensor, lengths: torch.Tensor,
                         write_mask: torch.Tensor | None = None):
    """Single-token decode against the paged KV cache: write, then attend.

    u_t (b, d); kv = (k_pages, v_pages); page_table (b, W); lengths (b,)
    the row's token count BEFORE this step (the new token lands at cache
    position ``lengths[r]``).  ``write_mask`` (b,) bool sends masked
    rows' writes to the trash page (how the serving tick keeps dead,
    done and prefilling slots off live pages).  The pages are written IN
    PLACE.  Returns (y (b, d), kv)."""
    nh, nkv, hd, rot = _attn_dims(cfg)
    b = u_t.shape[0]
    cd = cfg.torch_compute_dtype
    k_pages, v_pages = kv
    pg = cfg.kv_page_tokens
    W = page_table.shape[1]

    q, k, v = _split_qkv(linear(params["wqkv"], u_t[:, None, :], cd), cfg)
    if rot > 0:
        angles = rope_angles(lengths[:, None], rot, cfg.rope_theta)
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)

    pidx = (lengths // pg).clamp(0, W - 1).long()
    phys = page_table.gather(1, pidx[:, None])[:, 0]
    off = lengths % pg
    if write_mask is not None:
        phys = torch.where(write_mask, phys, 0)
        off = torch.where(write_mask, off, 0)
    phys, off = phys.long(), off.long()
    # head-major pages: the token offset sits one axis past the heads
    k_pages[phys, :, off] = k[:, 0].to(k_pages.dtype)
    v_pages[phys, :, off] = v[:, 0].to(v_pages.dtype)

    # tokens readable after the write
    kv_len = (lengths + 1).clamp(max=W * pg).to(torch.int32)
    attend = (ragged_paged_decode_attention_plain if cfg.attn_impl == "xla"
              else ragged_paged_decode_attention)
    out = attend(q[:, 0], k_pages, v_pages, page_table, kv_len)
    y = linear(params["out_proj"], out.reshape(b, nh * hd), cd)
    return y, (k_pages, v_pages)


def attention_mixer_chunk(params: dict, cfg: ModelConfig, u: torch.Tensor, kv,
                          page_table: torch.Tensor, lengths: torch.Tensor,
                          token_mask: torch.Tensor | None = None):
    """One prefill CHUNK against the paged cache: write the chunk's real
    tokens' K/V into this row's pages at positions [lengths, lengths +
    n_real), then attend every chunk query over prefix + chunk.

    u (b, c, d); token_mask (b, c) {0,1} marks real tokens, a LEFT pad
    prefix, so real token j sits at absolute position ``lengths[r] + j``
    whatever the pad; pad queries clamp to position 0 and produce
    garbage that dies with their discarded positions.  The pages are
    written IN PLACE (through the fused kernel on the card).  Returns
    (y (b, c, d), kv)."""
    nh, nkv, hd, rot = _attn_dims(cfg)
    b, c, _ = u.shape
    cd = cfg.torch_compute_dtype
    k_pages, v_pages = kv

    q, k, v = _split_qkv(linear(params["wqkv"], u, cd), cfg)
    if token_mask is None:
        n_real = torch.full((b,), c, dtype=torch.int32, device=u.device)
    else:
        n_real = (token_mask > 0.5).sum(dim=1).to(torch.int32)
    if rot > 0:
        i = torch.arange(c, device=u.device)
        posc = (lengths[:, None] + i[None, :] - (c - n_real)[:, None]).clamp(min=0)
        angles = rope_angles(posc, rot, cfg.rope_theta)
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)

    attend = (ragged_paged_prefill_attention_plain if cfg.attn_impl == "xla"
              else ragged_paged_prefill_attention)
    out, k_pages, v_pages = attend(q, k, v, k_pages, v_pages, page_table, lengths,
                                   n_real)
    y = linear(params["out_proj"], out.reshape(b, c, nh * hd), cd)
    return y, (k_pages, v_pages)
