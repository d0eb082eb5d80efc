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

Int8 pages (``cfg.kv_page_dtype="int8"``, models/attention.py:228-724 of
the JAX package): a layer's cache is the 4-tuple ``(k_pages int8,
v_pages int8, k_scale (P, nkv) fp32, v_scale (P, nkv) fp32)``, one
symmetric scale per (physical page, KV head).  A write needs no read of
old page content to plan its scale:

  new_scale = max(old_scale if the page holds PRIOR tokens of this
                  sequence (write offset inside the page > 0),
                  absmax(fresh rows) / 127, 1e-12)

because the old scale bounds the stored values; old rows re-express
under the new scale (``kv_requant(q, old / new)``, ratio 0 on a page
with no prior content, so a recycled page's stale rows and scale are
wiped), fresh rows quantize under it (``kv_quantize``).  The plain
versions and the int8 kernel branches share this rule and its
arithmetic, so the pages they write are bit-identical.

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

import torch

from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.models.common import init_linear, linear, out_proj_rescale
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
from mamba_distributed_tpu_torch.ops.quant import Q_MAX, SCALE_EPS, kv_quantize, kv_requant

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
    (d, (nh + 2 nkv) hd) and ``out_proj`` (nh hd, d), the latter divided
    by ``out_proj_rescale``."""
    nh, nkv, hd, _ = _attn_dims(cfg)
    lead = (n_layers,)
    params = {
        "wqkv": init_linear(cfg.d_model, (nh + 2 * nkv) * hd, generator,
                            cfg.proj_bias, lead, device),
        "out_proj": init_linear(nh * hd, cfg.d_model, generator, cfg.proj_bias,
                                lead, device),
    }
    if cfg.rescale_prenorm_residual:
        params["out_proj"]["kernel"] /= out_proj_rescale(cfg.n_layer, cfg.d_intermediate)
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


def _kv_page_scale_init(n_pages: int, nkv: int, device=None) -> torch.Tensor:
    """Fresh (P, nkv) scales: ones, never read before a page's first
    write sets them, and finite so a trash page dequantizes finitely."""
    return torch.ones((n_pages, nkv), dtype=torch.float32, device=device)


def init_attention_state(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Empty paged KV cache of one attention layer: (k_pages, v_pages) of
    shape (1 + batch * W, nkv, page, hd) in the compute dtype, page 0 the
    trash page (W = ``attention_page_count(cfg, max_len)``); int8 pools
    return the 4-tuple with int8 pages and (P, nkv) scales."""
    _, nkv, hd, _ = _attn_dims(cfg)
    P = 1 + batch * attention_page_count(cfg, max_len)
    shape = (P, nkv, cfg.kv_page_tokens, hd)
    dtype = torch.int8 if cfg.kv_quantized else cfg.torch_compute_dtype
    pages = (torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
    if cfg.kv_quantized:
        return (*pages, _kv_page_scale_init(P, nkv, device),
                _kv_page_scale_init(P, nkv, device))
    return pages


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
    state packing, models/attention.py:295-328): row r's tokens fill
    pages [1 + r W, 1 + (r + 1) W), page 0 the trash page.  Int8 pools
    quantize each (page, KV head) tile under its own absmax and return
    the 4-tuple."""
    b, t, nkv, hd = k.shape
    pg = cfg.kv_page_tokens
    W = attention_page_count(cfg, max_len)

    def pack(x):
        pages = x.new_zeros((1 + b * W, nkv, pg, hd))
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, W * pg - t))
        pages[1:] = x.reshape(b, W, pg, nkv, hd).transpose(2, 3).reshape(b * W, nkv, pg, hd)
        return pages

    if not cfg.kv_quantized:
        return pack(k), pack(v)

    def pack_q(x):
        pages = pack(x.float())
        scale = torch.clamp(pages.abs().amax(dim=(2, 3)) / Q_MAX, min=SCALE_EPS)
        return kv_quantize(pages, scale[:, :, None, None]).to(torch.int8), scale

    (kq, ks), (vq, vs) = pack_q(k), pack_q(v)
    return kq, vq, ks, vs


def attention_mixer_step(params: dict, cfg: ModelConfig, u_t: torch.Tensor, kv,
                         page_table: torch.Tensor, lengths: torch.Tensor,
                         write_mask: torch.Tensor | None = None):
    """Single-token decode against the paged KV cache: write, then attend.

    u_t (b, d); kv = (k_pages, v_pages), or the int8 4-tuple with the
    scales; page_table (b, W); lengths (b,) the row's token count BEFORE
    this step (the new token lands at cache position ``lengths[r]``).
    ``write_mask`` (b,) bool sends masked rows' writes to the trash page
    (how the serving tick keeps dead, done and prefilling slots off live
    pages).  An int8 write is page-granular (``_qwrite``).  The pages
    (and scales) are written IN PLACE.  Returns (y (b, d), kv)."""
    nh, nkv, hd, rot = _attn_dims(cfg)
    b = u_t.shape[0]
    cd = cfg.torch_compute_dtype
    k_pages, v_pages = kv[:2]
    scales = tuple(kv[2:])
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
    if scales:
        _qwrite(k_pages, scales[0], k[:, 0], phys, off)
        _qwrite(v_pages, scales[1], v[:, 0], phys, off)
    else:
        # head-major pages: the token offset sits one axis past the heads
        k_pages[phys, :, off] = k[:, 0].to(k_pages.dtype)
        v_pages[phys, :, off] = v[:, 0].to(v_pages.dtype)

    # tokens readable after the write
    kv_len = (lengths + 1).clamp(max=W * pg).to(torch.int32)
    attend = (ragged_paged_decode_attention_plain if cfg.attn_impl == "xla"
              else ragged_paged_decode_attention)
    out = attend(q[:, 0], k_pages, v_pages, page_table, kv_len, *scales)
    y = linear(params["out_proj"], out.reshape(b, nh * hd), cd)
    return y, kv


def _qwrite(pages: torch.Tensor, scales: torch.Tensor, row: torch.Tensor,
            phys: torch.Tensor, off: torch.Tensor) -> None:
    """The int8 decode write (models/attention.py:456-472), in place: row
    (b, nkv, hd) lands at offset ``off`` of page ``phys``; the page's
    scale grows to cover it (the rule of the module docstring), its old
    rows requantize under the new scale, the row quantizes in.  Masked
    rows (``phys`` 0, ``off`` 0) write page 0 and its scale."""
    pg = pages.shape[2]
    old_q, old_s = pages[phys], scales[phys]       # (b, nkv, pg, hd), (b, nkv)
    has_prior = (off > 0)[:, None]
    amax = row.float().abs().amax(dim=-1)
    new_s = torch.clamp(torch.maximum(torch.where(has_prior, old_s, 0.0), amax / Q_MAX),
                        min=SCALE_EPS)
    ratio = torch.where(has_prior, old_s / new_s, 0.0)
    req = kv_requant(old_q, ratio[..., None, None])
    q_row = kv_quantize(row, new_s[..., None])
    onehot = torch.arange(pg, device=pages.device)[None, :] == off[:, None]   # (b, pg)
    pages[phys] = torch.where(onehot[:, None, :, None], q_row[:, :, None, :],
                              req).to(pages.dtype)
    scales[phys] = new_s


def _chunk_page_scales(k: torch.Tensor, v: torch.Tensor, real: torch.Tensor,
                       page_table: torch.Tensor, lengths: torch.Tensor,
                       n_real: torch.Tensor, k_scale: torch.Tensor,
                       v_scale: torch.Tensor, pg: int):
    """The per-(page, KV head) scales after one chunk's write (int8
    pools; models/attention.py:520-564): the module docstring's rule
    applied to every page of each row's write window ``[lengths, lengths
    + n_real)``, from the fresh rows' absmax alone.  Returns NEW (P, nkv)
    tensors (the old ones are left as they are: the chunk write reads
    both); pages outside the window keep their scales, the trash page's
    is garbage."""
    b, c = real.shape
    W = page_table.shape[1]
    total = lengths + n_real
    pad = c - n_real
    pos = lengths[:, None] + torch.arange(c, device=k.device)[None, :] - pad[:, None]
    pageidx = (pos.clamp(min=0) // pg).clamp(0, W - 1)
    wcol = torch.arange(W, device=k.device)[None, :]
    takes = ((wcol * pg < total[:, None]) & ((wcol + 1) * pg > lengths[:, None])
             & (n_real > 0)[:, None])                              # (b, W)
    has_prior = lengths[:, None] > wcol * pg                       # (b, W)
    # which real chunk rows land in which page: (b, c, W)
    oh = (pageidx[:, :, None] == wcol[:, None, :]) & real[:, :, None]
    tbl = page_table.long()
    dst = torch.where(takes, tbl, 0)

    def update(x, scales):
        absmax = x.float().abs().amax(dim=-1)                      # (b, c, nkv)
        amax = torch.where(oh[..., None], absmax[:, :, None, :], 0.0).amax(dim=1)
        old = scales[tbl]                                          # (b, W, nkv)
        new = torch.clamp(torch.maximum(torch.where(has_prior[..., None], old, 0.0),
                                        amax / Q_MAX), min=SCALE_EPS)
        out = scales.clone()
        out[dst] = torch.where(takes[..., None], new, old)
        return out

    return update(k, k_scale), update(v, v_scale)


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
    written IN PLACE (through the fused kernel on the card).

    Int8 pools (``kv`` the 4-tuple): ``_chunk_page_scales`` plans the new
    scales into fresh tensors; the chunk write reads the old and the new
    (old rows requantize, fresh rows quantize, the attend runs on the
    dequantized pages), then the new scales are copied into the layer's
    scale tensors.  Returns (y (b, c, d), kv)."""
    nh, nkv, hd, rot = _attn_dims(cfg)
    b, c, _ = u.shape
    cd = cfg.torch_compute_dtype
    k_pages, v_pages = kv[:2]

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
    scales = ()
    if len(kv) == 4:
        real = torch.arange(c, device=u.device)[None, :] >= (c - n_real)[:, None]
        new = _chunk_page_scales(k, v, real, page_table, lengths, n_real, kv[2], kv[3],
                                 cfg.kv_page_tokens)
        scales = (kv[2], kv[3], *new)
    out, _, _ = attend(q, k, v, k_pages, v_pages, page_table, lengths, n_real, *scales)
    if scales:
        kv[2].copy_(scales[2])
        kv[3].copy_(scales[3])
    y = linear(params["out_proj"], out.reshape(b, c, nh * hd), cd)
    return y, kv
