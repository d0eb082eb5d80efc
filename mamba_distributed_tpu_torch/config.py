"""Model and training configuration of the PyTorch port.

An own copy of the ``ModelConfig`` fields the serving and training
paths read, and of ``TrainConfig``/``DataConfig``/``MeshConfig``, with
the same names, defaults and validation as
``mamba_distributed_tpu/config.py``, so a test can build both configs
from one keyword dict.  Pure Mamba-2 and Mamba-1 stacks and hybrid
stacks (attention layers at ``attn_layer_idx``: full-sequence attention
in training and one-shot prefill, a paged KV cache in decode), with or
without a gated MLP or a token-choice MoE after each mixer
(``d_intermediate``, ``moe_*``), are served on one device, with
multi-tenant LoRA adapters in serving (``lora_*``, ``tenant_max_slots``),
and trained on one device or over the ``data``, ``fsdp``, ``seq``, ``tensor``
and ``expert`` mesh axes.  The ``pipe`` axis, ``seq`` composed with
``tensor`` or ``expert``, and the online-tuning ``tune_*`` fields are left
out, and a config the port cannot run raises at construction with the
reason.

Knob meanings carried over from the JAX package: ``ssm_impl="pallas"``
and ``attn_impl="pallas"``/``"auto"`` mean "the hand-written CUDA
kernel" here (ops/dispatch.py), and ``"xla"`` means "the plain PyTorch
formulation".
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Mamba-2, Mamba-1 or hybrid LM config (same field names as the JAX
    package)."""

    d_model: int = 768
    n_layer: int = 64
    vocab_size: int = 50304
    pad_vocab_size_multiple: int = 8
    # "mamba2" -> SSD mixer; "mamba1" -> selective-scan mixer
    ssm_layer: str = "mamba2"
    # 0 => no MLP between mixers (the pure mixer stack)
    d_intermediate: int = 0
    # --- MoE: 0 => dense gated MLP; > 1 => the MLP becomes a token-choice
    # top-k mixture of experts (dense dispatch and combine on one device, as
    # in the JAX package; over a mesh the routing is global over the batch
    # ranks and mesh.expert shards the experts, models/lm._moe_mlp) ---
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    # weight of the Switch load-balance aux loss that lm_loss adds
    moe_aux_weight: float = 0.01
    residual_in_fp32: bool = True
    tie_embeddings: bool = True
    norm_eps: float = 1e-5

    # --- shared mixer knobs (mamba_simple.py / mamba2.py defaults) ---
    d_state: int = 0  # 0 => auto: 16 for mamba1, 128 for mamba2
    d_conv: int = 4
    expand: int = 2
    conv_bias: bool = True
    proj_bias: bool = False
    dt_min: float = 0.001
    dt_max: float = 0.1
    dt_init_floor: float = 1e-4

    # --- mamba1-only ---
    dt_rank: int = 0  # 0 => auto: ceil(d_model / 16)
    dt_init: str = "random"  # "random" | "constant"
    dt_scale: float = 1.0

    # --- mamba2-only ---
    headdim: int = 64
    ngroups: int = 1
    chunk_size: int = 256
    a_init_min: float = 1.0
    a_init_max: float = 16.0
    d_has_hdim: bool = False

    # --- hybrid attention layers; empty => pure SSM stack ---
    attn_layer_idx: tuple[int, ...] = ()
    attn_num_heads: int = 0  # 0 => auto: d_model // 64
    attn_num_kv_heads: int = 0  # 0 => same as attn_num_heads (MHA)
    attn_head_dim: int = 0  # 0 => auto: d_model // num_heads
    # -1 => full head dim; 0 => no rotary
    attn_rotary_dim: int = -1
    rope_theta: float = 10000.0
    # attention under sequence parallelism: "ring" (KV shards rotate over
    # the seq ranks, parallel/ring_attention.py) or "ulysses" (all-to-all
    # head sharding, needs heads % seq == 0; parallel/ulysses.py)
    attn_sp_impl: str = "ring"
    # "auto"/"pallas" -> the hand-written flash and ragged paged attention
    # kernels on a CUDA tensor (their plain versions on a CPU tensor);
    # "xla" -> the plain formulations everywhere
    attn_impl: str = "auto"

    # --- precision policy ---
    compute_dtype: str = "bfloat16"

    # --- init ---
    initializer_range: float = 0.02
    rescale_prenorm_residual: bool = True

    # --- memory (training) ---
    remat: bool = True  # per-block activation checkpointing
    # "all": recompute everything; "dots": save the outputs of the 2-D
    # matrix products (aten.mm/addmm), recompute the rest; "mixer": save
    # only each mixer core's output, so the backward never runs the SSD,
    # scan or flash forward kernel again (models/remat.py)
    remat_policy: str = "all"

    # "pallas" -> the hand-written SSD (mamba2) or selective-scan (mamba1)
    # kernels on a CUDA tensor (the plain versions on a CPU tensor);
    # "xla" -> the plain formulation everywhere
    ssm_impl: str = "xla"
    # causal conv: "shift" (width shifted multiply-adds) or "xla_conv" (one
    # depthwise conv1d); the same function
    conv_impl: str = "shift"

    # LM-head + CE formulation: "dense" (one head matmul, logits in the
    # compute dtype) or "blocked" (vocab-blocked online logsumexp,
    # ops/loss.py: no (b, t, V) tensor in the forward or the backward)
    loss_impl: str = "dense"
    loss_vocab_blocks: int = 8

    # --- chunked prompt prefill (serving/prefill.py) ---
    prefill_chunk_tokens: int = 256
    # max prefill-chunk tokens dispatched between two decode ticks
    # (serving/engine.py); 0 => unbounded
    prefill_tokens_per_tick: int = 512
    # how the chunk budget is shared across concurrent partial prefills:
    # "rr" rotates one chunk at a time in admission order; "srpt" grants
    # the prompt with the fewest remaining chunks first, with a
    # starvation guard (serving/engine._pick_prefill_slot)
    prefill_schedule: str = "rr"

    # --- prefix-state cache and priorities (serving/prefix_cache.py,
    # serving/engine.py) ---
    # entry cap of the prefix-state cache (chunk-boundary carries and
    # full-prompt state + logits, keyed by the prompt's layout hash);
    # 0 turns the cache off.  Hybrid entries pin KV pages of one engine
    prefix_cache_entries: int = 0
    # byte cap over the cached carries, logits and pinned KV page bytes;
    # 0 => the entry cap only
    prefix_cache_bytes: int = 0
    # misses a prefix must collect before its snapshot is stored
    prefix_min_chunk_hits: int = 1
    # priority of a request whose ``priority`` is None (higher wins); a
    # queued request that outranks a decoding slot preempts it when no
    # slot is free
    serving_default_priority: int = 0

    # --- occupancy-adaptive compacted ticks (serving/engine.py) ---
    # gather the decodable slots into a pow2 lane bucket, run the tick at
    # that width and scatter the rows back; False is the full-width tick
    tick_compaction: bool = False
    # ticks of lower occupancy the lane bucket waits before it shrinks
    # (it grows at once); 0 shrinks at once
    compaction_hysteresis_ticks: int = 4

    # --- paged attention KV cache (hybrid stacks; models/attention.py,
    # serving/state_cache.py) ---
    # tokens per KV page: a positive multiple of 8
    kv_page_tokens: int = 64
    # per-request KV budget in the serving pool (prompt + max_new_tokens)
    kv_slot_tokens: int = 1024
    # pages in the serving pool; 0 => capacity * kv_pages_per_slot
    kv_pool_pages: int = 0
    # "bf16" stores pages in the compute dtype; "int8" stores int8 pages
    # with one fp32 scale per (physical page, KV head) (ops/quant.py,
    # models/attention.py), read and written by the int8 branches of the
    # ragged paged kernels
    kv_page_dtype: str = "bf16"
    # serving weights: "bf16" casts the matmul kernels and the embedding
    # to the compute dtype (inference/generate._decode_params); "int8"
    # quantizes them per channel from the fp32 masters (ops/quant.py) and
    # the matmul sites dequantize at use
    serving_weight_dtype: str = "bf16"

    # --- serving meshes (parallel/mesh.serving_mesh; serving/engine.py) ---
    # engine replicas a request router places over; read by the router,
    # validated here
    serving_replicas: int = 1
    # data shards of the slot pool (and of a hybrid's page pool): data
    # rank d holds slots [d C/D, (d+1) C/D) and its own page rows; the
    # capacity must divide
    serving_data_shards: int = 1
    # tensor-parallel shards of the serving weights (the mixers' heads and
    # channels, the MLP's inner axis, the vocab axis of the embedding and
    # head); d_inner, the heads and the padded vocab must divide (checked
    # at engine construction, parallel/sharding.validate_serving_model_shards)
    serving_model_shards: int = 1
    # pipeline stages of the serving layer stacks: stage s holds the s-th
    # block of each layer family's weights, carries and KV page pools;
    # each family must divide (validate_serving_stage_shards)
    serving_stage_shards: int = 1

    # --- speculative decoding (serving/spec_decode.py) ---
    # draft tokens verified per serving tick; 0 (the default) turns it
    # off.  K > 0 makes every decode tick one draft-verify step: a
    # drafter proposes K guesses per slot and one chunk-step launch
    # (models/lm.lm_verify_chunk) scores all K+1 positions, committing
    # the longest correct prefix.  Greedy-only (requests must use
    # top_k=1); the streams stay those of greedy decoding.  The engine
    # and generate() both read it, so the two speculate alike
    spec_tokens: int = 0
    # who drafts: "ngram" (prompt lookup over the stream's own history)
    # or "model" (a small companion LM; the engine and generate() take
    # its ModelDrafter instance)
    spec_drafter: str = "ngram"
    # longest trailing n-gram the "ngram" drafter matches before it
    # falls back to shorter ones
    spec_ngram_order: int = 3

    # --- multi-tenant LoRA serving (serving/adapters.py) ---
    # named adapters one engine may serve; 0 (the default) turns LoRA
    # off: no factor pools ride the params and no record gains a field.
    # > 0 adds the segmented delta ``(x @ A[ids]) @ B[ids]`` to every
    # targeted linear, with per-slot adapter ids, so slots running
    # different adapters (or none) share one launch
    lora_max_adapters: int = 0
    # low-rank dimension shared by every adapter of an engine
    lora_rank: int = 8
    # the delta's weight is alpha / rank, folded into the stored B once
    lora_alpha: float = 16.0
    # device factor-pool slots; 0 => lora_max_adapters (all resident).
    # Fewer pages adapters: admission reserves a slot as it reserves KV
    # pages, and waits while every slot is pinned
    lora_cache_slots: int = 0
    # most concurrent resident slots one tenant (adapter base name, any
    # version) may hold; 0 = no quota.  An over-quota admission waits
    tenant_max_slots: int = 0
    # share of bare-name requests routed to a tenant's latest adapter
    # version (the rest pin the previous one, by a hash of the request)
    lora_ab_fraction: float = 1.0

    def __post_init__(self):
        if self.ssm_layer not in ("mamba1", "mamba2"):
            raise ValueError(
                f"ssm_layer must be 'mamba1' or 'mamba2', got {self.ssm_layer!r}"
            )
        if self.dt_init not in ("random", "constant"):
            raise ValueError(
                f"dt_init must be 'random' or 'constant', got {self.dt_init!r}"
            )
        if self.attn_layer_idx:
            self._check_hybrid()
        if self.remat_policy not in ("all", "dots", "mixer"):
            raise ValueError(
                f"remat_policy must be 'all', 'dots' or 'mixer', got "
                f"{self.remat_policy!r}"
            )
        if self.ssm_impl not in ("xla", "pallas"):
            raise ValueError(
                f"ssm_impl must be 'xla' or 'pallas', got {self.ssm_impl!r}"
            )
        if self.conv_impl not in ("shift", "xla_conv"):
            raise ValueError(
                f"conv_impl must be 'shift' or 'xla_conv', got "
                f"{self.conv_impl!r}"
            )
        if self.loss_impl not in ("dense", "blocked"):
            raise ValueError(
                f"loss_impl must be 'dense' or 'blocked', got "
                f"{self.loss_impl!r}"
            )
        if self.loss_impl == "blocked" and (
            self.loss_vocab_blocks < 1
            or self.vocab_size_padded % self.loss_vocab_blocks != 0
        ):
            raise ValueError(
                f"loss_vocab_blocks={self.loss_vocab_blocks} must be a "
                f"positive divisor of padded vocab {self.vocab_size_padded}"
            )
        if self.moe_num_experts:
            if self.moe_num_experts < 2:
                raise ValueError("moe_num_experts must be 0 (dense) or >= 2")
            if self.d_intermediate <= 0:
                raise ValueError(
                    "MoE replaces the gated MLP: moe_num_experts > 0 needs "
                    "d_intermediate > 0"
                )
            if not 1 <= self.moe_top_k <= self.moe_num_experts:
                raise ValueError(
                    f"moe_top_k={self.moe_top_k} must be in "
                    f"[1, {self.moe_num_experts}]"
                )
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(
                f"compute_dtype must be 'bfloat16' or 'float32', got "
                f"{self.compute_dtype!r}"
            )
        if self.prefill_chunk_tokens < 0:
            raise ValueError(
                f"prefill_chunk_tokens must be >= 0 (0 disables chunked "
                f"prefill), got {self.prefill_chunk_tokens}"
            )
        if self.prefill_tokens_per_tick < 0:
            raise ValueError(
                f"prefill_tokens_per_tick must be >= 0 (0 => unbounded), "
                f"got {self.prefill_tokens_per_tick}"
            )
        if self.prefill_schedule not in ("rr", "srpt"):
            raise ValueError(
                f"prefill_schedule must be 'rr' or 'srpt', got "
                f"{self.prefill_schedule!r}"
            )
        for name in ("serving_replicas", "serving_data_shards", "serving_model_shards",
                     "serving_stage_shards"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.compaction_hysteresis_ticks < 0:
            raise ValueError(
                f"compaction_hysteresis_ticks must be >= 0 (0 shrinks the "
                f"lane bucket immediately), got "
                f"{self.compaction_hysteresis_ticks}"
            )
        if self.prefix_cache_entries < 0:
            raise ValueError(
                f"prefix_cache_entries must be >= 0 (0 disables the "
                f"prefix-state cache), got {self.prefix_cache_entries}"
            )
        if self.prefix_cache_bytes < 0:
            raise ValueError(
                f"prefix_cache_bytes must be >= 0 (0 => entry cap only), "
                f"got {self.prefix_cache_bytes}"
            )
        if self.prefix_min_chunk_hits < 1:
            raise ValueError(
                f"prefix_min_chunk_hits must be >= 1 (store on first "
                f"sight), got {self.prefix_min_chunk_hits}"
            )
        if self.attn_impl not in ("auto", "xla", "pallas"):
            raise ValueError(
                f"attn_impl must be 'auto', 'xla' or 'pallas', got "
                f"{self.attn_impl!r}"
            )
        if self.attn_sp_impl not in ("ring", "ulysses"):
            raise ValueError(
                f"attn_sp_impl must be 'ring' or 'ulysses', got "
                f"{self.attn_sp_impl!r}"
            )
        if self.kv_page_tokens < 8 or self.kv_page_tokens % 8:
            raise ValueError(
                f"kv_page_tokens must be a positive multiple of 8, got "
                f"{self.kv_page_tokens}"
            )
        if self.kv_slot_tokens < self.kv_page_tokens:
            raise ValueError(
                f"kv_slot_tokens={self.kv_slot_tokens} must hold at least "
                f"one page of kv_page_tokens={self.kv_page_tokens}"
            )
        if self.kv_pool_pages < 0:
            raise ValueError(
                f"kv_pool_pages must be >= 0 (0 => auto-size from "
                f"capacity), got {self.kv_pool_pages}"
            )
        if self.serving_weight_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"serving_weight_dtype must be 'bf16' (the compute-dtype "
                f"decode cast, the status quo) or 'int8', got "
                f"{self.serving_weight_dtype!r}"
            )
        if self.kv_page_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"kv_page_dtype must be 'bf16' (compute-dtype pages, the "
                f"status quo) or 'int8', got {self.kv_page_dtype!r}"
            )
        if self.spec_tokens < 0:
            raise ValueError(
                f"spec_tokens must be >= 0 (0 disables speculative "
                f"decoding), got {self.spec_tokens}"
            )
        if self.spec_drafter not in ("ngram", "model"):
            raise ValueError(
                f"spec_drafter must be 'ngram' or 'model', got "
                f"{self.spec_drafter!r}"
            )
        if self.spec_ngram_order < 1:
            raise ValueError(
                f"spec_ngram_order must be >= 1, got "
                f"{self.spec_ngram_order}"
            )
        self._check_lora()
        if self.ssm_layer == "mamba2":
            self._check_mamba2()

    def _check_mamba2(self) -> None:
        if self.d_inner % self.headdim:
            raise ValueError(
                f"d_inner={self.d_inner} must be a multiple of "
                f"headdim={self.headdim}"
            )
        if self.nheads % self.ngroups:
            raise ValueError(
                f"nheads={self.nheads} must be a multiple of "
                f"ngroups={self.ngroups}"
            )

    def _check_lora(self) -> None:
        if self.lora_max_adapters < 0:
            raise ValueError(
                f"lora_max_adapters must be >= 0 (0 disables multi-"
                f"tenant LoRA serving), got {self.lora_max_adapters}"
            )
        if self.lora_max_adapters > 0:
            if self.lora_rank < 1:
                raise ValueError(
                    f"lora_rank must be >= 1 when LoRA serving is on, "
                    f"got {self.lora_rank}"
                )
            if self.lora_alpha <= 0:
                raise ValueError(
                    f"lora_alpha must be > 0, got {self.lora_alpha}"
                )
            if self.lora_cache_slots < 0:
                raise ValueError(
                    f"lora_cache_slots must be >= 0 (0 => auto: "
                    f"lora_max_adapters), got {self.lora_cache_slots}"
                )
        if self.tenant_max_slots < 0:
            raise ValueError(
                f"tenant_max_slots must be >= 0 (0 = no per-tenant "
                f"quota), got {self.tenant_max_slots}"
            )
        if not 0.0 <= self.lora_ab_fraction <= 1.0:
            raise ValueError(
                f"lora_ab_fraction must be in [0, 1] (the share of "
                f"bare-name requests routed to the latest adapter "
                f"version), got {self.lora_ab_fraction}"
            )

    def _check_hybrid(self) -> None:
        idx = self.attn_layer_idx
        if len(set(idx)) != len(idx) or not all(0 <= i < self.n_layer for i in idx):
            raise ValueError(
                f"attn_layer_idx={idx} must name distinct layers in "
                f"[0, n_layer={self.n_layer})"
            )
        nh, nkv = self.effective_attn_num_heads, self.effective_attn_num_kv_heads
        if nh < 1 or nkv < 1 or nh % nkv:
            raise ValueError(
                f"attn_num_heads={nh} must be a positive multiple of "
                f"attn_num_kv_heads={nkv} (grouped-query attention)"
            )
        hd = self.effective_attn_head_dim
        rot = hd if self.attn_rotary_dim < 0 else self.attn_rotary_dim
        if rot % 2 or rot > hd:
            raise ValueError(
                f"attn_rotary_dim={rot} must be even and <= head dim {hd}"
            )

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def vocab_size_padded(self) -> int:
        m = self.pad_vocab_size_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def effective_d_state(self) -> int:
        if self.d_state:
            return self.d_state
        return 128 if self.ssm_layer == "mamba2" else 16

    @property
    def effective_dt_rank(self) -> int:
        return self.dt_rank or math.ceil(self.d_model / 16)

    @property
    def nheads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def effective_prefill_chunk_tokens(self) -> int:
        """Chunked-prefill width actually used (0 => disabled): the
        configured width, for mamba2 rounded UP to a multiple of
        ``chunk_size`` so prefill-chunk boundaries land on SSD chunk
        boundaries.  The engine and ``generate()`` both read this, never
        the raw field."""
        c = self.prefill_chunk_tokens
        if c <= 0:
            return 0
        if self.ssm_layer == "mamba2" and c % self.chunk_size:
            return ((c + self.chunk_size - 1) // self.chunk_size) * self.chunk_size
        return c

    @property
    def effective_attn_num_heads(self) -> int:
        return self.attn_num_heads or self.d_model // 64

    @property
    def effective_attn_num_kv_heads(self) -> int:
        return self.attn_num_kv_heads or self.effective_attn_num_heads

    @property
    def effective_attn_head_dim(self) -> int:
        return self.attn_head_dim or self.d_model // self.effective_attn_num_heads

    @property
    def effective_lora_cache_slots(self) -> int:
        """Device adapter-cache slots allocated (0 = LoRA off):
        ``lora_cache_slots``, or every registered adapter resident when
        the knob is 0."""
        if self.lora_max_adapters <= 0:
            return 0
        return self.lora_cache_slots or self.lora_max_adapters

    @property
    def kv_quantized(self) -> bool:
        """True when the paged KV pools store int8 pages with
        per-(page, KV head) fp32 scales (``kv_page_dtype="int8"``)."""
        return self.kv_page_dtype == "int8"

    @property
    def kv_pages_per_slot(self) -> int:
        """Page-table width of one serving slot (ceil of the per-request
        KV budget in pages)."""
        return -(-self.kv_slot_tokens // self.kv_page_tokens)


# The presets the slice serves (the JAX package's PRESETS, model half).
PRESETS: dict[str, dict[str, Any]] = {
    "mamba2-tiny": dict(d_model=128, n_layer=4, headdim=32, d_state=64,
                        chunk_size=64, vocab_size=4096),
    # the JAX package's CPU parity-artifact scale: the reference recipe's
    # seq 1024 and padded GPT-2 vocab on a small model
    "mamba2-mini": dict(d_model=256, n_layer=8),
    "mamba2-280m": dict(d_model=768, n_layer=64),
    "hybrid-tiny": dict(d_model=128, n_layer=4, headdim=32, d_state=64,
                        chunk_size=64, vocab_size=4096, attn_layer_idx=(1, 3),
                        attn_num_heads=4, attn_num_kv_heads=2,
                        prefill_chunk_tokens=128, kv_page_tokens=32,
                        kv_slot_tokens=512),
    # attention every 8th layer from layer 3, GQA 12 query / 4 KV heads
    "hybrid-280m": dict(d_model=768, n_layer=64,
                        attn_layer_idx=tuple(range(3, 64, 8)),
                        attn_num_heads=12, attn_num_kv_heads=4),
    # what the reference's train.py:75 builds (Mamba-1 mixers): d_inner
    # 1536, d_state 16, dt_rank 48, d_conv 4
    "mamba1-280m": dict(d_model=768, n_layer=64, ssm_layer="mamba1"),
    # Jamba-style hybrid 7B: a gated MLP (d_intermediate 14336) after every
    # mixer, attention every 8th layer from layer 3, GQA 32 query / 8 KV
    # heads of 128 (JAX config.py:1200-1211)
    "hybrid-7b": dict(d_model=4096, n_layer=32, d_intermediate=14336,
                      attn_layer_idx=tuple(range(3, 32, 8)), attn_num_heads=32,
                      attn_num_kv_heads=8),
    # the models of the JAX package's data-parallel presets (their meshes
    # are in TRAIN_PRESETS)
    "mamba2-280m-dp8": dict(d_model=768, n_layer=64),
    "mamba2-1.3b-fsdp16": dict(d_model=2048, n_layer=48),
    # the model of the JAX package's sequence-parallel preset
    "mamba2-2.8b-sp32": dict(d_model=2560, n_layer=64),
}


def get_preset(name: str, **overrides: Any) -> ModelConfig:
    """``ModelConfig`` of preset ``name`` with field ``overrides``."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return ModelConfig(**{**PRESETS[name], **overrides})


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh (the JAX package's ``MeshConfig``), one rank of
    ``torch.distributed`` per device; axes of size 1 collapse.

    data   - pure data parallel (gradients mean-all-reduced, params replicated)
    fsdp   - data parallel + param/optimizer-state sharding (ZeRO-3 style)
    tensor - tensor parallel: every mixer and FFN on its ranks' own heads of
             a packed per-rank layout (parallel/tp_layout.py); the ranks of
             one tensor group read the same batch rows
    expert - expert parallel: the MoE's experts sharded over it, the
             routed rows moved by all-to-alls; a batch axis for every other
             layer
    seq    - sequence parallel: each rank holds its block of every
             sequence's tokens (parallel/seq_parallel.py); the ranks of one
             seq group read the same batch rows
    pipe   - the JAX package's pipeline axis; the port trains with it at 1
             (``TrainConfig`` refuses more, naming the slice that adds it)
    """

    data: int = 1
    fsdp: int = 1
    seq: int = 1
    tensor: int = 1
    pipe: int = 1
    expert: int = 1

    @property
    def num_devices(self) -> int:
        return (self.data * self.fsdp * self.seq * self.tensor * self.pipe
                * self.expert)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return ("data", "fsdp", "seq", "tensor", "pipe", "expert")

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.data, self.fsdp, self.seq, self.tensor, self.pipe,
                self.expert)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Token-shard data pipeline (the JAX package's ``DataConfig``)."""

    data_dir: str = "edu_fineweb10B"
    # If True and data_dir holds no shards, generate deterministic
    # synthetic shards (data/synthetic.py); nothing is downloaded
    allow_synthetic: bool = True
    synthetic_tokens_per_shard: int = 2_097_152
    synthetic_num_shards: int = 2


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Host-side telemetry (``obs/``): spans, the divergence sentinel, the
    flight recorder, SLO targets (the JAX package's ``TelemetryConfig``:
    same field names, defaults and validation).  Everything here is
    host-side and free of device syncs; ``overflow_threshold`` is the one
    knob that changes the train step (one more on-card comparison, read
    back in the step's one host fetch).  The XLA compile watchdog has no
    counterpart in the port: ``compile_watchdog=True`` and its thrash
    knobs raise."""

    # span tracer -> {log_dir}/events.jsonl (trainer, eval, checkpointing)
    spans: bool = False
    # non-finite loss/grad-norm watchdog on already-fetched host scalars,
    # feeding the flight-recorder ring that dumps on crash/divergence
    sentinel: bool = True
    # raise DivergenceError on a non-finite step (after dumping) — a NaN
    # run only burns compute; opt out for loss-spike research
    halt_on_divergence: bool = True
    flight_recorder_len: int = 64
    # > 0: the train step also returns a flag for grad_norm > threshold
    # (or non-finite), computed on the card and accumulated on the host.
    # 0 disables.
    overflow_threshold: float = 0.0
    # --- serving SLO targets (obs/slo.py): rolling-window p95 targets
    # in milliseconds over the last `slo_window_requests` finished
    # requests; 0 leaves a metric untargeted.  Crossing a target emits
    # one `slo_breach` event record (and `slo_recovered` on the way
    # back).  All host-side, no device syncs. ---
    slo_ttft_p95_ms: float = 0.0
    slo_itl_p95_ms: float = 0.0
    slo_queue_wait_p95_ms: float = 0.0
    slo_window_requests: int = 64
    # byte cap on a SpanTracer's jsonl file: exceeding it rolls the
    # file to `<name>.1` (one generation kept; obs/export.load_jsonl
    # reads the pair oldest-first).  0 = never rotate.
    span_rotate_bytes: int = 0
    # the JAX package's XLA compile watchdog: the port has no XLA
    # compiles to count, so True (and a thrash knob off its default)
    # raises
    compile_watchdog: bool = False
    compile_thrash_threshold: int = 0
    compile_thrash_window_s: float = 60.0
    # --- tick-latency regression sentinel (obs/slo.py
    # TickRegressionDetector): breach when the EWMA-smoothed tick
    # latency exceeds `tick_regression_factor` x the learned baseline.
    # factor 0 (default) = off. ---
    tick_regression_factor: float = 0.0
    tick_ewma_alpha: float = 0.1
    tick_regression_warmup: int = 32

    def __post_init__(self):
        if self.flight_recorder_len < 1:
            raise ValueError(
                f"flight_recorder_len must be >= 1, got "
                f"{self.flight_recorder_len}"
            )
        if self.overflow_threshold < 0:
            raise ValueError(
                f"overflow_threshold must be >= 0 (0 disables), got "
                f"{self.overflow_threshold}"
            )
        if self.overflow_threshold > 0 and not self.sentinel:
            raise ValueError(
                "overflow_threshold > 0 needs sentinel=True — the host-"
                "side accumulator and flight record that consume the "
                "on-device flag live on the sentinel"
            )
        for name in ("slo_ttft_p95_ms", "slo_itl_p95_ms",
                     "slo_queue_wait_p95_ms"):
            if getattr(self, name) < 0:
                raise ValueError(
                    f"{name} must be >= 0 (0 disables), got "
                    f"{getattr(self, name)}"
                )
        if self.slo_window_requests < 1:
            raise ValueError(
                f"slo_window_requests must be >= 1, got "
                f"{self.slo_window_requests}"
            )
        if self.span_rotate_bytes < 0:
            raise ValueError(
                f"span_rotate_bytes must be >= 0 (0 = never rotate), "
                f"got {self.span_rotate_bytes}"
            )
        if self.compile_thrash_threshold < 0:
            raise ValueError(
                f"compile_thrash_threshold must be >= 0 (0 = count "
                f"only), got {self.compile_thrash_threshold}"
            )
        if self.compile_thrash_window_s <= 0:
            raise ValueError(
                f"compile_thrash_window_s must be > 0, got "
                f"{self.compile_thrash_window_s}"
            )
        if self.tick_regression_factor and self.tick_regression_factor <= 1:
            raise ValueError(
                f"tick_regression_factor must be > 1 (breach = factor "
                f"x baseline; 0 disables), got "
                f"{self.tick_regression_factor}"
            )
        if not 0.0 < self.tick_ewma_alpha <= 1.0:
            raise ValueError(
                f"tick_ewma_alpha must be in (0, 1], got "
                f"{self.tick_ewma_alpha}"
            )
        if self.tick_regression_warmup < 1:
            raise ValueError(
                f"tick_regression_warmup must be >= 1, got "
                f"{self.tick_regression_warmup}"
            )
        if (self.compile_watchdog or self.compile_thrash_threshold
                or self.compile_thrash_window_s != 60.0):
            raise ValueError(
                "compile_watchdog and its thrash knobs: the XLA compile "
                "watchdog (obs/watchdog.py of the JAX package) has no "
                "counterpart in the PyTorch port; leave them at their "
                "defaults"
            )


def _hybrid_period(cfg: ModelConfig):
    """(period, offset) when ``attn_layer_idx`` is one attention layer
    every ``n_layer / n_attn`` layers at a fixed offset, else None (the
    JAX package's ``models/lm._hybrid_period``, which its pipeline check
    calls)."""
    idx = cfg.attn_layer_idx
    n_attn = len(idx)
    if n_attn == 0 or cfg.n_layer % n_attn:
        return None
    p = cfg.n_layer // n_attn
    r = idx[0]
    if not 0 <= r < p:
        return None
    if tuple(idx) != tuple(r + g * p for g in range(n_attn)):
        return None
    return p, r


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training loop config (same field names, defaults and checks as
    the JAX package's ``TrainConfig``).  The port trains over every mesh
    the JAX package takes (``parallel/``, one ``torch.distributed`` rank
    per device): ``data``, ``fsdp``, ``seq``, ``tensor`` and ``expert``
    in any composition, and ``pipe`` with data and fsdp.  Under seq the
    sequence must split into equal blocks no shorter than the conv's
    halo (``d_conv - 1`` tokens).  Like the
    JAX package, no check asks the tensor size to divide the heads: a
    block whose heads it does not divide runs whole on each tensor rank
    (``parallel/tp_layout.py``)."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    telemetry: TelemetryConfig = dataclasses.field(default_factory=TelemetryConfig)

    total_batch_size: int = 524288  # tokens/step
    micro_batch_size: int = 32  # rows per data-parallel rank
    seq_len: int = 1024

    max_lr: float = 6e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 715
    max_steps: int = 19073
    weight_decay: float = 0.1
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adam_eps: float = 1e-8
    grad_clip: float = 1.0

    seed: int = 1337

    val_every: int = 250
    val_steps: int = 20
    sample_every: int = 250
    checkpoint_every: int = 1000
    log_dir: str = "log"

    # shard params and AdamW moments over the fsdp axis (ZeRO-3)
    shard_params: bool = False

    def __post_init__(self):
        # the JAX package's checks (config.py:1026-1080), its messages
        m = self.mesh
        if m.pipe > 1 and (m.seq * m.tensor * m.expert) > 1:
            raise ValueError(
                f"mesh.pipe={m.pipe} composes with data/fsdp only; got "
                f"seq={m.seq}, tensor={m.tensor}, expert={m.expert}")
        if m.pipe > 1 and self.model.moe_num_experts:
            raise ValueError(
                "MoE models do not pipeline yet (the aux-loss carry is "
                "not threaded through the GPipe schedule); use pipe=1")
        if m.expert > 1:
            if not self.model.moe_num_experts:
                raise ValueError(
                    f"mesh.expert={m.expert} needs a MoE model "
                    "(moe_num_experts > 0)")
            if self.model.moe_num_experts % m.expert:
                raise ValueError(
                    f"moe_num_experts={self.model.moe_num_experts} must "
                    f"divide over mesh.expert={m.expert}")
        if m.pipe > 1 and self.shard_params:
            raise ValueError(
                "mesh.pipe > 1 keeps params replicated across data/fsdp "
                "(stage-sharded over pipe); shard_params=True is not "
                "supported with pipeline parallelism")
        if m.pipe > 1 and self.model.attn_layer_idx:
            if _hybrid_period(self.model) is None:
                raise ValueError(
                    "pipeline parallelism needs a uniform layer stack or a "
                    "periodic hybrid (one attn layer every n_layer/n_attn)")
            if len(self.model.attn_layer_idx) % m.pipe != 0:
                raise ValueError(
                    f"hybrid pipeline: n_attn={len(self.model.attn_layer_idx)} "
                    f"supersteps must divide over mesh.pipe={m.pipe} stages")
        elif m.pipe > 1 and self.model.n_layer % m.pipe != 0:
            raise ValueError(
                f"n_layer={self.model.n_layer} must divide over "
                f"mesh.pipe={m.pipe} stages")
        if m.seq > 1:
            if self.seq_len % m.seq:
                raise ValueError(
                    f"seq_len={self.seq_len} does not split over mesh.seq={m.seq}: "
                    f"sequence parallelism cuts every sequence into equal blocks")
            halo = self.model.d_conv - 1
            if self.seq_len // m.seq < halo:
                raise ValueError(
                    f"local sequence shard ({self.seq_len // m.seq} tokens of seq_len="
                    f"{self.seq_len} over mesh.seq={m.seq}) shorter than the conv halo "
                    f"({halo})")
        if self.micro_batch_size < 1 or self.seq_len < 1:
            raise ValueError(
                f"micro_batch_size={self.micro_batch_size} and seq_len="
                f"{self.seq_len} must be >= 1")
        denom = self.micro_batch_size * self.seq_len * self.data_parallel_size
        if self.total_batch_size % denom:
            raise ValueError(
                f"total_batch_size={self.total_batch_size} must be divisible "
                f"by micro_batch_size * seq_len * data_parallel_size = {denom} "
                f"(make sure total_batch_size is divisible by B * T * dp_size)")

    @property
    def grad_accum_steps(self) -> int:
        return self.total_batch_size // (
            self.micro_batch_size * self.seq_len * self.data_parallel_size)

    @property
    def data_parallel_size(self) -> int:
        # expert is an extra pure-DP batch axis for the non-MoE layers
        return self.mesh.data * self.mesh.fsdp * self.mesh.expert


# The training halves of the presets the port trains (the JAX package's
# PRESETS, config.py:1106-1172).
TRAIN_PRESETS: dict[str, dict[str, Any]] = {
    "mamba2-tiny": dict(seq_len=256, micro_batch_size=8, total_batch_size=4096,
                        max_steps=300, warmup_steps=20, val_every=25),
    # the recipe of the JAX package's committed log_parity_cpu/ run: 4,096
    # tokens a step, validation every 250 steps
    "mamba2-mini": dict(micro_batch_size=4, total_batch_size=4096, val_every=250),
    "mamba2-280m": dict(),
    "hybrid-tiny": dict(seq_len=256, micro_batch_size=8, total_batch_size=4096,
                        max_steps=300, warmup_steps=20, val_every=25),
    "hybrid-280m": dict(),
    "mamba1-280m": dict(),
    # the JAX preset's mesh (fsdp 16, seq 4: 64 ranks), seq, micro-batch
    # and total batch (JAX config.py:1200-1215); one card trains it cut in
    # depth, with a one-device mesh
    "hybrid-7b": dict(mesh=MeshConfig(fsdp=16, seq=4), shard_params=True, seq_len=4096,
                      micro_batch_size=4, total_batch_size=4194304),
    # the JAX package's long-context preset (config.py:1189-1198): seq 8192
    # cut over 4 seq ranks, params and moments sharded over 8 fsdp ranks
    "mamba2-2.8b-sp32": dict(mesh=MeshConfig(fsdp=8, seq=4), shard_params=True,
                             seq_len=8192, micro_batch_size=8, total_batch_size=2097152),
    # the JAX package's data-parallel presets (config.py:1174-1187): DDP
    # over 8 ranks, and params + AdamW moments sharded over 16
    "mamba2-280m-dp8": dict(mesh=MeshConfig(data=8)),
    "mamba2-1.3b-fsdp16": dict(mesh=MeshConfig(fsdp=16), shard_params=True,
                               micro_batch_size=8, total_batch_size=1048576),
}


def get_train_preset(name: str, **overrides: Any) -> TrainConfig:
    """``TrainConfig`` of preset ``name`` with field ``overrides`` (a
    ``model`` override replaces the preset's model config)."""
    if name not in TRAIN_PRESETS:
        raise KeyError(f"unknown training preset {name!r}; have {sorted(TRAIN_PRESETS)}")
    model = overrides.pop("model", None) or get_preset(name)
    return TrainConfig(model=model, **{**TRAIN_PRESETS[name], **overrides})
