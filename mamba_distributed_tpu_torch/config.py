"""Model and training configuration of the PyTorch port.

An own copy of the ``ModelConfig`` fields the serving and training
paths read, and of ``TrainConfig``/``DataConfig``/``MeshConfig``, with
the same names, defaults and validation as
``mamba_distributed_tpu/config.py``, so a test can build both configs
from one keyword dict.  Pure Mamba-2 and Mamba-1 stacks and hybrid
stacks (attention layers at ``attn_layer_idx``: full-sequence attention
in training and one-shot prefill, a paged KV cache in decode) are served
and trained on one device; MLPs, MoE, LoRA, quantization and mesh sizes
above 1 are left out, and a config the port cannot run raises at
construction with the reason.

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
    # "all": recompute everything; "dots" and "mixer" wait for a later slice
    remat_policy: str = "all"

    # "pallas" -> the hand-written SSD (mamba2) or selective-scan (mamba1)
    # kernels on a CUDA tensor (the plain versions on a CPU tensor);
    # "xla" -> the plain formulation everywhere
    ssm_impl: str = "xla"
    conv_impl: str = "shift"

    # LM-head + CE formulation: "dense" (one head matmul, logits in the
    # compute dtype); "blocked" (ops/loss.py) waits for a later slice
    loss_impl: str = "dense"

    # --- chunked prompt prefill (serving/prefill.py) ---
    prefill_chunk_tokens: int = 256
    # max prefill-chunk tokens dispatched between two decode ticks
    # (serving/engine.py); 0 => unbounded
    prefill_tokens_per_tick: int = 512

    # --- paged attention KV cache (hybrid stacks; models/attention.py,
    # serving/state_cache.py) ---
    # tokens per KV page: a positive multiple of 8
    kv_page_tokens: int = 64
    # per-request KV budget in the serving pool (prompt + max_new_tokens)
    kv_slot_tokens: int = 1024
    # pages in the serving pool; 0 => capacity * kv_pages_per_slot
    kv_pool_pages: int = 0
    # "bf16" stores pages in the compute dtype; "int8" raises (it waits
    # for the port of ops/quant.py)
    kv_page_dtype: str = "bf16"

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
        if self.d_intermediate:
            raise ValueError(
                "the PyTorch port serves the pure mixer stack only "
                f"(d_intermediate=0), got {self.d_intermediate}"
            )
        if not self.tie_embeddings:
            raise ValueError("the PyTorch port serves tied heads only")
        if self.ssm_impl not in ("xla", "pallas"):
            raise ValueError(
                f"ssm_impl must be 'xla' or 'pallas', got {self.ssm_impl!r}"
            )
        if self.remat_policy != "all":
            raise ValueError(
                f"remat_policy={self.remat_policy!r}: the PyTorch port implements "
                f"remat_policy='all' only ('dots' and 'mixer' are a later slice)"
            )
        if self.loss_impl != "dense":
            raise ValueError(
                f"loss_impl={self.loss_impl!r}: the PyTorch port implements "
                f"loss_impl='dense' only ('blocked', ops/loss.py, is a later slice)"
            )
        if self.conv_impl != "shift":
            raise ValueError(
                f"the PyTorch port implements conv_impl='shift' only, got "
                f"{self.conv_impl!r}"
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
        if self.attn_impl not in ("auto", "xla", "pallas"):
            raise ValueError(
                f"attn_impl must be 'auto', 'xla' or 'pallas', got "
                f"{self.attn_impl!r}"
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
        if self.kv_page_dtype == "int8":
            raise ValueError(
                "kv_page_dtype='int8' is not served by the PyTorch port yet: "
                "int8 KV pages wait for the port of ops/quant.py"
            )
        if self.kv_page_dtype != "bf16":
            raise ValueError(
                f"kv_page_dtype must be 'bf16' or 'int8', got "
                f"{self.kv_page_dtype!r}"
            )
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
    def kv_pages_per_slot(self) -> int:
        """Page-table width of one serving slot (ceil of the per-request
        KV budget in pages)."""
        return -(-self.kv_slot_tokens // self.kv_page_tokens)


# The presets the slice serves (the JAX package's PRESETS, model half).
PRESETS: dict[str, dict[str, Any]] = {
    "mamba2-tiny": dict(d_model=128, n_layer=4, headdim=32, d_state=64,
                        chunk_size=64, vocab_size=4096),
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
}


def get_preset(name: str, **overrides: Any) -> ModelConfig:
    """``ModelConfig`` of preset ``name`` with field ``overrides``."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return ModelConfig(**{**PRESETS[name], **overrides})


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Mesh axes of the JAX package's ``MeshConfig``.  The port trains
    on one device: every axis must be 1 (``TrainConfig`` checks)."""

    data: int = 1
    fsdp: int = 1
    seq: int = 1
    tensor: int = 1
    pipe: int = 1
    expert: int = 1


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
class TrainConfig:
    """Training loop config (same field names, defaults and checks as
    the JAX package's ``TrainConfig``, one device)."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)

    total_batch_size: int = 524288  # tokens/step
    micro_batch_size: int = 32
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

    def __post_init__(self):
        multi = {k: v for k, v in dataclasses.asdict(self.mesh).items() if v != 1}
        if multi:
            raise ValueError(
                f"mesh axes {multi}: the PyTorch port trains on one device "
                f"(every mesh axis 1); parallel training is a later slice"
            )
        if self.micro_batch_size < 1 or self.seq_len < 1:
            raise ValueError(
                f"micro_batch_size={self.micro_batch_size} and seq_len="
                f"{self.seq_len} must be >= 1"
            )
        if self.total_batch_size % (self.micro_batch_size * self.seq_len):
            raise ValueError(
                f"total_batch_size={self.total_batch_size} must be divisible "
                f"by micro_batch_size * seq_len = "
                f"{self.micro_batch_size * self.seq_len}"
            )

    @property
    def grad_accum_steps(self) -> int:
        return self.total_batch_size // (self.micro_batch_size * self.seq_len)


# The training halves of the presets the port trains (the JAX package's
# PRESETS, config.py:1106-1172).
TRAIN_PRESETS: dict[str, dict[str, Any]] = {
    "mamba2-tiny": dict(seq_len=256, micro_batch_size=8, total_batch_size=4096,
                        max_steps=300, warmup_steps=20, val_every=25),
    "mamba2-280m": dict(),
    "hybrid-tiny": dict(seq_len=256, micro_batch_size=8, total_batch_size=4096,
                        max_steps=300, warmup_steps=20, val_every=25),
    "hybrid-280m": dict(),
    "mamba1-280m": dict(),
}


def get_train_preset(name: str, **overrides: Any) -> TrainConfig:
    """``TrainConfig`` of preset ``name`` with field ``overrides`` (a
    ``model`` override replaces the preset's model config)."""
    if name not in TRAIN_PRESETS:
        raise KeyError(f"unknown training preset {name!r}; have {sorted(TRAIN_PRESETS)}")
    model = overrides.pop("model", None) or get_preset(name)
    return TrainConfig(model=model, **{**TRAIN_PRESETS[name], **overrides})
