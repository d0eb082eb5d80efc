"""Model configuration of the PyTorch port.

An own copy of the ``ModelConfig`` fields the serving slice reads, with
the same names, defaults and validation as
``mamba_distributed_tpu/config.py``, so a test can build both configs
from one keyword dict.  Hybrid attention, MoE, LoRA, quantization and
mesh knobs are left out; a config the port cannot serve raises at
construction.

Knob meanings carried over from the JAX package: ``ssm_impl="pallas"``
means "the hand-written CUDA kernel" here (ops/dispatch.py), and
``"xla"`` means "the plain PyTorch formulation".
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Pure Mamba-2 LM config (same field names as the JAX package)."""

    d_model: int = 768
    n_layer: int = 64
    vocab_size: int = 50304
    pad_vocab_size_multiple: int = 8
    # only "mamba2" is served by the port; "mamba1" raises
    ssm_layer: str = "mamba2"
    # 0 => no MLP between mixers (the pure mixer stack)
    d_intermediate: int = 0
    residual_in_fp32: bool = True
    tie_embeddings: bool = True
    norm_eps: float = 1e-5

    # --- mixer knobs (mamba2.py defaults) ---
    d_state: int = 0  # 0 => auto: 128 for mamba2
    d_conv: int = 4
    expand: int = 2
    conv_bias: bool = True
    proj_bias: bool = False
    dt_min: float = 0.001
    dt_max: float = 0.1
    dt_init_floor: float = 1e-4
    headdim: int = 64
    ngroups: int = 1
    chunk_size: int = 256
    a_init_min: float = 1.0
    a_init_max: float = 16.0
    d_has_hdim: bool = False

    # empty => pure SSM stack; anything else raises (hybrid serving is a
    # later slice of the port)
    attn_layer_idx: tuple[int, ...] = ()

    # --- precision policy ---
    compute_dtype: str = "bfloat16"

    # --- init ---
    initializer_range: float = 0.02
    rescale_prenorm_residual: bool = True

    # "pallas" -> the hand-written SSD kernel on a CUDA tensor (the plain
    # version on a CPU tensor); "xla" -> the plain version everywhere
    ssm_impl: str = "xla"
    conv_impl: str = "shift"

    # --- chunked prompt prefill (serving/prefill.py) ---
    prefill_chunk_tokens: int = 256
    # max prefill-chunk tokens dispatched between two decode ticks
    # (serving/engine.py); 0 => unbounded
    prefill_tokens_per_tick: int = 512

    def __post_init__(self):
        if self.ssm_layer != "mamba2":
            raise ValueError(
                f"the PyTorch port serves ssm_layer='mamba2' only, got "
                f"{self.ssm_layer!r} (Mamba-1 is a later slice)"
            )
        if self.attn_layer_idx:
            raise ValueError(
                "the PyTorch port serves pure Mamba-2 stacks only: "
                f"attn_layer_idx={self.attn_layer_idx} needs the paged "
                "attention slice"
            )
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
        return self.d_state or 128

    @property
    def nheads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def effective_prefill_chunk_tokens(self) -> int:
        """Chunked-prefill width actually used (0 => disabled): the
        configured width rounded UP to a multiple of ``chunk_size`` so
        prefill-chunk boundaries land on SSD chunk boundaries.  The
        engine and ``generate()`` both read this, never the raw field."""
        c = self.prefill_chunk_tokens
        if c <= 0:
            return 0
        if c % self.chunk_size:
            return ((c + self.chunk_size - 1) // self.chunk_size) * self.chunk_size
        return c


# The presets the slice serves (the JAX package's PRESETS, model half).
PRESETS: dict[str, dict[str, Any]] = {
    "mamba2-tiny": dict(d_model=128, n_layer=4, headdim=32, d_state=64,
                        chunk_size=64, vocab_size=4096),
    "mamba2-280m": dict(d_model=768, n_layer=64),
}


def get_preset(name: str, **overrides: Any) -> ModelConfig:
    """``ModelConfig`` of preset ``name`` with field ``overrides``."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return ModelConfig(**{**PRESETS[name], **overrides})
