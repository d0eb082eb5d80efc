"""HellaSwag evaluation CLI of the PyTorch port (counterpart of the
top-level ``eval.py``), on the card unless ``--device cpu``.

    python -m mamba_distributed_tpu_torch.eval -m custom --checkpoint log/checkpoint \\
        --preset mamba2-280m --data-file hellaswag/hellaswag_val.jsonl --bpe-dir gpt2_bpe
    python -m mamba_distributed_tpu_torch.eval -m custom --checkpoint model.pt --preset mamba2-280m
    python -m mamba_distributed_tpu_torch.eval -m hugging_face --hf-path <local HF dir>

``-m custom`` reads a directory of the port trainer's own ``torch.save``
checkpoints (``training/checkpoint.py``; the newest is taken) or a
reference-style ``.pt`` file (a state dict, or ``{"model": state_dict,
...}``) through ``models/hf.py``.  The JAX package's Orbax checkpoint
directories cannot be read without JAX.  ``-m hugging_face`` reads a
local directory with ``config.json`` + ``pytorch_model.bin``.

The user brings the data: a local ``hellaswag_val.jsonl`` and the GPT-2
BPE files (``encoder.json`` + ``vocab.bpe``, or ``vocab.json`` +
``merges.txt``) from ``--bpe-dir``, ``$GPT2_BPE_DIR`` or ``./gpt2_bpe``;
nothing is downloaded.  On the card the forward runs the hand-written
kernels (``--ssm-impl pallas``, attention "auto") or raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from mamba_distributed_tpu_torch.config import PRESETS, ModelConfig, get_preset

MODEL_TYPES = ("custom", "hugging_face")


def get_encoder(bpe_dir: str | None = None):
    """-> (encode, a line that says which tokenizer and merge loop)."""
    from mamba_distributed_tpu_torch.data.gpt2_bpe import GPT2BPE, load_encoder

    bpe_dir = bpe_dir or os.environ.get("GPT2_BPE_DIR", "gpt2_bpe")
    try:
        if os.path.isdir(bpe_dir):
            bpe = GPT2BPE.from_dir(bpe_dir)
            merge = "native" if bpe.uses_native else "python"
            return bpe.encode, f"tokenizer: GPT-2 BPE from {bpe_dir}, merge loop {merge}"
        encode, _ = load_encoder(bpe_dir)
        return encode, "tokenizer: tiktoken gpt2"
    except FileNotFoundError as e:
        raise SystemExit(
            f"GPT-2 tokenizer unavailable: {e}\n(Or inject your own encode via the "
            "library API mamba_distributed_tpu_torch.eval.evaluate_hellaswag.)")


def check_embedding(params: dict, cfg: ModelConfig, checkpoint: str, preset: str) -> None:
    got = tuple(params["embedding"].shape)
    want = (cfg.vocab_size_padded, cfg.d_model)
    if got != want:
        raise SystemExit(
            f"checkpoint/preset mismatch: embedding {got} in {checkpoint!r} but "
            f"--preset {preset!r} expects {want} — pass the preset the checkpoint "
            f"was trained with")


def load_custom(checkpoint: str, preset: str, device=None) -> tuple[dict, ModelConfig]:
    """(params on ``device``, cfg) from a port checkpoint directory or a
    reference-style ``.pt`` file, with the model config of ``preset``; the
    embedding's shape must be the preset's (a ``.pt`` embedding is checked
    after the import has padded it to the padded vocab)."""
    cfg = get_preset(preset)
    if checkpoint.endswith(".pt"):
        from mamba_distributed_tpu_torch.models.hf import load_hf_checkpoint

        params, cfg = load_hf_checkpoint(checkpoint, cfg, device)
        check_embedding(params, cfg, checkpoint, preset)
        return params, cfg
    from mamba_distributed_tpu_torch.training.checkpoint import restore_checkpoint
    from mamba_distributed_tpu_torch.training.optimizer import tree_map

    params = restore_checkpoint(checkpoint)["params"]
    check_embedding(params, cfg, checkpoint, preset)
    return tree_map(lambda t: t.to(device), params), cfg


def load_hf(path: str, device=None) -> tuple[dict, ModelConfig]:
    from mamba_distributed_tpu_torch.models.hf import load_hf_checkpoint

    return load_hf_checkpoint(path, device=device)


def runtime_config(cfg: ModelConfig, ssm_impl: str, device: torch.device) -> ModelConfig:
    """``cfg`` with the kernel choice; on the card, refuse shapes the
    kernels were not built for."""
    from mamba_distributed_tpu_torch.ops.dispatch import check_kernel_shapes

    cfg = dataclasses.replace(cfg, ssm_impl=ssm_impl)
    if device.type == "cuda":
        check_kernel_shapes(cfg)
    return cfg


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("-m", "--model_type", default="custom", choices=MODEL_TYPES)
    p.add_argument("--checkpoint", default="log/checkpoint",
                   help="custom: a directory of the port trainer's checkpoints (the "
                        "newest is read) or a reference-style .pt file; the JAX "
                        "package's Orbax directories are not readable here")
    p.add_argument("--preset", default="mamba2-280m", choices=sorted(PRESETS))
    p.add_argument("-v", "--hf-path", default=None,
                   help="local HF directory (config.json + pytorch_model.bin)")
    p.add_argument("--data-file", default="hellaswag/hellaswag_val.jsonl")
    p.add_argument("--limit", type=int, default=2000)
    p.add_argument("--example-batch", type=int, default=8,
                   help="examples packed per forward call (scores unchanged)")
    p.add_argument("--log-file", default="log/hellaswag_eval.txt")
    p.add_argument("--bpe-dir", default=None,
                   help="dir with GPT-2 encoder.json/vocab.bpe (or HF vocab.json/"
                        "merges.txt); default $GPT2_BPE_DIR or ./gpt2_bpe")
    p.add_argument("--device", default="cuda", help="cuda (default: the card) or cpu")
    p.add_argument("--ssm-impl", choices=["xla", "pallas"], default="pallas",
                   help="pallas (default): the hand-written SSD or scan kernels on the "
                        "card (their plain versions on the CPU); xla: plain PyTorch")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from mamba_distributed_tpu_torch.eval import evaluate_hellaswag, iterate_examples
    from mamba_distributed_tpu_torch.models.lm import lm_forward
    from mamba_distributed_tpu_torch.training.trainer import resolve_device

    device = resolve_device(args.device)
    if args.model_type == "hugging_face":
        if not args.hf_path:
            raise SystemExit("--hf-path required for -m hugging_face")
        params, cfg = load_hf(args.hf_path, device)
    else:
        params, cfg = load_custom(args.checkpoint, args.preset, device)
    cfg = runtime_config(cfg, args.ssm_impl, device)
    encode, tokenizer = get_encoder(args.bpe_dir)
    print(tokenizer, flush=True)

    result = evaluate_hellaswag(
        lambda tokens: lm_forward(params, cfg, tokens),
        iterate_examples(args.data_file),
        encode,
        limit=args.limit,
        log_path=args.log_file,
        verbose=True,
        example_batch=args.example_batch,
        device=device,
    )
    print(result)
    return result


if __name__ == "__main__":
    main()
