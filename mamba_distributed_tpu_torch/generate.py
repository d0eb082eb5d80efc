"""Generate text from a checkpoint with the PyTorch port (counterpart of
the top-level ``generate.py``), on the card unless ``--device cpu``.

    python -m mamba_distributed_tpu_torch.generate --checkpoint log/checkpoint \\
        --preset mamba2-280m --prompt "Hello, I'm a language model,"
    python -m mamba_distributed_tpu_torch.generate --hf-path <local HF dir> \\
        --prompt-ids 15496,11,314 --max-new-tokens 64

The prompt is prefilled into the O(1) decode state and continued by
top-k sampling (``inference/generate.generate``): row r of the
``--num-return`` rows samples with seed ``--seed + r``.  ``--prompt``
is tokenized by the port's GPT-2 BPE from ``$GPT2_BPE_DIR`` or
``./gpt2_bpe``; ``--prompt-ids`` needs no tokenizer.  ``--checkpoint``
is a directory of the port trainer's checkpoints; ``--hf-path`` a local
HF directory (config.json + pytorch_model.bin) or a reference-style
``.pt`` file (with ``--preset``).
"""

from __future__ import annotations

import argparse
import os

import torch

from mamba_distributed_tpu_torch.config import PRESETS


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint", help="directory of the port trainer's checkpoints")
    src.add_argument("--hf-path", help="local HF dir (config.json + pytorch_model.bin) "
                                       "or reference-style .pt")
    p.add_argument("--preset", default="mamba2-280m", choices=sorted(PRESETS),
                   help="model preset (ignored for --hf-path dirs, which carry their "
                        "own config.json)")
    p.add_argument("--prompt", default=None,
                   help="text (tokenized by the port's GPT-2 BPE from $GPT2_BPE_DIR / "
                        "./gpt2_bpe)")
    p.add_argument("--prompt-ids", default=None,
                   help="comma-separated token ids (no tokenizer needed)")
    p.add_argument("--num-return", type=int, default=4)
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--top-k", type=int, default=50)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (default: the card) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> torch.Tensor:
    args = parse_args(argv)
    from mamba_distributed_tpu_torch.eval.__main__ import load_custom, load_hf, runtime_config
    from mamba_distributed_tpu_torch.inference.generate import generate
    from mamba_distributed_tpu_torch.training.trainer import resolve_device

    decode_fn = None
    if args.prompt_ids is not None:
        ids = [int(t) for t in args.prompt_ids.split(",")]
    elif args.prompt is not None:
        from mamba_distributed_tpu_torch.data.gpt2_bpe import load_encoder

        try:
            encode, decode_fn = load_encoder()
        except FileNotFoundError as e:
            raise SystemExit(f"--prompt: {e}\nOr pass --prompt-ids instead.")
        ids = encode(args.prompt)
    else:
        raise SystemExit("pass --prompt or --prompt-ids")

    device = resolve_device(args.device)
    # .pt files go through the reference-style importer, directories of
    # --hf-path through config.json, --checkpoint through the port's own
    if args.hf_path and os.path.isdir(args.hf_path):
        params, cfg = load_hf(args.hf_path, device)
    else:
        params, cfg = load_custom(args.hf_path or args.checkpoint, args.preset, device)
    cfg = runtime_config(cfg, "pallas", device)

    prompt = torch.tensor(ids, dtype=torch.int64)[None].repeat(args.num_return, 1)
    out = generate(params, cfg, prompt, seed=args.seed, max_new_tokens=args.max_new_tokens,
                   top_k=args.top_k, temperature=args.temperature)
    for row in out.cpu().tolist():
        print(f"> {decode_fn(row) if decode_fn else f'tokens {row}'}")
    return out


if __name__ == "__main__":
    main()
