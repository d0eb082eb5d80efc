"""Train a Mamba-2, Mamba-1 or hybrid LM with the PyTorch port, on the card by default.

    python -m mamba_distributed_tpu_torch.train --preset mamba2-280m --max-steps 3
    python -m mamba_distributed_tpu_torch.train --preset hybrid-280m --max-steps 3
    python -m mamba_distributed_tpu_torch.train --preset mamba1-280m --max-steps 3
    python -m mamba_distributed_tpu_torch.train --preset hybrid-tiny --device cpu --max-steps 5

The SSD (Mamba-2) or selective scan (Mamba-1) runs through the
hand-written kernels (``--ssm-impl pallas``, the default here) on the
card, and a hybrid's attention layers through the hand-written flash
kernels (``attn_impl="auto"``).  Without
``edu_fineweb10B/`` (or ``--data-dir``) the run trains on synthetic
shards written there; nothing is downloaded.
"""

from __future__ import annotations

import argparse
import dataclasses

from mamba_distributed_tpu_torch.config import TRAIN_PRESETS, TrainConfig, get_train_preset


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--preset", default="mamba2-280m", choices=sorted(TRAIN_PRESETS))
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="steps between checkpoints (preset default 1000)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --checkpoint-dir")
    p.add_argument("--micro-batch-size", type=int, default=None)
    p.add_argument("--total-batch-size", type=int, default=None)
    p.add_argument("--seq-len", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--ssm-impl", choices=["xla", "pallas"], default="pallas",
                   help="pallas (default): the hand-written SSD or scan kernels on the card "
                        "(their plain versions on the CPU); xla: plain PyTorch autograd")
    p.add_argument("--chunk-size", type=int, default=None, help="SSD chunk length")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the card) or cpu")
    return p.parse_args(argv)


def build_config(args) -> TrainConfig:
    overrides = {field: val for field, val in (
        ("micro_batch_size", args.micro_batch_size),
        ("total_batch_size", args.total_batch_size),
        ("seq_len", args.seq_len),
        ("seed", args.seed),
        ("checkpoint_every", args.checkpoint_every),
        ("log_dir", args.log_dir),
    ) if val is not None}
    cfg = get_train_preset(args.preset, **overrides)
    model_over = {k: v for k, v in (("ssm_impl", args.ssm_impl),
                                    ("chunk_size", args.chunk_size)) if v is not None}
    if model_over:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model_over))
    if args.data_dir is not None:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, data_dir=args.data_dir))
    return cfg


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = build_config(args)
    from mamba_distributed_tpu_torch.training import Trainer

    trainer = Trainer(cfg, device=args.device)
    try:
        if args.resume and args.checkpoint_dir:
            try:
                trainer.restore_checkpoint(args.checkpoint_dir)
                print(f"resumed from step {trainer.step}")
            except FileNotFoundError:
                print("no checkpoint found; starting fresh")
        trainer.run(max_steps=args.max_steps, checkpoint_dir=args.checkpoint_dir)
    finally:
        trainer.finish()


if __name__ == "__main__":
    main()
