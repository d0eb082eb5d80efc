"""Train a Mamba-2, Mamba-1 or hybrid LM with the PyTorch port, on the card by default.

    python -m mamba_distributed_tpu_torch.train --preset mamba2-280m --max-steps 3
    python -m mamba_distributed_tpu_torch.train --preset hybrid-280m --max-steps 3
    python -m mamba_distributed_tpu_torch.train --preset mamba1-280m --max-steps 3
    python -m mamba_distributed_tpu_torch.train --preset mamba2-280m --remat-policy mixer \
        --loss-impl blocked --max-steps 3
    python -m mamba_distributed_tpu_torch.train --preset hybrid-7b --n-layer 8 --max-steps 3
    python -m mamba_distributed_tpu_torch.train --preset hybrid-tiny --device cpu --max-steps 5

Telemetry (the JAX CLI's flags): ``--spans`` writes host spans to
``{log_dir}/events.jsonl``; the divergence sentinel is on by default and
dumps ``{log_dir}/flight_record.json`` on a non-finite step, then stops
(``--no-halt-on-divergence`` trains on); ``--overflow-threshold NORM``
counts steps whose pre-clip grad norm exceeds NORM.  ``--auto-restart
N`` (with ``--checkpoint-dir``) rebuilds the trainer from the newest
checkpoint after a crash, up to N times, with the crashed trainer's
device memory released first; a divergence is never retried.

``--preset hybrid-7b`` (gated MLP after every mixer) is the JAX
package's 64-chip recipe on one card: its fp32 masters, gradients and
AdamW moments take 16 bytes for each of its 8.9 billion parameters at
32 layers, more than one 80 GB card holds, so train it cut with
``--n-layer`` (8 layers, one period of its attention pattern, keep
attention at layer 3).

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
import gc

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
    p.add_argument("--remat-policy", choices=["all", "dots", "mixer"], default=None,
                   help="what each checkpointed block saves: all (nothing but its "
                        "input), dots (the 2-D matrix products) or mixer (each mixer "
                        "core's output, so its forward kernel runs once)")
    p.add_argument("--loss-impl", choices=["dense", "blocked"], default=None,
                   help="LM-head+CE formulation; blocked never makes the (b, t, V) logits")
    p.add_argument("--conv-impl", choices=["shift", "xla_conv"], default=None,
                   help="causal-conv formulation (same function)")
    p.add_argument("--n-layer", type=int, default=None,
                   help="cut the preset's depth (a hybrid keeps its attention layers "
                        "below it)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the card) or cpu")
    p.add_argument("--sample-prompt", default=None, metavar="TEXT",
                   help="sample 4x32-token continuations of TEXT every sample_every "
                        "steps, as the reference samples in its loop (tokenized by the "
                        "port's GPT-2 BPE from $GPT2_BPE_DIR / ./gpt2_bpe)")
    p.add_argument("--sample-prompt-ids", default=None, metavar="IDS",
                   help="same, with the prompt as comma-separated token ids (no "
                        "tokenizer needed)")
    p.add_argument("--spans", action="store_true",
                   help="host-side span tracing (obs/): data_load/train_step/eval/"
                        "checkpoint phase timings to {log_dir}/events.jsonl, readable by "
                        "scripts/obs_report.py; no device work")
    p.add_argument("--overflow-threshold", type=float, default=None, metavar="NORM",
                   help="on-device divergence sentinel: the train step also reports "
                        "pre-clip global grad norm > NORM (counted into the flight "
                        "record); 0 disables")
    p.add_argument("--no-halt-on-divergence", action="store_true",
                   help="keep training through a non-finite loss instead of dumping the "
                        "flight record and stopping")
    p.add_argument("--auto-restart", type=int, default=0, metavar="N",
                   help="on a crash, rebuild the trainer from the latest checkpoint in "
                        "--checkpoint-dir and continue, up to N times (restart-based "
                        "failure recovery)")
    return p.parse_args(argv)


def resolve_sampling(args):
    """-> (prompt ids | None, decode_fn | None)."""
    if args.sample_prompt_ids is not None:
        return [int(t) for t in args.sample_prompt_ids.split(",")], None
    if args.sample_prompt is None:
        return None, None
    from mamba_distributed_tpu_torch.data.gpt2_bpe import load_encoder

    try:
        encode, decode = load_encoder()
    except FileNotFoundError as e:
        raise SystemExit(f"--sample-prompt: {e}\nOr pass --sample-prompt-ids instead.")
    return encode(args.sample_prompt), decode


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
                                    ("chunk_size", args.chunk_size),
                                    ("remat_policy", args.remat_policy),
                                    ("loss_impl", args.loss_impl),
                                    ("conv_impl", args.conv_impl)) if v is not None}
    if args.n_layer is not None:
        model_over["n_layer"] = args.n_layer
        model_over["attn_layer_idx"] = tuple(
            i for i in cfg.model.attn_layer_idx if i < args.n_layer)
    if model_over:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model_over))
    if args.data_dir is not None:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, data_dir=args.data_dir))
    tele = {}
    if args.spans:
        tele["spans"] = True
    if args.overflow_threshold is not None:
        tele["overflow_threshold"] = args.overflow_threshold
    if args.no_halt_on_divergence:
        tele["halt_on_divergence"] = False
    if tele:
        cfg = dataclasses.replace(cfg, telemetry=dataclasses.replace(cfg.telemetry, **tele))
    return cfg


def main(argv=None) -> dict:
    """Train as the flags say.  Returns the history of the run's last
    trainer (step -> (loss, pre-clip grad norm)) for in-process callers."""
    args = parse_args(argv)
    if args.auto_restart < 0:
        raise SystemExit(f"--auto-restart must be >= 0, got {args.auto_restart}")
    if args.auto_restart and not args.checkpoint_dir:
        raise SystemExit("--auto-restart needs --checkpoint-dir to recover from")
    cfg = build_config(args)
    sample_ids, decode_fn = resolve_sampling(args)
    import torch

    from mamba_distributed_tpu_torch.obs import DivergenceError
    from mamba_distributed_tpu_torch.training import Trainer

    def make_trainer(resume: bool, after_crash: bool = False):
        trainer = Trainer(cfg, device=args.device, sample_prompt_ids=sample_ids,
                          decode_fn=decode_fn)
        if resume and args.checkpoint_dir:
            try:
                trainer.restore_checkpoint(args.checkpoint_dir)
                print(f"resumed from step {trainer.step}")
            except FileNotFoundError:
                if after_crash:
                    trainer.finish()
                    # a restart from step 0 would only replay the same
                    # data and burn the restart budget
                    raise SystemExit(
                        "auto-restart: crashed before any checkpoint was written; "
                        "refusing to silently restart from step 0 (lower "
                        "--checkpoint-every or rerun manually)")
                print("no checkpoint found; starting fresh")
        return trainer

    # restart-based failure recovery: rebuild from the newest full-state
    # checkpoint and continue, up to --auto-restart times
    trainer = None
    try:
        for attempt in range(args.auto_restart + 1):
            if attempt:
                # the crashed trainer (params, AdamW moments, the failed
                # step's activations held by the traceback's frames) is
                # unreachable now: collect it and hand its cached blocks
                # back, so the card never holds two parameter sets
                gc.collect()
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()
                    print(f"restart {attempt}/{args.auto_restart}: device memory "
                          f"allocated before the rebuild {torch.cuda.memory_allocated()} B")
            try:
                trainer = make_trainer(resume=args.resume if attempt == 0 else True,
                                       after_crash=attempt > 0)
                trainer.run(max_steps=args.max_steps, checkpoint_dir=args.checkpoint_dir)
                break
            except Exception as e:
                # a divergence is deterministic from the restored state: a
                # restart would replay the same data back to the same NaN,
                # so the flight record is the artifact; stop here
                if isinstance(e, DivergenceError) or attempt == args.auto_restart:
                    raise
                print(f"run crashed ({type(e).__name__}: {e}); "
                      f"restart {attempt + 1}/{args.auto_restart} from the latest checkpoint")
                if trainer is not None:
                    try:
                        trainer.finish()
                    except Exception:
                        pass
                trainer = None
        return trainer.history
    finally:
        if trainer is not None:
            trainer.finish()


if __name__ == "__main__":
    main()
