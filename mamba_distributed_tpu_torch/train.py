"""Train a Mamba-2, Mamba-1 or hybrid LM with the PyTorch port, on the card by default.

    python -m mamba_distributed_tpu_torch.train --preset mamba2-280m --max-steps 3
    python -m mamba_distributed_tpu_torch.train --preset hybrid-280m --max-steps 3
    python -m mamba_distributed_tpu_torch.train --preset mamba1-280m --max-steps 3
    python -m mamba_distributed_tpu_torch.train --preset mamba2-280m --remat-policy mixer \
        --loss-impl blocked --max-steps 3
    python -m mamba_distributed_tpu_torch.train --preset hybrid-7b --mesh-fsdp 1 --mesh-seq 1 \
        --n-layer 8 --max-steps 3
    python -m mamba_distributed_tpu_torch.train --preset hybrid-tiny --device cpu --max-steps 5

Data parallel and FSDP run one process per device under torchrun, as the
reference launches (NCCL on the cards, gloo with ``--device cpu``):

    torchrun --standalone --nproc_per_node=8 -m mamba_distributed_tpu_torch.train \
        --preset mamba2-280m-dp8
    torchrun --standalone --nproc_per_node=2 -m mamba_distributed_tpu_torch.train \
        --preset mamba2-tiny --mesh-data 2 --device cpu --max-steps 2

Tensor parallelism is the ``tensor`` axis (every mixer and FFN on its
rank's own heads, the ranks of one tensor group reading the same rows),
alone or with data and fsdp:

    torchrun --standalone --nproc_per_node=2 -m mamba_distributed_tpu_torch.train \
        --preset hybrid-280m --mesh-tensor 2
    torchrun --standalone --nproc_per_node=2 -m mamba_distributed_tpu_torch.train \
        --preset mamba2-tiny --mesh-tensor 2 --device cpu --max-steps 2

Expert parallelism is the ``expert`` axis of a MoE model (each rank holds
E/expert of every layer's experts; the routed rows move by all-to-alls;
a batch axis for every other layer), alone or with the three above; the
presets have no MoE, so ``--moe-num-experts`` makes one:

    torchrun --standalone --nproc_per_node=2 -m mamba_distributed_tpu_torch.train \
        --preset hybrid-tiny --d-intermediate 64 --moe-num-experts 4 --mesh-expert 2 \
        --device cpu --max-steps 2

Sequence parallelism is the ``seq`` axis (every sequence cut into equal
blocks of tokens, one a rank; the conv halo, the SSD or scan state and
the attention's KV (ring) or heads (Ulysses, ``--attn-sp-impl ulysses``)
cross the ranks), alone or with data, fsdp, tensor and expert; the
long-context presets
``mamba2-2.8b-sp32`` (fsdp 8 x seq 4) and ``hybrid-7b`` (fsdp 16 x seq 4)
name it:

    torchrun --standalone --nproc_per_node=2 -m mamba_distributed_tpu_torch.train \
        --preset hybrid-tiny --mesh-seq 2 --device cpu --max-steps 2
    torchrun --standalone --nproc_per_node=32 -m mamba_distributed_tpu_torch.train \
        --preset mamba2-2.8b-sp32

``--mesh-data``/``--mesh-fsdp``/``--mesh-seq``/``--mesh-tensor``/``--mesh-expert``
override the preset's mesh (their product must be the world size).  Like
the JAX CLI, this one has no pipe flag: the pipeline axis is reached
through ``TrainConfig.mesh`` and ``Trainer``.  Only rank 0 prints and
writes logs and checkpoints.

Telemetry (the JAX CLI's flags): ``--spans`` writes host spans to
``{log_dir}/events.jsonl``; the divergence sentinel is on by default and
dumps ``{log_dir}/flight_record.json`` on a non-finite step, then stops
(``--no-halt-on-divergence`` trains on); ``--overflow-threshold NORM``
counts steps whose pre-clip grad norm exceeds NORM.  ``--auto-restart
N`` (with ``--checkpoint-dir``) rebuilds the trainer from the newest
checkpoint after a crash, up to N times, with the crashed trainer's
device memory released first; a divergence is never retried.

``--preset hybrid-7b`` (gated MLP after every mixer) is the JAX
package's 64-chip recipe (fsdp 16 x seq 4); on one card give it a
one-device mesh (``--mesh-fsdp 1 --mesh-seq 1``): its fp32 masters,
gradients and AdamW moments take 16 bytes for each of its 8.9 billion
parameters at 32 layers, more than one 80 GB card holds, so train it cut
with ``--n-layer`` (8 layers, one period of its attention pattern, keep
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
import os

from mamba_distributed_tpu_torch.config import (
    TRAIN_PRESETS,
    MeshConfig,
    TrainConfig,
    get_preset,
    get_train_preset,
)


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
    p.add_argument("--mesh-data", type=int, default=None)
    p.add_argument("--mesh-fsdp", type=int, default=None)
    p.add_argument("--mesh-seq", type=int, default=None)
    p.add_argument("--mesh-tensor", type=int, default=None)
    p.add_argument("--mesh-expert", type=int, default=None)
    p.add_argument("--ssm-impl", choices=["xla", "pallas"], default="pallas",
                   help="pallas (default): the hand-written SSD or scan kernels on the card "
                        "(their plain versions on the CPU); xla: plain PyTorch autograd")
    p.add_argument("--chunk-size", type=int, default=None, help="SSD chunk length")
    p.add_argument("--attn-sp-impl", choices=["ring", "ulysses"], default=None,
                   help="attention under --mesh-seq: ring (the KV blocks travel the seq "
                        "ranks) or ulysses (an all-to-all to a head cut; heads must "
                        "divide by the seq size)")
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
    p.add_argument("--d-intermediate", type=int, default=None,
                   help="width of the gated MLP (or of each expert) after every mixer")
    p.add_argument("--moe-num-experts", type=int, default=None,
                   help="make the MLP a token-choice top-k mixture of this many experts")
    p.add_argument("--moe-capacity-factor", type=float, default=None)
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
    mesh_over = {k: v for k, v in (("data", args.mesh_data), ("fsdp", args.mesh_fsdp),
                                   ("seq", args.mesh_seq), ("tensor", args.mesh_tensor),
                                   ("expert", args.mesh_expert))
                 if v is not None}
    if mesh_over:
        base = TRAIN_PRESETS[args.preset].get("mesh", MeshConfig())
        overrides["mesh"] = dataclasses.replace(base, **mesh_over)
    # the model first: the mesh checks read it (an expert axis needs a MoE)
    model = get_preset(args.preset)
    model_over = {k: v for k, v in (("ssm_impl", args.ssm_impl),
                                    ("chunk_size", args.chunk_size),
                                    ("attn_sp_impl", args.attn_sp_impl),
                                    ("remat_policy", args.remat_policy),
                                    ("loss_impl", args.loss_impl),
                                    ("conv_impl", args.conv_impl),
                                    ("d_intermediate", args.d_intermediate),
                                    ("moe_num_experts", args.moe_num_experts),
                                    ("moe_capacity_factor", args.moe_capacity_factor))
                  if v is not None}
    if args.n_layer is not None:
        model_over["n_layer"] = args.n_layer
        model_over["attn_layer_idx"] = tuple(
            i for i in model.attn_layer_idx if i < args.n_layer)
    cfg = get_train_preset(args.preset, model=dataclasses.replace(model, **model_over),
                           **overrides)
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
    # under torchrun: one rank of the mesh (the process group forms in
    # make_trainer, anew after a restart, since finish() destroys it)
    launched = "WORLD_SIZE" in os.environ
    if launched and args.auto_restart and int(os.environ["WORLD_SIZE"]) > 1:
        raise SystemExit(
            f"--auto-restart: a world of {os.environ['WORLD_SIZE']} ranks restarts through "
            f"torchrun's --max-restarts (every rank has to restart together), not in process")
    cfg = build_config(args)
    sample_ids, decode_fn = resolve_sampling(args)
    import torch
    import torch.distributed as dist

    from mamba_distributed_tpu_torch.obs import DivergenceError
    from mamba_distributed_tpu_torch.parallel.mesh import init_distributed
    from mamba_distributed_tpu_torch.training import Trainer

    def make_trainer(resume: bool, after_crash: bool = False):
        if launched and not dist.is_initialized():
            init_distributed(args.device)
        trainer = Trainer(cfg, device=args.device, sample_prompt_ids=sample_ids,
                          decode_fn=decode_fn)
        if resume and args.checkpoint_dir:
            try:
                trainer.restore_checkpoint(args.checkpoint_dir)
                if trainer.master:
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
                if trainer.master:
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
