"""Training loop (counterpart of the JAX package's
``training/trainer.py``).

The reference's loop: grad-accum steps, validation every ``val_every``
steps and at the last step, reference-format logging with tokens/s and
MFU, periodic full-state checkpoints with exact resume, and in-loop
sampling through the port's ``generate()``.  Telemetry as the JAX
trainer wires it (``cfg.telemetry``): host spans (``data_load``,
``train_step``, ``eval``, ``sample``, ``checkpoint_save``) to
``{log_dir}/events.jsonl``, and the divergence sentinel, whose flight
record ``{log_dir}/flight_record.json`` is dumped on a non-finite step
(then ``DivergenceError``, unless ``halt_on_divergence`` is off) or on
any exception out of ``run()``.  Restarts after a crash are the CLI's
(``train.py --auto-restart``).  The trainer runs on the card unless it
is given ``device="cpu"``.

Data parallel, FSDP, sequence, tensor, expert and pipeline parallel:
when a ``torch.distributed`` process group is up (``torchrun``,
``parallel/mesh.init_distributed``) the trainer is one rank of
``cfg.mesh``: its device is
``cuda:{LOCAL_RANK}`` (a card given with its index, e.g. ``cuda:0`` for
two gloo ranks sharing one card, is kept; the CPU over gloo), its
loaders read its block of the batch rows (the rank-strided windows of
batch coordinate c of ``data_parallel_size``, over ``(data, fsdp,
expert)``: the ranks of one tensor, seq or pipe group read the same
rows), every rank initialises the same full tree from the seed, keeps
its pipeline stage's layers, its block of every MoE's experts, packs its
tensor shard of that
(``parallel/tp_layout.py``) and keeps its fsdp block of that, and the
train step runs the blocks' tensor and expert collectives and reduces
the gradients over the batch ranks (``training/train_step.py``).  Rank 0 is
the master: only it logs, writes records, spans and the sentinel's dump,
samples, prints and writes checkpoints (the logical full params and
moments, gathered over fsdp, then over tensor and unpacked, then over
expert, then over pipe: today's format, loadable on one device, plus
every batch rank's loader cursor).  Validation runs the
train step's forward on the packed shards; sampling gathers the full
params on every rank and runs today's ``generate()`` on the master (TP
decode is a later slice).  MFU stays over the world's peak.  Without a
group the trainer is the one-device trainer, and a mesh of more than one
device raises.  ``finish()`` destroys the group.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from mamba_distributed_tpu_torch.config import TrainConfig
from mamba_distributed_tpu_torch.data import ShardedTokenLoader, ensure_synthetic_shards
from mamba_distributed_tpu_torch.models.lm import count_params, init_lm_params
from mamba_distributed_tpu_torch.obs import (
    NULL_TRACER,
    DivergenceError,
    DivergenceSentinel,
    SpanTracer,
)
from mamba_distributed_tpu_torch.ops.dispatch import check_kernel_shapes
from mamba_distributed_tpu_torch.parallel.mesh import (
    build_mesh,
    expert_context,
    pipe_context,
    seq_context,
    tensor_context,
)
from mamba_distributed_tpu_torch.parallel.sharding import (
    batch_coordinate,
    executed_specs,
    expert_shard,
    gather_params,
    narrow_leaf,
    opt_state_specs,
    param_specs,
    stage_block,
)
from mamba_distributed_tpu_torch.parallel.tp_layout import pack_tp, tp_plan
from mamba_distributed_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from mamba_distributed_tpu_torch.training.optimizer import AdamW, tree_map
from mamba_distributed_tpu_torch.training.train_step import (
    is_fsdp,
    make_eval_step,
    make_train_step,
)
from mamba_distributed_tpu_torch.utils.flops import flops_per_token, peak_flops
from mamba_distributed_tpu_torch.utils.metrics import MetricsLogger


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: the trainer runs on the card; pass "
            "device='cpu' (--device cpu on the command line) to train on the CPU"
        )
    return dev


def rank_device(device: torch.device) -> torch.device:
    """This rank's device under a process group: on a card
    ``cuda:{LOCAL_RANK}``, or the card ``device`` names by its index
    (``init_distributed`` pinned it), over NCCL or an explicitly asked-for
    gloo group; the CPU over gloo.  Any other pairing raises."""
    backend = dist.get_backend()
    allowed = {"cuda": ("nccl", "gloo"), "cpu": ("gloo",)}.get(device.type, ())
    if backend not in allowed:
        raise RuntimeError(f"a {device.type} trainer needs a {' or '.join(allowed) or 'known'} "
                           f"process group, this one is {backend}")
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


class Trainer:
    def __init__(self, cfg: TrainConfig, device="cuda", verbose: bool = True,
                 sample_prompt_ids=None, decode_fn=None, loader_backend: str = "auto"):
        self.cfg = cfg
        if torch.device(device).type == "cuda":
            check_kernel_shapes(cfg.model)
        self.device = resolve_device(device)
        # one rank of cfg.mesh whenever a process group is up
        self.mesh, self.rank, self.world, self.batch_rank = None, 0, 1, 0
        if dist.is_available() and dist.is_initialized():
            self.device = rank_device(self.device)
            # the mesh's device type names the backend's: a gloo group on
            # a card is a CPU mesh (its groups are gloo's either way)
            self.mesh = build_mesh(cfg.mesh, "cuda" if dist.get_backend() == "nccl" else "cpu")
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
            self.batch_rank = batch_coordinate(self.mesh)
        elif cfg.mesh.num_devices > 1:
            raise RuntimeError(
                f"mesh {dict(zip(cfg.mesh.axis_names, cfg.mesh.shape))} wants "
                f"{cfg.mesh.num_devices} ranks and no process group is up: launch under "
                f"torchrun --nproc_per_node={cfg.mesh.num_devices}")
        self.master = self.rank == 0
        self.verbose = verbose = verbose and self.master
        self._fsdp = self.mesh is not None and is_fsdp(cfg)
        self.tp = tensor_context(self.mesh) if self.mesh is not None else None
        self.plan = tp_plan(cfg.model, self.tp.size) if self.tp is not None else None
        self.ep = expert_context(self.mesh) if self.mesh is not None else None
        # a seq rank trains on its block of every row's tokens
        self.seq = seq_context(self.mesh) if self.mesh is not None else None
        # a pipe rank holds its stage's layers
        self.pipe = pipe_context(self.mesh) if self.mesh is not None else None
        # params and moments live as shards of some axis
        self._sharded = (self._fsdp or self.tp is not None or self.ep is not None
                         or self.pipe is not None)

        # data: synthetic shards when the data dir holds none (the master
        # writes them, the others wait)
        data_dir = cfg.data.data_dir
        if cfg.data.allow_synthetic and self.master:
            ensure_synthetic_shards(
                data_dir, vocab_size=cfg.model.vocab_size,
                tokens_per_shard=cfg.data.synthetic_tokens_per_shard,
                num_shards=cfg.data.synthetic_num_shards, seed=cfg.seed,
            )
        if self.mesh is not None:
            dist.barrier()
        # loader_backend: "auto", "native" or "numpy" (data/loader.py);
        # each batch rank reads its rank-strided rows
        loader_args = dict(B=cfg.micro_batch_size, T=cfg.seq_len, data_dir=data_dir,
                           process_rank=self.batch_rank, num_processes=cfg.data_parallel_size,
                           master_process=verbose, backend=loader_backend)
        self.train_loader = ShardedTokenLoader(split="train", **loader_args)
        self.val_loader = ShardedTokenLoader(split="val", **loader_args)

        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        params = init_lm_params(cfg.model, gen, device=self.device)
        if verbose:
            print(f"model params: {count_params(params):,}")
        self.specs = None
        if self.mesh is not None:
            m = cfg.mesh
            self.specs = param_specs(params, cfg.shard_params, m.fsdp, m.tensor, m.pipe,
                                     m.expert)
            if self.pipe is not None:  # every rank keeps its stage's layers
                params = stage_block(params, self.specs, self.pipe)
            if self.ep is not None:  # every rank keeps its experts of the full tree
                params = expert_shard(params, self.specs, self.ep)
            if self.tp is not None:  # packs its tensor shard of that
                params = pack_tp(params, self.plan, self.tp.rank)
                self.specs = executed_specs(self.specs, params, m.fsdp, self.plan)
            if self._fsdp:  # and keeps its fsdp block of that
                params = self._fsdp_block(params)
        self.params = tree_map(lambda t: t.requires_grad_(), params)
        del params
        self.optimizer = AdamW(cfg, self.params)
        self.schedule = self.optimizer.schedule
        # telemetry (obs/): spans and the divergence sentinel read only
        # host scalars the loop fetches anyway, so turning them on adds
        # no launch and no device sync; the overflow flag is computed on
        # the card and comes back in the step's one fetch
        tcfg = cfg.telemetry
        self.tracer = (SpanTracer(os.path.join(cfg.log_dir, "events.jsonl"),
                                  rotate_bytes=tcfg.span_rotate_bytes)
                       if tcfg.spans and self.master else NULL_TRACER)
        # every rank watches (all halt together on a divergence); only the
        # master writes the dump
        self.sentinel = (DivergenceSentinel(os.path.join(cfg.log_dir, "flight_record.json")
                                            if self.master else None,
                                            capacity=tcfg.flight_recorder_len,
                                            tracer=self.tracer)
                         if tcfg.sentinel else None)
        self._overflow_on = tcfg.overflow_threshold > 0
        self.train_step = make_train_step(
            cfg, self.optimizer, self.mesh, self.specs,
            overflow_threshold=tcfg.overflow_threshold if self._overflow_on else None)
        self.eval_step = make_eval_step(cfg, self.mesh)
        self.logger = MetricsLogger(cfg.log_dir, verbose)
        self.step = 0
        # step -> (loss, pre-clip grad norm) of every step this trainer ran
        self.history: dict[int, tuple[float, float]] = {}
        # draws the sampling seeds (its state is checkpointed)
        self.rng = torch.Generator().manual_seed(cfg.seed)
        self._sample_prompt_ids = sample_prompt_ids
        self._decode_fn = decode_fn
        self._fpt_model = flops_per_token(cfg.model, cfg.seq_len, convention="model")
        self._fpt_hw = flops_per_token(cfg.model, cfg.seq_len)
        # MFU only against the cards' peak; a CPU run reports none
        self._peak = (peak_flops(self.device) * self.world if self.device.type == "cuda"
                      else None)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A batch's (..., B, T) tokens on the device: under seq, this
        rank's block of the T columns (JAX ``batch_sharding(seq_sharded=True)``)."""
        if self.seq is not None:
            tl = arr.shape[-1] // self.seq.size
            arr = np.ascontiguousarray(arr[..., self.seq.rank * tl:(self.seq.rank + 1) * tl])
        return torch.from_numpy(arr).to(self.device, dtype=torch.int64)

    def _batch(self, accum: int, loader) -> tuple[torch.Tensor, torch.Tensor]:
        xs, ys = zip(*(loader.next_batch() for _ in range(accum)))
        return self._to_device(np.stack(xs)), self._to_device(np.stack(ys))

    def local_params(self) -> dict:
        """This rank's packed tensor shard and experts of every leaf, whole
        over fsdp (gathered from the shards under FSDP: a collective, so
        every rank calls it); the full tree without a tensor or expert
        axis."""
        if not self._fsdp:
            return self.params
        return gather_params(self.params, self.specs, self.mesh.get_group("fsdp"))

    def full_params(self) -> dict:
        """The full (logical) parameter tree: gathered over fsdp, then over
        tensor and unpacked, then over expert, then over pipe (collectives,
        so every rank calls it)."""
        return self._gather(self.params, self.specs)

    def _gather(self, tree: dict, specs: dict) -> dict:
        if not self._sharded:
            return tree
        group = self.mesh.get_group("fsdp") if self._fsdp else None
        return gather_params(tree, specs, group, self.tp, self.plan, self.ep, self.pipe)

    def _fsdp_block(self, tree: dict) -> dict:
        group = self.mesh.get_group("fsdp")
        index, size = dist.get_rank(group), dist.get_world_size(group)
        return tree_map(lambda t, s: narrow_leaf(t, s, index, size), tree, self.specs)

    def _own(self, tree: dict) -> dict:
        """This rank's shard of a full (logical) tree: its stage, its
        experts, packed over tensor, narrowed over fsdp."""
        if self.pipe is not None:
            tree = stage_block(tree, self.specs, self.pipe)
        if self.ep is not None:
            tree = expert_shard(tree, self.specs, self.ep)
        if self.tp is not None:
            tree = pack_tp(tree, self.plan, self.tp.rank)
        return self._fsdp_block(tree) if self._fsdp else tree

    def validate(self) -> float:
        """The mean loss over ``val_steps`` validation batches (every rank's
        rows, averaged over the batch ranks)."""
        with self.tracer.span("eval", steps=self.cfg.val_steps):
            self.val_loader.reset()
            params = self.local_params()
            total = 0.0
            for _ in range(self.cfg.val_steps):
                x, y = self.val_loader.next_batch()
                total += float(self.eval_step(params, self._to_device(x), self._to_device(y)))
        return total / self.cfg.val_steps

    def run(self, max_steps: int | None = None, checkpoint_dir: str | None = None):
        cfg = self.cfg
        last = min(cfg.max_steps if max_steps is None else max_steps, cfg.max_steps)
        try:
            self._run_loop(last, checkpoint_dir)
        except BaseException as e:
            # the crash-time flight dump: the last steps before the death
            # (a DivergenceError already dumped with its own reason; the
            # dump is once-only)
            if self.sentinel is not None:
                self.sentinel.on_crash(e)
            raise
        return self

    def _run_loop(self, last: int, checkpoint_dir: str | None) -> None:
        cfg = self.cfg
        accum = cfg.grad_accum_steps
        while self.step < last:
            step = self.step
            if step % cfg.val_every == 0 or step == last - 1:
                val_loss = self.validate()
                self.logger.val(step, val_loss)
                if self.sentinel is not None:
                    self.sentinel.record_event("val", step=step, loss=val_loss)
            if self._sample_prompt_ids is not None and step % cfg.sample_every == 0 and step > 0:
                with self.tracer.span("sample", step=step):
                    self.sample()
            if checkpoint_dir and step > 0 and step % cfg.checkpoint_every == 0:
                self.save_checkpoint(checkpoint_dir)

            t0 = time.perf_counter()
            with self.tracer.span("data_load", step=step):
                x, y = self._batch(accum, self.train_loader)
            with self.tracer.span("train_step", step=step):
                out = self.train_step(self.params, x, y)
                # the step's one host fetch (loss, grad norm and, when on,
                # the overflow flag): it waits for the step, so the span
                # covers the device work
                host = torch.stack(out).tolist()
            dt = time.perf_counter() - t0
            loss_f, grad_norm_f = host[0], host[1]
            overflow = int(host[2]) if self._overflow_on else None
            # the global batch, counted once (the seq ranks share its rows)
            tok_per_sec = cfg.total_batch_size / dt
            mfu = mfu_hw = None
            if self._peak is not None:
                mfu = self._fpt_model * tok_per_sec / self._peak
                mfu_hw = self._fpt_hw * tok_per_sec / self._peak
            self.logger.train_step(step, loss_f, self.schedule(step), grad_norm_f, dt,
                                   tok_per_sec, mfu, mfu_hw)
            self.history[step] = (loss_f, grad_norm_f)
            if self.sentinel is not None and self.sentinel.observe_step(
                    step, loss_f, grad_norm_f, overflow=overflow,
                    step_ms=round(dt * 1000, 2)):
                if cfg.telemetry.halt_on_divergence:
                    raise DivergenceError(
                        f"non-finite loss/grad_norm at step {step} "
                        f"(loss={loss_f}, grad_norm={grad_norm_f}); flight "
                        f"record: {self.sentinel.dumped_to or 'written by rank 0'}")
            self.step += 1

    def sample(self, num_return: int = 4, max_new_tokens: int = 32, top_k: int = 50):
        """Continuations of the sample prompt (4 x 32 tokens, top-k 50, as
        the reference samples in its loop) through ``generate()``, on the
        master (every rank draws the seed and takes part in the gather);
        None elsewhere."""
        from mamba_distributed_tpu_torch.inference.generate import generate

        prompt = torch.as_tensor(self._sample_prompt_ids, dtype=torch.int64)[None]
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=self.rng))
        params = self.full_params()
        if not self.master:
            return None
        with torch.no_grad():
            out = generate(params, self.cfg.model, prompt.repeat(num_return, 1),
                           seed=seed, max_new_tokens=max_new_tokens, top_k=top_k)
        if self.verbose:
            for row in out.cpu().tolist():
                print("sample: " + (self._decode_fn(row) if self._decode_fn
                                    else f"tokens {row}"))
        return out

    def save_checkpoint(self, directory: str) -> str | None:
        """Write the full state: the master writes the gathered params and
        moments, the loader cursor of batch rank 0 and, over a mesh, every
        batch rank's cursor (the reference's rank-strided rule lets a rank
        move to the next shard a window before rank 0, so rank 0's cursor
        does not give the others'); the ranks meet at a barrier after.
        Returns the path on the master."""
        path = None
        with self.tracer.span("checkpoint_save", step=self.step):
            params, opt_state = self.params, self.optimizer.state_dict()
            loaders = None
            if self.mesh is not None:
                if self._sharded:
                    params = self._gather(params, self.specs)
                    ospecs = opt_state_specs(opt_state, self.specs)
                    opt_state = {k: self._gather(v, ospecs[k]) if ospecs[k] else v
                                 for k, v in opt_state.items()}
                pairs = [None] * self.world
                dist.all_gather_object(pairs, (self.batch_rank, self.train_loader.state()))
                by_rank = dict(pairs)
                loaders = [by_rank[c] for c in range(self.cfg.data_parallel_size)]
            if self.master:
                path = save_checkpoint(directory, self.step, params, opt_state,
                                       self.train_loader.state(), self.rng.get_state(),
                                       loaders=loaders)
            del params, opt_state
            if self.mesh is not None:
                dist.barrier()
        if self.sentinel is not None:
            self.sentinel.record_event("checkpoint_save", step=self.step)
        return path

    def restore_checkpoint(self, directory: str, step: int | None = None) -> None:
        """Resume from a checkpoint: every rank reads the file and keeps
        its shard; over a mesh each batch rank takes its own loader cursor
        (the checkpoint must come from a run of the same world)."""
        ck = restore_checkpoint(directory, step)
        loader = ck["loader"]
        if self.mesh is not None:
            loaders = ck.get("loaders")
            if loaders is None or len(loaders) != self.cfg.data_parallel_size:
                raise ValueError(
                    f"checkpoint {directory} holds "
                    f"{'one loader cursor' if loaders is None else f'{len(loaders)} cursors'}; "
                    f"a run over {self.cfg.data_parallel_size} batch ranks resumes from a "
                    f"checkpoint of the same data-parallel size")
            loader = loaders[self.batch_rank]
        state = {"count": ck["opt_state"]["count"], "mu": ck["opt_state"]["mu"],
                 "nu": ck["opt_state"]["nu"]}
        params = ck["params"]
        if self._sharded:
            params = self._own(params)
            state["mu"], state["nu"] = self._own(state["mu"]), self._own(state["nu"])
        with torch.no_grad():
            tree_map(lambda dst, src: dst.copy_(src), self.params, params)
        self.optimizer.load_state_dict(state)
        self.train_loader.restore(loader)
        self.rng.set_state(ck["rng"])
        self.step = int(ck["step"])
        self.logger.preserve_history()
        self.tracer.preserve_history()

    def finish(self) -> None:
        """Stop the loaders' prefetch threads and, over a mesh, destroy the
        process group."""
        self.train_loader.close()
        self.val_loader.close()
        if self.mesh is not None and dist.is_initialized():
            dist.destroy_process_group()
        self.mesh = None

