"""Training loop (counterpart of the JAX package's
``training/trainer.py``, one device).

The reference's loop: grad-accum steps, validation every ``val_every``
steps and at the last step, reference-format logging with tokens/s and
MFU, periodic full-state checkpoints with exact resume, and in-loop
sampling through the port's ``generate()``.  Left out with the mesh:
multi-host loading, the span tracer, the divergence sentinel and
auto-restart.  The trainer runs on the card unless it is given
``device="cpu"``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mamba_distributed_tpu_torch.config import TrainConfig
from mamba_distributed_tpu_torch.data import ShardedTokenLoader, ensure_synthetic_shards
from mamba_distributed_tpu_torch.models.lm import count_params, init_lm_params
from mamba_distributed_tpu_torch.ops.dispatch import check_kernel_shapes
from mamba_distributed_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from mamba_distributed_tpu_torch.training.optimizer import AdamW, tree_map
from mamba_distributed_tpu_torch.training.train_step import make_eval_step, make_train_step
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


class Trainer:
    def __init__(self, cfg: TrainConfig, device="cuda", verbose: bool = True,
                 sample_prompt_ids=None, decode_fn=None, loader_backend: str = "auto"):
        self.cfg = cfg
        if torch.device(device).type == "cuda":
            check_kernel_shapes(cfg.model)
        self.device = resolve_device(device)
        self.verbose = verbose

        # data: synthetic shards when the data dir holds none
        data_dir = cfg.data.data_dir
        if cfg.data.allow_synthetic:
            ensure_synthetic_shards(
                data_dir, vocab_size=cfg.model.vocab_size,
                tokens_per_shard=cfg.data.synthetic_tokens_per_shard,
                num_shards=cfg.data.synthetic_num_shards, seed=cfg.seed,
            )
        # loader_backend: "auto", "native" or "numpy" (data/loader.py)
        loader_args = dict(B=cfg.micro_batch_size, T=cfg.seq_len, data_dir=data_dir,
                           master_process=verbose, backend=loader_backend)
        self.train_loader = ShardedTokenLoader(split="train", **loader_args)
        self.val_loader = ShardedTokenLoader(split="val", **loader_args)

        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.params = tree_map(lambda t: t.requires_grad_(),
                               init_lm_params(cfg.model, gen, device=self.device))
        if verbose:
            print(f"model params: {count_params(self.params):,}")
        self.optimizer = AdamW(cfg, self.params)
        self.schedule = self.optimizer.schedule
        self.train_step = make_train_step(cfg, self.optimizer)
        self.eval_step = make_eval_step(cfg)
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
        # MFU only against a card's peak; a CPU run reports none
        self._peak = peak_flops(self.device) if self.device.type == "cuda" else None

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device, dtype=torch.int64)

    def _batch(self, accum: int, loader) -> tuple[torch.Tensor, torch.Tensor]:
        xs, ys = zip(*(loader.next_batch() for _ in range(accum)))
        return self._to_device(np.stack(xs)), self._to_device(np.stack(ys))

    def validate(self) -> float:
        self.val_loader.reset()
        total = 0.0
        for _ in range(self.cfg.val_steps):
            x, y = self.val_loader.next_batch()
            total += float(self.eval_step(self.params, self._to_device(x), self._to_device(y)))
        return total / self.cfg.val_steps

    def run(self, max_steps: int | None = None, checkpoint_dir: str | None = None):
        cfg = self.cfg
        last = min(cfg.max_steps if max_steps is None else max_steps, cfg.max_steps)
        accum = cfg.grad_accum_steps
        while self.step < last:
            step = self.step
            if step % cfg.val_every == 0 or step == last - 1:
                self.logger.val(step, self.validate())
            if self._sample_prompt_ids is not None and step % cfg.sample_every == 0 and step > 0:
                self.sample()
            if checkpoint_dir and step > 0 and step % cfg.checkpoint_every == 0:
                self.save_checkpoint(checkpoint_dir)

            t0 = time.perf_counter()
            x, y = self._batch(accum, self.train_loader)
            loss, grad_norm = self.train_step(self.params, x, y)
            loss_f, grad_norm_f = float(loss), float(grad_norm)  # waits for the step
            dt = time.perf_counter() - t0
            tok_per_sec = cfg.total_batch_size / dt
            mfu = mfu_hw = None
            if self._peak is not None:
                mfu = self._fpt_model * tok_per_sec / self._peak
                mfu_hw = self._fpt_hw * tok_per_sec / self._peak
            self.logger.train_step(step, loss_f, self.schedule(step), grad_norm_f, dt,
                                   tok_per_sec, mfu, mfu_hw)
            self.history[step] = (loss_f, grad_norm_f)
            self.step += 1
        return self

    def sample(self, num_return: int = 4, max_new_tokens: int = 32, top_k: int = 50):
        """Continuations of the sample prompt (4 x 32 tokens, top-k 50, as
        the reference samples in its loop) through ``generate()``."""
        from mamba_distributed_tpu_torch.inference.generate import generate

        prompt = torch.as_tensor(self._sample_prompt_ids, dtype=torch.int64)[None]
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=self.rng))
        with torch.no_grad():
            out = generate(self.params, self.cfg.model, prompt.repeat(num_return, 1),
                           seed=seed, max_new_tokens=max_new_tokens, top_k=top_k)
        if self.verbose:
            for row in out.cpu().tolist():
                print("sample: " + (self._decode_fn(row) if self._decode_fn
                                    else f"tokens {row}"))
        return out

    def save_checkpoint(self, directory: str) -> str:
        return save_checkpoint(directory, self.step, self.params, self.optimizer.state_dict(),
                               self.train_loader.state(), self.rng.get_state())

    def restore_checkpoint(self, directory: str, step: int | None = None) -> None:
        ck = restore_checkpoint(directory, step)
        with torch.no_grad():
            tree_map(lambda dst, src: dst.copy_(src), self.params, ck["params"])
        self.optimizer.load_state_dict(ck["opt_state"])
        self.train_loader.restore(ck["loader"])
        self.rng.set_state(ck["rng"])
        self.step = int(ck["step"])
        self.logger.preserve_history()

    def finish(self) -> None:
        """Stop the loaders' prefetch threads."""
        self.train_loader.close()
        self.val_loader.close()
