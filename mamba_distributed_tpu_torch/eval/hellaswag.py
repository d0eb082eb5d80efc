"""HellaSwag evaluation (counterpart of the JAX package's
``eval/hellaswag.py``), reproducing the reference scoring:

  * each ending tokenized with a leading " " (GPT-2 BPE quirk)
  * rows padded to the per-batch max length, completion mask marks ending
    tokens
  * autoregressive CE at all positions, logits/tokens/mask shifted by one
  * ``acc`` = argmin of summed loss, ``acc_norm`` = argmin of mean loss
  * evaluation stops at 2,000 examples and appends the summary line
    ``"{n} {correct}/{n} {acc:.4f}"``: the number comparable to the
    reference's published 0.324

The tokenizer is injected (``data/gpt2_bpe.load_encoder`` in the CLI);
rows are padded to a bucket of 32 tokens and packed ``example_batch``
examples to a call at a fixed row count, as in the JAX package.  Scores
are fp32, computed on the forward's device as ``logsumexp - gathered
logit`` (the same function as the JAX package's log-softmax gather, with
no (R, L, V) log-prob tensor).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Iterable, Iterator

import numpy as np
import torch


def render_example(example: dict, encode: Callable[[str], list[int]]):
    """dict -> (data, tokens (4, L) int32, mask (4, L) int32, label)."""
    ctx = example["ctx"]
    label = int(example["label"])
    endings = example["endings"]

    ctx_tokens = encode(ctx)
    data = {"label": label, "ctx_tokens": ctx_tokens, "ending_tokens": []}
    tok_rows, mask_rows = [], []
    for end in endings:
        end_tokens = encode(" " + end)  # the " "-prefix rule
        tok_rows.append(ctx_tokens + end_tokens)
        mask_rows.append([0] * len(ctx_tokens) + [1] * len(end_tokens))
        data["ending_tokens"].append(end_tokens)

    max_len = max(len(r) for r in tok_rows)
    tokens = np.zeros((4, max_len), dtype=np.int32)
    mask = np.zeros((4, max_len), dtype=np.int32)
    for i, (tr, mr) in enumerate(zip(tok_rows, mask_rows)):
        tokens[i, :len(tr)] = tr
        mask[i, :len(mr)] = mr
    return data, tokens, mask, label


def iterate_examples(path: str) -> Iterator[dict]:
    """Yield examples from a local HellaSwag jsonl file (the user brings
    it: nothing is downloaded)."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found. Download hellaswag_val.jsonl from "
            "github.com/rowanz/hellaswag/tree/master/data and point "
            "--data-file at it."
        )
    with open(path) as f:
        for line in f:
            yield json.loads(line)


def pad_bucket(n: int, bucket: int = 32) -> int:
    return ((n + bucket - 1) // bucket) * bucket


def pack_batch(batch: list, example_batch: int, bucket: int = 32):
    """Rendered examples -> (tokens, mask), each (4 * example_batch, L)
    int32 with L the longest row padded to ``bucket``; rows past the
    batch's examples are zero."""
    L = pad_bucket(max(t.shape[1] for _, t, _, _ in batch), bucket)
    pt = np.zeros((4 * example_batch, L), np.int32)
    pm = np.zeros((4 * example_batch, L), np.int32)
    for i, (_, tokens, mask, _) in enumerate(batch):
        pt[4 * i:4 * i + 4, :tokens.shape[1]] = tokens
        pm[4 * i:4 * i + 4, :mask.shape[1]] = mask
    return pt, pm


@torch.inference_mode()
def score_rows(forward: Callable[[torch.Tensor], torch.Tensor], tokens: torch.Tensor,
               mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, L) int64 tokens and (R, L) mask -> per-row (summed, mean)
    masked CE of the shifted logits, fp32 (R,) each.  Rows are
    independent."""
    logits = forward(tokens)[:, :-1].float()  # (R, L - 1, V)
    target = tokens[:, 1:]
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, target[..., None])[..., 0]
    m = mask[:, 1:].to(torch.float32)
    sum_loss = (nll * m).sum(dim=1)
    avg_loss = sum_loss / m.sum(dim=1).clamp_min(1.0)
    return sum_loss, avg_loss


def evaluate_hellaswag(
    forward: Callable[[torch.Tensor], torch.Tensor],
    examples: Iterable[dict],
    encode: Callable[[str], list[int]],
    limit: int = 2000,
    log_path: str | None = None,
    verbose: bool = False,
    bucket: int = 32,
    example_batch: int = 8,
    device="cuda",
) -> dict:
    """Run the eval; ``forward`` maps (R, L) int64 tokens on ``device``
    to (R, L, V) logits, as ``lm_forward`` does.

    ``example_batch`` examples are packed into one call (R = 4 x
    example_batch rows); each row scores independently, so the numbers
    are the reference's one-example-at-a-time loop's.  Returns {"acc",
    "acc_norm", "num_total", ...} after ``limit`` examples."""
    num_total = num_correct = num_correct_norm = 0

    def score_batch(batch):
        nonlocal num_total, num_correct, num_correct_norm
        pt, pm = pack_batch(batch, example_batch, bucket)
        sum_loss, avg_loss = score_rows(
            forward, torch.from_numpy(pt).to(device, torch.int64),
            torch.from_numpy(pm).to(device))
        sum_loss = sum_loss.cpu().numpy().reshape(example_batch, 4)
        avg_loss = avg_loss.cpu().numpy().reshape(example_batch, 4)
        for i, (_, _, _, label) in enumerate(batch):
            num_total += 1
            num_correct += int(int(np.argmin(sum_loss[i])) == label)
            num_correct_norm += int(int(np.argmin(avg_loss[i])) == label)
            if verbose:
                print(f"{num_total} acc_norm: {num_correct_norm}/{num_total}"
                      f"={num_correct_norm / num_total:.4f}")

    pending = []
    taken = 0
    for example in examples:
        pending.append(render_example(example, encode))
        taken += 1
        if len(pending) == example_batch:
            score_batch(pending)
            pending = []
        if taken == limit:
            break
    if pending:
        score_batch(pending)

    result = {
        "num_total": num_total,
        "acc": num_correct / max(num_total, 1),
        "acc_norm": num_correct_norm / max(num_total, 1),
        "num_correct": num_correct,
        "num_correct_norm": num_correct_norm,
    }
    if log_path:
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
        with open(log_path, "a") as f:  # appended, as the reference does
            f.write(f"{num_total} {num_correct_norm}/{num_total} "
                    f"{num_correct_norm / max(num_total, 1):.4f}")
    return result
