"""Evaluation harnesses (HellaSwag); ``python -m
mamba_distributed_tpu_torch.eval`` is the evaluation CLI."""

from mamba_distributed_tpu_torch.eval.hellaswag import (
    evaluate_hellaswag,
    iterate_examples,
    render_example,
)

__all__ = ["evaluate_hellaswag", "iterate_examples", "render_example"]
