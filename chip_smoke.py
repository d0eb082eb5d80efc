"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py              # the whole run (one card)
    python3 chip_smoke.py --kernels-only

Phases, each of which fails the run (nonzero exit, no result line):

1. build every CUDA kernel of the port from the sources in the checkout
   (one nvcc per source, all started together), fail if a tensor-core
   instance (flash forward, dq, dk/dv; the paged prefill attend; the SSD
   forward; the SSD chunk states and the backward's two kernels), a
   split-decode instance, the Mamba-1 forward scan or the Mamba-1
   backward is missing or spills registers (``-Xptxas -v``) or a
   tensor-core SSD kernel has no HGMMA instruction in its SASS, hold the
   Python tables of built shapes (``ops/dispatch.check_kernel_shapes``)
   against each library's own answers, and the paged prefill's, the SSD
   forward's and the SSD backward's dispatch rules (the last also routes
   the chunk states), the decode's split rule and ``m1_scan``'s launch
   geometry against the libraries', with hybrid-280m's and mamba2-280m's
   shapes on the tensor cores;
2. hold each kernel against its plain PyTorch version on the card, in
   fp32 with TF32 off and in bf16, and time both at its main path's
   shapes, beside a bound from the bytes and operations the work needs
   and, for attention, a PyTorch SDPA call: ``ssd_fwd`` at mamba2-280m's
   (24 heads, headdim 64, d_state 128; also d_state 64, and headdim 32 on
   CUDA cores) over l 64, 100 and 256, g 1 and 2, seeded and not, t
   shorter than l, two launches bit-identical, timed at the serving chunk
   (b 1, t 256) and the trainer's micro-batch (b 32, t 1024);
   ``ssd_chunk_states`` and ``ssd_bwd`` (the SSD backward: bf16 at d_state
   128 and 64 with chunks of 64-256 on the tensor cores, fp32 and a
   ragged l 100 on CUDA cores, each case's route printed) over g 1 and 2,
   seeded and not, with and
   without a final-state cotangent, two launches bit-identical, then the
   whole ``SSDFunction``'s gradients against torch autograd of the plain
   forward, timed at a quarter of the trainer's micro-batch (b 8) and at
   one layer of the mamba2-280m train step (b 32, t 1024, chunk 256);
   ``rpa_fwd`` (the split-K paged decode) over split counts 1 to 40, GQA
   rep 3, 4 and 8 and head dims 32 to 128, two launches bit-identical, and
   ``rpp_fwd`` (fused page write + chunk prefill) at hybrid-280m's (12
   query / 4 KV heads, head dim 64, pages of 64 tokens, 16 pages per slot)
   over ragged length mixes, with the written pages compared bit for bit
   and two prefill launches bit-identical, each with bf16/fp32 pages and
   with int8 pages and
   scales (``rpa_fwd_int8``, ``rpp_fwd_int8``: the int8 branches, stale
   scales on recycled pages included); ``flash_fwd``, ``flash_bwd_dq``
   and ``flash_bwd_dkv`` (flash attention) over t 1024 and 1000, GQA rep
   1 and 3, offsets 0, positive and negative, head dims 32, 64 and 128,
   ragged edges of the tensor-core kernels' TMA boxes (tk 133, tq 1,
   tk_valid < tk), strided views and contiguous copies, two launches of
   each kernel bit for bit,
   then the whole ``FlashAttentionFunction``'s gradients against torch
   autograd of the plain blockwise attention, timed at one attention
   layer of the hybrid-280m train step (b 32, t 1024); ``m1_scan``,
   ``m1_entry_states`` and ``m1_bwd`` (the Mamba-1 selective scan, fp32
   only) over d 1536, 1000 and a ragged 70, t 1024, 1000, 256 and 37,
   seeded and not, with and without a final-state cotangent, two launches
   bit-identical, then the
   whole ``SelectiveScanFunction``'s gradients against torch autograd of
   the plain ``selective_scan_seq``, ``m1_scan`` timed at the serving
   chunk (b 1, t 256, device time) and all three at one layer of the
   mamba1-280m train step (b 32, t 1024); then rows 1-3 and 7-11 again
   at hybrid-7b's shapes (128 SSD heads of 64 at b 1, t 256 and b 4, t
   4096; the paged kernels at 32 query / 8 KV heads of 128; flash at b 4,
   t 4096), each against its plain version and timed beside its bound
   and, for attention, SDPA (``check_7b_shapes``); ``ssd_fwd``,
   ``m1_scan`` and ``rpp_fwd`` (bf16 and int8 pages) at the speculative
   verify's shape, 8 rows of K+1 = 4 tokens over a 17-page table
   (``check_verify_shapes``); and the two RMSNorm kernels of
   ``rms_norm.cu`` (no ``pallas_call`` counterpart) against their plain
   versions at 8 and 256 rows of 768 to 8192 channels (``check_norms``);
3. serve requests on a full-width mamba2-280m ``ServingEngine`` (64
   layers, bf16, ``ssm_impl="pallas"``, random weights from a seeded
   ``torch.Generator``): prompts of 12 and 100 tokens take the one-shot
   prefill, 300 and 700 the chunked prefill; then on a full-width
   hybrid-280m engine (64 layers, 8 of them attention over the paged
   KV cache), where every prompt takes the chunked prefill.  One greedy
   request's stream must equal the port's solo ``generate()``, and a
   hybrid engine must end with no KV page in use.  On the hybrid
   engine's weights the one-shot prefill (full-sequence attention
   through ``flash_fwd``) must agree with the chunked one, and a greedy
   ``generate(length_bucketing=False)`` runs through it; then on a
   full-width mamba1-280m engine (d_inner 1536, d_state 16), whose
   one-shot and chunked (seeded) prefills go through ``m1_scan``; and
   between them a second hybrid-280m engine with int8 weights and int8
   KV pages, whose paged attention runs the int8 branches (its greedy
   stream equal to ``generate()``'s, no page leaked), printed beside
   the bf16 hybrid run: resident weight and KV bytes, greedy agreement
   (not gated), tokens/s, TTFT, chunk step and decode tick; then
   hybrid-7b at full width and depth (32 layers, a gated MLP of 14336
   after every mixer, 4 attention layers of 32/8 heads of 128), in bf16
   and in int8 weights and KV pages, from one set of fp32 masters that is
   quantized and cast once and freed: the same requests, greedy stream
   equal to ``generate()``, no page leaked, the bf16 one-shot prefill
   against the chunked one, and peak memory printed beside the rest;
3b. the engine's admission and occupancy features (``engine_features_
   phase``, on the decode weights of the 280m runs above, bf16 unless
   named, "pallas"; on the first 16 of the 64 layers, the cut that keeps
   the script under its limit): (a) the
   prefix-state cache on
   mamba2-280m, hybrid-280m and int8 hybrid-280m, capacity 8: a
   600-token preamble under four 100-token and two 356-token suffixes
   and two repeats of the first prompt, on an engine warmed by that
   prompt against a cache-off one: every stream bit for bit, 3 full
   and 5 partial hits, fewer ``ssd_fwd`` and ``rpp_fwd`` launches warm,
   on the hybrids at least one copy-on-write page copy, no page with
   more than one holder written while shared, and the pages in use at
   the end the cache's pins (0 after ``clear()``), TTFT p50 warm and
   cold printed; (b) hybrid-280m at capacity 4: two priority-1 requests
   arriving while four priority-0 ones decode preempt, reach their
   first tokens before any priority-0 request finishes, every stream
   equal to a uniform-priority engine's, no page leaked, swap-out and
   swap-in ms printed; mamba2-280m's serving mix under
   ``prefill_schedule`` "rr" and "srpt", streams equal, TTFT p50 side by
   side; (c) compacted ticks on the three presets at capacity 8 over the
   serving mix with budgets 64, 8, 16, 8, 32, 8, 16, 8 (greedy), on
   against off: every stream equal, the hybrids must launch ``rpa_fwd``
   at widths below 8; bucket histogram, lanes saved and device ms a tick
   by width beside the full tick at the same live counts printed, with
   which widths of hybrid-280m's decode GEMMs and row-wise ops give other
   bits than the 8-row call (none allowed for the two norm kernels) and
   ``rpa_fwd``'s device ms with its split rule pinned to the capacity
   against its own; before them, hybrid-280m's decode sub-step with the
   norm kernels and with the plain norms (kernels run, device and event
   ms: ``norm_tick``);
3c. speculative decoding (``spec_phase``, the same weights, K = 3,
   capacity 8, greedy) on mamba2-280m, hybrid-280m, int8 hybrid-280m and
   mamba1-280m over the serving mix (32 new tokens) and a repetitive mix
   (8 prompts of a 32-token pattern tiled to 256, 64 new tokens), on the
   first 16 layers (full width) of each, whose verify checks run at 64
   layers: the
   compacted spec engine's streams equal the spec engine's, a spec stream
   parts from the non-spec engine's only at a step whose full-width
   top-two margin is within the bf16 tolerance, the verify launches
   ``ssd_fwd``/``m1_scan``/``rpp_fwd`` and no ``rpa_fwd``; printed: the
   acceptance rate, committed tokens a verify launch, launches a
   committed token, tick ms a committed token and tokens/s against the
   non-spec engine, ``summary()["speculation"]``, and the device ms of
   one verify launch against K+1 decode sub-steps; then a ``ModelDrafter``
   (a seeded 4-layer mamba2 companion) on mamba2-280m's repetitive mix;
3d. multi-tenant LoRA serving (``lora_phase``, the same weights, capacity
   8, greedy): four seeded random adapters (rank 8, alpha 16, every
   target) and the base model spread over the serving mix, on full-width
   mamba2-280m and hybrid-280m cut to 16 layers: every stream against a solo
   greedy run on its adapter's merged weights, parting only at a step
   whose top-two margin is within the bf16 tolerance of that step's
   largest |logit|; the no-adapter streams bit-identical to a LoRA-less
   engine's; on mamba2-280m the mixed engine's streams equal to
   sequential per-tenant engines'; the hand kernels launched, every
   adapter ref and KV page returned; at layer 0 of every target the LoRA
   ``linear`` gives the same rows at 1, 2 and 4 rows as at 8, and the
   bf16-output GEMM equals the rounded fp32-output one; printed: tokens/s,
   TTFT p50 and decode tick ms on against off, mixed against sequential
   tokens/s, a decode sub-step's CUDA kernels, device and event ms on
   against off, factor bytes an adapter and upload ms a miss.  Then on
   the first 16 layers (full width): compacted LoRA ticks equal to full
   ones, K = 3 compacted spec streams equal to spec ones, fp32
   mamba2-280m streams equal to the merged references and fp32 spec equal
   to non-spec, a hot swap to ``tenant-0@v2`` after the first tick that
   loses no token, a hybrid cache of 2 rows over 4 adapters that waits,
   evicts and streams as an 8-row one, mamba1-280m (``x_proj`` a target,
   ``m1_scan`` launched) against its merged references; and int8
   hybrid-280m with LoRA refusing to build;
4. eval and import (after serving, about a minute and a half): the
   HellaSwag scorer (``evaluate_hellaswag``) over
   ``tests/data/hellaswag_tiny.jsonl`` (16 examples, ``example_batch`` 8,
   so 32 rows) with a word-level tokenizer of 1, 6 and 18 ids a word
   (rows padded to 32, 96 and 288 tokens: SSD chunks of 32, 96 and 144)
   on full-width mamba2-280m, hybrid-280m and mamba1-280m cut to 16
   layers (bf16, seeded weights), once with "pallas"/"auto" and once with "xla":
   the logits (RMS error over RMS) and the per-row summed and mean losses
   agree at the bf16 tolerance, the pallas
   runs launch ``ssd_fwd``, ``flash_fwd`` and ``m1_scan`` (the xla runs
   none), and the three kernels are held against their plain versions at
   those lengths (b 32); seeded mamba2-280m and hybrid-280m params
   written as a ``MambaLMHeadModel``-named config.json +
   pytorch_model.bin (``hf_state_dict``) and read back by
   ``models/hf.load_hf_checkpoint``, every tensor and the logits
   bit-identical; the eval CLI (``-m hugging_face``, a toy GPT-2 BPE on
   the native merge loop) and the generation CLI as subprocesses, equal
   to in-process runs that launch ``ssd_fwd`` and ``flash_fwd`` (eval) and
   ``ssd_fwd``, ``rpp_fwd`` and ``rpa_fwd`` (generation: the hybrid's
   chunked prefill and paged decode); ``mamba2-mini`` trained 251 steps on the JAX
   package's synthetic shards through the native shard reader, held to
   ``log_parity_cpu/log.txt`` by the fingerprint and the 30-step strict
   comparisons (the 251-step strict one printed), and the eval CLI with
   ``-m custom`` on its checkpoint;
5. train a full-width, full-depth mamba2-280m, hybrid-280m, then
   mamba1-280m (bf16, pallas, remat) through the port's ``Trainer`` for
   3 optimizer steps at seq 1024 on synthetic shards (micro-batch 32, or
   16 if 32 does not fit), with validation; every loss and grad norm
   must be finite.  At 4 layers of the same width (attention at layers 1
   and 3 for the hybrid), for each of the three, one train step's loss
   and gradients with "pallas" must match "xla" (fp32 and bf16), and ten
   steps on one repeated batch must lower the loss.  Then hybrid-7b at
   full width cut to 8 layers (attention at layer 3), seq 4096,
   micro-batch 4 (2 if 4 does not fit), 3 steps with the dense loss and
   3 with the blocked one (step ms, MFU with the MLP FLOPs, peak memory),
   and the peak of one ``loss_and_grads`` without the optimizer with
   each loss (``loss_peaks``); mamba2-280m's 3-step run again with the
   blocked loss and under the "dots" and "mixer" remat policies; one step of each 280m preset at full depth under "all",
   "dots", "mixer" and "all" again, whose gradients must equal the first
   "all"'s bit for bit (or be no further off than the second "all" is)
   and whose mixer-core forward launches must be one per mixer layer
   under "mixer" and two otherwise (``remat_checks``); and the pallas
   against xla checks and the falling loss on a 4-layer hybrid-tiny with
   a MoE (4 experts, top-2, d_intermediate 256), an untied head,
   ``conv_impl="xla_conv"`` and ``loss_impl="blocked"``;
6. telemetry and recovery (``telemetry_phase``): mamba2-280m at full
   width and depth (seq 1024, micro-batch 32) for 3 steps with spans,
   the sentinel and the overflow flag on, between two runs with them
   off: the losses and grad norms bit for bit, the kernel launches and
   the synchronizing calls (``torch.cuda.set_sync_debug_mode("warn")``)
   equal, each span's median printed beside the step time; a NaN weight
   must raise ``DivergenceError`` at step 0 with a flight record, and
   ``train.main`` with ``--auto-restart 1`` over it must not restart;
   ``train.main`` on mamba2-280m cut to 8 layers with ``--checkpoint-
   every 2 --auto-restart 1`` and one step raising at step 3 must print
   "restart 1/1" and "resumed from step 2", match an uninterrupted run's
   step-4 loss bit for bit, and hold device memory before the rebuild and
   after the teardown within 64 MiB of before the first build; the
   serving runs of phase 3 again on mamba2-280m and bf16 and int8
   hybrid-280m with a ``ServingMetrics`` jsonl stream, a ``SpanTracer``
   and an ``SLOMonitor``: streams equal to the untraced runs', tick
   records' tokens summing to the events, request records carrying their
   trace ids, no page leaked, the int8 stamp equal to
   ``ops/quant.param_bytes`` and the pool's bytes, every ``serving_tick``
   slice of the Chrome trace inside the run's wall-clock window; the
   summary's latency percentiles, goodput and ``serving_mfu``, and the
   report's numbers (``obs/report.py``) printed;
7. data parallel (``parallel_phase``): mamba2-280m at full width cut to
   16 layers (bf16, pallas, remat, seq 1024, micro-batch 32 or 16 if 32 does
   not fit, accum 2) through the port's ``Trainer`` for 3 steps, (a) with
   no process group and (b) as rank 0 of a world of one on NCCL
   (``parallel/mesh.init_distributed`` on a free local TCP port, mesh
   ``data=1``: the trainer's distributed path with its bucketed mean
   all-reduce); (b)'s losses and pre-clip grad norms must equal (a)'s
   bit for bit, ``ssd_fwd``, ``ssd_chunk_states`` and ``ssd_bwd`` launch
   in (b) as in (a), and an NCCL kernel must show in ``torch.profiler``'s
   trace of one more step of (b); the step ms of both, NCCL's device ms
   and launches a step, the bytes and buckets all-reduced a step and each
   run's peak memory are printed;
8. tensor parallel (``tensor_phase``): hybrid-280m at full width through
   the port's Trainer, (a) one process, bf16, cut to 16 layers,
   micro-batch 8, seq 1024, 3 steps, and (b) the same at mesh ``tensor=2`` in two
   processes sharing the one card over an explicitly requested gloo
   group (``--tensor-worker``; the kernels built by this process first);
   (c, d) as (a, b) in fp32 at 8 layers, 2 steps.  (d)'s losses and grad
   norms must be (c)'s within rtol 2e-4, (b)'s losses (a)'s within rtol
   1e-3 and its grad norms within 2e-3, and every rank must launch the
   SSD and flash kernels as often as the one-process run; the step ms,
   the tensor-group all-reduces of one profiled step of (b) (their share
   of the step from ``record_function`` spans in the ``torch.profiler``
   trace, and from a replay of them alone) and each rank's peak memory
   are printed.  The
   kernel phase holds the SSD and flash kernels at hybrid-7b's per-rank
   head counts at tensor 2, 4 and 8, and the scan kernels at
   mamba1-280m's d_inner at tensor 2 (``check_tp_shapes``);
9. expert parallel (``expert_phase``): hybrid-280m's widths made MoE (8
   experts, top 2, d_intermediate 2048, capacity factor 1.25) cut to 16
   layers through the port's Trainer, (a) one process, bf16, micro 8,
   seq 1024, 3 steps, and (b) the same at mesh ``expert=2`` in two
   processes sharing the card over gloo (``--expert-worker``), micro 4
   each; (c, d) as (a, b) in fp32 at 4 layers, 2 steps.  (d)'s losses
   and grad norms must be (c)'s within rtol 2e-4, (b)'s losses (a)'s
   within 1e-3 and its grad norms within 2e-3, (d)'s keep masks of the
   first MoE layer's first micro-batch (both ranks together) (c)'s but
   at near ties, and every rank must launch the SSD and flash kernels
   as often as the one-process run; the step ms, the all-to-alls of one
   profiled step of (b) (count, bytes, their share of the step from the
   trace's spans), the dropped choices and each rank's peak memory are
   printed;
10. sequence parallel (``seq_phase``): through the port's Trainer, bf16,
   pallas, micro 1, 2 steps, remat, (a) one process and (b) mesh
   ``seq=2`` in two processes sharing the card over gloo
   (``--seq-worker``), on mamba2-2.8b-sp32's widths cut to 4 layers at
   seq 8192 (the SSD state exchange), hybrid-7b's widths cut to 4 layers
   (attention at 3) at seq 8192 with ring attention and then Ulysses, and
   mamba1-280m cut to 8 layers at seq 8192 (the two-pass scan); (c, d) as
   (a, b) in fp32 at 2 layers, seq 2048, on the hybrid with ring and on
   Mamba-1.  (b)'s losses must be (a)'s within rtol 1e-3 and its grad
   norms within 2e-3, (d)'s (c)'s within 1e-5; every rank must launch
   ``ssd_fwd`` as often as one process, ``m1_scan`` twice as often, the
   flash kernels r + 1 times as often on seq rank r under ring (the hops
   not skipped) and as often under Ulysses; the step ms, the seq-group
   exchanges of one profiled step (``SP_COMM``: count, bytes, their share
   of the step from the trace's spans), device busy and each rank's peak
   memory are printed.  The kernel phase holds the flash kernels at the
   ring's fully-past hop (``tq == tk``, offset ``tk``: no masked pair) at
   t 4096;
11. composed meshes and the pipeline (``compose_phase``): through the
   port's Trainer, bf16, pallas, remat, 2 steps each, (a) one process and
   (b) one world of four processes sharing the card over gloo
   (``--compose-worker``) that runs three meshes in turn: (i) ``seq=2 x
   tensor=2`` on hybrid-7b's widths cut to 2 layers (Mamba-2, then
   attention at 1, ring), micro 1, seq 8192; (ii) ``seq=2 x expert=2`` on
   the expert phase's MoE cut to 4 layers (attention at 3), micro 1,
   seq 8192; (iii) ``pipe=2 x data=2`` on hybrid-280m cut to 16 layers (2
   supersteps, one a stage), micro 4, accum 4 (the pipeline's
   microbatches), seq 1024; then (d) (i) in fp32 at seq 2048 against its
   one-process (c).  (b)'s losses must be (a)'s within rtol 1e-3 and its
   grad norms within 2e-3, (d)'s (c)'s within 1e-5; every rank must
   launch the SSD kernels as often as (a) (half as often a stage under
   pipe), the flash kernels r + 1 times as often on seq rank r (the
   ring's hops), half as often a stage under pipe; the seq, tensor,
   expert and pipe exchanges of one more measured step (count, bytes),
   its ms, and each rank's peak memory are printed;
12. serving meshes (``serving_mesh_phase``, between phase 3's hybrid-7b
   runs and phase 4): one world of four processes sharing the card over
   gloo (``--mesh-worker``) serves the mix of phase 3 (capacity 8, 32 new
   tokens, bf16, pallas, seeded weights, each rank building its shard:
   hybrid-7b's ranks one at a time) at full width on (i) ``data=2 x
   model=2`` on hybrid-280m cut to 16 layers with compacted ticks, (ii)
   ``model=4`` on hybrid-7b cut to 8 layers, (iii) ``stage=2 x model=2``
   on hybrid-280m cut to 16 layers, (iv) ``stage=4`` on mamba2-280m cut
   to 16 layers with compacted ticks (the microbatched decode clock), and
   in fp32 ``data=2 x model=2`` on (f) mamba1-280m and (g) hybrid-280m
   cut to 4 layers, each against one process's engine on the same
   weights; every rank's streams of the sampled 700-token requests (one
   on each data shard) must equal its ``generate(mesh=)`` streams bit for
   bit; the greedy request's logits at each of its 32 steps, one
   process's greedy stream fed to both, must be one process's within
   5e-2 (fp32: 1e-5) of the step's largest |logit|, and (i) with its
   embedding's model sum taken out must part beyond that; the greedy
   stream must be one process's or part only at a near tie; no page may
   stay in use, every rank launch ``ssd_fwd``, ``m1_scan``, ``rpa_fwd``
   and ``rpp_fwd`` as one process does (a stage its share, the prefills
   summed over the data ranks), a rank of (ii) hold under 0.3 of one
   process's weight bytes, and (iv) run the clock and bill its bubbles;
   printed: the logits gaps, launches, one decode tick's ``SERVE_COMM``,
   tick ms, TTFT, tokens/s, weight bytes, peaks and the bubble lanes.
   The kernel phase holds
   ``ssd_fwd``, ``rpa_fwd`` and ``rpp_fwd`` at those per-rank heads
   (``check_serving_shapes``) and the model-split gated norm's sum of
   squares (``check_norms``);
13. print the serving and training numbers beside the card's name and
   power limit, one ``{"kernels": [...]}`` line, and last ``{"ok": true,
   "device": ...}``.

Before each serving, eval and training run the kernels' launch counts
are zeroed, and after it every kernel of that path must have launched.

It imports nothing of JAX or of the JAX package, and exits nonzero when
no card is visible or the port's package is not beside it.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from mamba_distributed_tpu_torch.ops.cuda.timing import (
    RPA_TIMED,
    RPP_TIMED,
    SSD_TIMED,
    TPU_M1_T_TILE,
    bound,
    cuda_ms,
    device_ms,
    m1_bound,
    m1_inputs,
    m1_work,
    rel_err,
    rpa_case,
    rpa_work,
    rpp_case,
    rpp_work,
    ssd_bwd_work,
    ssd_inputs,
    ssd_work,
)

# kernel-vs-plain tolerances, as max|kernel - plain| / max|plain|:
# fp32 differs only by summation order; bf16 also by where each side
# rounds (the kernel at the TPU kernel's cast points, the plain version
# at ops/ssd.py's), a few bf16 ulps (2^-8 relative each)
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# a 4-layer train step, pallas against xla: in bf16 the two formulations
# round at different points and the differences compound through four
# layers and the backward (about 1e-2 on every gradient leaf in a CPU
# rehearsal at width 128-256), so bf16 gets a wider bound; fp32 keeps 1e-4
TRAIN_TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-2}


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------- a checkpoint in the reference's names


def hf_state_dict(params: dict, cfg) -> dict:
    """The port's param tree -> a ``MambaLMHeadModel``-named state dict
    (torch Linear (out, in), Conv1d (ch, 1, width), one key per layer),
    the inverse of ``models/hf.import_state_dict``; the tests import it
    from here."""
    def linear(pre: str, leaf: dict, i: int) -> dict:
        out = {pre + ".weight": leaf["kernel"][i].t().contiguous()}
        if "bias" in leaf:
            out[pre + ".bias"] = leaf["bias"][i].clone()
        return out

    sd = {"backbone.embedding.weight": params["embedding"].clone(),
          "backbone.norm_f.weight": params["norm_f"]["weight"].clone()}
    counters = {False: 0, True: 0}
    for layer in range(cfg.n_layer):
        attn = layer in cfg.attn_layer_idx
        i = counters[attn]
        counters[attn] += 1
        bp = params["attn_blocks" if attn else "blocks"]
        m, pre = bp["mixer"], f"backbone.layers.{layer}."
        sd[pre + "norm.weight"] = bp["norm"]["weight"][i].clone()
        if attn:
            sd.update(linear(pre + "mixer.Wqkv", m["wqkv"], i))
        else:
            sd.update(linear(pre + "mixer.in_proj", m["in_proj"], i))
            sd[pre + "mixer.conv1d.weight"] = m["conv"]["kernel"][i][:, None, :].clone()
            if "bias" in m["conv"]:
                sd[pre + "mixer.conv1d.bias"] = m["conv"]["bias"][i].clone()
            for k in ("A_log", "D", "dt_bias"):
                if k in m:
                    sd[pre + "mixer." + k] = m[k][i].clone()
            if "norm" in m:
                sd[pre + "mixer.norm.weight"] = m["norm"]["weight"][i].clone()
            if "x_proj" in m:
                sd.update(linear(pre + "mixer.x_proj", m["x_proj"], i))
                sd.update(linear(pre + "mixer.dt_proj", m["dt_proj"], i))
        sd.update(linear(pre + "mixer.out_proj", m["out_proj"], i))
        if "mlp" in bp:
            sd[pre + "norm2.weight"] = bp["norm2"]["weight"][i].clone()
            sd.update(linear(pre + "mlp.fc1", bp["mlp"]["fc1"], i))
            sd.update(linear(pre + "mlp.fc2", bp["mlp"]["fc2"], i))
    sd["lm_head.weight"] = (sd["backbone.embedding.weight"] if cfg.tie_embeddings
                            else params["lm_head"]["kernel"].t().contiguous())
    return sd


def hf_config_json(cfg) -> dict:
    """The mamba_ssm ``config.json`` of ``cfg`` (what
    ``models/hf.config_from_hf_json`` reads back into the same model)."""
    out = {"d_model": cfg.d_model, "n_layer": cfg.n_layer, "vocab_size": cfg.vocab_size,
           "d_intermediate": cfg.d_intermediate,
           "ssm_cfg": {"layer": "Mamba2" if cfg.ssm_layer == "mamba2" else "Mamba1",
                       "d_state": cfg.effective_d_state, "d_conv": cfg.d_conv,
                       "expand": cfg.expand},
           "rms_norm": True, "residual_in_fp32": cfg.residual_in_fp32,
           "tie_embeddings": cfg.tie_embeddings,
           "pad_vocab_size_multiple": cfg.pad_vocab_size_multiple}
    if cfg.ssm_layer == "mamba2":
        out["ssm_cfg"].update(headdim=cfg.headdim, ngroups=cfg.ngroups,
                              chunk_size=cfg.chunk_size)
    if cfg.attn_layer_idx:
        hd = cfg.effective_attn_head_dim
        out["attn_layer_idx"] = list(cfg.attn_layer_idx)
        out["attn_cfg"] = {"num_heads": cfg.effective_attn_num_heads,
                           "num_heads_kv": cfg.effective_attn_num_kv_heads,
                           "head_dim": hd,
                           "rotary_emb_dim": hd if cfg.attn_rotary_dim < 0
                           else cfg.attn_rotary_dim}
    return out


# ----------------------------------------------------------------- SSD kernel


def check_ssd(gen):
    """Kernel 1 against the plain ``ssd_chunked`` (y and the final state),
    bf16 (the tensor-core kernel at the presets' headdim 64 and d_state
    128 or 64, the CUDA-core one at headdim 32) and fp32 (CUDA cores), over
    l 64 and 256, g 1 and 2, seeded and not, a t shorter than l, a ragged l
    (t 300, l 100); two launches of each case bit-identical.  Timed at the
    serving chunk (b 1, t 256, seeded) and at the trainer's micro-batch (b
    32, t 1024, unseeded), each beside its bound from ``ssd_work``."""
    from mamba_distributed_tpu_torch.ops.cuda import ssd_kernels
    from mamba_distributed_tpu_torch.ops.ssd import _divisor_chunk, ssd_chunked

    cases = [  # (dtype, b, t, chunk, g, seeded, p, n)
        (torch.float32, 1, 8, 256, 1, False, 64, 128),
        (torch.float32, 2, 128, 64, 2, True, 64, 128),
        (torch.float32, 1, 512, 256, 1, True, 64, 128),
        (torch.bfloat16, 1, 8, 256, 1, False, 64, 128),  # t shorter than l
        (torch.bfloat16, 2, 128, 64, 2, True, 64, 128),
        (torch.bfloat16, 2, 512, 64, 1, False, 64, 128),
        (torch.bfloat16, 1, 512, 256, 2, True, 64, 128),
        (torch.bfloat16, 2, 768, 256, 1, False, 64, 128),
        (torch.bfloat16, 1, 300, 128, 1, True, 64, 128),  # l = 100: a ragged row block
        (torch.bfloat16, 2, 512, 256, 2, True, 64, 64),
        (torch.bfloat16, 1, 200, 64, 1, False, 64, 64),  # l = 50
        (torch.bfloat16, 1, 256, 256, 1, True, 32, 64),  # CUDA cores in bf16
        # the chunked-prefill step of the serving path, then the trainer's
        # micro-batch (both timed below)
        (torch.bfloat16, 1, 256, 256, 1, True, 64, 128),
        (torch.bfloat16, 32, 1024, 256, 1, False, 64, 128),
    ]
    row, at = None, []
    for dtype, b, t, chunk, g, seeded, p, n in cases:
        inp = ssd_inputs(gen, b, t, g, dtype, seeded, p=p, n=n)
        kw = dict(chunk_size=chunk, return_final_state=True, compute_dtype=dtype)
        yk, sk = ssd_kernels.ssd_chunked_kernel(**inp, **kw)
        yk2, sk2 = ssd_kernels.ssd_chunked_kernel(**inp, **kw)
        yp, sp = ssd_chunked(**inp, **kw)
        torch.cuda.synchronize()
        same = bool(torch.equal(yk, yk2) and torch.equal(sk, sk2))
        errs = []
        for got, ref in ((yk, yp), (sk, sp)):
            if not torch.isfinite(got).all():
                raise SystemExit(f"ssd_fwd: non-finite output ({dtype}, t={t})")
            errs.append(rel_err(got, ref))
        worst = max(r for _, r in errs)
        l = _divisor_chunk(t, chunk)
        route = ("tensor cores" if ssd_kernels.ssd_uses_tensor_cores(dtype, p, n)
                 else "CUDA cores")
        tag = f"{str(dtype)[6:]} b={b} t={t} l={l} g={g} p={p} n={n} seeded={seeded}"
        print(f"check ssd_fwd {tag} ({route}): y max_abs_err={errs[0][0]:.3e} (rel "
              f"{errs[0][1]:.2e}), state max_abs_err={errs[1][0]:.3e} (rel {errs[1][1]:.2e}), "
              f"tol rel {TOL[dtype]:.0e}; 2 launches bit-identical: {same}", flush=True)
        if worst > TOL[dtype] or not same:
            raise SystemExit(f"ssd_fwd disagrees with the plain version (rel {worst:.3e}) or "
                             f"differs between launches ({same}): {tag}")
        timed = (b, t, chunk, g, seeded) in SSD_TIMED
        if dtype is torch.bfloat16 and p == 64 and n == 128 and timed:
            # the kernel's device time (one kernel a call: a loop of calls
            # at the serving chunk is host-bound), the event time beside it
            args = (inp["x"], inp["dt"], inp["A"], inp["B"], inp["C"], l,
                    inp["initial_state"], dtype)
            ms = sum(device_ms(lambda: ssd_kernels._ssd_fwd(*args), 20).values())
            loop_ms = cuda_ms(lambda: ssd_kernels._ssd_fwd(*args), 20)
            plain_ms = cuda_ms(lambda: ssd_chunked(**inp, **kw), 5, 1)
            nbytes, flops = ssd_work(b, t, 24, g, p, n, l, dtype, seeded)
            bound_ms, bound_by = bound(nbytes, flops)
            ctas = -(-l // 64) * 24 * b
            shape = f"bf16 b={b} t={t} l={l} h=24 {'seeded' if seeded else 'unseeded'}"
            print(f"time ssd_fwd {shape} ({ctas} CTAs): kernel {ms:.4f} ms of device time "
                  f"({loop_ms:.4f} ms a call by the event timer), plain {plain_ms:.4f} ms, "
                  f"bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, {flops} FLOP), "
                  f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
            at.append(dict(shape=shape, ctas=ctas, ms=ms, event_ms=loop_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by, max_abs_err=errs[0][0]))
    # the row: the serving chunk, whose launches it counts (the mamba2
    # serving run); the trainer's shape beside it
    serve = at[0]
    row = dict(name="ssd_fwd", route="cuda",
               source="mamba_distributed_tpu_torch/ops/cuda/csrc/ssd_fwd.cu",
               replaces="mamba_distributed_tpu/ops/pallas/ssd_kernels.py:164",
               launches=None, max_abs_err=serve["max_abs_err"], ms=serve["ms"],
               plain_ms=serve["plain_ms"], bound_ms=serve["bound_ms"],
               bound_by=serve["bound_by"], library_ms=None, shapes=at)
    return row


def check_ssd_bwd(gen):
    """Kernels 2 and 3 against their plain versions (same inputs, the
    plain entering states fed to both), two launches of each bit-identical,
    then the whole SSDFunction's gradients against torch autograd of the
    plain ``ssd_chunked``.  Both routes of kernel 3's dispatch rule: bf16
    at (headdim, d_state) (64, 128) and (64, 64) with chunks of 64, 128
    and 256 on the tensor cores; fp32, and the ragged l 100, on the
    CUDA-core kernel (the chunk states take the same route).  The last
    two cases, a quarter of the trainer's micro-batch (b 8) and one layer
    of the mamba2-280m train step (b 32, the shape of the training run's
    launches and of the row), are timed, the chunk states by device time."""
    from mamba_distributed_tpu_torch.ops.cuda import ssd_kernels as sk
    from mamba_distributed_tpu_torch.ops.ssd import (
        _divisor_chunk,
        chunk_log_decay,
        ssd_chunked,
        state_passing,
    )

    cases = [  # (dtype, b, t, chunk, g, seeded, dfinal, d_state)
        (torch.float32, 1, 64, 64, 1, False, False, 128),
        (torch.float32, 2, 512, 256, 2, True, True, 128),
        (torch.float32, 1, 300, 128, 2, False, True, 128),  # l = 100: ragged row blocks
        (torch.bfloat16, 1, 64, 64, 1, False, False, 128),  # one row block
        (torch.bfloat16, 2, 512, 256, 2, True, True, 128),
        (torch.bfloat16, 1, 300, 128, 1, True, False, 128),  # l = 100: CUDA cores in bf16
        (torch.bfloat16, 2, 512, 128, 1, True, True, 64),
        (torch.bfloat16, 1, 256, 256, 2, False, True, 64),
        (torch.bfloat16, 8, 1024, 256, 1, False, False, 128),  # a quarter micro-batch (timed)
        (torch.bfloat16, 32, 1024, 256, 1, False, False, 128),  # one train-step layer (timed)
    ]
    names = ("dx", "ddt_direct", "da", "dB_h", "dC_h", "dgamma", "dinit")
    rows, failures, shapes = [None, None], [], {"ssd_chunk_states": [], "ssd_bwd": []}
    for dtype, b, t, chunk, g, seeded, dfin, n in cases:
        inp = ssd_inputs(gen, b, t, g, dtype, seeded, n=n)
        x, dt, A, B, C, s0 = (inp[k] for k in ("x", "dt", "A", "B", "C", "initial_state"))
        h, p = x.shape[2], x.shape[3]
        l = _divisor_chunk(t, chunk)
        a4 = chunk_log_decay(dt, A, l)
        a_cum = a4.reshape(b, t, h).contiguous()
        st_k = sk.ssd_chunk_states_kernel(x, dt, a_cum, B, l, dtype)
        st_k2 = sk.ssd_chunk_states_kernel(x, dt, a_cum, B, l, dtype)
        st_p = sk.ssd_chunk_states_plain(x, dt, a_cum, B, l, dtype)
        prev, _ = state_passing(st_p, torch.exp(a4[:, :, -1]), s0)
        prev = prev.contiguous()
        dy = torch.randn((b, t, h, p), generator=gen, device="cuda").to(dtype)
        dfinal = torch.randn((b, h, p, n), generator=gen, device="cuda") if dfin else None
        args = (x, dt, a_cum, B, C, prev, dy, dfinal, l, dtype)
        got = sk.ssd_bwd_kernel(*args)
        got2 = sk.ssd_bwd_kernel(*args)
        ref = sk.ssd_bwd_plain(*args)
        torch.cuda.synchronize()
        same = bool(torch.equal(st_k, st_k2)) and all(
            torch.equal(u, v) for u, v in zip(got, got2, strict=True))
        # one rule routes the chunk states and the backward alike
        route = ("tensor cores" if sk.ssd_bwd_uses_tensor_cores(dtype, p, n, l)
                 else "CUDA cores")
        tag = f"{str(dtype)[6:]} b={b} t={t} l={l} g={g} n={n} seeded={seeded} dfinal={dfin}"
        err2, rel2 = rel_err(st_k, st_p)
        errs = {nm: rel_err(a, r) for nm, a, r in zip(names, got, ref)}
        worst = max([rel2] + [r for _, r in errs.values()])
        finite = all(bool(torch.isfinite(v).all()) for v in (st_k, *got))
        print(f"check ssd_chunk_states {tag} ({route}): max_abs_err={err2:.3e} (rel "
              f"{rel2:.2e}); ssd_bwd ({route}) rel "
              + " ".join(f"{k} {r:.2e}" for k, (_, r) in errs.items())
              + f"; tol rel {TOL[dtype]:.0e}; 2 launches bit-identical: {same}", flush=True)
        if not finite or worst > TOL[dtype] or not same:
            failures.append(f"ssd_chunk_states/ssd_bwd {tag}: finite={finite}, rel {worst:.3e}, "
                            f"2 launches bit-identical {same}")

        if b * t <= 1024:  # the whole Function against autograd of the plain forward
            failures += function_grads(sk, ssd_chunked, inp, dy, dfinal, chunk, dtype, tag)
        if b in (8, 32):
            # the chunk states by device time (a loop of calls at b 8 is
            # host-bound), the event time beside it
            states = lambda: sk.ssd_chunk_states_kernel(x, dt, a_cum, B, l, dtype)  # noqa: E731
            ms2 = sum(device_ms(states, 20).values())
            event2 = cuda_ms(states, 20)
            plain2 = cuda_ms(lambda: sk.ssd_chunk_states_plain(x, dt, a_cum, B, l, dtype), 5)
            ms3 = cuda_ms(lambda: sk.ssd_bwd_kernel(*args), 20)
            plain3 = cuda_ms(lambda: sk.ssd_bwd_plain(*args), 3, 1)
            (b2, f2), (b3, f3) = ssd_bwd_work(b, t, h, g, p, n, l, dtype, seeded, dfin)
            what = ("one layer of the mamba2-280m train step" if b == 32 else
                    "a quarter of the trainer's micro-batch of 32")
            for i, (nm, ms, plain, nb, fl, err, line) in enumerate((
                    ("ssd_chunk_states", ms2, plain2, b2, f2, err2, 61),
                    ("ssd_bwd", ms3, plain3, b3, f3, max(e for e, _ in errs.values()), 299))):
                bound_ms, bound_by = bound(nb, fl)
                shape = f"bf16 b={b} t={t} l={l} h={h}"
                device = (f" of device time ({event2:.4f} ms a call by the event timer)"
                          if i == 0 else "")
                print(f"time {nm} {shape} ({what}, {route}): kernel {ms:.4f} ms{device}, plain "
                      f"{plain:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}: {nb} B, {fl} FLOP), "
                      f"{fl / ms / 1e9:.1f} TFLOP/s", flush=True)
                shapes[nm].append(dict(shape=shape, ms=ms, plain_ms=plain, bound_ms=bound_ms,
                                       bound_by=bound_by, max_abs_err=err))
                if i == 0:
                    shapes[nm][-1]["event_ms"] = event2
                if b == 32:  # the row: the shape the training run launches at
                    rows[i] = dict(
                        name=nm, route="cuda",
                        source="mamba_distributed_tpu_torch/ops/cuda/csrc/ssd_bwd.cu",
                        replaces=f"mamba_distributed_tpu/ops/pallas/ssd_kernels.py:{line}",
                        launches=None, max_abs_err=err, ms=ms, plain_ms=plain,
                        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                        shapes=shapes[nm])
        del inp, x, dt, A, B, C, s0, prev, dy, dfinal, args, got, got2, ref
    torch.cuda.empty_cache()
    if failures:
        raise SystemExit("SSD backward checks failed:\n" + "\n".join(failures))
    return rows


def function_grads(sk, ssd_chunked, inp, dy, dfinal, chunk, dtype, tag):
    """Gradients of x, dt, A, B, C (and the initial state) through
    ``ssd_chunked_kernel`` (SSDFunction: kernels 1-3) and through torch
    autograd of the plain ``ssd_chunked``, same inputs, same cotangents.
    x, B and C are slices of one leaf, as in the mixer."""
    grads = []
    for fn in (sk.ssd_chunked_kernel, ssd_chunked):
        x, B, C = inp["x"], inp["B"], inp["C"]
        xbc = torch.cat([x.flatten(2), B.flatten(2), C.flatten(2)], -1).detach().requires_grad_()
        b, t, h, p = x.shape
        g, n = B.shape[2], B.shape[3]
        xs = xbc[..., :h * p].reshape(b, t, h, p)
        Bs = xbc[..., h * p:h * p + g * n].reshape(b, t, g, n)
        Cs = xbc[..., h * p + g * n:].reshape(b, t, g, n)
        leaves = {"xBC": xbc, "dt": inp["dt"].detach().requires_grad_(),
                  "A": inp["A"].detach().requires_grad_()}
        s0 = inp["initial_state"]
        if s0 is not None:
            leaves["initial_state"] = s0.detach().requires_grad_()
        y, final = fn(xs, leaves["dt"], leaves["A"], Bs, Cs, chunk_size=chunk, D=inp["D"],
                      initial_state=leaves.get("initial_state"), return_final_state=True,
                      compute_dtype=dtype)
        loss = (y.float() * dy.float()).sum()
        if dfinal is not None:
            loss = loss + (final * dfinal).sum()
        loss.backward()
        grads.append({k: v.grad for k, v in leaves.items()})
    torch.cuda.synchronize()
    errs = {k: rel_err(grads[0][k], grads[1][k]) for k in grads[1]}
    worst = max(r for _, r in errs.values())
    print(f"check SSDFunction grads vs plain autograd {tag}: rel "
          + " ".join(f"{k} {r:.2e}" for k, (_, r) in errs.items()), flush=True)
    ok = worst <= TOL[dtype] and all(bool(torch.isfinite(v).all()) for v in grads[0].values())
    return [] if ok else [f"SSDFunction grads {tag}: rel {worst:.3e}"]


# ---------------------------------------------------- paged attention kernels


def check_rpa(gen):
    """Paged decode (the split-K kernel): kernel vs plain over ragged
    kv_len mixes (0, 1, mid-page, an exact page multiple, a full table),
    with bf16 and fp32 pages and with int8 pages and scales, over split
    counts from 1 to 40 (``attention_kernels.rpa_splits``) that leave
    ranges empty, GQA rep 3 (hybrid-280m), 4 and 8, head dims 64, 32, 128
    and 36 (no vector loads in bf16); zeros where kv_len is 0, two launches
    bit-identical.  The bf16 hybrid-280m case at 8 slots is timed for each
    page type (rows ``rpa_fwd`` and ``rpa_fwd_int8``): the kernel's device
    time beside SDPA's on the pre-gathered view, the event time printed."""
    from mamba_distributed_tpu_torch.ops.cuda import attention_kernels as ak

    timed = RPA_TIMED[-1]
    cases = [  # (dtype, S, nh, nkv, hd, pg, W, kv_len of the S slots)
        (torch.float32, 8, 12, 4, 64, 64, 16, timed),
        (torch.bfloat16, 8, 12, 4, 64, 64, 16, timed),
        (torch.float32, 8, 16, 4, 64, 8, 16, [0, 5, 16, 128, 77, 8, 1, 100]),
        (torch.bfloat16, 8, 16, 4, 64, 8, 16, [0, 5, 16, 128, 77, 8, 1, 100]),
        # 64 slots: two ranges of 8 pages; 2 slots: 16 ranges of a page
        (torch.bfloat16, 64, 12, 4, 64, 64, 16, [0, 1, 63, 64, 65, 384, 385, 1024] * 8),
        (torch.bfloat16, 2, 12, 4, 64, 64, 16, [37, 1024]),
        (torch.float32, 2, 12, 4, 64, 64, 16, [37, 1024]),
        (torch.float32, 2, 16, 2, 128, 16, 5, [80, 33]),
        (torch.bfloat16, 4, 8, 2, 32, 64, 7, [448, 0, 200, 64]),
        (torch.bfloat16, 3, 8, 2, 36, 16, 6, [96, 17, 50]),
        (torch.float32, 3, 8, 2, 36, 16, 6, [96, 17, 50]),
        # 40 ranges of a page (more than the combine holds in registers);
        # 3 ranges of 34 pages (more than a page per lane); one range (the
        # walk writes the output)
        (torch.bfloat16, 1, 12, 4, 64, 16, 40, [600]),
        (torch.bfloat16, 64, 8, 2, 64, 8, 100, [0, 1, 300, 800, 799, 272, 273, 8] * 8),
        (torch.bfloat16, 132, 4, 2, 32, 16, 4, [0, 1, 17, 64, 33, 16] * 22),
    ]
    rows = {}
    for quant in (False, True):
        name = "rpa_fwd_int8" if quant else "rpa_fwd"
        for dtype, S, nh, nkv, hd, pg, W, lens in cases:
            args = rpa_case(gen, S, nh, nkv, hd, pg, W, lens, dtype, quant)
            q, kp, vp, tbl, kv_len, *scales = args
            got = ak.ragged_paged_decode_attention(*args)
            got2 = ak.ragged_paged_decode_attention(*args)
            ref = ak.ragged_paged_decode_attention_plain(*args)
            torch.cuda.synchronize()
            empty = kv_len == 0
            same = bool(torch.equal(got, got2))
            if not torch.isfinite(got).all() or (bool(empty.any())
                                                 and got[empty].abs().max() != 0):
                raise SystemExit(f"{name}: non-finite output or a nonzero empty row ({dtype})")
            err, rel = rel_err(got[~empty], ref[~empty])
            shown = lens if S <= 8 else f"{lens[:8]}... ({S} slots)"
            print(f"check {name} {str(dtype)[6:]} S={S} nh={nh} nkv={nkv} hd={hd} pg={pg} "
                  f"W={W} kv_len={shown} ({ak.rpa_splits(S, nkv, W)} splits): "
                  f"max_abs_err={err:.3e} (rel {rel:.2e}), tol rel {TOL[dtype]:.0e}; 2 launches "
                  f"bit-identical: {same}", flush=True)
            if rel > TOL[dtype] or not same:
                raise SystemExit(f"{name} disagrees with the plain version (rel {rel:.3e}) or "
                                 f"differs between launches ({same})")
            if dtype is torch.bfloat16 and lens == timed:
                per = device_ms(lambda: ak.ragged_paged_decode_attention(*args), 50)
                ms = sum(per.values())
                loop_ms = cuda_ms(lambda: ak.ragged_paged_decode_attention(*args), 50)
                plain_ms = cuda_ms(lambda: ak.ragged_paged_decode_attention_plain(*args), 10)
                # yardstick: SDPA over the pre-gathered contiguous view
                # (int8 pages: dequantized; the gather is not timed),
                # heads expanded to nh
                kk, vv = ak.gather_kv_pages(kp, vp, tbl, None, *scales, dtype=dtype)
                kk = kk.transpose(1, 2).repeat_interleave(nh // nkv, dim=1).contiguous()
                vv = vv.transpose(1, 2).repeat_interleave(nh // nkv, dim=1).contiguous()
                mask = (torch.arange(W * pg, device="cuda") < kv_len.clamp(min=1)[:, None])
                qq = q[:, :, None]

                def sdpa():
                    return F.scaled_dot_product_attention(qq, kk, vv,
                                                          attn_mask=mask[:, None, None])

                library_ms = sum(device_ms(sdpa, 50).values())
                library_loop = cuda_ms(sdpa, 50)
                nbytes, flops = rpa_work(args)
                bound_ms, bound_by = bound(nbytes, flops)
                pages = "int8 pages" if quant else "bf16 pages"
                print(f"time {name} bf16 q, {pages}, S={S} kv_len={lens} "
                      f"({ak.rpa_splits(S, nkv, W)} splits): kernel {ms:.4f} ms of device time ("
                      + ", ".join(f"{k.removeprefix('void (anonymous namespace)::')[:40]} "
                                  f"{v:.4f}" for k, v in per.items())
                      + f"; {loop_ms:.4f} ms a call by the event timer), plain {plain_ms:.4f} "
                      f"ms, SDPA on the pre-gathered view (no page gather"
                      f"{' or dequant' if quant else ''}) {library_ms:.4f} ms of device time "
                      f"({library_loop:.4f} by the event timer), bound {bound_ms:.6f} ms "
                      f"({bound_by}: {nbytes} B, {flops} FLOP)", flush=True)
                rows[name] = dict(
                    name=name, route="cuda",
                    source="mamba_distributed_tpu_torch/ops/cuda/csrc/ragged_paged_attention.cu",
                    replaces="mamba_distributed_tpu/ops/pallas/attention_kernels.py:525",
                    launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                    event_ms=loop_ms)
    return rows["rpa_fwd"], rows["rpa_fwd_int8"]


def check_rpp(gen):
    """Fused page write + chunk prefill: kernel vs plain over the ragged
    mixes of tests/test_paged_attention.py (positions scaled by 8 to
    pages of 64) and the second 256-token chunk of a 700-token prompt
    (ln = 188, the timed case ``timing.RPP_TIMED``), with bf16/fp32 pages
    and with int8 pages (plus, for int8, a mix whose pages with no prior
    token of their row carry stale scales 1000x too large, as recycled
    pages do; the new scales come from ``models/attention.
    _chunk_page_scales``).  bf16 q with pages of 64 or 128 tokens runs the
    tensor-core attend, fp32 q the CUDA-core one.  Output rows at real
    query positions agree within the tolerance; every page but the trash
    page 0 is bit-identical, the kernel leaves the four scale arrays as it
    found them, and a second launch on a copy of the same pages gives the
    same output and pages bit for bit.  Rows ``rpp_fwd`` and
    ``rpp_fwd_int8``."""
    from mamba_distributed_tpu_torch.ops.cuda import attention_kernels as ak

    mixes = [  # (b, c, nh, nkv, pg, W, lengths, chunk_real, stale old scales)
        (3, 128, 12, 4, 64, 8, [0, 40, 136], [128, 88, 128], False),
        (3, 128, 12, 4, 64, 8, [0, 72, 0], [0, 128, 56], False),
        (2, 128, 12, 4, 64, 8, [96, 96], [128, 128], False),
        (2, 128, 12, 4, 64, 8, [384, 384], [128, 128], False),
        (2, 128, 4, 1, 128, 4, [24, 160], [128, 128], False),
        (2, 128, 12, 4, 64, 8, [96, 32], [0, 128], False),
        (*RPP_TIMED, False),
    ]
    int8_mixes = mixes + [(3, 128, 12, 4, 64, 8, [0, 64, 100], [128, 100, 60], True)]
    rows = {}
    for quant, dtype in ((False, torch.float32), (False, torch.bfloat16),
                         (True, torch.float32), (True, torch.bfloat16)):
        name = "rpp_fwd_int8" if quant else "rpp_fwd"
        for b, c, nh, nkv, pg, W, lens, reals, stale in (int8_mixes if quant else mixes):
            args, real = rpp_case(gen, b, c, nh, nkv, pg, W, lens, reals, dtype, quant, stale)
            q, kc, vc, kp, vp, tbl, ln, cr, *scales = args
            kept = [t.clone() for t in scales]
            kp2, vp2, kp3, vp3 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
            got, gk, gv = ak.ragged_paged_prefill_attention(*args)
            ref, rk, rv = ak.ragged_paged_prefill_attention_plain(
                q, kc, vc, kp2, vp2, tbl, ln, cr, *scales)
            # the attend sums in a fixed order: a second launch from the
            # same pages gives the same bits
            got3, _, _ = ak.ragged_paged_prefill_attention(q, kc, vc, kp3, vp3, tbl, ln, cr,
                                                           *scales)
            torch.cuda.synchronize()
            if not (torch.equal(gk[1:], rk[1:]) and torch.equal(gv[1:], rv[1:])):
                raise SystemExit(f"{name} wrote pages unlike the plain version "
                                 f"({dtype}, lengths {lens}, chunk_real {reals})")
            if not all(torch.equal(a, k) for a, k in zip(scales, kept)):
                raise SystemExit(f"{name} changed a scale array it only reads")
            if not (torch.equal(got3[real], got[real]) and torch.equal(kp3, gk)
                    and torch.equal(vp3, gv)):
                raise SystemExit(f"{name}: two launches differ ({dtype}, lengths {lens})")
            if not torch.isfinite(got[real]).all():
                raise SystemExit(f"{name}: non-finite output ({dtype}, lengths {lens})")
            err, rel = rel_err(got[real], ref[real]) if bool(real.any()) else (0.0, 0.0)
            route = ("tensor cores" if ak.rpp_uses_tensor_cores(dtype, q.shape[-1], pg)
                     else "CUDA cores")
            print(f"check {name} {str(dtype)[6:]} b={b} c={c} nh={nh} nkv={nkv} pg={pg} "
                  f"W={W} lengths={lens} chunk_real={reals}{' stale scales' if stale else ''} "
                  f"({route}): max_abs_err={err:.3e} (rel {rel:.2e}), tol rel "
                  f"{TOL[dtype]:.0e}; pages bit-identical{', scales read only' if quant else ''}"
                  f", 2 launches bit-identical", flush=True)
            if rel > TOL[dtype]:
                raise SystemExit(f"{name} disagrees with the plain version: rel {rel:.3e}")
            if dtype is torch.bfloat16 and (b, c, nh, nkv, pg, W, lens, reals) == RPP_TIMED:
                # the kernels' device time (write + attend): a loop of
                # wrapper calls is host-bound at this size, so the event
                # timer's loop time is printed beside it
                per = device_ms(lambda: ak.ragged_paged_prefill_attention(*args), 50)
                ms = sum(per.values())
                loop_ms = cuda_ms(lambda: ak.ragged_paged_prefill_attention(*args), 50)
                plain_ms = cuda_ms(lambda: ak.ragged_paged_prefill_attention_plain(*args), 10)
                # yardstick: causal SDPA over the pre-gathered view of
                # prefix + chunk (int8: dequantized; no page gather,
                # dequant or write)
                total = lens[0] + reals[0]
                kk, vv = ak.gather_kv_pages(kp, vp, tbl, None, *scales[2:], dtype=dtype)
                kk = kk[:, :total].transpose(1, 2).repeat_interleave(nh // nkv, dim=1)
                vv = vv[:, :total].transpose(1, 2).repeat_interleave(nh // nkv, dim=1)
                kk, vv = kk.contiguous(), vv.contiguous()
                qq = q.transpose(1, 2).contiguous()
                qpos = lens[0] + torch.arange(c, device="cuda")
                mask = torch.arange(total, device="cuda")[None, :] <= qpos[:, None]
                library_ms = sum(device_ms(lambda: F.scaled_dot_product_attention(
                    qq, kk, vv, attn_mask=mask), 50).values())
                nbytes, flops = rpp_work(args)
                bound_ms, bound_by = bound(nbytes, flops)
                pages = "int8 pages" if quant else "bf16 pages"
                print(f"time {name} bf16 q, {pages}, b=1 c=256 lengths={lens} chunk_real="
                      f"{reals}: kernels {ms:.4f} ms of device time ("
                      + ", ".join(f"{k.removeprefix('void (anonymous namespace)::')[:48]} {v:.4f}" for k, v in per.items())
                      + f"; {loop_ms:.4f} ms a call by the event timer), plain {plain_ms:.4f} "
                      f"ms, SDPA on the pre-gathered view (no page gather, dequant or write) "
                      f"{library_ms:.4f} ms of device time, bound {bound_ms:.6f} ms "
                      f"({bound_by}: {nbytes} B, {flops} FLOP)", flush=True)
                rows[name] = dict(
                    name=name, route="cuda",
                    source="mamba_distributed_tpu_torch/ops/cuda/csrc/ragged_paged_attention.cu",
                    replaces="mamba_distributed_tpu/ops/pallas/attention_kernels.py:722",
                    launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    return rows["rpp_fwd"], rows["rpp_fwd_int8"]


def check_kernel_tables() -> None:
    """The Python tables of built shapes (what ``ops/dispatch.
    check_kernel_shapes`` refuses by) against each library's own answers,
    and the paged prefill's dispatch rule against the library's."""
    from mamba_distributed_tpu_torch.config import get_preset
    from mamba_distributed_tpu_torch.models.attention import _attn_dims
    from mamba_distributed_tpu_torch.ops.cuda import (
        attention_kernels,
        flash_kernels,
        scan_kernels,
        ssd_kernels,
    )

    dims = (8, 16, 32, 48, 64, 96, 128, 192, 256)
    for name, fn in (("ssd_fwd", ssd_kernels._fwd_lib().mdt_ssd_fwd_supports),
                     ("ssd_bwd", ssd_kernels._bwd_lib().mdt_ssd_bwd_supports)):
        built = {(p, n) for p in dims for n in dims if fn(p, n)}
        if built != ssd_kernels.BUILT_SHAPES:
            raise SystemExit(f"{name} is built for {sorted(built)}, the table says "
                             f"{sorted(ssd_kernels.BUILT_SHAPES)}")
    fl = flash_kernels._lib()
    built = tuple(hd for hd in range(8, 257, 8) if fl.mdt_flash_supports(hd))
    if built != flash_kernels.HEAD_DIMS:
        raise SystemExit(f"flash is built for head dims {built}, the table says "
                         f"{flash_kernels.HEAD_DIMS}")
    ak = attention_kernels._lib()
    got = (ak.mdt_rpa_max_rep(), ak.mdt_rpa_max_head_dim())
    if got != (attention_kernels.MAX_REP, attention_kernels.MAX_HEAD_DIM):
        raise SystemExit(f"ragged paged limits {got} != the table's "
                         f"{(attention_kernels.MAX_REP, attention_kernels.MAX_HEAD_DIM)}")
    n_state = scan_kernels._lib().mdt_m1_state_size()
    if n_state != scan_kernels.N_STATE:
        raise SystemExit(f"selective scan d_state {n_state} != {scan_kernels.N_STATE}")
    print(f"check kernel shape tables: SSD (headdim, d_state) {sorted(ssd_kernels.BUILT_SHAPES)}, "
          f"flash head dims {flash_kernels.HEAD_DIMS}, paged rep <= {got[0]} and head dim <= "
          f"{got[1]}, scan d_state {n_state}: each equals its library's answers", flush=True)
    # the paged prefill's one dispatch rule: the wrapper's predicate is the
    # C dispatch's, and hybrid-280m's serving shapes (bf16 compute, with
    # bf16 or int8 pages) take the tensor-core attend
    codes = {torch.float32: 0, torch.bfloat16: 1}
    for dtype, code in codes.items():
        for hd in range(8, attention_kernels.MAX_HEAD_DIM + 1, 8):
            for pg in (8, 16, 32, 48, 64, 96, 128, 192, 256):
                py = attention_kernels.rpp_uses_tensor_cores(dtype, hd, pg)
                if py != bool(ak.mdt_rpp_uses_tc(code, hd, pg)):
                    raise SystemExit(f"paged prefill dispatch differs at {dtype} hd {hd} pg "
                                     f"{pg}: the wrapper says {py}")
    cfg = get_preset("hybrid-280m", compute_dtype="bfloat16")
    _, _, hd, _ = _attn_dims(cfg)
    if not attention_kernels.rpp_uses_tensor_cores(cfg.torch_compute_dtype, hd,
                                                   cfg.kv_page_tokens):
        raise SystemExit(f"hybrid-280m's paged prefill (head dim {hd}, pages of "
                         f"{cfg.kv_page_tokens}) would run the CUDA-core attend")
    print(f"check paged prefill dispatch: the wrapper's rule equals the library's over "
          f"{len(codes) * 16 * 9} (dtype, head dim, page) shapes; hybrid-280m (head dim {hd}, "
          f"pages of {cfg.kv_page_tokens}, bf16 and int8 pages) takes the tensor-core attend",
          flush=True)
    # the decode's split rule: the wrapper sizes the workspace by it, the
    # library refuses a launch sized by another
    grid = [(S, nkv, W) for S in (1, 2, 3, 8, 16, 64, 256) for nkv in (1, 2, 4, 8)
            for W in (1, 2, 5, 16, 33, 64, 128)]
    for S, nkv, W in grid:
        if attention_kernels.rpa_splits(S, nkv, W) != ak.mdt_rpa_splits(S, nkv, W):
            raise SystemExit(f"decode split count differs at S {S} nkv {nkv} W {W}: the "
                             f"wrapper says {attention_kernels.rpa_splits(S, nkv, W)}")
    S, nkv, W = 8, 4, 16
    print(f"check decode split rule: the wrapper's equals the library's over {len(grid)} "
          f"(slots, KV heads, pages) shapes; hybrid-280m's 8 slots of {W} pages take "
          f"{attention_kernels.rpa_splits(S, nkv, W)} splits of "
          f"{attention_kernels.rpa_split_pages(S, nkv, W)} pages", flush=True)
    # the SSD forward's one dispatch rule, and the presets on the tensor cores
    fwd = ssd_kernels._fwd_lib()
    for dtype, code in codes.items():
        for p in dims:
            for n in dims:
                py = ssd_kernels.ssd_uses_tensor_cores(dtype, p, n)
                if py != bool(fwd.mdt_ssd_uses_tc(code, p, n)):
                    raise SystemExit(f"ssd_fwd dispatch differs at {dtype} p {p} n {n}: the "
                                     f"wrapper says {py}")
    for preset in ("mamba2-280m", "hybrid-280m"):
        m = get_preset(preset, compute_dtype="bfloat16")
        p, n = m.headdim, m.effective_d_state
        if not ssd_kernels.ssd_uses_tensor_cores(m.torch_compute_dtype, p, n):
            raise SystemExit(f"{preset}'s SSD forward (headdim {p}, d_state {n}) would run the "
                             f"CUDA-core kernel")
    print(f"check ssd_fwd dispatch: the wrapper's rule equals the library's over "
          f"{len(codes) * len(dims) ** 2} (dtype, headdim, d_state) shapes; mamba2-280m and "
          f"hybrid-280m (headdim 64, d_state 128, bf16) take the tensor-core kernel", flush=True)
    # the SSD backward's one dispatch rule, and the presets' training shapes
    # on the tensor cores
    bwd = ssd_kernels._bwd_lib()
    chunks = (8, 50, 64, 100, 128, 192, 200, 256)
    for dtype, code in codes.items():
        for p in dims:
            for n in dims:
                for l in chunks:
                    py = ssd_kernels.ssd_bwd_uses_tensor_cores(dtype, p, n, l)
                    if py != bool(bwd.mdt_ssd_bwd_uses_tc(code, p, n, l)):
                        raise SystemExit(f"ssd_bwd dispatch differs at {dtype} p {p} n {n} l {l}: "
                                         f"the wrapper says {py}")
    for preset in ("mamba2-280m", "hybrid-280m"):
        m = get_preset(preset, compute_dtype="bfloat16")
        p, n = m.headdim, m.effective_d_state
        if not ssd_kernels.ssd_bwd_uses_tensor_cores(m.torch_compute_dtype, p, n, m.chunk_size):
            raise SystemExit(f"{preset}'s SSD backward (headdim {p}, d_state {n}, chunk "
                             f"{m.chunk_size}) would run the CUDA-core kernel")
    print(f"check ssd_bwd dispatch: the wrapper's rule equals the library's over "
          f"{len(codes) * len(dims) ** 2 * len(chunks)} (dtype, headdim, d_state, chunk) shapes; "
          f"mamba2-280m and hybrid-280m (headdim 64, d_state 128, chunk 256, bf16) take the "
          f"tensor-core kernels", flush=True)


# ------------------------------------------------------ flash attention kernels


def flash_inputs(gen, b, tq, tk, nh, nkv, hd, dtype):
    """Head-major q, k, v as transposed views of qkv-projection-like
    (b, t, heads * hd) tensors (so the kernels read them through strides,
    as in the mixer), and a dO of q's shape."""
    dev = "cuda"
    qx = torch.randn((b, tq, nh * hd), generator=gen, device=dev).to(dtype)
    kvx = torch.randn((b, tk, 2 * nkv * hd), generator=gen, device=dev).to(dtype)
    qt = qx.reshape(b, tq, nh, hd).transpose(1, 2)
    kt = kvx[..., :nkv * hd].reshape(b, tk, nkv, hd).transpose(1, 2)
    vt = kvx[..., nkv * hd:].reshape(b, tk, nkv, hd).transpose(1, 2)
    do = torch.randn((b, nh, tq, hd), generator=gen, device=dev).to(dtype)
    return qt, kt, vt, do


def check_flash(gen, micro: int):
    """Kernels 7-9 against their plain versions (the backward fed the
    plain lse and delta), in fp32 (TF32 off) and bf16, over t 1024 and a
    ragged 1000, GQA rep 1 and 3, offset 0 and a later query slice
    (tq < tk), head dims 64, 32 (hybrid-tiny) and 128; ragged cases for
    the tensor-core kernels' TMA zero fill and partial-tile masks (tk not
    a multiple of 8, tq 1, hd 32 and 128 at tq != tk, tk_valid < tk); ring
    attention's fully-past hop (tq == tk == 4096 at offset tk, no masked
    pair) at hd 64 and 128; the mixer's strided views and contiguous head-major copies; two launches
    of each kernel bit-identical; then the whole
    FlashAttentionFunction's gradients against torch autograd of the
    plain ``blockwise_sdpa_causal``; then one attention layer of the
    hybrid-280m train step (b ``micro``, t 1024, 12/4 heads, hd 64,
    bf16), checked and timed beside PyTorch's SDPA forward and backward,
    and dq + dk/dv timed together beside SDPA's backward."""
    from mamba_distributed_tpu_torch.ops.blockwise_attention import blockwise_sdpa_causal
    from mamba_distributed_tpu_torch.ops.cuda import flash_kernels as fk
    from mamba_distributed_tpu_torch.ops.cuda.flash_kernels import flash_work

    cases = [  # (b, tq, tk, nh, nkv, hd, offset)
        (1, 1024, 1024, 12, 4, 64, 0),
        (2, 1000, 1000, 4, 4, 64, 0),
        (1, 256, 1024, 12, 4, 64, 768),
        (2, 1000, 1000, 4, 2, 32, 0),
        (1, 200, 300, 8, 4, 128, 100),
        (1, 64, 128, 4, 2, 64, -16),  # rows that see no key: o 0, lse +inf
        # ragged edges of the tensor-core kernels' TMA boxes and masks
        (1, 77, 133, 4, 2, 64, 56),  # tk not a multiple of 8
        (2, 1, 300, 4, 2, 64, 299),  # one query row
        (1, 100, 250, 4, 2, 32, 150),
        (2, 65, 190, 6, 3, 128, 125),
        (1, 130, 200, 4, 2, 64, 70, 163),  # tk_valid < tk
        # ring attention's fully-past hop (sequence parallelism): a rank's
        # 4096 queries against the previous rank's 4096 keys, every pair
        # unmasked, at hybrid-280m's and hybrid-7b's heads
        (1, 4096, 4096, 12, 4, 64, 4096),
        (1, 4096, 4096, 32, 8, 128, 4096),
    ]
    failures = []

    def check_one(dtype, b, tq, tk, nh, nkv, hd, off, tk_valid=None, contiguous=False):
        tk_valid = tk if tk_valid is None else tk_valid
        qt, kt, vt, do = flash_inputs(gen, b, tq, tk, nh, nkv, hd, dtype)
        if contiguous:
            qt, kt, vt = (x.contiguous() for x in (qt, kt, vt))
        o_k, lse_k = fk.flash_fwd(qt, kt, vt, off, tk_valid)
        o_p, lse_p = fk.flash_fwd_plain(qt, kt, vt, off, tk_valid)
        delta = (do.float() * o_p.float()).sum(-1).contiguous()
        bwd = (qt, kt, vt, do, lse_p, delta, off, tk_valid)
        dq_k = fk.flash_bwd_dq(*bwd)
        dq_p = fk.flash_bwd_dq_plain(*bwd)
        dk_k, dv_k = fk.flash_bwd_dkv(*bwd)
        dk_p, dv_p = fk.flash_bwd_dkv_plain(*bwd)
        # the redesigned kernels sum in a fixed order: a second launch
        # gives the same bits
        o_2, lse_2 = fk.flash_fwd(qt, kt, vt, off, tk_valid)
        dq_2 = fk.flash_bwd_dq(*bwd)
        dk_2, dv_2 = fk.flash_bwd_dkv(*bwd)
        torch.cuda.synchronize()
        same = all(bool(torch.equal(a, c)) for a, c in
                   ((o_k, o_2), (lse_k, lse_2), (dq_k, dq_2), (dk_k, dk_2), (dv_k, dv_2)))
        seen = torch.isfinite(lse_p)
        same_inf = bool(torch.equal(torch.isfinite(lse_k), seen))
        errs = {"o": rel_err(o_k, o_p), "lse": rel_err(lse_k[seen], lse_p[seen]),
                "dq": rel_err(dq_k, dq_p), "dk": rel_err(dk_k, dk_p), "dv": rel_err(dv_k, dv_p)}
        finite = all(bool(torch.isfinite(t).all()) for t in (o_k, dq_k, dk_k, dv_k))
        worst = max(r for _, r in errs.values())
        tag = (f"{str(dtype)[6:]} b={b} tq={tq} tk={tk} nh={nh} nkv={nkv} hd={hd} offset={off}"
               + (f" tk_valid={tk_valid}" if tk_valid != tk else "")
               + (" contiguous" if contiguous else " strided views"))
        print(f"check flash {tag}: rel " + " ".join(f"{k} {r:.2e}" for k, (_, r) in errs.items())
              + f" (no-key rows alike: {same_inf}; fwd, dq, dkv bit-identical over 2 launches: "
              f"{same}); tol rel {TOL[dtype]:.0e}", flush=True)
        if not (finite and same_inf and same) or worst > TOL[dtype]:
            failures.append(f"flash kernels {tag}: finite={finite}, inf rows alike={same_inf}, "
                            f"deterministic={same}, rel {worst:.3e}")
        return (qt, kt, vt, do, o_p, lse_p, delta), errs

    for dtype in (torch.float32, torch.bfloat16):
        for case in cases:
            check_one(dtype, *case)
        for case in (cases[0], cases[6], cases[9]):
            check_one(dtype, *case, contiguous=True)
        # the whole Function against autograd of the plain blockwise path
        for b, tq, tk, nh, nkv, hd, off in ((1, 1000, 1000, 12, 4, 64, 0),
                                            (2, 256, 512, 4, 2, 32, 256)):
            qt, kt, vt, do = flash_inputs(gen, b, tq, tk, nh, nkv, hd, dtype)
            grads = []
            for fn in (fk.flash_sdpa_causal, blockwise_sdpa_causal):
                q, k, v = (t.transpose(1, 2).detach().requires_grad_() for t in (qt, kt, vt))
                o = fn(q, k, v, off)
                grads.append(torch.autograd.grad(
                    (o.float() * do.transpose(1, 2).float()).sum(), (q, k, v)))
            torch.cuda.synchronize()
            errs = {n: rel_err(a, r) for n, a, r in zip(("dq", "dk", "dv"), *grads)}
            worst = max(r for _, r in errs.values())
            tag = f"{str(dtype)[6:]} b={b} tq={tq} tk={tk} nh={nh} nkv={nkv} hd={hd} offset={off}"
            print(f"check FlashAttentionFunction grads vs blockwise autograd {tag}: rel "
                  + " ".join(f"{k} {r:.2e}" for k, (_, r) in errs.items()), flush=True)
            if worst > TOL[dtype] or not all(bool(torch.isfinite(g).all()) for g in grads[0]):
                failures.append(f"FlashAttentionFunction grads {tag}: rel {worst:.3e}")
    if failures:
        raise SystemExit("flash attention checks failed:\n" + "\n".join(failures))

    # one attention layer of the hybrid-280m train step, checked and timed
    b, t, nh, nkv, hd = micro, 1024, 12, 4, 64
    dtype = torch.bfloat16
    (qt, kt, vt, do, o_p, lse_p, delta), errs = check_one(dtype, b, t, t, nh, nkv, hd, 0)
    if failures:
        raise SystemExit("flash attention checks failed:\n" + "\n".join(failures))
    bwd = (qt, kt, vt, do, lse_p, delta, 0, t)
    timed = (
        ("flash_fwd", lambda: fk.flash_fwd(qt, kt, vt, 0, t),
         lambda: fk.flash_fwd_plain(qt, kt, vt, 0, t), errs["o"][0], 65),
        ("flash_bwd_dq", lambda: fk.flash_bwd_dq(*bwd), lambda: fk.flash_bwd_dq_plain(*bwd),
         errs["dq"][0], 127),
        ("flash_bwd_dkv", lambda: fk.flash_bwd_dkv(*bwd), lambda: fk.flash_bwd_dkv_plain(*bwd),
         max(errs["dk"][0], errs["dv"][0]), 171),
    )
    # library yardstick: SDPA on contiguous head-major copies; the
    # backward row is autograd of that call (dq, dk and dv together)
    qc, kc, vc = (x.contiguous().requires_grad_() for x in (qt, kt, vt))
    sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        qc, kc, vc, is_causal=True, enable_gqa=True), 10)
    out = F.scaled_dot_product_attention(qc, kc, vc, is_causal=True, enable_gqa=True)
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(out, (qc, kc, vc), do, retain_graph=True), 10)
    rows = []
    for (nm, kern, plain, err, line), (nb, fl), lib in zip(
            timed, flash_work(b, t, t, nh, nkv, hd, 0, dtype), (sdpa_fwd, sdpa_bwd, sdpa_bwd)):
        ms = cuda_ms(kern, 10)
        plain_ms = cuda_ms(plain, 3, 1)
        bound_ms, bound_by = bound(nb, fl)
        print(f"time {nm} bf16 b={b} t={t} nh={nh} nkv={nkv} hd={hd} (one attention layer of "
              f"the hybrid-280m train step): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"SDPA {'forward' if nm == 'flash_fwd' else 'backward (dq, dk, dv together)'} "
              f"{lib:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}: {nb} B, {fl} FLOP)",
              flush=True)
        if nm == "flash_bwd_dkv":
            both = cuda_ms(lambda: (fk.flash_bwd_dq(*bwd), fk.flash_bwd_dkv(*bwd)), 10)
            print(f"time flash_bwd_dq + flash_bwd_dkv bf16 b={b} t={t} nh={nh} nkv={nkv} "
                  f"hd={hd} (the port's whole backward kernel work): {both:.4f} ms, SDPA "
                  f"backward (dq, dk, dv together) {lib:.4f} ms", flush=True)
        rows.append(dict(name=nm, route="cuda",
                         source="mamba_distributed_tpu_torch/ops/cuda/csrc/flash_attention.cu",
                         replaces=f"mamba_distributed_tpu/ops/pallas/attention_kernels.py:{line}",
                         launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=lib))
    del qc, kc, vc, out
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------ selective scan (Mamba-1)

# ------------------------------------------------------------- RMSNorm kernels

# (rows, width, group) of each norm kernel's checked and timed shapes: the
# decode tick's 8 rows and a 256-token chunk step's, at the 280m presets'
# widths (d_model 768 for the residual norm, d_inner 1536 for the gated
# one), 1536 for both, and hybrid-7b's (d_model 4096, d_inner 8192, and a
# grouped norm of 8 groups); the first shape of each is its row's
NORM_SHAPES = {
    "add_rms_norm": ((8, 768, None), (256, 768, None), (8, 1536, None), (256, 1536, None),
                     (256, 4096, None), (256, 8192, None)),
    "rms_norm_gated": ((8, 1536, None), (256, 1536, None), (256, 8192, None),
                       (256, 8192, 1024)),
}
# the sum of squares of the part of a gated row a serving mesh's model rank
# holds: the d_inner a rank holds (hybrid-280m at model 2: 768; hybrid-7b
# at model 4: 2048) at a data rank's decode rows and the chunk
NORM_TP_SHAPES = {
    "rms_norm_gated_sumsq": ((4, 768, None), (256, 768, None), (8, 2048, None),
                             (256, 2048, None)),
}
NORM_SOURCE = "mamba_distributed_tpu_torch/ops/cuda/csrc/rms_norm.cu"
NORM_NO_PALLAS = ("none: no pallas_call counterpart (mamba_distributed_tpu/ops/norm.py:23-75 "
                  "is plain jnp, left to XLA)")


def norm_case(gen, name: str, rows: int, d: int, group, dtype):
    """(kernel call, plain call, bytes moved) of one norm case: bf16 (or
    fp32) activations, an fp32 residual stream and fp32 weights, as the
    decode step and the chunk step feed them; the bytes count each input
    read once and each output written once."""
    from mamba_distributed_tpu_torch.ops.cuda import norm_kernels as nk

    e = torch.tensor([], dtype=dtype).element_size()
    x = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    w = 1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
    if name == "add_rms_norm":
        r = torch.randn((rows, d), generator=gen, device="cuda")
        return (lambda: nk.add_rms_norm_kernel(x, r, w), lambda: nk.add_rms_norm_plain(x, r, w),
                rows * d * (e + 4 + e + 4) + d * 4)
    z = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    if name == "rms_norm_gated_sumsq":
        return (lambda: (nk.rms_norm_gated_sumsq_kernel(x, z),),
                lambda: (nk.rms_norm_gated_sumsq_plain(x, z),), rows * d * 2 * e + rows * 4)
    return (lambda: (nk.rms_norm_gated_kernel(x, z, w, group_size=group),),
            lambda: (nk.rms_norm_gated_plain(x, z, w, group_size=group),),
            rows * d * 3 * e + d * 4)


def check_norms(gen) -> list[dict]:
    """The three RMSNorm kernels (``rms_norm.cu``, no ``pallas_call``
    counterpart) against their plain versions in fp32 and bf16 at
    ``NORM_SHAPES`` and ``NORM_TP_SHAPES``, two launches bit-identical,
    timed in bf16 by device time beside their bytes bound and the plain
    version's device time.  (The row-count invariance of the first two is
    held in ``compaction_kernels``, of the sum of squares by the serving
    mesh phase's compacted ticks.)"""
    rows = []
    for name, shapes in {**NORM_SHAPES, **NORM_TP_SHAPES}.items():
        entries = []
        for n_rows, d, group in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                kern, plain, nbytes = norm_case(gen, name, n_rows, d, group, dtype)
                got, got2, ref = kern(), kern(), plain()
                torch.cuda.synchronize()
                errs = [rel_err(a, b) for a, b in zip(got, ref)]
                err, rel = max(e for e, _ in errs), max(r for _, r in errs)
                same = all(torch.equal(a, b) for a, b in zip(got, got2))
                tag = f"{str(dtype)[6:]} rows={n_rows} d={d} group={group}"
                print(f"check {name} {tag}: max_abs_err={err:.3e} (rel {rel:.2e}), tol rel "
                      f"{TOL[dtype]:.0e}; 2 launches bit-identical: {same}", flush=True)
                if rel > TOL[dtype] or not same:
                    raise SystemExit(f"{name} disagrees with the plain version (rel {rel:.3e})"
                                     f" or differs between launches ({same}): {tag}")
                if dtype is not torch.bfloat16:
                    continue
                ms = sum(device_ms(kern, 50).values())
                plain_ms = sum(device_ms(plain, 20).values())
                bound_ms, bound_by = bound(nbytes, 0)
                print(f"time {name} {tag}: kernel {ms:.5f} ms of device time, plain "
                      f"{plain_ms:.5f} ms of device time, bound {bound_ms:.6f} ms ({bound_by}: "
                      f"{nbytes} B)", flush=True)
                entries.append(dict(shape=tag, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, max_abs_err=err))
        head = entries[0]
        rows.append(dict(name=name, route="cuda", source=NORM_SOURCE, replaces=NORM_NO_PALLAS,
                         pallas_call=False, launches=None, max_abs_err=head["max_abs_err"],
                         ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                         bound_by=head["bound_by"], library_ms=None, shapes=entries))
    return rows


# ------------------------------------------------- kernels at the verify shape

SPEC_K = 3  # draft tokens of the speculative runs: the verify feeds K+1 a row
# the verify launch's rows at capacity 8 for the paged prefill: KV lengths
# of the slots (one masked row, chunk_real 0) and the spec engine's page
# table width (hybrid-280m's 16 pages a slot and the trash column)
VERIFY_LENS = [300, 12, 700, 100, 956, 257, 63, 0]
VERIFY_REALS = [SPEC_K + 1] * 7 + [0]
VERIFY_W = 17


def rpp_rows_work(args) -> tuple[int, int]:
    """``rpp_work`` summed over the rows of a batched paged prefill."""
    q, kc, vc, kp, vp, tbl, ln, cr, *scales = args
    works = [rpp_work((q[i:i + 1], kc[i:i + 1], vc[i:i + 1], kp, vp, tbl[i:i + 1],
                       ln[i:i + 1], cr[i:i + 1], *scales)) for i in range(q.shape[0])]
    return sum(b for b, _ in works), sum(f for _, f in works)


def check_verify_shapes(gen, rows: dict) -> None:
    """The kernels the speculative verify launches, at its shape: 8 rows
    of K+1 = 4 tokens.  ``ssd_fwd`` (bf16, seeded, the 4-token chunk that
    ``_divisor_chunk`` gives, on the tensor cores, zero-filled past l
    inside its 64-row block) and ``m1_scan`` (fp32, t 4, below its 16-step
    ``cp.async`` tile) against their plain versions; ``rpp_fwd`` and
    ``rpp_fwd_int8`` at c 4 over a 17-page table (16 and the trash column)
    with one masked row, pages bit-identical; each timed by device time
    beside its bound, into its row's ``shapes``."""
    from mamba_distributed_tpu_torch.ops.cuda import attention_kernels as ak
    from mamba_distributed_tpu_torch.ops.cuda import scan_kernels as sk
    from mamba_distributed_tpu_torch.ops.cuda import ssd_kernels
    from mamba_distributed_tpu_torch.ops.ssd import _divisor_chunk, ssd_chunked

    b, c = 8, SPEC_K + 1
    dtype = torch.bfloat16
    inp = ssd_inputs(gen, b, c, 1, dtype, True)
    kw = dict(chunk_size=256, return_final_state=True, compute_dtype=dtype)
    got, ref = ssd_kernels.ssd_chunked_kernel(**inp, **kw), ssd_chunked(**inp, **kw)
    errs = [rel_err(a, r) for a, r in zip(got, ref)]
    err, rel = max(e for e, _ in errs), max(r for _, r in errs)
    l = _divisor_chunk(c, 256)
    args = (inp["x"], inp["dt"], inp["A"], inp["B"], inp["C"], l, inp["initial_state"], dtype)
    ms = sum(device_ms(lambda: ssd_kernels._ssd_fwd(*args), 50).values())
    plain_ms = cuda_ms(lambda: ssd_chunked(**inp, **kw), 5, 1)
    nbytes, flops = ssd_work(b, c, 24, 1, 64, 128, l, dtype, True)
    bound_ms, bound_by = bound(nbytes, flops)
    route = "tensor cores" if ssd_kernels.ssd_uses_tensor_cores(dtype, 64, 128) else "CUDA cores"
    print(f"verify shape ssd_fwd bf16 b={b} t={c} l={l} h=24 seeded ({route}): max_abs_err="
          f"{err:.3e} (rel {rel:.2e}), tol rel {TOL[dtype]:.0e}; kernel {ms:.4f} ms of device "
          f"time, plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})", flush=True)
    if rel > TOL[dtype] or not all(torch.isfinite(t).all() for t in got):
        raise SystemExit(f"ssd_fwd at the verify shape: rel {rel:.3e}")
    rows["ssd_fwd"]["shapes"].append(dict(
        shape=f"bf16 b={b} t={c} l={l} h=24 seeded (verify)", ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err))

    tol = TOL[torch.float32]
    u, dt, A, B, C, h0 = m1_inputs(gen, b, c, 1536, True)
    errs = [rel_err(a, r) for a, r in zip(sk.m1_scan(u, dt, A, B, C, h0),
                                          sk.m1_scan_plain(u, dt, A, B, C, h0))]
    err, rel = max(e for e, _ in errs), max(r for _, r in errs)
    ms = sum(device_ms(lambda: sk.m1_scan(u, dt, A, B, C, h0), 50).values())
    plain_ms = cuda_ms(lambda: sk.m1_scan_plain(u, dt, A, B, C, h0), 5, 1)
    (nb, ne, nf), _, _ = m1_work(b, c, 1536, 16, True, False)
    bound_ms, bound_by = m1_bound(nb, ne, nf)
    print(f"verify shape m1_scan fp32 b={b} t={c} d=1536 seeded ({sk.m1_scan_ctas(b, 1536)} "
          f"CTAs): max_abs_err={err:.3e} (rel {rel:.2e}), tol rel {tol:.0e}; kernel {ms:.4f} ms "
          f"of device time, plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})",
          flush=True)
    if rel > tol:
        raise SystemExit(f"m1_scan at the verify shape: rel {rel:.3e}")
    rows["m1_scan"]["shapes"].append(dict(
        shape=f"fp32 b={b} t={c} d=1536 seeded (verify)", ctas=sk.m1_scan_ctas(b, 1536), ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err))

    for quant, name in ((False, "rpp_fwd"), (True, "rpp_fwd_int8")):
        args, real = rpp_case(gen, b, c, 12, 4, 64, VERIFY_W, VERIFY_LENS, VERIFY_REALS,
                              dtype, quant)
        q, kc, vc, kp, vp, tbl, ln, cr, *scales = args
        kp2, vp2 = kp.clone(), vp.clone()
        out, gk, gv = ak.ragged_paged_prefill_attention(*args)
        ref, rk, rv = ak.ragged_paged_prefill_attention_plain(q, kc, vc, kp2, vp2, tbl, ln, cr,
                                                              *scales)
        torch.cuda.synchronize()
        if not (torch.equal(gk[1:], rk[1:]) and torch.equal(gv[1:], rv[1:])):
            raise SystemExit(f"{name} at the verify shape wrote pages unlike the plain version")
        err, rel = rel_err(out[real], ref[real])
        ms = sum(device_ms(lambda: ak.ragged_paged_prefill_attention(*args), 50).values())
        plain_ms = cuda_ms(lambda: ak.ragged_paged_prefill_attention_plain(*args), 5, 1)
        nbytes, flops = rpp_rows_work(args)
        bound_ms, bound_by = bound(nbytes, flops)
        print(f"verify shape {name} bf16 q b={b} c={c} W={VERIFY_W} lengths={VERIFY_LENS} "
              f"chunk_real={VERIFY_REALS}: max_abs_err={err:.3e} (rel {rel:.2e}), tol rel "
              f"{TOL[dtype]:.0e}, pages bit-identical; kernels {ms:.4f} ms of device time, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})", flush=True)
        if rel > TOL[dtype] or not torch.isfinite(out[real]).all():
            raise SystemExit(f"{name} at the verify shape: rel {rel:.3e}")
        rows[name].setdefault("shapes", []).append(dict(
            shape=f"bf16 q b={b} c={c} W={VERIFY_W} (verify)", ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err))


def m1_layout_extra(b, t, d, n):
    """Bytes the port's layout moves beyond ``m1_work``'s count: the entry
    states at T_BLK steps in place of the TPU tile (written by kernel 5,
    read by kernel 6), and kernel 6's per-batch dA and per-CTA dB/dC
    partials in place of the summed dA, dB, dC."""
    from mamba_distributed_tpu_torch.ops.cuda.scan_kernels import D_BLK, T_BLK

    entry = b * (-(-t // T_BLK) - -(-t // TPU_M1_T_TILE)) * d * n * 4
    parts = (b - 1) * d * n * 4 + 2 * b * (-(-d // D_BLK) - 1) * t * n * 4
    return entry, parts


def check_m1(gen):
    """Kernels 4-6 against their plain versions in fp32 (the core is
    fp32-only, as on the TPU) over ragged tiles and channel blocks, d 1536
    and 1000, t 1024, 1000 and 256, seeded or not, with and without a
    final-state cotangent (kernel 6 fed the plain entry states), two
    launches of each bit-identical, then the whole ``selective_scan_kernel``
    (SelectiveScanFunction, D, z, softplus)
    against torch autograd of the plain ``selective_scan_seq``.  Timed:
    kernel 4 at the serving chunk (b 1, t 256, seeded, final state; device
    time) and kernels 4-6 at one layer of the mamba1-280m train step (b 32,
    t 1024); the rows' errors are at the timed inputs, kernel 4's row has
    both shapes.  First, kernel 4's launch geometry (``m1_scan_ctas``)
    against the library's."""
    from mamba_distributed_tpu_torch.ops.cuda import scan_kernels as sk
    from mamba_distributed_tpu_torch.ops.scan import selective_scan_seq

    tol = TOL[torch.float32]
    # m1_scan's geometry: the wrapper's rule is the library's launch grid
    lib = sk._lib()
    grid = [(b, d) for b in (1, 2, 8, 32) for d in (1, 16, 17, 70, 1000, 1536, 2048)]
    for b, d in grid:
        if sk.m1_scan_ctas(b, d) != lib.mdt_m1_scan_ctas(b, d):
            raise SystemExit(f"m1_scan CTAs differ at b {b} d {d}: the wrapper says "
                             f"{sk.m1_scan_ctas(b, d)}, the library {lib.mdt_m1_scan_ctas(b, d)}")
    print(f"check m1_scan geometry: the wrapper's rule equals the library's over {len(grid)} "
          f"(b, d) shapes; {sk.SCAN_Q} threads a channel, {sk.SCAN_CH} channels a CTA: "
          f"{sk.m1_scan_ctas(1, 1536)} CTAs at b 1 and {sk.m1_scan_ctas(32, 1536)} at b 32, d 1536",
          flush=True)
    cases = [  # (b, t, d, seeded, dfinal)
        (3, 37, 70, True, True),  # ragged tile and channel block
        (2, 1024, 1536, False, False),
        (2, 1000, 1000, True, True),
        (1, 256, 1536, True, False),  # the serving chunk step
        (8, 1024, 1536, False, True),  # train-step widths at b 8
    ]
    names = ("du", "ddt", "dA", "dB", "dC", "dh0")
    failures = []
    for b, t, d, seeded, dfin in cases:
        u, dt, A, B, C, h0 = m1_inputs(gen, b, t, d, seeded)
        dy = torch.randn((b, t, d), generator=gen, device="cuda")
        dfinal = torch.randn((b, d, 16), generator=gen, device="cuda") if dfin else None
        got = [*sk.m1_scan(u, dt, A, B, C, h0), sk.m1_entry_states(u, dt, A, B, h0)]
        got2 = [*sk.m1_scan(u, dt, A, B, C, h0), sk.m1_entry_states(u, dt, A, B, h0)]
        ref = [*sk.m1_scan_plain(u, dt, A, B, C, h0), sk.m1_entry_states_plain(u, dt, A, B, h0)]
        got += sk.m1_bwd(u, dt, A, B, C, ref[2], dy, dfinal)
        got2 += sk.m1_bwd(u, dt, A, B, C, ref[2], dy, dfinal)
        ref += sk.m1_bwd_plain(u, dt, A, B, C, ref[2], dy, dfinal)
        torch.cuda.synchronize()
        same = all(torch.equal(a, a2) for a, a2 in zip(got, got2, strict=True))
        errs = {nm: rel_err(a, r) for nm, a, r in zip(("y", "hT", "states", *names), got, ref)}
        worst = max(r for _, r in errs.values())
        finite = all(bool(torch.isfinite(v).all()) for v in got)
        tag = f"fp32 b={b} t={t} d={d} seeded={seeded} dfinal={dfin}"
        print(f"check m1_scan/m1_entry_states/m1_bwd {tag}: rel "
              + " ".join(f"{k} {r:.2e}" for k, (_, r) in errs.items())
              + f"; tol rel {tol:.0e}; 2 launches bit-identical: {same}", flush=True)
        if not finite or worst > tol or not same:
            failures.append(f"m1 kernels {tag}: finite={finite}, rel {worst:.3e}, "
                            f"2 launches bit-identical {same}")
        if b * t <= 2048:
            failures += m1_function_grads(sk.selective_scan_kernel, selective_scan_seq,
                                          gen, b, t, d, seeded, dfin, tag)
    if failures:
        raise SystemExit("selective scan checks failed:\n" + "\n".join(failures))

    # kernel 4 at the serving chunk step
    u, dt, A, B, C, h0 = m1_inputs(gen, 1, 256, 1536, True)
    errs = [rel_err(a, r) for a, r in zip(sk.m1_scan(u, dt, A, B, C, h0),
                                          sk.m1_scan_plain(u, dt, A, B, C, h0))]
    err, rel = max(e for e, _ in errs), max(r for _, r in errs)
    if rel > tol:
        raise SystemExit(f"m1_scan at the serving chunk: rel {rel:.3e} > {tol:.0e}")
    # the kernel's device time (a loop of calls at this size is host-bound),
    # the event time beside it
    ms = sum(device_ms(lambda: sk.m1_scan(u, dt, A, B, C, h0), 50).values())
    event_ms = cuda_ms(lambda: sk.m1_scan(u, dt, A, B, C, h0), 50)
    plain_ms = cuda_ms(lambda: sk.m1_scan_plain(u, dt, A, B, C, h0), 3, 1)
    (nb, ne, nf), _, _ = m1_work(1, 256, 1536, 16, True, False)
    bound_ms, bound_by = m1_bound(nb, ne, nf)
    ctas = sk.m1_scan_ctas(1, 1536)
    print(f"time m1_scan fp32 b=1 t=256 d=1536 seeded (the serving chunk step, {ctas} CTAs): "
          f"kernel {ms:.4f} ms of device time ({event_ms:.4f} ms a call by the event timer), "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}: {nb} B, {ne} exp, "
          f"{nf} FLOP)", flush=True)
    shapes = [dict(shape="fp32 b=1 t=256 d=1536 seeded", ctas=ctas, ms=ms, event_ms=event_ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)]
    # the row: the serving chunk, whose launches it counts (the mamba1
    # serving run); the train layer beside it
    rows = [dict(name="m1_scan", route="cuda",
                 source="mamba_distributed_tpu_torch/ops/cuda/csrc/selective_scan.cu",
                 replaces="mamba_distributed_tpu/ops/pallas/scan_kernels.py:64",
                 launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=None, shapes=shapes)]

    # kernels 4-6 at one layer of the train step
    b, t, d = 32, 1024, 1536
    u, dt, A, B, C, _ = m1_inputs(gen, b, t, d, False)
    dy = torch.randn((b, t, d), generator=gen, device="cuda")
    states = sk.m1_entry_states_plain(u, dt, A, B)
    timed = (
        ("m1_scan", lambda: sk.m1_scan(u, dt, A, B, C),
         lambda: sk.m1_scan_plain(u, dt, A, B, C), None),
        ("m1_entry_states", lambda: sk.m1_entry_states(u, dt, A, B),
         lambda: sk.m1_entry_states_plain(u, dt, A, B), 178),
        ("m1_bwd", lambda: sk.m1_bwd(u, dt, A, B, C, states, dy),
         lambda: sk.m1_bwd_plain(u, dt, A, B, C, states, dy), 201),
    )
    for (nm, kern, plain, line), (nb, ne, nf) in zip(timed, m1_work(b, t, d, 16, False, False)):
        ref, out = plain(), kern()
        if not isinstance(ref, tuple):
            ref, out = (ref,), (out,)
        errs = [rel_err(a, r) for a, r in zip(out, ref)]
        err, rel = max(e for e, _ in errs), max(r for _, r in errs)
        del ref, out
        if rel > tol:
            raise SystemExit(f"{nm} at the train layer: rel {rel:.3e} > {tol:.0e}")
        ms = cuda_ms(kern, 10)
        plain_ms = cuda_ms(plain, 2, 1)
        bound_ms, bound_by = m1_bound(nb, ne, nf)
        print(f"time {nm} fp32 b={b} t={t} d={d} (one layer of the mamba1-280m train step): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
              f"({bound_by}: {nb} B, {ne} exp, {nf} FLOP), max_abs_err {err:.3e} "
              f"(rel {rel:.2e})", flush=True)
        if line is None:
            shapes.append(dict(shape=f"fp32 b={b} t={t} d={d}", ctas=sk.m1_scan_ctas(b, d),
                               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                               max_abs_err=err))
        else:
            rows.append(dict(name=nm, route="cuda",
                             source="mamba_distributed_tpu_torch/ops/cuda/csrc/selective_scan.cu",
                             replaces=f"mamba_distributed_tpu/ops/pallas/scan_kernels.py:{line}",
                             launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    entry, parts = m1_layout_extra(b, t, d, 16)
    print(f"m1 layout at b={b} t={t} d={d}: beyond the bounds' bytes, the entry states at "
          f"{sk.T_BLK}-step tiles add {entry} B (written by m1_entry_states, read by "
          f"m1_bwd) and the per-batch dA and per-{sk.D_BLK}-channel dB/dC partials add "
          f"{parts} B (m1_bwd)", flush=True)
    del u, dt, dy, states
    torch.cuda.empty_cache()
    return rows


def m1_function_grads(kernel_fn, seq_fn, gen, b, t, d, seeded, dfin, tag):
    """Gradients of u, delta, A, B, C, D, z, delta_bias (and h0) through
    ``selective_scan_kernel`` (the Function: kernels 4-6) and through torch
    autograd of the plain ``selective_scan_seq``, same inputs, same
    cotangents."""
    dev, n = "cuda", 16
    inp = dict(u=torch.randn((b, t, d), generator=gen, device=dev),
               delta=torch.randn((b, t, d), generator=gen, device=dev) - 3.0,
               A=-torch.exp(torch.rand((d, n), generator=gen, device=dev) * 2.77),
               B=torch.randn((b, t, n), generator=gen, device=dev),
               C=torch.randn((b, t, n), generator=gen, device=dev),
               D=torch.randn((d,), generator=gen, device=dev),
               z=torch.randn((b, t, d), generator=gen, device=dev),
               delta_bias=0.1 * torch.randn((d,), generator=gen, device=dev))
    if seeded:
        inp["initial_state"] = 0.5 * torch.randn((b, d, n), generator=gen, device=dev)
    dy = torch.randn((b, t, d), generator=gen, device=dev)
    dfinal = torch.randn((b, d, n), generator=gen, device=dev) if dfin else None
    grads = []
    for fn in (kernel_fn, seq_fn):
        leaves = {k: v.detach().clone().requires_grad_() for k, v in inp.items()}
        y, final = fn(**leaves, delta_softplus=True, return_final_state=True)
        loss = (y * dy).sum()
        if dfinal is not None:
            loss = loss + (final * dfinal).sum()
        loss.backward()
        grads.append({k: v.grad for k, v in leaves.items()})
    torch.cuda.synchronize()
    errs = {k: rel_err(grads[0][k], grads[1][k]) for k in grads[1]}
    worst = max(r for _, r in errs.values())
    print(f"check SelectiveScanFunction grads vs plain autograd {tag}: rel "
          + " ".join(f"{k} {r:.2e}" for k, (_, r) in errs.items()), flush=True)
    ok = worst <= TOL[torch.float32] and all(
        bool(torch.isfinite(v).all()) for v in grads[0].values())
    return [] if ok else [f"SelectiveScanFunction grads {tag}: rel {worst:.3e}"]


# ------------------------------------------------------------ serving path


def serving_mix(cfg, new: int):
    """The serving mix: prompts of 12, 100, 300 and 700 tokens, twice
    each, from a seeded generator, ``new`` tokens each; request 0 is
    greedy (its stream is held to ``generate()``'s), the others sample
    top-50 with their own seeds.  Returns (lengths, prompts, a function
    making fresh requests)."""
    from mamba_distributed_tpu_torch.serving import GenerationRequest

    lens = [12, 100, 300, 700, 12, 100, 300, 700]
    prompt_gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (t,), generator=prompt_gen).numpy()
               for t in lens]

    def requests():
        return [GenerationRequest(prompt_ids=p.copy(), max_new_tokens=new,
                                  top_k=1 if i == 0 else 50, seed=i)
                for i, p in enumerate(prompts)]

    return lens, prompts, requests


def serve(preset: str, path_kernels: tuple[str, ...], params=None, keep_params: bool = False,
          **overrides) -> dict:
    """Serve 8 requests on a full-width engine of ``preset`` (config
    fields ``overrides``, e.g. the int8 knobs); returns the run's launch
    counts, the greedy stream and the serving numbers.  Every kernel in
    ``path_kernels`` (keys of ``build.LAUNCHES``) must have launched in
    it.  ``params``: decode weights already cast for this config (the
    engine, ``generate()`` and the chunk step then share them, since a
    cast of cast weights returns the same tensors); by default fp32
    masters are made here from a seeded generator.  ``keep_params``
    returns the run's decode weights under "params" too."""
    from mamba_distributed_tpu_torch.config import get_preset
    from mamba_distributed_tpu_torch.inference.generate import generate
    from mamba_distributed_tpu_torch.models.lm import init_lm_params, init_lm_state
    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
    from mamba_distributed_tpu_torch.ops.quant import param_bytes
    from mamba_distributed_tpu_torch.serving import ServingEngine
    from mamba_distributed_tpu_torch.serving.prefill import (
        cast_decode_params,
        chunk_inputs,
        plan_chunks,
        prefill_chunk,
    )

    cfg = get_preset(preset, ssm_impl="pallas", compute_dtype="bfloat16", **overrides)
    hybrid = bool(cfg.attn_layer_idx)
    tag = f"{preset}{' int8' if overrides else ''}"
    torch.cuda.reset_peak_memory_stats()
    if params is None:
        params = init_lm_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                device="cuda")
    capacity, new = 8, 32
    lens, prompts, requests = serving_mix(cfg, new)

    # warm-up run (cuBLAS handles, allocator), not counted
    ServingEngine(params, cfg, capacity=capacity).run(requests()[:2])
    torch.cuda.synchronize()

    eng = ServingEngine(params, cfg, capacity=capacity)
    reqs = requests()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t0 = time.perf_counter()
    ids = [eng.submit(r) for r in reqs]
    tracked = {t.request_id: t for t in eng.scheduler}
    decode_ticks = []
    while eng.pending:
        prefill_pending = bool(eng.scheduler.depth or eng._prefill_queue)
        ts = time.perf_counter()
        events = eng.step()
        if events and not prefill_pending:
            decode_ticks.append(time.perf_counter() - ts)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    results = [eng.results[i] for i in ids]

    n_tokens = sum(len(r.new_tokens) for r in results)
    for r in results:
        if len(r.new_tokens) != new or not (0 <= r.new_tokens.min() and
                                            r.new_tokens.max() < cfg.vocab_size):
            raise SystemExit(f"request {r.request_id}: bad stream {r.new_tokens}")
    for k in path_kernels:
        if launches[k] < 1:
            raise SystemExit(f"the {preset} serving path launched no {k} kernel")
    if hybrid and eng.page_pool.pages_in_use:
        raise SystemExit(f"{eng.page_pool.pages_in_use} KV pages leaked")
    ttft = sorted((tracked[i].t_first_token - tracked[i].t_submit) * 1e3 for i in ids)

    solo = generate(params, cfg, torch.from_numpy(prompts[0])[None], seed=0,
                    max_new_tokens=new, top_k=1, decode_rows=capacity)
    solo = solo[0, len(prompts[0]):].tolist()
    if solo != results[0].new_tokens.tolist():
        raise SystemExit(f"engine greedy stream {results[0].new_tokens.tolist()} != "
                         f"generate() {solo}")

    # prefill cost per token: the second 256-token chunk step of the
    # 700-token prompt, batch 1 (a hybrid's pages hold its first 188)
    dparams = cast_decode_params(params, cfg)
    plan = plan_chunks(700, cfg.effective_prefill_chunk_tokens)
    cids, cmask = chunk_inputs(prompts[3], plan, 1, device=eng.device)
    st = init_lm_state(cfg, 1, max_len=cfg.kv_slot_tokens if hybrid else 0,
                       device=eng.device)
    if hybrid:
        st["attn_meta"] = (st["attn_meta"][0],
                           torch.tensor([plan.real_tokens(0)], dtype=torch.int32,
                                        device=eng.device))
    with torch.no_grad():
        chunk_ms = cuda_ms(lambda: prefill_chunk(dparams, cids, cmask, st, cfg), 3, 1)
    card = smi()
    dtypes = (f"weights {cfg.serving_weight_dtype}, KV pages {cfg.kv_page_dtype}"
              if overrides else "bf16")
    print(f"serve {tag} n_layer={cfg.n_layer} {dtypes} capacity={capacity}: "
          f"{len(reqs)} requests, prompts {lens}, {n_tokens} new tokens in "
          f"{wall:.3f} s = {n_tokens / wall:.1f} tokens/s [{card}]")
    print(f"serve {tag} TTFT ms: min {ttft[0]:.1f} median {ttft[len(ttft) // 2]:.1f} "
          f"max {ttft[-1]:.1f} [{card}]")
    print(f"serve {tag} prefill: {chunk_ms / 256:.4f} ms per token "
          f"(one 256-token chunk step, batch 1: {chunk_ms:.2f} ms) [{card}]")
    tick_ms = None
    if decode_ticks:
        dt = sorted(decode_ticks)
        tick_ms = dt[len(dt) // 2] * 1e3
        print(f"serve {tag} decode: {tick_ms:.2f} ms per tick (median of "
              f"{len(dt)} decode-only ticks, {eng.tokens_per_tick} sub-steps x "
              f"{capacity} slots) [{card}]")
    print(f"serve {tag} launches during the run: {launches}; greedy stream == "
          f"generate(): True" + ("; KV pages in use at the end: 0" if hybrid else ""))
    if hybrid and not overrides:
        hybrid_one_shot(params, cfg, dparams, prompts[3][:512], new, card)
    kv = eng.pool["state"].get("attn_blocks", ())
    kv_bytes = sum(t.numel() * t.element_size() for t in kv)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"serve {tag}: resident decode weights {param_bytes(dparams)} B, KV pool {kv_bytes} B, "
          f"peak device memory (max_memory_allocated, the weights' cast included) "
          f"{peak_gib:.2f} GiB [{card}]", flush=True)
    return dict(launches=launches, greedy=results[0].new_tokens.tolist(),
                streams=[r.new_tokens.tolist() for r in results],
                tokens_per_s=n_tokens / wall, ttft_ms=ttft[len(ttft) // 2],
                chunk_ms=chunk_ms, tick_ms=tick_ms, weight_bytes=param_bytes(dparams),
                kv_bytes=kv_bytes, peak_gib=peak_gib,
                **({"params": dparams} if keep_params else {}))


def serve_int8(bf16: dict, preset: str = "hybrid-280m", params=None,
               keep_params: bool = False) -> dict:
    """The int8 hybrid serving run of ``preset`` (int8 weights and int8 KV
    pages, the same requests; ``params`` as for ``serve``), against the
    bf16 run ``bf16`` of this call: the int8 branches of both paged
    kernels must launch; resident weight and KV pool bytes, the greedy
    agreement with bf16 (printed, not gated) and the serving numbers side
    by side."""
    card = smi()
    q8 = serve(preset, ("ssd_fwd", "ragged_decode_int8", "ragged_prefill_int8",
                        *NORM_SHAPES), params=params,
               keep_params=keep_params, kv_page_dtype="int8", serving_weight_dtype="int8")
    if q8["launches"]["ragged_decode"] or q8["launches"]["ragged_prefill"]:
        raise SystemExit(f"the int8 {preset} run launched a bf16 paged kernel")
    a, b = q8["greedy"], bf16["greedy"]
    agree = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
    print(f"serve {preset} int8 vs bf16: resident decode weights {q8['weight_bytes']} B vs "
          f"{bf16['weight_bytes']} B ({q8['weight_bytes'] / bf16['weight_bytes']:.3f}x), KV "
          f"pool {q8['kv_bytes']} B vs {bf16['kv_bytes']} B "
          f"({q8['kv_bytes'] / bf16['kv_bytes']:.3f}x) [{card}]")
    print(f"serve {preset} int8 vs bf16 greedy stream: first {agree} of {len(a)} tokens "
          f"agree (information, not gated)")
    for key in ("tokens_per_s", "ttft_ms", "chunk_ms", "tick_ms", "peak_gib"):
        print(f"serve {preset} {key}: int8 {q8[key]}, bf16 {bf16[key]} [{card}]")
    return q8


def serve_7b() -> tuple[dict, dict]:
    """hybrid-7b at full width and depth (32 layers, 4 of them attention
    with 32 query / 8 KV heads of 128, a gated MLP of 14336 after every
    mixer), bf16 and then int8 weights and KV pages, through ``serve``.
    The fp32 masters (35.5 GB) are made once on the card, quantized to
    int8 and cast to bf16 from there, then freed, so each run's engine,
    its ``generate()`` and its chunk step share one set of decode
    weights.  Returns the two runs' results."""
    import dataclasses

    from mamba_distributed_tpu_torch.config import get_preset
    from mamba_distributed_tpu_torch.models.lm import count_params, init_lm_params
    from mamba_distributed_tpu_torch.serving.prefill import cast_decode_params

    cfg = get_preset("hybrid-7b", ssm_impl="pallas", compute_dtype="bfloat16")
    masters = init_lm_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    n_params = count_params(masters)
    q8 = cast_decode_params(masters, dataclasses.replace(
        cfg, kv_page_dtype="int8", serving_weight_dtype="int8"))
    bf = cast_decode_params(masters, cfg)
    del masters
    torch.cuda.empty_cache()
    print(f"serve hybrid-7b: {n_params} parameters, fp32 masters freed after the int8 and bf16 "
          f"casts", flush=True)
    paged = ("ssd_fwd", "ragged_decode", "ragged_prefill")
    bf16 = serve("hybrid-7b", paged, params=bf)
    del bf
    torch.cuda.empty_cache()
    int8 = serve_int8(bf16, "hybrid-7b", params=q8)
    del q8
    torch.cuda.empty_cache()
    return bf16, int8


def hybrid_one_shot(params, cfg, dparams, prompt, new: int, card: str) -> None:
    """The hybrid one-shot prefill (the full-sequence attention through
    kernel 7, K/V packed into pages): its last-position logits against
    the chunked prefill's (two 256-token chunks through kernel 11) within
    the bf16 tolerance, then one greedy ``generate(length_bucketing=False)``."""
    from mamba_distributed_tpu_torch.inference.generate import generate
    from mamba_distributed_tpu_torch.models.lm import lm_prefill
    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
    from mamba_distributed_tpu_torch.serving.prefill import chunked_prefill

    ids = torch.from_numpy(prompt)[None]
    t = ids.shape[1]
    before = LAUNCHES["flash_fwd"]
    with torch.no_grad():
        one, _ = lm_prefill(dparams, cfg, ids.cuda(), max_len=t + new)
        chunked, _ = chunked_prefill(dparams, cfg, ids, max_len=t + new)
    err, rel = rel_err(one, chunked)
    out = generate(params, cfg, ids, seed=0, max_new_tokens=new, top_k=1,
                   length_bucketing=False)[0, t:]
    ran = LAUNCHES["flash_fwd"] - before
    print(f"serve {cfg.n_layer}-layer hybrid one-shot prefill ({t} tokens) vs chunked: last "
          f"logits max_abs_err={err:.3e} (rel {rel:.2e}), tol rel {TOL[torch.bfloat16]:.0e}; "
          f"greedy generate(length_bucketing=False) {out.tolist()[:8]}...; flash_fwd "
          f"launches {ran} [{card}]", flush=True)
    if rel > TOL[torch.bfloat16] or ran < 1 or not (0 <= int(out.min()) and
                                                    int(out.max()) < cfg.vocab_size):
        raise SystemExit("the hybrid one-shot prefill disagrees with the chunked one")


# ------------------------------------------------------------ training path


def mm_out_dtype_has_grad() -> str:
    """Whether autograd differentiates ``torch.mm(..., out_dtype=fp32)``
    (the serving head's fp32-logit GEMM, models/common.mm_f32)."""
    a = torch.randn((4, 8), device="cuda", dtype=torch.bfloat16, requires_grad=True)
    b = torch.randn((8, 4), device="cuda", dtype=torch.bfloat16)
    try:
        torch.mm(a, b, out_dtype=torch.float32).sum().backward()
    except (RuntimeError, NotImplementedError) as e:
        return f"no ({type(e).__name__}: {str(e).splitlines()[0][:120]})"
    return "yes"


def train_checks(card: str, preset: str = "mamba2-280m", gate_bf16_grads: bool = True,
                 **layers):
    """At 4 layers of ``preset``'s width (``layers`` overrides the layer
    fields, e.g. a hybrid's attention layers): one step's loss and
    gradients with ssm_impl and attn_impl "pallas" (the SSD Function,
    kernels 1-3, and the flash Function, kernels 7-9) against "xla"
    (autograd of the plain forwards), in fp32 (TF32 off) and bf16, same
    params and batch, the worst gradient leaf named; then ten AdamW steps
    on one repeated bf16 batch (warmup 1) must lower the loss.  With
    ``gate_bf16_grads`` off the bf16 gradients are printed, not gated
    (the loss still is): a MoE's top-k router is discontinuous, so where
    the two formulations round a near-tie token's router logits apart it
    takes another expert, and with a capacity the queue positions of the
    tokens after it move too."""
    from mamba_distributed_tpu_torch.config import get_preset, get_train_preset
    from mamba_distributed_tpu_torch.models.lm import init_lm_params
    from mamba_distributed_tpu_torch.training.optimizer import AdamW, tree_leaves, tree_map
    from mamba_distributed_tpu_torch.training.train_step import loss_and_grads, make_train_step

    gen = torch.Generator().manual_seed(5)
    vocab = min(50257, get_preset(preset).vocab_size)
    x = torch.randint(0, vocab, (1, 8, 1024), generator=gen).cuda()
    y = torch.randint(0, vocab, (1, 8, 1024), generator=gen).cuda()
    for dtype in ("float32", "bfloat16"):
        res = {}
        for impl in ("pallas", "xla"):
            model = get_preset(preset, n_layer=4, ssm_impl=impl, attn_impl=impl,
                               compute_dtype=dtype, **layers)
            cfg = get_train_preset(preset, model=model, micro_batch_size=8,
                                   total_batch_size=8 * 1024)
            params = tree_map(lambda t: t.requires_grad_(), init_lm_params(
                model, torch.Generator(device="cuda").manual_seed(11), device="cuda"))
            loss, grads = loss_and_grads(params, cfg, x, y)
            res[impl] = (float(loss), _named_leaves(grads))
        tol = TRAIN_TOL[getattr(torch, dtype)]
        loss_rel = abs(res["pallas"][0] - res["xla"][0]) / abs(res["xla"][0])
        grad_rel, leaf = max((rel_err(a, res["xla"][1][k])[1], k)
                             for k, a in res["pallas"][1].items())
        finite = all(bool(torch.isfinite(g).all()) for g in res["pallas"][1].values())
        gated = gate_bf16_grads or dtype == "float32"
        print(f"train check 4-layer {preset} {dtype} b=8 t=1024 {layers}: loss pallas "
              f"{res['pallas'][0]:.6f} xla {res['xla'][0]:.6f} (rel {loss_rel:.2e}), worst "
              f"grad leaf rel {grad_rel:.2e} ({leaf}{'' if gated else ', not gated'}), tol rel "
              f"{tol:.0e} [{card}]", flush=True)
        if not finite or loss_rel > tol or (gated and grad_rel > tol):
            raise SystemExit(f"pallas and xla train steps disagree ({dtype})")

    model = get_preset(preset, n_layer=4, ssm_impl="pallas", compute_dtype="bfloat16", **layers)
    cfg = get_train_preset(preset, model=model, micro_batch_size=8,
                           total_batch_size=8 * 1024, warmup_steps=1)
    params = tree_map(lambda t: t.requires_grad_(), init_lm_params(
        model, torch.Generator(device="cuda").manual_seed(12), device="cuda"))
    step = make_train_step(cfg, AdamW(cfg, params))
    losses = [float(step(params, x, y)[0]) for _ in range(10)]
    print(f"train check 4-layer {preset} bf16, one batch repeated, warmup 1: losses "
          + " ".join(f"{v:.4f}" for v in losses), flush=True)
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"the repeated-batch loss did not fall: {losses}")


def _named_leaves(tree, prefix: str = "") -> dict:
    """{dotted key: leaf} of a parameter-like tree."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _named_leaves(sub, f"{prefix}{key}.").items()}
    return {prefix[:-1]: tree}


def loss_peaks(card: str) -> None:
    """Where the loss's memory goes at hybrid-7b's 8-layer cut (b 4, t
    4096, bf16, pallas, remat): the peak device memory of one
    ``loss_and_grads`` (the forward, the loss and the backward; no
    optimizer) and of the loss's forward alone, with the dense and with
    the blocked loss, above the parameters' own bytes."""
    import dataclasses

    from mamba_distributed_tpu_torch.config import MeshConfig, get_preset, get_train_preset
    from mamba_distributed_tpu_torch.models.lm import init_lm_params, lm_loss
    from mamba_distributed_tpu_torch.training.optimizer import tree_map
    from mamba_distributed_tpu_torch.training.train_step import loss_and_grads

    model = get_preset("hybrid-7b", ssm_impl="pallas", compute_dtype="bfloat16", remat=True,
                       n_layer=8, attn_layer_idx=(3,))
    params = tree_map(lambda t: t.requires_grad_(), init_lm_params(
        model, torch.Generator(device="cuda").manual_seed(31), device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(32)
    x, y = (torch.randint(0, model.vocab_size, (1, 4, 4096), generator=gen, device="cuda")
            for _ in range(2))
    for impl in ("dense", "blocked"):
        m = dataclasses.replace(model, loss_impl=impl)
        # the preset's 64-rank mesh made one device: this is one card
        cfg = get_train_preset("hybrid-7b", model=m, micro_batch_size=4,
                               total_batch_size=4 * 4096, mesh=MeshConfig())
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = lm_loss(params, m, x[0], y[0])
        fwd = torch.cuda.max_memory_allocated() - base
        del loss
        torch.cuda.reset_peak_memory_stats()
        grads = loss_and_grads(params, cfg, x, y)[1]
        step = torch.cuda.max_memory_allocated() - base
        del grads
        print(f"train hybrid-7b 8 layers b=4 t=4096 {impl} loss: peak above the parameters "
              f"{fwd / 2**30:.2f} GiB for the forward and loss, {step / 2**30:.2f} GiB for "
              f"loss_and_grads (its gradients included; no optimizer); the parameters "
              f"{base / 2**30:.2f} GiB [{card}]", flush=True)
    del params
    torch.cuda.empty_cache()


def train_run(card: str, preset: str, path_kernels: tuple[str, ...], seq: int = 1024,
              micros: tuple[int, ...] = (32, 16), **model_fields) -> dict:
    """Full-width ``preset`` (full depth unless ``model_fields`` cut it;
    bf16, pallas, remat, and any other ``model_fields``, e.g. the remat
    policy or the loss) through the port's Trainer: 3 optimizer steps at
    ``seq`` and the first micro-batch of ``micros`` that fits, accum 1,
    with the validation at steps 0 and 2, on synthetic shards under
    build/chip_smoke/.  Every kernel in ``path_kernels`` must have
    launched.  Returns the run's launch counts, micro-batch, step ms and
    peak device memory."""
    import gc
    import shutil

    from mamba_distributed_tpu_torch.config import (
        DataConfig,
        MeshConfig,
        get_preset,
        get_train_preset,
    )
    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
    from mamba_distributed_tpu_torch.training import Trainer

    root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    shutil.rmtree(root / "log", ignore_errors=True)
    model = get_preset(preset, ssm_impl="pallas", compute_dtype="bfloat16", remat=True,
                       **model_fields)
    for micro in micros:
        # one process: a one-device mesh, whatever the preset's (hybrid-7b's
        # is fsdp 16 x seq 4)
        cfg = get_train_preset(
            preset, model=model, micro_batch_size=micro, total_batch_size=micro * seq,
            seq_len=seq, val_steps=2, log_dir=str(root / "log"), mesh=MeshConfig(),
            data=DataConfig(data_dir=str(root / "data"), synthetic_tokens_per_shard=1 << 20))
        # what earlier runs left to the cyclic collector goes before this
        # run's peak is taken
        gc.collect()
        torch.cuda.empty_cache()
        trainer = Trainer(cfg, device="cuda")
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        torch.cuda.reset_peak_memory_stats()
        try:
            trainer.run(max_steps=3)
        except torch.cuda.OutOfMemoryError:
            oom = True
        else:
            oom = False
        if oom:  # outside the handler: its traceback no longer holds the step's tensors
            print(f"train run: micro-batch {micro} does not fit in device memory; halving",
                  flush=True)
            trainer.finish()
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            continue
        break
    else:
        raise SystemExit(f"train run: micro-batch {micros[-1]} does not fit either")
    launches = dict(LAUNCHES)
    trainer.finish()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    hist = [trainer.history[s] for s in range(3)]
    del trainer
    if not all(math.isfinite(v) for h in hist for v in h):
        raise SystemExit(f"non-finite loss or grad norm: {hist}")
    for k in path_kernels:
        if launches[k] < 1:
            raise SystemExit(f"the {preset} train path launched no {k} kernel")
    recs = [json.loads(s) for s in (root / "log" / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in recs if r["kind"] == "train"]
    vals = [r["loss"] for r in recs if r["kind"] == "val"]
    tag = (f"{preset} n_layer={model.n_layer}"
           + "".join(f" {k}={v}" for k, v in model_fields.items() if k != "n_layer"))
    print(f"train {tag} bf16 pallas remat {model.remat_policy} loss {model.loss_impl} "
          f"micro={micro} seq={seq} accum=1: losses {[round(h[0], 6) for h in hist]}, grad "
          f"norms {[round(h[1], 4) for h in hist]}, val {vals}", flush=True)
    for r in steps:
        print(f"train {tag} step {r['step']}: {r['step_ms']} ms, {r['tokens_per_sec']} tokens/s, "
              f"MFU {r['mfu']} (model), {r.get('mfu_hw')} (hardware) [{card}]", flush=True)
    print(f"train {tag} peak device memory (max_memory_allocated): {peak_gb:.2f} GiB "
          f"[{card}]")
    print(f"train {tag} launches during the run: {launches}")
    torch.cuda.empty_cache()
    return dict(launches=launches, micro=micro, step_ms=[r["step_ms"] for r in steps],
                peak_gib=peak_gb)


def remat_checks(card: str) -> dict:
    """The remat policies on each 280m preset at full width and depth (64
    layers, bf16, pallas, micro-batch 4, seq 1024, one set of params):
    one train step's loss and gradients under "all", "dots", "mixer" and
    "all" again, each held to the first "all" (bit for bit, and otherwise
    no further off than the second "all" is), and the step's launches of
    the mixer cores' forward kernels: "mixer" must launch each once per
    mixer layer, "all" twice.  Returns {preset: {policy: launches}}."""
    import dataclasses

    from mamba_distributed_tpu_torch.config import get_preset, get_train_preset
    from mamba_distributed_tpu_torch.models.lm import init_lm_params
    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
    from mamba_distributed_tpu_torch.training.optimizer import tree_leaves, tree_map
    from mamba_distributed_tpu_torch.training.train_step import loss_and_grads

    cores = {"mamba2-280m": ("ssd_fwd",), "mamba1-280m": ("m1_scan",),
             "hybrid-280m": ("ssd_fwd", "flash_fwd")}
    out = {}
    for preset, kernels in cores.items():
        model = get_preset(preset, ssm_impl="pallas", compute_dtype="bfloat16", remat=True)
        n_attn = len(model.attn_layer_idx)
        layers = {"ssd_fwd": model.n_layer - n_attn, "m1_scan": model.n_layer,
                  "flash_fwd": n_attn}
        params = tree_map(lambda t: t.requires_grad_(), init_lm_params(
            model, torch.Generator(device="cuda").manual_seed(21), device="cuda"))
        gen = torch.Generator(device="cuda").manual_seed(22)
        x, y = (torch.randint(0, model.vocab_size, (1, 4, 1024), generator=gen, device="cuda")
                for _ in range(2))
        runs = []
        for policy in ("all", "dots", "mixer", "all"):
            cfg = get_train_preset(preset, model=dataclasses.replace(model, remat_policy=policy),
                                   micro_batch_size=4, total_batch_size=4 * 1024)
            for k in LAUNCHES:
                LAUNCHES[k] = 0
            torch.cuda.reset_peak_memory_stats()
            loss, grads = loss_and_grads(params, cfg, x, y)
            torch.cuda.synchronize()
            runs.append((policy, loss, tree_leaves(grads), {k: LAUNCHES[k] for k in kernels},
                        torch.cuda.max_memory_allocated() / 2**30))
        _, loss0, g0, _, _ = runs[0]
        diffs = []
        for policy, loss, g, launches, peak in runs[1:]:
            same = bool(torch.equal(loss, loss0)) and all(
                torch.equal(a, b) for a, b in zip(g, g0, strict=True))
            worst = max(rel_err(a, b)[1] for a, b in zip(g, g0, strict=True))
            diffs.append((policy, same, worst, abs(float(loss) - float(loss0))))
            print(f"remat {preset} {policy} vs all (64 layers, b=4 t=1024 bf16): loss "
                  f"{float(loss):.6f} vs {float(loss0):.6f}, bit-identical loss and gradients: "
                  f"{same}, worst gradient leaf rel {worst:.2e}; launches {launches}; step peak "
                  f"{peak:.2f} GiB [{card}]", flush=True)
        repeat = diffs[-1][2]  # "all" against itself
        for policy, same, worst, _ in diffs[:-1]:
            if not same and worst > repeat:
                raise SystemExit(f"remat {policy} gradients differ from all's (rel {worst:.3e}) "
                                 f"more than a second all run does ({repeat:.3e})")
        by_policy = {r[0]: r[3] for r in runs[:3]}
        for k in kernels:
            if (by_policy["mixer"][k] != layers[k] or by_policy["all"][k] != 2 * layers[k]
                    or by_policy["dots"][k] != 2 * layers[k]):
                raise SystemExit(f"remat {preset}: {k} launched {by_policy} in one step; "
                                 f"want {layers[k]} under mixer, {2 * layers[k]} otherwise")
        out[preset] = by_policy
        del params, grads, runs
        torch.cuda.empty_cache()
    return out


def check_7b_shapes(gen, rows: dict) -> None:
    """Rows 1-3 and 7-11 at hybrid-7b's shapes (d_inner 8192: 128 SSD
    heads of 64, d_state 128; attention 32 query / 8 KV heads of 128,
    GQA rep 4): ``ssd_fwd`` at the serving chunk (b 1, t 256, seeded) and
    the trainer's micro-batch (b 4, t 4096); ``ssd_chunk_states`` and
    ``ssd_bwd`` at b 4, t 4096; ``rpa_fwd`` over 8 slots and ``rpp_fwd``
    at the second chunk of a 700-token prompt (bf16 pages of 64); the
    flash kernels at b 4, t 4096.  Each is held against its plain
    version within the bf16 tolerance (flash at b 1 of the same inputs:
    the plain scores of b 4 would take 35 GB) and timed beside its bound,
    and the attention kernels beside SDPA; each result goes into its
    row's ``shapes`` list (``rows`` keyed by name) with ``path`` "serve"
    or "train", for the launches of the hybrid-7b runs."""
    from mamba_distributed_tpu_torch.ops.cuda import attention_kernels as ak
    from mamba_distributed_tpu_torch.ops.cuda import flash_kernels as fk
    from mamba_distributed_tpu_torch.ops.cuda import ssd_kernels as sk
    from mamba_distributed_tpu_torch.ops.cuda.flash_kernels import flash_work
    from mamba_distributed_tpu_torch.ops.ssd import chunk_log_decay, ssd_chunked, state_passing

    bf16, h, l = torch.bfloat16, 128, 256
    failures = []

    def add(name, path, shape, err, ms, plain_ms, nbytes, flops, library_ms=None, note=""):
        bound_ms, bound_by = bound(nbytes, flops)
        rel = err[1]
        lib = "" if library_ms is None else f", SDPA {library_ms:.4f} ms"
        print(f"time {name} hybrid-7b {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
              f"{note}{lib}, bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, {flops} FLOP); "
              f"max_abs_err={err[0]:.3e} (rel {rel:.2e}), tol rel {TOL[bf16]:.0e}", flush=True)
        if rel > TOL[bf16]:
            failures.append(f"{name} hybrid-7b {shape}: rel {rel:.3e}")
        rows[name].setdefault("shapes", []).append(dict(
            shape=f"hybrid-7b {shape}", path=path, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_ms, max_abs_err=err[0], launches=None))

    # the SSD forward, the chunk states and the backward
    for b, t, seeded in ((1, 256, True), (4, 4096, False)):
        inp = ssd_inputs(gen, b, t, 1, bf16, seeded, h=h)
        kw = dict(chunk_size=l, return_final_state=True, compute_dtype=bf16)
        yk, fk_ = sk.ssd_chunked_kernel(**inp, **kw)
        yp, fp = ssd_chunked(**inp, **kw)
        err = max(rel_err(yk, yp), rel_err(fk_, fp), key=lambda e: e[1])
        args = (inp["x"], inp["dt"], inp["A"], inp["B"], inp["C"], l, inp["initial_state"], bf16)
        ms = sum(device_ms(lambda: sk._ssd_fwd(*args), 20).values())
        plain_ms = cuda_ms(lambda: ssd_chunked(**inp, **kw), 3, 1)
        add("ssd_fwd", "serve" if b == 1 else "train",
            f"b={b} t={t} l={l} h={h} {'seeded' if seeded else 'unseeded'}", err, ms, plain_ms,
            *ssd_work(b, t, h, 1, 64, 128, l, bf16, seeded), note=" (device time)")
        del yk, fk_, yp, fp
    x, dt, A, B, C = (inp[k] for k in ("x", "dt", "A", "B", "C"))
    a4 = chunk_log_decay(dt, A, l)
    a_cum = a4.reshape(4, 4096, h).contiguous()
    st_k = sk.ssd_chunk_states_kernel(x, dt, a_cum, B, l, bf16)
    st_p = sk.ssd_chunk_states_plain(x, dt, a_cum, B, l, bf16)
    prev = state_passing(st_p, torch.exp(a4[:, :, -1]), None)[0].contiguous()
    dy = torch.randn((4, 4096, h, 64), generator=gen, device="cuda").to(bf16)
    bargs = (x, dt, a_cum, B, C, prev, dy, None, l, bf16)
    got, ref = sk.ssd_bwd_kernel(*bargs), sk.ssd_bwd_plain(*bargs)
    (b2, f2), (b3, f3) = ssd_bwd_work(4, 4096, h, 1, 64, 128, l, bf16, False, False)
    states = lambda: sk.ssd_chunk_states_kernel(x, dt, a_cum, B, l, bf16)  # noqa: E731
    add("ssd_chunk_states", "train", f"b=4 t=4096 l={l} h={h}", rel_err(st_k, st_p),
        sum(device_ms(states, 20).values()),
        cuda_ms(lambda: sk.ssd_chunk_states_plain(x, dt, a_cum, B, l, bf16), 3, 1), b2, f2,
        note=" (device time)")
    add("ssd_bwd", "train", f"b=4 t=4096 l={l} h={h}",
        max((rel_err(a, r) for a, r in zip(got, ref)), key=lambda e: e[1]),
        cuda_ms(lambda: sk.ssd_bwd_kernel(*bargs), 10),
        cuda_ms(lambda: sk.ssd_bwd_plain(*bargs), 2, 1), b3, f3)
    del inp, x, dt, A, B, C, a4, a_cum, st_k, st_p, prev, dy, bargs, got, ref
    torch.cuda.empty_cache()

    # the paged decode and chunk prefill: SDPA on the pre-gathered view
    nh, nkv, hd = 32, 8, 128
    lens = RPA_TIMED[-1]
    args = rpa_case(gen, 8, nh, nkv, hd, 64, 16, lens, bf16, False)
    q, kp, vp, tbl, kv_len = args
    err = rel_err(ak.ragged_paged_decode_attention(*args),
                  ak.ragged_paged_decode_attention_plain(*args))
    kk, vv = ak.gather_kv_pages(kp, vp, tbl, None, dtype=bf16)
    kk, vv = (v.transpose(1, 2).repeat_interleave(nh // nkv, dim=1).contiguous()
              for v in (kk, vv))
    mask = torch.arange(16 * 64, device="cuda") < kv_len.clamp(min=1)[:, None]
    sdpa = sum(device_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kk, vv, attn_mask=mask[:, None, None]), 50).values())
    add("rpa_fwd", "serve", f"S=8 nh={nh} nkv={nkv} hd={hd} kv_len={lens} "
        f"({ak.rpa_splits(8, nkv, 16)} splits)", err,
        sum(device_ms(lambda: ak.ragged_paged_decode_attention(*args), 50).values()),
        cuda_ms(lambda: ak.ragged_paged_decode_attention_plain(*args), 10), *rpa_work(args),
        library_ms=sdpa, note=" (device time, SDPA too)")
    args, real = rpp_case(gen, 1, 256, nh, nkv, 64, 16, [188], [256], bf16, False, hd=hd)
    q, kc, vc, kp, vp, tbl, ln, cr = args
    got = ak.ragged_paged_prefill_attention(q, kc, vc, kp.clone(), vp.clone(), tbl, ln, cr)[0]
    ref = ak.ragged_paged_prefill_attention_plain(q, kc, vc, kp.clone(), vp.clone(), tbl, ln,
                                                  cr)[0]
    kk, vv = ak.gather_kv_pages(kp, vp, tbl, None, dtype=bf16)
    kk, vv = (v[:, :444].transpose(1, 2).repeat_interleave(nh // nkv, dim=1).contiguous()
              for v in (kk, vv))
    qpos = 188 + torch.arange(256, device="cuda")
    mask = torch.arange(444, device="cuda")[None, :] <= qpos[:, None]
    sdpa = sum(device_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2).contiguous(), kk, vv, attn_mask=mask), 50).values())
    add("rpp_fwd", "serve", f"b=1 c=256 nh={nh} nkv={nkv} hd={hd} lengths=[188] "
        f"chunk_real=[256]", rel_err(got[real], ref[real]),
        sum(device_ms(lambda: ak.ragged_paged_prefill_attention(*args), 50).values()),
        cuda_ms(lambda: ak.ragged_paged_prefill_attention_plain(*args), 10), *rpp_work(args),
        library_ms=sdpa, note=" (device time, SDPA too)")
    del args, got, ref, kk, vv

    # the flash kernels at the trainer's micro-batch; the plain versions
    # and the error at b 1 of the same inputs
    b, t = 4, 4096
    qt, kt, vt, do = flash_inputs(gen, b, t, t, nh, nkv, hd, bf16)
    o_k, lse_k = fk.flash_fwd(qt, kt, vt, 0, t)
    one = (qt[:1], kt[:1], vt[:1])
    o_p, lse_p = fk.flash_fwd_plain(*one, 0, t)
    delta = (do.float() * o_k.float()).sum(-1).contiguous()
    bwd = (qt, kt, vt, do, lse_k, delta, 0, t)
    bwd1 = (*one, do[:1], lse_k[:1], delta[:1], 0, t)
    dq_k = fk.flash_bwd_dq(*bwd)
    dk_k, dv_k = fk.flash_bwd_dkv(*bwd)
    errs = {"flash_fwd": rel_err(o_k[:1], o_p),
            "flash_bwd_dq": rel_err(dq_k[:1], fk.flash_bwd_dq_plain(*bwd1)),
            "flash_bwd_dkv": max((rel_err(a[:1], r) for a, r in zip(
                (dk_k, dv_k), fk.flash_bwd_dkv_plain(*bwd1))), key=lambda e: e[1])}
    del o_p, lse_p, dq_k, dk_k, dv_k
    torch.cuda.empty_cache()
    qc, kc, vc = (v.contiguous().requires_grad_() for v in (qt, kt, vt))
    sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        qc, kc, vc, is_causal=True, enable_gqa=True), 10)
    out = F.scaled_dot_product_attention(qc, kc, vc, is_causal=True, enable_gqa=True)
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(out, (qc, kc, vc), do, retain_graph=True), 10)
    del out, qc, kc, vc
    timed = (("flash_fwd", lambda: fk.flash_fwd(qt, kt, vt, 0, t),
              lambda: fk.flash_fwd_plain(*one, 0, t), sdpa_fwd),
             ("flash_bwd_dq", lambda: fk.flash_bwd_dq(*bwd), lambda: fk.flash_bwd_dq_plain(*bwd1),
              sdpa_bwd),
             ("flash_bwd_dkv", lambda: fk.flash_bwd_dkv(*bwd),
              lambda: fk.flash_bwd_dkv_plain(*bwd1), sdpa_bwd))
    for (name, kern, plain, lib), work in zip(timed, flash_work(b, t, t, nh, nkv, hd, 0, bf16)):
        add(name, "train", f"b={b} t={t} nh={nh} nkv={nkv} hd={hd}", errs[name],
            cuda_ms(kern, 10), cuda_ms(plain, 2, 1), *work, library_ms=lib,
            note=" (plain at b=1; SDPA backward is dq, dk, dv together)")
    del qt, kt, vt, do, bwd, bwd1
    torch.cuda.empty_cache()
    if failures:
        raise SystemExit("hybrid-7b kernel shapes disagree with the plain versions:\n"
                         + "\n".join(failures))


# ------------------------------------------------------------ eval and import

REPO = Path(__file__).resolve().parent
HELLASWAG_TINY = REPO / "tests" / "data" / "hellaswag_tiny.jsonl"
# the eval's word-level tokenizer emits this many ids a word: 1 keeps the
# rows at one 32-token bucket, 6 and 18 stretch them to 96-288 tokens,
# where the SSD chunk (the largest divisor <= 256) is not a multiple of 64
EVAL_WORD_WIDTHS = (1, 6, 18)
# the toy GPT-2 merge table the CLIs read (the 256 byte symbols first)
TOY_MERGES = (("t", "h"), ("th", "e"), ("Ġ", "t"), ("Ġ", "a"), ("e", "r"), ("i", "n"),
              ("o", "n"), ("a", "n"), ("r", "e"), ("Ġ", "s"), ("e", "d"), ("Ġ", "w"))
EVAL_LINE = r"^(\d+) (\d+)/(\d+) (\d\.\d{4})$"


def word_encoder(width: int):
    """A word-level ``encode``: each space-separated word -> ``width``
    ids from its crc32, all below the GPT-2 vocab."""
    import zlib

    def encode(text: str) -> list[int]:
        out = []
        for word in text.split(" "):
            h = zlib.crc32(word.encode())
            out += [(h + 7919 * j) % 50000 + 1 for j in range(width)]
        return out
    return encode


def write_toy_bpe(directory: Path) -> str:
    """A GPT-2 BPE directory (encoder.json + vocab.bpe) of the 256 byte
    symbols and ``TOY_MERGES``, as the tokenizer tests build one."""
    from mamba_distributed_tpu_torch.data.gpt2_bpe import bytes_to_unicode

    b2u = bytes_to_unicode()
    vocab = {b2u[i]: i for i in range(256)}
    for a, b in TOY_MERGES:
        vocab.setdefault(a + b, len(vocab))
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "encoder.json").write_text(json.dumps(vocab), encoding="utf-8")
    (directory / "vocab.bpe").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in TOY_MERGES), encoding="utf-8")
    return str(directory)


def eval_forward(params, cfg):
    from mamba_distributed_tpu_torch.models.lm import lm_forward

    return lambda tokens: lm_forward(params, cfg, tokens)


def eval_preset(card: str, preset: str, path_kernels: tuple[str, ...]) -> set[int]:
    """``evaluate_hellaswag`` over the tiny HellaSwag file (16 examples,
    ``example_batch`` 8: R 32) on a seeded full-width ``preset`` cut to
    ``CUT_LAYERS`` layers (bf16) with "pallas"/"auto" and with "xla", at
    each word width; the logits (RMS error over RMS) and the per-row
    summed and mean losses of the two must agree at the bf16 tolerance,
    and the pallas run must launch every kernel of ``path_kernels`` (the
    xla run none but the norm kernels, which no impl knob selects).
    Returns the padded lengths."""
    import dataclasses

    from mamba_distributed_tpu_torch.config import get_preset
    from mamba_distributed_tpu_torch.eval import evaluate_hellaswag, iterate_examples
    from mamba_distributed_tpu_torch.eval.hellaswag import pack_batch, render_example, score_rows
    from mamba_distributed_tpu_torch.models.lm import init_lm_params
    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
    from mamba_distributed_tpu_torch.ops.dispatch import check_kernel_shapes
    from mamba_distributed_tpu_torch.ops.ssd import _divisor_chunk

    cfg = cut_layers(get_preset(preset, ssm_impl="pallas", compute_dtype="bfloat16"),
                     CUT_LAYERS)
    check_kernel_shapes(cfg)
    xla = dataclasses.replace(cfg, ssm_impl="xla", attn_impl="xla")
    params = init_lm_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    examples = list(iterate_examples(str(HELLASWAG_TINY)))
    fwd = {"pallas": eval_forward(params, cfg), "xla": eval_forward(params, xla)}
    tol = TOL[torch.bfloat16]
    lengths = set()
    for width in EVAL_WORD_WIDTHS:
        encode = word_encoder(width)
        batches = [[render_example(ex, encode) for ex in examples[i:i + 8]] for i in (0, 8)]
        packed = [pack_batch(b, 8) for b in batches]
        lens = [pt.shape[1] for pt, _ in packed]
        lengths.update(lens)
        chunks = [_divisor_chunk(n, cfg.chunk_size) for n in lens]
        results, launches, secs = {}, {}, {}
        for impl in ("pallas", "xla"):
            evaluate_hellaswag(fwd[impl], examples[:8], encode, example_batch=8,
                               device="cuda")  # warm-up
            torch.cuda.synchronize()
            for k in LAUNCHES:
                LAUNCHES[k] = 0
            t0 = time.perf_counter()
            results[impl] = evaluate_hellaswag(fwd[impl], examples, encode, limit=16,
                                               example_batch=8, device="cuda")
            torch.cuda.synchronize()
            secs[impl] = time.perf_counter() - t0
            launches[impl] = {k: v for k, v in LAUNCHES.items() if v}
        for k in path_kernels:
            if launches["pallas"].get(k, 0) < 1:
                raise SystemExit(f"the {preset} eval path launched no {k} kernel")
        # the norm kernels follow no impl knob (ops/dispatch.use_norm_kernel):
        # the xla run takes them too, and no other hand kernel
        xla_hand = {k: v for k, v in launches["xla"].items() if k not in NORM_SHAPES}
        if xla_hand:
            raise SystemExit(f"the {preset} xla eval launched hand kernels: {xla_hand}")
        # the logits and per-row losses of the two implementations on the
        # same batches: the losses sit near ln V with random weights, the
        # logits show what the mixers computed.  The logits are gated by
        # their RMS error over their RMS, a statistic of every element; the
        # largest element's error over the largest logit, one element of
        # up to 46M, is printed beside it
        worst, worst_rms, worst_max, agree = 0.0, 0.0, 0.0, [0, 0]
        for pt, pm in packed:
            t, m = torch.from_numpy(pt).cuda().long(), torch.from_numpy(pm).cuda()
            with torch.inference_mode():
                lp, lx = fwd["pallas"](t), fwd["xla"](t)
                worst_rms = max(worst_rms, float((lp.float() - lx.float()).norm()
                                                 / lx.float().norm()))
            worst_max = max(worst_max, rel_err(lp, lx)[1])
            sp, ap = score_rows(lambda _: lp, t, m)
            sx, ax = score_rows(lambda _: lx, t, m)
            del lp, lx
            for i, (p_, x_) in enumerate(((sp, sx), (ap, ax))):
                if not (torch.isfinite(p_).all() and torch.isfinite(x_).all()):
                    raise SystemExit(f"{preset} eval: non-finite row losses")
                worst = max(worst, float(((p_ - x_).abs() / x_.abs()).max()))
                agree[i] += int((p_.view(8, 4).argmin(1) == x_.view(8, 4).argmin(1)).sum())
        tokens = sum(32 * n for n in lens)
        print(f"eval {preset} n_layer={cfg.n_layer} bf16 words x{width}: padded lengths {lens}, "
              f"SSD chunks {chunks}, R=32; pallas {results['pallas']['num_correct_norm']}/16 "
              f"acc_norm, xla {results['xla']['num_correct_norm']}/16; pallas vs xla: logits "
              f"RMS rel err {worst_rms:.3e}, per-row losses rel err {worst:.3e} (tol {tol:.0e} "
              f"each), logits max rel err {worst_max:.3e} (printed); "
              f"argmin agreement sum {agree[0]}/16, "
              f"mean {agree[1]}/16 (not gated: random weights make near-ties); pallas "
              f"{16 / secs['pallas']:.2f} examples/s, {tokens / secs['pallas']:.0f} tokens/s "
              f"({secs['pallas'] * 1e3:.1f} ms), xla {16 / secs['xla']:.2f} examples/s "
              f"[{card}]; launches {launches['pallas']}", flush=True)
        if not (worst <= tol and worst_rms <= tol):
            raise SystemExit(f"{preset} eval: pallas vs xla, logits RMS rel err {worst_rms:.3e}, "
                             f"per-row losses rel err {worst:.3e} > {tol:.0e} at words x{width}")
    del params, fwd
    torch.cuda.empty_cache()
    return lengths


def check_eval_shapes(gen, lengths: set[int]) -> None:
    """The eval path's kernels at its own padded lengths, each against its
    plain version: ``ssd_fwd`` at mamba2-280m's widths (b 32, the chunk the
    largest divisor <= 256), ``flash_fwd`` at hybrid-280m's (b 32, tq = tk,
    12/4 heads of 64, bf16), ``m1_scan`` at mamba1-280m's (b 32, d 1536,
    fp32)."""
    from mamba_distributed_tpu_torch.ops.cuda import flash_kernels as fk
    from mamba_distributed_tpu_torch.ops.cuda import scan_kernels as sk
    from mamba_distributed_tpu_torch.ops.cuda import ssd_kernels
    from mamba_distributed_tpu_torch.ops.ssd import _divisor_chunk, ssd_chunked

    bf16, f32 = torch.bfloat16, torch.float32
    for t in sorted(lengths):
        inp = ssd_inputs(gen, 32, t, 1, bf16, False)
        kw = dict(chunk_size=256, return_final_state=True, compute_dtype=bf16)
        (yk, sk_), (yp, sp) = ssd_kernels.ssd_chunked_kernel(**inp, **kw), ssd_chunked(**inp, **kw)
        qt, kt, vt, _ = flash_inputs(gen, 32, t, t, 12, 4, 64, bf16)
        (ok_, lk), (op, lp) = fk.flash_fwd(qt, kt, vt, 0, t), fk.flash_fwd_plain(qt, kt, vt, 0, t)
        u, dt, A, B, C, h0 = m1_inputs(gen, 32, t, 1536, False)
        mk, mp = sk.m1_scan(u, dt, A, B, C, h0), sk.m1_scan_plain(u, dt, A, B, C, h0)
        torch.cuda.synchronize()
        errs = {"ssd_fwd y": (rel_err(yk, yp), TOL[bf16]), "ssd_fwd state": (rel_err(sk_, sp), TOL[bf16]),
                "flash_fwd o": (rel_err(ok_, op), TOL[bf16]), "flash_fwd lse": (rel_err(lk, lp), TOL[bf16]),
                "m1_scan y": (rel_err(mk[0], mp[0]), TOL[f32]),
                "m1_scan state": (rel_err(mk[1], mp[1]), TOL[f32])}
        route = "tensor cores" if ssd_kernels.ssd_uses_tensor_cores(bf16, 64, 128) else "CUDA cores"
        print(f"check eval shape t={t} b=32: ssd_fwd l={_divisor_chunk(t, 256)} ({route}), "
              f"flash_fwd tq=tk={t}, m1_scan fp32: rel "
              + ", ".join(f"{k} {e[1]:.2e} (tol {tl:.0e})" for k, (e, tl) in errs.items()),
              flush=True)
        bad = {k: e[1] for k, (e, tl) in errs.items() if not e[1] <= tl}
        if bad:
            raise SystemExit(f"eval shape t={t}: kernels disagree with their plain versions: {bad}")
    torch.cuda.empty_cache()


@contextlib.contextmanager
def path_launches(what: str, *kernels: str):
    """Zero the launch counts, run the body, then fail unless each of
    ``kernels`` launched; yields the dict of nonzero counts, filled on
    exit."""
    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES

    for k in LAUNCHES:
        LAUNCHES[k] = 0
    ran = {}
    yield ran
    ran.update({k: v for k, v in LAUNCHES.items() if v})
    missing = [k for k in kernels if not ran.get(k)]
    if missing:
        raise SystemExit(f"{what} launched no {missing} kernel: {ran}")


def run_cli(module: str, *args: str, timeout: int = 600) -> str:
    """``python -m module args`` from the checkout; its stdout, or the
    run fails."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO, capture_output=True,
                       text=True, timeout=timeout)
    if p.returncode != 0:
        raise SystemExit(f"{module} {' '.join(args)} exited {p.returncode}:\n"
                         f"{p.stdout[-4000:]}\n{p.stderr[-4000:]}")
    print(f"cli {module}: {time.perf_counter() - t0:.1f} s", flush=True)
    return p.stdout


def import_checks(card: str, root: Path) -> dict:
    """A ``MambaLMHeadModel``-named state dict of seeded mamba2-280m and
    hybrid-280m params (``hf_state_dict``), written as config.json +
    pytorch_model.bin and read back by ``models/hf.load_hf_checkpoint``
    onto the card: every tensor and the logits of a fixed batch
    bit-identical.  Returns the hybrid's directory, params and config."""
    import dataclasses

    from mamba_distributed_tpu_torch.config import get_preset
    from mamba_distributed_tpu_torch.models.hf import load_hf_checkpoint
    from mamba_distributed_tpu_torch.models.lm import init_lm_params, lm_forward

    out = {}
    for preset in ("mamba2-280m", "hybrid-280m"):
        cfg = get_preset(preset, ssm_impl="pallas", compute_dtype="bfloat16")
        params = init_lm_params(cfg, torch.Generator(device="cuda").manual_seed(3),
                                device="cuda")
        directory = root / preset
        directory.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        sd = {k: v.cpu() for k, v in hf_state_dict(params, cfg).items()}
        (directory / "config.json").write_text(json.dumps(hf_config_json(cfg)))
        torch.save(sd, str(directory / "pytorch_model.bin"))
        write_s = time.perf_counter() - t0
        nbytes = sum(v.numel() * v.element_size() for v in sd.values())
        del sd
        t0 = time.perf_counter()
        back, bcfg = load_hf_checkpoint(str(directory), device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        src, got = _named_leaves(params), _named_leaves(back)
        if sorted(src) != sorted(got):
            raise SystemExit(f"{preset} import: keys differ: {sorted(set(src) ^ set(got))}")
        differ = [k for k in src if not torch.equal(src[k], got[k])]
        if differ:
            raise SystemExit(f"{preset} import: tensors not bit-identical: {differ}")
        bcfg = dataclasses.replace(bcfg, ssm_impl="pallas", compute_dtype="bfloat16")
        ids = torch.randint(0, cfg.vocab_size, (4, 256),
                            generator=torch.Generator().manual_seed(4)).cuda()
        with torch.inference_mode():
            same = bool(torch.equal(lm_forward(params, cfg, ids), lm_forward(back, bcfg, ids)))
        print(f"import {preset}: {len(src)} tensors, {nbytes} B state dict; write "
              f"{write_s:.2f} s, load_hf_checkpoint onto the card {load_s:.2f} s; every tensor "
              f"bit-identical: True; logits (4, 256) bit-identical: {same} [{card}]", flush=True)
        if not same:
            raise SystemExit(f"{preset} import: logits differ from the source params'")
        out[preset] = dict(dir=str(directory), params=back, cfg=bcfg)
        del params
    torch.cuda.empty_cache()
    return out["hybrid-280m"]


def cli_checks(card: str, hybrid: dict, bpe: str, root: Path) -> None:
    """The eval and generation CLIs on the card, as subprocesses, against
    in-process runs on the same imported weights: the eval's counts and
    log line, the generated tokens."""
    import re

    import numpy as np

    from mamba_distributed_tpu_torch.data import native_bpe
    from mamba_distributed_tpu_torch.data.gpt2_bpe import GPT2BPE
    from mamba_distributed_tpu_torch.eval import evaluate_hellaswag, iterate_examples
    from mamba_distributed_tpu_torch.inference.generate import generate

    params, cfg = hybrid["params"], hybrid["cfg"]
    log = root / "cli_eval.txt"
    out = run_cli("mamba_distributed_tpu_torch.eval", "-m", "hugging_face", "--hf-path",
                  hybrid["dir"], "--data-file", str(HELLASWAG_TINY), "--bpe-dir", bpe,
                  "--log-file", str(log), "--device", "cuda")
    if f"tokenizer: GPT-2 BPE from {bpe}, merge loop native" not in out:
        raise SystemExit(f"the eval CLI did not tokenize with the native merge loop:\n{out}")
    if not native_bpe.available():
        raise SystemExit(f"native BPE unavailable: {native_bpe.unavailable_reason()}")
    bpe_tok = GPT2BPE.from_dir(bpe)
    with path_launches("the in-process eval", "ssd_fwd", "flash_fwd") as eval_launches:
        want = evaluate_hellaswag(eval_forward(params, cfg),
                                  iterate_examples(str(HELLASWAG_TINY)), bpe_tok.encode,
                                  log_path=str(root / "inproc_eval.txt"), device="cuda")
    line = log.read_text()
    if (not re.match(EVAL_LINE, line) or line != (root / "inproc_eval.txt").read_text()
            or out.strip().splitlines()[-1] != str(want)):
        raise SystemExit(f"eval CLI: log line {line!r} / result {out.strip().splitlines()[-1]} "
                         f"!= in-process {want}")
    lens = sorted({max(len(bpe_tok.encode(ex["ctx"])) + len(bpe_tok.encode(" " + e))
                       for e in ex["endings"]) for ex in iterate_examples(str(HELLASWAG_TINY))})
    print(f"cli eval hybrid-280m (toy GPT-2 BPE, merge loop native: {bpe_tok.uses_native}; "
          f"rows of {lens[0]}-{lens[-1]} tokens): log line {line!r} == the in-process run's "
          f"{want}; in-process launches {eval_launches} [{card}]", flush=True)

    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, 40).tolist()
    out = run_cli("mamba_distributed_tpu_torch.generate", "--hf-path", hybrid["dir"],
                  "--prompt-ids", ",".join(map(str, prompt)), "--seed", "42",
                  "--num-return", "2", "--max-new-tokens", "16", "--device", "cuda")
    with path_launches("the in-process generate()", "ssd_fwd", "ragged_prefill",
                       "ragged_decode") as gen_launches:
        rows = generate(params, cfg, torch.tensor([prompt] * 2), seed=42, max_new_tokens=16)
    want = [f"> tokens {row}" for row in rows.tolist()]
    if out.strip().splitlines() != want:
        raise SystemExit(f"generate CLI printed {out.strip().splitlines()}, in-process {want}")
    print(f"cli generate hybrid-280m --seed 42: 2 x 16 new tokens == the in-process "
          f"generate(); in-process launches {gen_launches} [{card}]", flush=True)


def parity_run(card: str, bpe: str, root: Path) -> None:
    """mamba2-mini through the Trainer (bf16, pallas) for 251 steps on the
    JAX package's synthetic shards (its generator, seed and layout), the
    loaders on the native reader, validation at 0 and 250; the
    fingerprint and 30-step strict comparisons against
    log_parity_cpu/log.txt gate, the 251-step strict one is printed; then
    the eval CLI with ``-m custom`` on the run's checkpoint."""
    import re
    import tempfile

    from mamba_distributed_tpu_torch.config import DataConfig, get_preset, get_train_preset
    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
    from mamba_distributed_tpu_torch.training import Trainer
    from mamba_distributed_tpu_torch.utils.parity import compare, compare_strict, parse_log_file

    with tempfile.TemporaryDirectory(dir=root) as tmp:
        tmp = Path(tmp)
        cfg = get_train_preset("mamba2-mini",
                               model=get_preset("mamba2-mini", ssm_impl="pallas"),
                               log_dir=str(tmp / "log"),
                               data=DataConfig(data_dir=str(tmp / "data")))
        t0 = time.perf_counter()
        trainer = Trainer(cfg, device="cuda", loader_backend="native")
        setup_s = time.perf_counter() - t0
        backends = (trainer.train_loader.backend, trainer.val_loader.backend)
        print(f"parity mamba2-mini: loaders settled on {backends[0]} (train), {backends[1]} "
              f"(val); set-up with the synthetic shards {setup_s:.1f} s", flush=True)
        if backends != ("native", "native"):
            raise SystemExit(f"parity run: loaders not on the native reader: {backends}")
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        t0 = time.perf_counter()
        # the 251 step lines go to a file, not into the run's output
        with open(tmp / "train_stdout.txt", "w") as out, contextlib.redirect_stdout(out):
            try:
                trainer.run(max_steps=251)
                trainer.save_checkpoint(str(tmp / "ckpt"))
            finally:
                trainer.finish()
        run_s = time.perf_counter() - t0
        launches = {k: v for k, v in LAUNCHES.items() if v}
        for k in ("ssd_fwd", "ssd_chunk_states", "ssd_bwd"):
            if launches.get(k, 0) < 1:
                raise SystemExit(f"the parity run launched no {k} kernel")
        recs = [json.loads(s) for s in (tmp / "log" / "metrics.jsonl").read_text().splitlines()]
        step_ms = sorted(r["step_ms"] for r in recs if r["kind"] == "train")
        ours = parse_log_file(str(tmp / "log" / "log.txt"))
        ref = parse_log_file(str(REPO / "log_parity_cpu" / "log.txt"))
        fp = compare(ours, ref, mode="fingerprint", steps=251)
        s30 = compare_strict(ours, ref, steps=30)
        s251 = compare_strict(ours, ref, steps=251)
        print(f"parity mamba2-mini bf16 pallas, 251 steps of {cfg.total_batch_size} tokens in "
              f"{run_s:.1f} s "
              f"(validation at 0 and 250 included): step ms median {step_ms[len(step_ms) // 2]}, "
              f"min {step_ms[0]}, max {step_ms[-1]}; val {ours['val']}; launches {launches} "
              f"[{card}]", flush=True)
        for res in (fp, s30, s251):
            print(res.report(), flush=True)
        print(f"parity gates: fingerprint(251) {fp.ok}, strict(30) {s30.ok}; strict(251) "
              f"{s251.ok} (printed, not gated)", flush=True)
        if not (fp.ok and s30.ok):
            raise SystemExit("parity run: the fingerprint or the 30-step strict comparison failed")
        log = tmp / "custom_eval.txt"
        run_cli("mamba_distributed_tpu_torch.eval", "-m", "custom", "--checkpoint",
                str(tmp / "ckpt"), "--preset", "mamba2-mini", "--data-file",
                str(HELLASWAG_TINY), "--bpe-dir", bpe, "--log-file", str(log),
                "--device", "cuda")
        line = log.read_text()
        if not re.match(EVAL_LINE, line) or not line.startswith("16 "):
            raise SystemExit(f"eval CLI -m custom: log line {line!r}")
        print(f"cli eval -m custom on the parity run's checkpoint: {line!r} [{card}]",
              flush=True)


def eval_and_import(card: str) -> None:
    """The phase after serving: eval at full width on the three 280m
    presets, the eval shapes' kernels, import, the CLIs, parity."""
    import shutil

    t0 = time.perf_counter()
    root = REPO / "build" / "chip_smoke" / "eval"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    lengths = set()
    for preset, kernels in (("mamba2-280m", ("ssd_fwd",)),
                            ("hybrid-280m", ("ssd_fwd", "flash_fwd")),
                            ("mamba1-280m", ("m1_scan",))):
        lengths |= eval_preset(card, preset, kernels)
    check_eval_shapes(torch.Generator(device="cuda").manual_seed(6), lengths)
    hybrid = import_checks(card, root)
    bpe = write_toy_bpe(root / "bpe")
    cli_checks(card, hybrid, bpe, root)
    del hybrid
    torch.cuda.empty_cache()
    parity_run(card, bpe, root)
    shutil.rmtree(root, ignore_errors=True)
    print(f"eval and import phase: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)

# ------------------------------------------------------------------ telemetry

def tele_train(card: str, tag: str, tele) -> dict:
    """Full-width, full-depth mamba2-280m (bf16, pallas, remat, seq 1024,
    micro-batch 32, accum 1, validation at steps 0 and 2) through the
    Trainer for 3 steps from seed 1337 with telemetry ``tele``, under
    ``torch.cuda.set_sync_debug_mode("warn")``.  Returns the history,
    the kernel launches, the count of synchronizing calls, the step ms
    and the span records."""
    import warnings

    from mamba_distributed_tpu_torch.config import DataConfig, get_preset, get_train_preset
    from mamba_distributed_tpu_torch.obs import load_jsonl
    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
    from mamba_distributed_tpu_torch.training import Trainer

    root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    model = get_preset("mamba2-280m", ssm_impl="pallas", compute_dtype="bfloat16", remat=True)
    cfg = get_train_preset(
        "mamba2-280m", model=model, micro_batch_size=32, total_batch_size=32 * 1024,
        seq_len=1024, val_steps=2, log_dir=str(root / "tele" / tag), telemetry=tele,
        data=DataConfig(data_dir=str(root / "data"), synthetic_tokens_per_shard=1 << 20))
    trainer = Trainer(cfg, device="cuda")
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            trainer.run(max_steps=3)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            trainer.finish()
    # each synchronizing call by the Python line that made it
    sites = collections.Counter(
        f"{Path(w.filename).parent.name}/{Path(w.filename).name}:{w.lineno}"
        for w in caught if "synchroniz" in str(w.message))
    out = dict(history=dict(trainer.history), launches={k: v for k, v in LAUNCHES.items() if v},
               syncs=sum(sites.values()), sites=sites,
               overflow=trainer.sentinel.overflow_count if trainer.sentinel else None)
    del trainer
    torch.cuda.empty_cache()
    log = Path(cfg.log_dir)
    out["step_ms"] = [r["step_ms"] for r in load_jsonl(str(log / "metrics.jsonl"))
                      if r["kind"] == "train"]
    events = log / "events.jsonl"
    out["spans"] = ([r for r in load_jsonl(str(events)) if r["kind"] == "span"]
                    if events.exists() else [])
    return out


def tele_training(card: str) -> dict:
    """Telemetry on the mamba2-280m step: 3 steps with spans, the sentinel
    and the overflow flag on, between two runs with all of them off from
    the same seed.  The losses and grad norms must equal the off run's bit
    for bit (or, if the two off runs differ, be no further from the first
    than the second is); the kernel launches and the synchronizing calls
    must be equal."""
    from mamba_distributed_tpu_torch.config import TelemetryConfig

    off = TelemetryConfig(spans=False, sentinel=False)
    on = TelemetryConfig(spans=True, sentinel=True, overflow_threshold=1.0)
    a = tele_train(card, "off_a", off)
    t = tele_train(card, "on", on)
    b = tele_train(card, "off_b", off)
    steps = sorted(a["history"])
    diff = lambda x, y: max(abs(u - v) for s in steps for u, v in zip(x[s], y[s]))
    noise = diff(a["history"], b["history"])
    moved = diff(a["history"], t["history"])
    print(f"telemetry train mamba2-280m: losses, grad norms off "
          f"{[a['history'][s] for s in steps]}, on {[t['history'][s] for s in steps]}; "
          f"max |on - off| {moved}, max |off - off| {noise} [{card}]", flush=True)
    if (noise == 0 and t["history"] != a["history"]) or moved > noise:
        raise SystemExit(f"telemetry moved the losses or grad norms by {moved} "
                         f"(two runs without it differ by {noise})")
    if not a["launches"] == t["launches"] == b["launches"]:
        raise SystemExit(f"telemetry changed the kernel launches: off {a['launches']}, "
                         f"on {t['launches']}, off {b['launches']}")
    print(f"telemetry train: kernel launches equal on and off {t['launches']}; "
          f"synchronizing calls over the 3 steps (set_sync_debug_mode warn): off "
          f"{a['syncs']}, on {t['syncs']}, off {b['syncs']}; by line: on "
          f"{dict(t['sites'])}; off runs beyond it {dict(a['sites'] - t['sites'])}, "
          f"{dict(b['sites'] - t['sites'])} [{card}]", flush=True)
    # the same rule as the losses': when the two runs without telemetry
    # differ (on the card the first of the three makes one more call),
    # the run with it may differ from neither by more
    spread = abs(a["syncs"] - b["syncs"])
    if max(abs(t["syncs"] - a["syncs"]), abs(t["syncs"] - b["syncs"])) > spread:
        raise SystemExit("telemetry changed the number of synchronizing calls")
    names = {r["name"] for r in t["spans"]}
    if not {"data_load", "train_step", "eval"} <= names:
        raise SystemExit(f"telemetry train: spans {sorted(names)}")
    for name in sorted(names):
        durs = sorted(r["dur_ms"] for r in t["spans"] if r["name"] == name)
        print(f"telemetry train span {name}: median {durs[len(durs) // 2]} ms of "
              f"{len(durs)} [{card}]")
    print(f"telemetry train step ms: on {t['step_ms']}, off {a['step_ms']} and "
          f"{b['step_ms']}; overflow flags (pre-clip norm > 1.0) {t['overflow']} of 3 "
          f"[{card}]", flush=True)
    return t


def _cut_cli_args(tmp: Path, tag: str) -> list[str]:
    """The CLI's flags for mamba2-280m at full width cut to 8 layers
    (seq 1024, micro-batch 8, accum 1) on the synthetic shards."""
    root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    return ["--preset", "mamba2-280m", "--n-layer", "8", "--seq-len", "1024",
            "--micro-batch-size", "8", "--total-batch-size", "8192",
            "--data-dir", str(root / "data"), "--log-dir", str(tmp / tag / "log"),
            "--checkpoint-dir", str(tmp / tag / "ckpt")]


def tele_divergence(card: str, tmp: Path) -> None:
    """A NaN on the card: the final norm's weight poisoned, the Trainer
    must raise ``DivergenceError`` at step 0 and leave a flight record
    whose reason starts "non-finite" and whose events hold ``train_step``
    and ``val``; then the CLI with ``--auto-restart 1`` over the same
    poisoning must re-raise it without a restart."""
    import io

    from mamba_distributed_tpu_torch import train as cli
    from mamba_distributed_tpu_torch.obs import DivergenceError
    from mamba_distributed_tpu_torch.training import trainer as trainer_mod

    args = cli.parse_args(_cut_cli_args(tmp, "div") + ["--max-steps", "2"])
    trainer = trainer_mod.Trainer(cli.build_config(args), device="cuda", verbose=False)
    with torch.no_grad():
        trainer.params["norm_f"]["weight"].fill_(float("nan"))
    try:
        trainer.run(max_steps=2)
        raise SystemExit("a NaN weight did not raise DivergenceError")
    except DivergenceError as e:
        err = str(e)
    finally:
        trainer.finish()
    del trainer
    doc = json.loads((tmp / "div" / "log" / "flight_record.json").read_text())
    kinds = {e["kind"] for e in doc["events"]}
    print(f"telemetry divergence: DivergenceError '{err}'; flight record reason "
          f"'{doc['reason']}', events {[e['kind'] for e in doc['events']]} [{card}]",
          flush=True)
    if "at step 0" not in err or not doc["reason"].startswith("non-finite") or not (
            {"train_step", "val"} <= kinds):
        raise SystemExit("telemetry divergence: wrong error or flight record")

    real = trainer_mod.init_lm_params

    def poisoned(*a, **k):
        params = real(*a, **k)
        params["norm_f"]["weight"].fill_(float("nan"))
        return params

    buf = io.StringIO()
    trainer_mod.init_lm_params = poisoned
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(_cut_cli_args(tmp, "div_cli") + ["--max-steps", "3", "--auto-restart", "1"])
        raise SystemExit("--auto-restart over a NaN weight did not raise")
    except DivergenceError as e:
        err = str(e)
    finally:
        trainer_mod.init_lm_params = real
    if "restart 1/1" in buf.getvalue() or "at step 0" not in err:
        raise SystemExit(f"--auto-restart retried a divergence:\n{buf.getvalue()}")
    print(f"telemetry divergence: --auto-restart 1 re-raised without a restart: '{err}'",
          flush=True)


def tele_recovery(card: str, tmp: Path) -> None:
    """``train.main`` with ``--checkpoint-every 2 --auto-restart 1`` over
    mamba2-280m cut to 8 layers, 5 steps, one step raising once at step
    3: it must restart once, resume from step 2, and give the step-4 loss
    of an uninterrupted run bit for bit, with the crashed trainer's device
    memory released before the rebuild and after the teardown."""
    import gc
    import io
    import re

    from mamba_distributed_tpu_torch import train as cli
    from mamba_distributed_tpu_torch.training import trainer as trainer_mod

    real = trainer_mod.make_train_step
    calls = [0]

    def faulty(*a, **k):
        step = real(*a, **k)

        def run_step(*xs):
            out = step(*xs)
            calls[0] += 1
            if calls[0] == 4:  # steps 0, 1, 2, then step 3 raises, once
                raise RuntimeError("injected fault at step 3")
            return out

        return run_step

    extra = ["--max-steps", "5", "--checkpoint-every", "2", "--auto-restart", "1"]
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    buf = io.StringIO()
    trainer_mod.make_train_step = faulty
    try:
        with contextlib.redirect_stdout(buf):
            hist = cli.main(_cut_cli_args(tmp, "crash") + extra)
    finally:
        trainer_mod.make_train_step = real
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    out = buf.getvalue()
    m = re.search(r"restart 1/1: device memory allocated before the rebuild (\d+) B", out)
    rebuild = int(m.group(1)) if m else None
    for line in out.splitlines():
        if "restart" in line or "resumed" in line or "crashed" in line:
            print(f"telemetry recovery: {line} [{card}]")
    with contextlib.redirect_stdout(io.StringIO()):
        hist0 = cli.main(_cut_cli_args(tmp, "whole") + extra)
    print(f"telemetry recovery: step-4 loss, grad norm {hist[4]} after the restart, "
          f"{hist0[4]} uninterrupted; device memory allocated before the first build "
          f"{before} B, before the rebuild {rebuild} B, after the teardown {after} B "
          f"[{card}]", flush=True)
    slack = 64 << 20
    if ("restart 1/1" not in out or "resumed from step 2" not in out or hist[4] != hist0[4]
            or rebuild is None or rebuild > before + slack or after > before + slack):
        raise SystemExit("telemetry recovery failed:\n" + out)


def tele_serve(card: str, preset: str, served: dict, tmp: Path, path_kernels, **overrides):
    """The serving run of ``serve(preset, **overrides)`` again (the same
    seeded weights and requests), with a ``ServingMetrics`` jsonl stream,
    a ``SpanTracer`` and an ``SLOMonitor``: every stream must equal the
    untraced run's (``served["streams"]``, whose greedy one equals
    ``generate()``'s); the tick records' ``tokens_emitted`` must sum to
    the events, each request record must carry its request's trace id,
    no page may leak, the int8 records must carry the dtype stamp and the
    resident bytes; the Chrome trace of the two streams must put every
    ``serving_tick`` slice inside the run's wall-clock window.  Prints
    the summary and the report's numbers."""
    from mamba_distributed_tpu_torch.config import get_preset
    from mamba_distributed_tpu_torch.models.lm import init_lm_params
    from mamba_distributed_tpu_torch.obs import (
        SLOMonitor,
        SpanTracer,
        export_chrome_trace,
        load_jsonl,
    )
    from mamba_distributed_tpu_torch.obs.report import build_report
    from mamba_distributed_tpu_torch.ops.quant import param_bytes
    from mamba_distributed_tpu_torch.serving import ServingEngine
    from mamba_distributed_tpu_torch.utils.metrics import ServingMetrics

    cfg = get_preset(preset, ssm_impl="pallas", compute_dtype="bfloat16", **overrides)
    tag = f"{preset}{' int8' if overrides else ''}"
    d = tmp / tag.replace(" ", "_")
    d.mkdir(parents=True, exist_ok=True)
    params = init_lm_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    _, _, requests = serving_mix(cfg, 32)
    wall0 = time.time()
    metrics = ServingMetrics(8, jsonl_path=str(d / "serving.jsonl"))
    tracer = SpanTracer(str(d / "events.jsonl"))
    slo = SLOMonitor(ttft_p95_ms=5000.0, itl_p95_ms=100.0, queue_wait_p95_ms=5000.0,
                     window=8, tracer=tracer)
    eng = ServingEngine(params, cfg, capacity=8, metrics=metrics, tracer=tracer, slo=slo)
    with path_launches(f"the traced {tag} serving run", *path_kernels) as ran:
        ids = [eng.submit(r) for r in requests()]
        traces = {t.request_id: t.trace_id for t in eng.scheduler}
        n_events = 0
        while eng.pending:
            n_events += len(eng.step())
    wall1 = time.time()
    streams = [eng.results[i].new_tokens.tolist() for i in ids]
    ticks = load_jsonl(str(d / "serving.jsonl"))
    reqs = [r for r in ticks if r["kind"] == "request"]
    ticks = [r for r in ticks if r["kind"] == "serving_tick"]
    fails = []
    if streams != served["streams"]:
        fails.append("streams differ from the untraced engine's")
    if sum(r["tokens_emitted"] for r in ticks) != n_events or n_events != 8 * 32:
        fails.append(f"tick records emit {sum(r['tokens_emitted'] for r in ticks)} tokens, "
                     f"events {n_events}")
    if sorted((r["request_id"], r["trace_id"]) for r in reqs) != sorted(traces.items()):
        fails.append("request records' trace ids")
    if eng.hybrid:
        if eng.page_pool.pages_in_use or (sum(r["kv_page_allocs"] for r in ticks)
                                          != sum(r["kv_page_frees"] for r in ticks)):
            fails.append("KV pages leaked")
    quant = [r for r in ticks if "quantized" in r]
    if overrides:
        pool = sum(t.numel() * t.element_size() for t in eng.pool["state"]["attn_blocks"])
        want = ({"weights": "int8", "kv": "int8"}, param_bytes(eng._params), pool)
        got = {(json.dumps(r["quantized"], sort_keys=True), r["weight_bytes"],
                r["page_pool_bytes"]) for r in quant}
        if len(quant) != len(ticks) or got != {(json.dumps(want[0], sort_keys=True),
                                                *want[1:])}:
            fails.append(f"int8 stamps {got}, want {want}")
        print(f"telemetry serve {tag}: every tick record stamps quantized {want[0]}, "
              f"weight_bytes {want[1]} (= ops/quant.param_bytes), page_pool_bytes {want[2]} "
              f"[{card}]")
    elif quant:
        fails.append("a bf16 engine stamped int8 fields")
    meta = export_chrome_trace([str(d / "events.jsonl"), str(d / "serving.jsonl")],
                               str(d / "trace.json"))
    doc = json.loads((d / "trace.json").read_text())
    slices = [e for e in doc["traceEvents"] if e.get("ph") == "X" and e["name"] == "serving_tick"]
    # 2 us: the header's and the records' rounding to the microsecond
    lo, hi = tracer.wall_t0 * 1e6 - 2, wall1 * 1e6 + 2
    outside = [e for e in slices if not (lo <= e["ts"] and e["ts"] + e["dur"] <= hi)]
    if len(slices) != len(ticks) or outside:
        fails.append(f"{len(outside)} of {len(slices)} serving_tick slices outside the run")
    s = metrics.summary()
    lat, good = s["latency"], s["goodput"]
    pct = lambda h: f"p50 {h['p50']} p95 {h['p95']} p99 {h['p99']}"
    print(f"telemetry serve {tag}: {s['ticks']} ticks, {s['finished_requests']} requests; "
          f"TTFT ms {pct(lat['ttft_ms'])}; ITL ms {pct(lat['itl_ms'])}; queue wait ms "
          f"{pct(lat['queue_wait_ms'])}; goodput {good['goodput_tokens_per_sec']} tokens/s, "
          f"useful fraction {good['useful_fraction']}, serving_mfu {good['serving_mfu']}; "
          f"SLO {slo.summary()['metrics']} [{card}]")
    rep = build_report(load_jsonl(str(d / "events.jsonl")) + ticks + reqs)
    sv, rq = rep["serving"], rep["requests"]
    spans = {k: (v["count"], v["mean_ms"]) for k, v in rep["spans"].items()}
    print(f"telemetry serve {tag} report: spans (count, mean ms) {spans}; decode "
          f"{sv['decode_tokens_per_sec']} tokens/s, tick ms {pct(sv['tick_ms'])}, kv pages "
          f"{sv['kv_pages']}, memory {sv['memory']}; requests {rq['count']}, queue wait ms "
          f"{pct(rq['queue_wait_ms'])}, TTFT ms {pct(rq['ttft_ms'])}, e2e ms "
          f"{pct(rq['e2e_ms'])}, ITL ms (merged) {pct(rq['itl_ms'])}; Chrome trace "
          f"{meta} [{card}]", flush=True)
    print(f"telemetry serve {tag}: launches {ran}; wall {wall1 - wall0:.3f} s [{card}]",
          flush=True)
    if fails:
        raise SystemExit(f"telemetry serve {tag}: {fails}")


def telemetry_phase(card: str, served: dict) -> None:
    """Telemetry and recovery on the card: the trainer's spans, sentinel
    and overflow flag on the mamba2-280m step; a NaN halting with a flight
    record and not restarted; ``--auto-restart`` resuming exactly with the
    memory released; the engines' metrics, spans and SLO monitor on
    mamba2-280m and bf16 and int8 hybrid-280m."""
    import shutil

    tmp = Path(__file__).resolve().parent / "build" / "chip_smoke" / "tele"
    shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    tele_training(card)
    tele_divergence(card, tmp)
    tele_recovery(card, tmp)
    torch.cuda.empty_cache()
    paged = ("ssd_fwd", "ragged_decode", "ragged_prefill")
    tele_serve(card, "mamba2-280m", served["mamba2-280m"], tmp, ("ssd_fwd",))
    tele_serve(card, "hybrid-280m", served["hybrid-280m"], tmp, paged)
    tele_serve(card, "hybrid-280m", served["hybrid-280m int8"], tmp,
               ("ssd_fwd", "ragged_decode_int8", "ragged_prefill_int8"),
               kv_page_dtype="int8", serving_weight_dtype="int8")
    print(f"telemetry phase: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)


# ------------------------------------------------ engine features (phase 3b)

FEATURE_INT8 = dict(kv_page_dtype="int8", serving_weight_dtype="int8")
FEATURE_NEW = (64, 8, 16, 8, 32, 8, 16, 8)  # the compaction mix's budgets
# a bf16 spec stream may part from the non-spec one only at a near tie:
# a top-two margin within the bf16 tolerance of the step's largest |logit|
# (the scale every bf16 check here is relative to)
MARGIN_TOL = TOL[torch.bfloat16]


# the depth of the engine features' runs (phase 3b's (a), (b) and the
# compaction run (c)), of the speculative and LoRA runs and of the eval
# phase's scorer runs: cut from 64 layers to keep the script under its
# limit with the parallel and serving mesh phases in it
CUT_LAYERS = 16


def cut_layers(cfg, layers: int | None):
    """``cfg`` cut to its first ``layers`` layers (its attention layers
    among them), or ``cfg`` itself for None."""
    import dataclasses

    if layers is None:
        return cfg
    return dataclasses.replace(cfg, n_layer=layers, attn_layer_idx=tuple(
        i for i in cfg.attn_layer_idx if i < layers))


def layer_prefix(dparams: dict, cfg) -> dict:
    """Decode weights of a deeper stack cut to ``cfg``'s layers: the
    first layers of every layer-stacked leaf (views)."""
    n_attn = len(cfg.attn_layer_idx)

    def head(tree, n):
        return {k: head(v, n) if isinstance(v, dict) else v[:n] for k, v in tree.items()}

    out = {**dparams, "blocks": head(dparams["blocks"], cfg.n_layer - n_attn)}
    if n_attn:
        out["attn_blocks"] = head(dparams["attn_blocks"], n_attn)
    return out


def feature_cfg(preset: str, layers: int | None = None, **overrides):
    from mamba_distributed_tpu_torch.config import get_preset

    return cut_layers(get_preset(preset, ssm_impl="pallas", compute_dtype="bfloat16",
                                 **overrides), layers)


def drive(eng, reqs, on_step=None) -> dict:
    """Submit ``reqs`` at once and step ``eng`` to the end (``on_step``
    after each step); returns the streams, the sorted TTFTs (ms) and the
    run's launch counts, zeroed just before it."""
    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES

    for k in LAUNCHES:
        LAUNCHES[k] = 0
    ids = [eng.submit(r) for r in reqs]
    tracked = {t.request_id: t for t in eng.scheduler}
    if on_step:
        on_step()
    while eng.pending:
        eng.step()
        if on_step:
            on_step()
    torch.cuda.synchronize()
    return dict(streams=[eng.results[i].new_tokens.tolist() for i in ids],
                ttft=sorted((tracked[i].t_first_token - tracked[i].t_submit) * 1e3 for i in ids),
                launches={k: v for k, v in LAUNCHES.items() if v})


def p50(xs):
    return round(sorted(xs)[len(xs) // 2], 1)


def page_bytes(eng, page: int) -> list:
    return [t[:, page].clone() for t in eng.pool["state"]["attn_blocks"]]


def shared_page_guard(eng, bad: list):
    """A callback that holds every page with more than one holder to the
    bytes it had when it became shared, while it stays shared: no slot
    may write a page another holder reads."""
    frozen = {}

    def check():
        pool = eng.page_pool
        for p in list(frozen):
            if pool.refcount(p) <= 1:
                del frozen[p]
            elif not all(torch.equal(a, b) for a, b in zip(page_bytes(eng, p), frozen[p])):
                bad.append(p)
                del frozen[p]
        for p in range(1, pool.num_pages + 1):
            if pool.refcount(p) > 1 and p not in frozen:
                frozen[p] = page_bytes(eng, p)

    return check


def prefix_run(card: str, tag: str, dparams, cfg) -> None:
    """Phase (a) on one preset: a 600-token preamble under four 100-token
    suffixes (700 tokens), two 356-token ones (956: congruent mod the
    256-token chunk, so they share the boundary keys; the deepest shared
    boundary ends at 444, mid-page) and two repeats of the first prompt,
    on a warm engine (the first prompt served once before) and a cold
    one.  Every stream bit for bit; hybrids copy at least one page, keep
    every shared page's bytes, and end with the cache's pins in use."""
    import dataclasses

    from mamba_distributed_tpu_torch.serving import GenerationRequest, ServingEngine

    gen = torch.Generator().manual_seed(3)
    draw = lambda n: torch.randint(0, cfg.vocab_size, (n,), generator=gen).numpy()
    pre = draw(600)
    tails = [draw(100) for _ in range(4)] + [draw(356) for _ in range(2)]
    prompts = [np.concatenate([pre, t]) for t in tails] + [np.concatenate([pre, tails[0]])] * 2

    def reqs():
        return [GenerationRequest(prompt_ids=p.copy(), max_new_tokens=32,
                                  top_k=1 if i == 0 else 50, seed=i)
                for i, p in enumerate(prompts)]

    cold = drive(ServingEngine(dparams, cfg, capacity=8), reqs())
    eng = ServingEngine(dparams, dataclasses.replace(cfg, prefix_cache_entries=64), capacity=8)
    eng.run([GenerationRequest(prompt_ids=prompts[0].copy(), max_new_tokens=32, top_k=50,
                               seed=100)])
    m = eng.metrics
    before = (m.prefix_full_hits, m.prefix_partial_hits, m.prefix_misses, m.prefix_saved_tokens)
    bad, guard, probe = [], None, None
    if eng.hybrid:
        guard = shared_page_guard(eng, bad)
        deep = next(e for e in eng.prefix_cache._entries.values() if e.kv_len == 444)
        probe = deep.kv_pages[0]
        probe_bytes = page_bytes(eng, probe)
    warm = drive(eng, reqs(), guard)
    full, part, miss, saved = (a - b for a, b in zip(
        (m.prefix_full_hits, m.prefix_partial_hits, m.prefix_misses, m.prefix_saved_tokens),
        before))
    prefill = "ragged_prefill_int8" if cfg.kv_quantized else "ragged_prefill"
    fails = []
    if warm["streams"] != cold["streams"]:
        fails.append("warm streams differ from cold ones")
    if (full, part, miss) != (3, 5, 0):
        fails.append(f"hits full {full}, partial {part}, misses {miss}: want 3, 5, 0")
    for k in ("ssd_fwd",) + ((prefill,) if eng.hybrid else ()):
        if not warm["launches"].get(k, 0) < cold["launches"].get(k, 0):
            fails.append(f"warm {k} launches {warm['launches'].get(k)} not below cold "
                         f"{cold['launches'].get(k)}")
    line = (f"prefix cache {tag}: full hits {full}, partial {part}, misses {miss}, saved "
            f"{saved} prompt tokens; TTFT p50 warm {p50(warm['ttft'])} ms, cold "
            f"{p50(cold['ttft'])} ms; launches warm {warm['launches']}, cold "
            f"{cold['launches']}; streams warm == cold: {warm['streams'] == cold['streams']}")
    if eng.hybrid:
        same = all(torch.equal(a, b) for a, b in zip(page_bytes(eng, probe), probe_bytes))
        pinned = {p for e in eng.prefix_cache._entries.values() for p in e.kv_pages}
        in_use = eng.page_pool.pages_in_use
        eng.prefix_cache.clear()
        line += (f"; CoW copies {eng.cow_copies}; shared page {probe} (boundary 444) bytes "
                 f"equal before and after the sharers: {same}; shared pages written: {bad}; "
                 f"pages in use at the end {in_use} (the cache pins {len(pinned)}), after "
                 f"clear() {eng.page_pool.pages_in_use}")
        if eng.cow_copies < 1 or not same or bad:
            fails.append(f"CoW {eng.cow_copies}, probe page equal {same}, written {bad}")
        if in_use != len(pinned) or eng.page_pool.pages_in_use:
            fails.append("pages leaked")
    print(f"{line} [{card}]", flush=True)
    if fails:
        raise SystemExit(f"prefix cache {tag}: {fails}")


def preempt_run(card: str, dparams, layers: int | None = None) -> None:
    """Phase (b): hybrid-280m at capacity 4 with four priority-0 requests
    (300-token prompts, 96 new tokens); once all four decode, two
    priority-1 requests (100 tokens, 32 new) arrive and must preempt,
    reach their first token before any priority-0 request finishes, and
    every stream must equal a uniform-priority engine's."""
    from mamba_distributed_tpu_torch.obs import SpanTracer
    from mamba_distributed_tpu_torch.serving import (
        GenerationRequest,
        RequestStatus,
        ServingEngine,
    )

    cfg = feature_cfg("hybrid-280m", layers)
    gen = torch.Generator().manual_seed(4)
    spec = [(300, 96, 0)] * 4 + [(100, 32, 1)] * 2
    prompts = [torch.randint(0, cfg.vocab_size, (t,), generator=gen).numpy() for t, _, _ in spec]

    def reqs(prioritized: bool):
        return [GenerationRequest(prompt_ids=p.copy(), max_new_tokens=n,
                                  top_k=1 if i == 0 else 50, seed=i,
                                  priority=prio if prioritized else None)
                for i, (p, (_, n, prio)) in enumerate(zip(prompts, spec))]

    uniform = drive(ServingEngine(dparams, cfg, capacity=4), reqs(False))
    tracer = SpanTracer(ring_len=8192)
    eng = ServingEngine(dparams, cfg, capacity=4, tracer=tracer)
    rs = reqs(True)
    ids = [eng.submit(r) for r in rs[:4]]
    while len(eng._slots) < 4 or any(t.status is not RequestStatus.DECODE
                                     for t in eng._slots.values()):
        eng.step()
    ids += [eng.submit(r) for r in rs[4:]]
    step, first, finish = 0, {}, {}
    while eng.pending:
        step += 1
        for ev in eng.step():
            first.setdefault(ev.request_id, step)
            if ev.done:
                finish[ev.request_id] = step
    torch.cuda.synchronize()
    streams = [eng.results[i].new_tokens.tolist() for i in ids]
    spans = [r for r in tracer.ring_pull()["records"] if r.get("kind") == "span"]
    swap = {n: [round(r["dur_ms"], 3) for r in spans if r["name"] == n]
            for n in ("serving_preempt", "serving_resume")}
    hi_first = max(first[i] for i in ids[4:])
    lo_finish = min(finish[i] for i in ids[:4])
    fails = []
    if eng.metrics.preemptions < 1:
        fails.append("no preemption")
    if not hi_first < lo_finish:
        fails.append(f"priority-1 first tokens by step {hi_first}, a priority-0 request "
                     f"finished at step {lo_finish}")
    if streams != uniform["streams"]:
        fails.append("streams differ from the uniform-priority engine's")
    if eng.page_pool.pages_in_use:
        fails.append(f"{eng.page_pool.pages_in_use} pages leaked")
    print(f"preemption hybrid-280m capacity 4: {eng.metrics.preemptions} preemptions; "
          f"priority-1 first tokens by step {hi_first}, first priority-0 finish at step "
          f"{lo_finish}; swap-out ms {swap['serving_preempt']}, swap-in ms "
          f"{swap['serving_resume']}; streams == uniform-priority engine: "
          f"{streams == uniform['streams']}; pages in use at the end "
          f"{eng.page_pool.pages_in_use} [{card}]", flush=True)
    if fails:
        raise SystemExit(f"preemption: {fails}")


def srpt_run(card: str, dparams, layers: int | None = None) -> None:
    """Phase (b), SRPT: mamba2-280m over the serving mix with
    ``prefill_schedule`` "rr" and "srpt": TTFT p50 side by side, streams
    equal."""
    from mamba_distributed_tpu_torch.serving import ServingEngine

    runs = {}
    for sched in ("rr", "srpt"):
        cfg = feature_cfg("mamba2-280m", layers, prefill_schedule=sched)
        runs[sched] = drive(ServingEngine(dparams, cfg, capacity=8), serving_mix(cfg, 32)[2]())
    same = runs["rr"]["streams"] == runs["srpt"]["streams"]
    print(f"prefill schedule mamba2-280m: TTFT p50 rr {p50(runs['rr']['ttft'])} ms, srpt "
          f"{p50(runs['srpt']['ttft'])} ms (all TTFTs rr {[round(x) for x in runs['rr']['ttft']]}"
          f", srpt {[round(x) for x in runs['srpt']['ttft']]}); streams equal: {same} [{card}]",
          flush=True)
    if not same:
        raise SystemExit("srpt streams differ from rr's")


def timed_ticks(eng, log: list) -> None:
    """Wrap the engine's two tick paths: each tick logs (lane width, live
    slots, device ms between CUDA events around it, launches in it)."""
    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES

    full, compact = eng._tick, eng._compact_tick

    def timed(fn, width, live, *args):
        n0 = dict(LAUNCHES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(live, *args)
        end.record()
        end.synchronize()
        log.append((width, len(live), start.elapsed_time(end),
                    {k: LAUNCHES[k] - n0[k] for k in LAUNCHES if LAUNCHES[k] - n0[k]}))
        return out

    eng._tick = lambda live, *rest: timed(full, eng.capacity, live, *rest)
    eng._compact_tick = lambda live, width, *rest: timed(compact, width, live, width, *rest)


def merge_states(states: list, logits: list):
    """Batch-1 decode states (and their last logits) stacked into one
    batch: the carries along the batch axis; a hybrid's private page
    pools side by side along the page axis, each row's table shifted to
    its own pool (its trash page included)."""
    merged = {"blocks": tuple(torch.cat(parts, dim=1)
                              for parts in zip(*(st["blocks"] for st in states)))}
    if "attn_meta" in states[0]:
        offsets = np.cumsum([0] + [st["attn_blocks"][0].shape[1] for st in states[:-1]])
        merged["attn_blocks"] = tuple(torch.cat(parts, dim=1) for parts in
                                      zip(*(st["attn_blocks"] for st in states)))
        merged["attn_meta"] = (
            torch.cat([st["attn_meta"][0] + int(o) for st, o in zip(states, offsets)]),
            torch.cat([st["attn_meta"][1] for st in states]))
    return merged, torch.cat(logits)


def greedy_margins(dparams, cfg, prompts, news, rows: int):
    """The greedy streams of ``prompts`` (``news[i]`` tokens each, at most
    ``rows`` prompts) decoded together at ``rows`` rows, each prompt
    prefilled alone as the engine prefills it: the full-width engine's
    streams, since every op of the decode step computes a row from that
    row alone at a fixed row count.  Returns, per prompt, (tokens, the
    top-two logit margin before each token, the largest |logit| there:
    the scale a relative tolerance applies to)."""
    from mamba_distributed_tpu_torch.inference.bucketing import (
        next_pow2_bucket,
        pad_to_bucket,
        use_chunked_prefill,
    )
    from mamba_distributed_tpu_torch.inference.generate import (
        _pad_rows,
        top_k_sample,
        vocab_pad_mask,
    )
    from mamba_distributed_tpu_torch.models.lm import lm_prefill, lm_step
    from mamba_distributed_tpu_torch.serving.prefill import chunked_prefill

    hybrid = bool(cfg.attn_layer_idx)
    states, firsts = [], []
    with torch.no_grad():
        for prompt, new in zip(prompts, news):
            t = len(prompt)
            ids = torch.as_tensor(prompt, dtype=torch.int64)[None]
            if hybrid or use_chunked_prefill(t, cfg.effective_prefill_chunk_tokens):
                logits, state = chunked_prefill(dparams, cfg, ids,
                                                max_len=t + new if hybrid else 0)
            else:
                padded, mask = pad_to_bucket(ids.cuda(), next_pow2_bucket(t))
                logits, state = lm_prefill(dparams, cfg, padded, token_mask=mask)
            states.append(state)
            firsts.append(logits)
        state, logits = _pad_rows(*merge_states(states, firsts), rows)
        pad = vocab_pad_mask(cfg, "cuda")
        ones = torch.ones((rows,), dtype=torch.int64, device="cuda")
        u = torch.full((rows,), 0.5, device="cuda")
        temp = torch.ones((rows,), device="cuda")
        steps, n = [], len(prompts)
        for i in range(max(news)):
            top2 = torch.topk((logits + pad)[:n], 2).values
            peak = logits[:n, :cfg.vocab_size].abs().amax(dim=-1)
            tok = top_k_sample(logits + pad, u, 1, temp, ones)
            steps.append(torch.stack([tok[:n].double(), (top2[:, 0] - top2[:, 1]).double(),
                                      peak.double()]))
            if i + 1 < max(news):
                logits, state = lm_step(dparams, cfg, state, tok)
        table = torch.stack(steps).cpu().numpy()  # (steps, 3, n)
    return [([int(x) for x in table[:new, 0, r]], table[:new, 1, r].tolist(),
             table[:new, 2, r].tolist()) for r, new in enumerate(news)]


def compaction_run(card: str, tag: str, dparams, cfg) -> None:
    """Phase (c) on one preset: the serving mix with budgets 64, 8, 16, 8,
    32, 8, 16, 8 (occupancy falls from 8 to 1), every request greedy,
    compaction on against off.  Every stream must be equal: a compacted
    tick computes each live row as the full tick does (the norms are
    row-count invariant kernels, ``compaction_kernels`` holds every
    row-wise op to that).  A stream that parts fails the run, printed with
    the step and the full-width top-two margin where it parts; hybrids
    must launch ``rpa_fwd`` at widths below 8."""
    import dataclasses

    from mamba_distributed_tpu_torch.serving import GenerationRequest, ServingEngine
    from mamba_distributed_tpu_torch.utils.metrics import ServingMetrics

    _, prompts, _ = serving_mix(cfg, 1)

    def reqs():
        return [GenerationRequest(prompt_ids=p.copy(), max_new_tokens=n, top_k=1, seed=i)
                for i, (p, n) in enumerate(zip(prompts, FEATURE_NEW))]

    logs, runs, engines = {}, {}, {}
    for on in (False, True):
        eng = ServingEngine(dparams, dataclasses.replace(cfg, tick_compaction=on), capacity=8,
                            metrics=ServingMetrics(8))
        logs[on] = []
        timed_ticks(eng, logs[on])
        runs[on], engines[on] = drive(eng, reqs()), eng
    decode = "ragged_decode_int8" if cfg.kv_quantized else "ragged_decode"
    fails, parted = [], []
    for i, (a, b) in enumerate(zip(runs[False]["streams"], runs[True]["streams"])):
        if a == b:
            continue
        k = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        ((toks, margins, _),) = greedy_margins(dparams, cfg, [prompts[i]], [FEATURE_NEW[i]], 8)
        parted.append((i, k, round(margins[k], 5)))
        fails.append(f"request {i} parts at step {k} (full-width top-two margin "
                     f"{margins[k]:.5f}; the full-width reference reproduces the uncompacted "
                     f"stream: {toks == a})")
    by_width = collections.defaultdict(list)
    full_at = collections.defaultdict(list)
    for width, live, ms, _ in logs[True]:
        by_width[width].append((live, ms))
    for _, live, ms, _ in logs[False]:
        full_at[live].append(ms)
    timing = {}
    for width, entries in sorted(by_width.items()):
        lives = sorted({live for live, _ in entries})
        ref = [ms for live in lives for ms in full_at.get(live, [])]
        timing[width] = (round(sum(ms for _, ms in entries) / len(entries), 3),
                         round(sum(ref) / len(ref), 3) if ref else None, lives)
    narrow_rpa = sum(l.get(decode, 0) for w, _, _, l in logs[True] if w < 8)
    if engines[True].hybrid and not narrow_rpa:
        fails.append(f"no {decode} launch at a width below 8")
    comp = engines[True].metrics.summary()["compaction"]
    print(f"compaction {tag}: streams equal {len(prompts) - len(parted)} of {len(prompts)}; "
          f"parted (request, first step, full-width top-two margin) {parted}; bucket histogram "
          f"{comp['bucket_histogram']}, lanes saved {comp['lanes_saved']}; device ms a tick by "
          f"width (compacted, full tick at the same live counts, live counts) {timing}; "
          f"{decode} launches on {runs[True]['launches'].get(decode, 0)} (at widths below 8: "
          f"{narrow_rpa}), off {runs[False]['launches'].get(decode, 0)} [{card}]", flush=True)
    if fails:
        raise SystemExit(f"compaction {tag}: {fails}")


ROW_TRIALS = 32  # random 8-row batches a row-count probe takes


def compaction_kernels(card: str, dparams, cfg) -> None:
    """What the row count does on the card: each of hybrid-280m's decode
    GEMMs (bf16, through ``models/common.linear`` and the LM head) and
    the other row-wise ops of its Mamba-2 decode step (the norms, the
    conv update, the SSM update) over ``ROW_TRIALS`` random 8-row batches:
    how many rows of the first 1, 2 and 4 rows, called alone, differ from
    the same rows of the 8-row call, which must be none for the two norm
    kernels; and ``rpa_fwd`` at 2 and 4 rows with its split rule pinned
    to 8 rows (the compacted tick's) against its own, device ms each."""
    from mamba_distributed_tpu_torch.models.common import linear
    from mamba_distributed_tpu_torch.models.lm import _head_logits
    from mamba_distributed_tpu_torch.ops.conv import causal_conv1d_update
    from mamba_distributed_tpu_torch.ops.cuda import attention_kernels as ak
    from mamba_distributed_tpu_torch.ops.norm import add_rms_norm, rms_norm_gated
    from mamba_distributed_tpu_torch.ops.ssd import ssd_state_update

    gen = torch.Generator(device="cuda").manual_seed(5)
    blocks, attn = dparams["blocks"], dparams["attn_blocks"]
    mix = {k: v[0] for k, v in blocks["mixer"].items() if not isinstance(v, dict)}
    conv = blocks["mixer"]["conv"]
    layer = lambda p: {k: v[0] for k, v in p.items()}
    nh, hp, ns, cd = cfg.nheads, cfg.headdim, cfg.effective_d_state, conv["kernel"].shape[1]
    bf = torch.bfloat16
    rnd = lambda *shape, dtype=torch.float32: torch.randn(
        shape, generator=gen, device="cuda").to(dtype)
    # name -> (the op, the shapes and dtypes of its row-major inputs)
    sites = {
        "mamba in_proj": (lambda x: linear(layer(blocks["mixer"]["in_proj"]), x, bf),
                          [((cfg.d_model,), bf)]),
        "mamba out_proj": (lambda x: linear(layer(blocks["mixer"]["out_proj"]), x, bf),
                           [((cfg.d_inner,), bf)]),
        "attention wqkv": (lambda x: linear(layer(attn["mixer"]["wqkv"]), x, bf),
                           [((cfg.d_model,), bf)]),
        "attention out_proj": (lambda x: linear(layer(attn["mixer"]["out_proj"]), x, bf),
                               [((cfg.d_model,), bf)]),
        "head": (lambda x: _head_logits(dparams, cfg, x), [((cfg.d_model,), bf)]),
        "add_rms_norm": (lambda h, r: add_rms_norm(h, r, blocks["norm"]["weight"][0]),
                         [((cfg.d_model,), bf), ((cfg.d_model,), torch.float32)]),
        "rms_norm_gated": (lambda y, z: rms_norm_gated(y, z, blocks["mixer"]["norm"]["weight"][0]),
                           [((cfg.d_inner,), bf), ((cfg.d_inner,), bf)]),
        "causal_conv1d_update": (
            lambda xt, st: causal_conv1d_update(xt, st.clone(), conv["kernel"][0],
                                                conv.get("bias", [None])[0]),
            [((cd,), bf), ((cfg.d_conv - 1, cd), bf)]),
        "ssd_state_update": (
            lambda st, xt, dt, bt, ct: ssd_state_update(
                st, xt, dt, -torch.exp(mix["A_log"].float()), bt, ct, mix.get("D"),
                dt_bias=mix["dt_bias"]),
            [((nh, hp, ns), torch.float32), ((nh, hp), bf), ((nh,), torch.float32),
             ((cfg.ngroups, ns), bf), ((cfg.ngroups, ns), bf)]),
    }
    flat = lambda out: out if isinstance(out, tuple) else (out,)
    rows = {}
    with torch.no_grad():
        for name, (fn, shapes) in sites.items():
            differ = {1: 0, 2: 0, 4: 0}
            for _ in range(ROW_TRIALS):
                inputs = [rnd(8, *shape, dtype=dtype) for shape, dtype in shapes]
                ref = flat(fn(*inputs))
                for w in differ:
                    got = flat(fn(*(t[:w] for t in inputs)))
                    differ[w] += sum(not all(torch.equal(a[r], b[r]) for a, b in zip(got, ref))
                                     for r in range(w))
            rows[name] = differ
    split = {}
    lens = [700, 300, 956, 120]
    for w in (2, 4):
        args = rpa_case(gen, w, 12, 4, 64, 64, 16, lens[:w], torch.bfloat16, False)
        pinned = sum(device_ms(lambda: ak.ragged_paged_decode_attention(
            *args, split_rows=8)).values())
        own = sum(device_ms(lambda: ak.ragged_paged_decode_attention(*args)).values())
        same = torch.equal(ak.ragged_paged_decode_attention(*args, split_rows=8),
                           ak.ragged_paged_decode_attention(*args))
        split[w] = (round(pinned, 4), round(own, 4), ak.rpa_splits(8, 4, 16),
                    ak.rpa_splits(w, 4, 16), same)
    print(f"compaction rows on the card, hybrid-280m bf16: rows that differ from the 8-row "
          f"call's over {ROW_TRIALS} random batches (of {ROW_TRIALS}, {2 * ROW_TRIALS} and "
          f"{4 * ROW_TRIALS} rows at widths 1, 2, 4) {rows}; rpa_fwd device ms at (lanes: split "
          f"pinned to 8 rows, own split, splits pinned, splits own, outputs equal) {split} "
          f"[{card}]", flush=True)
    bad = {k: rows[k] for k in NORM_SHAPES if any(rows[k].values())}
    if bad:
        raise SystemExit(f"the norm kernels depend on the row count: {bad}")


def engine_features_phase(card: str, params: dict) -> None:
    """The admission and occupancy features on the card at full width
    (phase 3b), on the first ``CUT_LAYERS`` layers of the decode weights
    the serving phase cast (``params``: preset tag -> weights): the prefix
    cache (a), priorities, preemption and SRPT grants (b), compacted ticks
    (c); the norm tick and the row-count probes at full depth."""
    t0 = time.perf_counter()
    presets = (("mamba2-280m", "mamba2-280m", {}), ("hybrid-280m", "hybrid-280m", {}),
               ("hybrid-280m int8", "hybrid-280m", FEATURE_INT8))
    print(f"engine features (a), (b) and (c): depth cut from 64 to {CUT_LAYERS} layers (their "
          f"first {CUT_LAYERS} layers' weights), full width", flush=True)
    cut = {tag: feature_cfg(preset, CUT_LAYERS, **over) for tag, preset, over in presets}
    for tag, _, _ in presets:
        prefix_run(card, tag, layer_prefix(params[tag], cut[tag]), cut[tag])
    preempt_run(card, layer_prefix(params["hybrid-280m"], cut["hybrid-280m"]), CUT_LAYERS)
    srpt_run(card, layer_prefix(params["mamba2-280m"], cut["mamba2-280m"]), CUT_LAYERS)
    norm_tick(card, params["hybrid-280m"], feature_cfg("hybrid-280m"))
    compaction_kernels(card, params["hybrid-280m"], feature_cfg("hybrid-280m"))
    # (c) on the first CUT_LAYERS layers too, to leave the serving mesh phase
    # room under the script's limit
    for tag, _, _ in presets:
        compaction_run(card, tag, layer_prefix(params[tag], cut[tag]), cut[tag])
    print(f"engine features phase: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)


# ------------------------------------- norm kernels in the decode step

@contextlib.contextmanager
def plain_norms():
    """Route ``ops/norm.py`` to its plain expressions on the card for the
    block: a measurement of what the norm kernels replace."""
    from mamba_distributed_tpu_torch.ops import norm

    saved = norm.use_norm_kernel
    norm.use_norm_kernel = lambda *tensors: False
    try:
        yield
    finally:
        norm.use_norm_kernel = saved


def kernel_events(fn) -> int:
    """CUDA kernels one call of ``fn`` runs, by ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def decode_state(cfg, rows: int, cached: int, width: int):
    """A decode state of ``rows`` rows with ``cached`` tokens a row: zero
    carries and, for a hybrid, an identity-paged private cache of
    ``width`` pages a row at that length."""
    from mamba_distributed_tpu_torch.models.lm import init_lm_state

    st = init_lm_state(cfg, rows, max_len=width * cfg.kv_page_tokens if cfg.attn_layer_idx
                       else 0, device="cuda")
    if cfg.attn_layer_idx:
        st["attn_meta"] = (st["attn_meta"][0],
                           torch.full((rows,), cached, dtype=torch.int32, device="cuda"))
    return st


def norm_tick(card: str, dparams, cfg) -> None:
    """hybrid-280m's decode sub-step at 8 rows (300 cached tokens a row)
    with the norm kernels and with the plain norms: the CUDA kernels it
    runs (profile), the norm kernels' launches in it, and its device ms
    and event ms a sub-step.  A record of what the launches saved, not a
    claim."""
    from mamba_distributed_tpu_torch.models.lm import lm_step
    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES

    st = decode_state(cfg, 8, 300, cfg.kv_pages_per_slot)
    tok = torch.randint(0, cfg.vocab_size, (8,), device="cuda")
    step = lambda: lm_step(dparams, cfg, st, tok)  # noqa: E731
    out = {}
    with torch.no_grad():
        n0 = {k: LAUNCHES[k] for k in NORM_SHAPES}
        step()
        norm_launches = {k: LAUNCHES[k] - n0[k] for k in NORM_SHAPES}
        for route in ("kernels", "plain"):
            with plain_norms() if route == "plain" else contextlib.nullcontext():
                out[route] = (kernel_events(step), sum(device_ms(step, 10).values()),
                              cuda_ms(step, 10))
    (ek, dk, ck), (ep, dp, cp) = out["kernels"], out["plain"]
    print(f"norm kernels in hybrid-280m's decode sub-step (8 rows, bf16): norm launches "
          f"{norm_launches}; CUDA kernels a sub-step {ek} with the norm kernels, {ep} with the "
          f"plain norms ({ep - ek} fewer); device ms a sub-step {dk:.4f} vs {dp:.4f}, event ms "
          f"{ck:.4f} vs {cp:.4f}; a decode tick of {8} sub-steps {8 * ck:.3f} vs {8 * cp:.3f} "
          f"ms by the event timer [{card}]", flush=True)


# -------------------------------------------- speculative decoding (3c)

SPEC_PRESETS = (("mamba2-280m", "mamba2-280m", {}), ("hybrid-280m", "hybrid-280m", {}),
                ("hybrid-280m int8", "hybrid-280m", FEATURE_INT8),
                ("mamba1-280m", "mamba1-280m", {}))
SPEC_NEW = 32  # new tokens a request of the serving mix
REPEAT = (32, 256, 64)  # the repetitive mix: pattern, prompt and new tokens


def spec_traffic(cfg, mix: str):
    """(prompts, budgets) of a speculative run, 8 requests: "serving" is
    the serving mix's prompts (12, 100, 300 and 700 tokens, twice) with
    ``SPEC_NEW`` new tokens each; "repetitive" is 8 prompts of a seeded
    32-token pattern tiled to 256 tokens, 64 new tokens each (code-like
    text, where the n-gram drafter is strong)."""
    if mix == "serving":
        _, prompts, _ = serving_mix(cfg, SPEC_NEW)
        return prompts, [SPEC_NEW] * len(prompts)
    pat, length, new = REPEAT
    g = torch.Generator().manual_seed(2)
    prompts = [np.tile(torch.randint(0, cfg.vocab_size, (pat,), generator=g).numpy(),
                       length // pat) for _ in range(8)]
    return prompts, [new] * len(prompts)


def verify_check(dparams, cfg, prompts) -> dict:
    """One verify launch against K+1 decode sub-steps from the same state:
    8 rows prefilled with ``prompts`` (256 tokens each; a hybrid's table
    at the spec engine's width), then K+1 seeded tokens a row fed as one
    ``spec_verify`` and as K+1 ``lm_step`` calls.  Returns the largest
    |verify logit - step logit| over the positions, relative to the
    steps' largest |logit| (the chunk-versus-step rounding the
    speculative streams ride on), and the device and event ms of the
    launch and of the K+1 sub-steps."""
    from mamba_distributed_tpu_torch.models.lm import lm_prefill, lm_step, lm_verify_chunk
    from mamba_distributed_tpu_torch.serving import spec_decode
    from mamba_distributed_tpu_torch.serving.prefill import chunked_prefill

    W = SPEC_K + 1
    ids = torch.as_tensor(np.stack(prompts[:8]), dtype=torch.int64)
    with torch.no_grad():
        if cfg.attn_layer_idx:
            _, st = chunked_prefill(dparams, cfg, ids, max_len=spec_decode.spec_page_len(
                cfg, ids.shape[1] + W))
        else:
            _, st = lm_prefill(dparams, cfg, ids.cuda())
        feed = torch.randint(0, cfg.vocab_size, (8, W), generator=torch.Generator().manual_seed(4))
        feed, mask = feed.cuda(), torch.ones((8, W), device="cuda")
        # the verify's logits (spec_verify's argmax input) from the state
        vlog, _ = lm_verify_chunk(dparams, cfg, feed, st, token_mask=mask)
        step_st = {**st, "blocks": tuple(t.clone() for t in st["blocks"])}
        diff = peak = 0.0
        for j in range(W):
            slog, step_st = lm_step(dparams, cfg, step_st, feed[:, j])
            diff = max(diff, float((vlog[:, j] - slog).abs().max()))
            peak = max(peak, float(slog.abs().max()))
        tok = feed[:, 0]
        verify = lambda: spec_decode.spec_verify(dparams, st, feed, mask, cfg)  # noqa: E731
        step = lambda: lm_step(dparams, cfg, step_st, tok)  # noqa: E731
        return dict(rel=diff / peak, diff=diff, v_dev=sum(device_ms(verify, 3).values()),
                    s_dev=W * sum(device_ms(step, 3).values()), v_ev=cuda_ms(verify, 3),
                    s_ev=W * cuda_ms(step, 3))


def per_token(launches: dict, tokens: int, keys) -> dict:
    return {k: round(launches.get(k, 0) / tokens, 3) for k in keys if k in launches}


def spec_run(card: str, tag: str, dparams, cfg, mix: str, base=None, drafter=None,
             compacted: bool = True) -> dict:
    """One preset and mix: the non-speculative engine (or ``base``, its
    run), the K = 3 spec engine and (``compacted``) the compacted spec
    engine, capacity 8, greedy.  The compacted spec streams must equal the
    spec streams.
    In fp32 every spec stream must equal the non-spec one (speculation is
    lossless); in bf16 one may part only at a step whose full-width
    top-two margin is within ``MARGIN_TOL`` of that step's largest
    |logit| (the verify's chunk arithmetic rounds elsewhere than the
    decode step: ``verify_check``).  Prints the acceptance rate,
    committed tokens per verify launch, kernel launches per committed
    token, tick ms per committed token and tokens/s, spec against
    non-spec."""
    import dataclasses

    from mamba_distributed_tpu_torch.serving import GenerationRequest, ServingEngine
    from mamba_distributed_tpu_torch.utils.metrics import ServingMetrics

    prompts, new = spec_traffic(cfg, mix)

    def reqs():
        return [GenerationRequest(prompt_ids=p.copy(), max_new_tokens=n, top_k=1, seed=i)
                for i, (p, n) in enumerate(zip(prompts, new))]

    spec_cfg = dataclasses.replace(cfg, spec_tokens=SPEC_K,
                                   spec_drafter="model" if drafter else "ngram")
    runs = {} if base is None else {"base": base}
    for name, c in (("base", cfg), ("spec", spec_cfg),
                    ("compacted", dataclasses.replace(spec_cfg, tick_compaction=True))):
        if name in runs or (name == "compacted" and not compacted):
            continue
        kw = {"drafter": drafter()} if drafter and name != "base" else {}
        eng = ServingEngine(dparams, c, capacity=8, metrics=ServingMetrics(8), **kw)
        t0 = time.perf_counter()
        run = drive(eng, reqs())
        run.update(wall=time.perf_counter() - t0, summary=eng.metrics.summary())
        if eng.hybrid and eng.page_pool.pages_in_use:
            raise SystemExit(f"spec {tag} {mix} {name}: {eng.page_pool.pages_in_use} pages leaked")
        runs[name] = run
    fails, parted = [], []
    same = runs["compacted"]["streams"] == runs["spec"]["streams"] if compacted else None
    if same is False:
        diff = [i for i, (a, b) in enumerate(zip(runs["compacted"]["streams"],
                                                 runs["spec"]["streams"])) if a != b]
        fails.append(f"the compacted spec streams {diff} differ from the spec engine's")
    apart = [i for i, (a, b) in enumerate(zip(runs["base"]["streams"], runs["spec"]["streams"]))
             if a != b]
    refs = (dict(zip(apart, greedy_margins(dparams, cfg, [prompts[i] for i in apart],
                                           [new[i] for i in apart], 8))) if apart else {})
    for i in apart:
        a, b = runs["base"]["streams"][i], runs["spec"]["streams"][i]
        k = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        toks, margins, peaks = refs[i]
        parted.append((i, k, round(margins[k], 5), round(margins[k] / peaks[k], 5)))
        if toks != a:
            fails.append(f"request {i}: the full-width reference does not reproduce its stream")
        elif cfg.torch_compute_dtype == torch.float32:
            fails.append(f"request {i} parts from the non-spec stream in fp32 at step {k}")
        elif margins[k] > MARGIN_TOL * peaks[k]:
            fails.append(f"request {i} parts from the non-spec stream at step {k} with margin "
                         f"{margins[k]:.5f} > {MARGIN_TOL} x {peaks[k]:.4f}")
    hybrid = bool(cfg.attn_layer_idx)
    q8 = "_int8" if cfg.kv_quantized and hybrid else ""
    need = (("m1_scan",) if cfg.ssm_layer == "mamba1" else ("ssd_fwd", "rms_norm_gated")) + (
        ("add_rms_norm",) + ((f"ragged_prefill{q8}",) if hybrid else ()))
    for k in need:
        if not runs["spec"]["launches"].get(k):
            fails.append(f"the spec run launched no {k}")
    if runs["spec"]["launches"].get(f"ragged_decode{q8}"):
        fails.append("the spec run launched the paged decode (the verify is a chunk step)")
    keys = ("ssd_fwd", "m1_scan", f"ragged_prefill{q8}", f"ragged_decode{q8}")
    out = {}
    for name in ("base", "spec"):
        run = runs[name]
        tokens = sum(len(s) for s in run["streams"])
        summ = run["summary"]
        out[name] = dict(
            launches=per_token(run["launches"], tokens, keys),
            tick_ms_per_token=(round(1000 / summ["decode_tokens_per_sec"], 4)
                               if summ["decode_tokens_per_sec"] else None),
            decode_tokens_per_s=summ["decode_tokens_per_sec"],
            wall_tokens_per_s=round(tokens / run["wall"], 1))
    sp = runs["spec"]["summary"]["speculation"]
    equal = sum(a == b for a, b in zip(runs["base"]["streams"], runs["spec"]["streams"]))
    print(f"spec {tag} {mix} mix ({'ModelDrafter' if drafter else 'n-gram'}, K={SPEC_K}, "
          f"capacity 8, greedy): streams equal to the non-spec engine's {equal} of "
          f"{len(prompts)}; parted (request, step, full-width top-two margin, over the step's "
          f"largest |logit|) {parted}; "
          f"compacted spec == spec: {'not run' if same is None else same}; "
          f"acceptance rate {sp['acceptance_rate']}, committed tokens per verify launch "
          f"{sp['accepted_tokens_per_tick']}; kernel launches per committed token spec "
          f"{out['spec']['launches']} vs non-spec {out['base']['launches']}; tick ms per "
          f"committed token spec {out['spec']['tick_ms_per_token']} vs non-spec "
          f"{out['base']['tick_ms_per_token']}; decode tokens/s spec "
          f"{out['spec']['decode_tokens_per_s']} vs non-spec {out['base']['decode_tokens_per_s']}"
          f"; wall tokens/s (prefill included) spec {out['spec']['wall_tokens_per_s']} vs "
          f"non-spec {out['base']['wall_tokens_per_s']}; summary()['speculation'] {sp} [{card}]",
          flush=True)
    if fails:
        raise SystemExit(f"spec {tag} {mix}: {fails}")
    return runs["base"]


def spec_phase(card: str, params: dict) -> None:
    """Speculative decoding on the card (phase 3c), on the decode weights
    the serving phase cast (``params``: preset tag -> weights), full width:
    per preset ``verify_check`` at full depth (the verify's logits within
    the bf16 tolerance of K+1 decode steps', and the device ms of each),
    then ``spec_run`` over the serving mix and the repetitive mix on the
    first ``CUT_LAYERS`` layers of each (a cut that keeps the script
    under its limit); then
    mamba2-280m in fp32 on its first ``CUT_LAYERS`` layers (seeded
    masters), where the verify's logits must
    sit within the fp32 tolerance and every spec stream equal the
    non-spec one; last a ``ModelDrafter`` (a seeded 4-layer mamba2
    companion at mamba2-280m's width and vocab) on mamba2-280m's
    repetitive mix."""
    from mamba_distributed_tpu_torch.config import get_preset
    from mamba_distributed_tpu_torch.models.lm import init_lm_params
    from mamba_distributed_tpu_torch.serving import ModelDrafter
    from mamba_distributed_tpu_torch.serving.prefill import cast_decode_params

    t0 = time.perf_counter()
    bases = {}

    def check(tag, dparams, cfg):
        v = verify_check(dparams, cfg, spec_traffic(cfg, "repetitive")[0])
        tol = TOL[cfg.torch_compute_dtype]
        print(f"spec {tag}: one verify launch (8 rows x {SPEC_K + 1} tokens after 256) against "
              f"{SPEC_K + 1} decode sub-steps from the same state: logits max_abs_diff "
              f"{v['diff']:.5f} (rel {v['rel']:.2e}, tol rel {tol:.0e}); {v['v_dev']:.4f} ms of "
              f"device time vs {v['s_dev']:.4f} ms; by the event timer {v['v_ev']:.4f} vs "
              f"{v['s_ev']:.4f} ms [{card}]", flush=True)
        if v["rel"] > tol:
            raise SystemExit(f"spec {tag}: the verify's logits sit {v['rel']:.3e} from the "
                             f"decode steps', over {tol}")

    for tag, preset, over in SPEC_PRESETS:
        cfg = feature_cfg(preset, **over)
        check(tag, params[tag], cfg)
        # every preset's runs on its first CUT_LAYERS layers, to leave the
        # serving mesh phase room under the script's limit
        cfg = cut_layers(cfg, CUT_LAYERS)
        run_tag, run_params = f"{tag} {CUT_LAYERS} layers", layer_prefix(params[tag], cfg)
        for mix in ("serving", "repetitive"):
            bases[tag, mix] = spec_run(card, run_tag, run_params, cfg, mix)
    f32 = cut_layers(get_preset("mamba2-280m", ssm_impl="pallas", compute_dtype="float32"),
                     CUT_LAYERS)
    masters = init_lm_params(f32, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    f32_params = cast_decode_params(masters, f32)
    check(f"mamba2-280m fp32 {CUT_LAYERS} layers", f32_params, f32)
    spec_run(card, f"mamba2-280m fp32 {CUT_LAYERS} layers", f32_params, f32, "serving",
             compacted=False)
    del masters, f32_params
    dcfg = feature_cfg("mamba2-280m", n_layer=4)
    dparams = init_lm_params(dcfg, torch.Generator(device="cuda").manual_seed(7), device="cuda")
    m2 = feature_cfg("mamba2-280m", CUT_LAYERS)
    spec_run(card, f"mamba2-280m {CUT_LAYERS} layers", layer_prefix(params["mamba2-280m"], m2),
             m2, "repetitive", base=bases["mamba2-280m", "repetitive"],
             drafter=lambda: ModelDrafter(dparams, dcfg), compacted=False)
    print(f"spec phase: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)


# ------------------------------------------------ multi-tenant LoRA (3d)

# the LoRA mix: the serving mix's 8 requests (greedy) spread over four
# tenants and the base model
LORA_NAMES = ("tenant-0", "tenant-1", "tenant-2", "tenant-3", None,
              "tenant-0", "tenant-1", "tenant-2")
# room for the four tenants and a hot swap's second version; the default
# cache keeps every registered adapter resident
LORA_KW = dict(lora_max_adapters=8, lora_rank=8, lora_alpha=16.0)
LORA_NEW = 32


def lora_registry(cfg, dparams):
    """A registry over ``dparams``' targets holding tenant-0..3, each a
    seeded ``register_random`` adapter over every target."""
    from mamba_distributed_tpu_torch.serving.adapters import AdapterRegistry

    reg = AdapterRegistry(cfg, dparams)
    for i in range(4):
        reg.register_random(f"tenant-{i}", seed=i)
    return reg


def lora_requests(prompts, names, news) -> list:
    from mamba_distributed_tpu_torch.serving import GenerationRequest

    return [GenerationRequest(prompt_ids=p.copy(), max_new_tokens=n, top_k=1, seed=i,
                              adapter=a)
            for i, (p, a, n) in enumerate(zip(prompts, names, news))]


def timed_drive(eng, reqs) -> dict:
    """``drive`` timed: the streams, the sorted TTFTs (ms), the launches
    (zeroed before the run), the wall time, tokens/s and the median
    decode-only tick in ms (a step with no prefill work pending)."""
    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES

    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t0 = time.perf_counter()
    ids = [eng.submit(r) for r in reqs]
    tracked = {t.request_id: t for t in eng.scheduler}
    ticks = []
    while eng.pending:
        prefill = bool(eng.scheduler.depth or eng._prefill_queue)
        ts = time.perf_counter()
        if eng.step() and not prefill:
            ticks.append((time.perf_counter() - ts) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    streams = [eng.results[i].new_tokens.tolist() for i in ids]
    return dict(streams=streams, wall=wall, tokens_per_s=sum(map(len, streams)) / wall,
                ttft=sorted((tracked[i].t_first_token - tracked[i].t_submit) * 1e3 for i in ids),
                launches={k: v for k, v in LAUNCHES.items() if v},
                tick_ms=p50(ticks) if ticks else None)


def lora_refs(dparams, cfg, reg, prompts, names, news) -> dict:
    """Each request's reference: the greedy stream of its prompt on its
    adapter's merged weights ``W + A @ B`` (the base weights for None),
    cast once, with the top-two margins and largest |logit| of every step
    (``greedy_margins`` at 8 rows, an adapter's requests together)."""
    from mamba_distributed_tpu_torch.serving.prefill import cast_decode_params

    refs = {}
    for name in dict.fromkeys(names):
        idx = [i for i, n in enumerate(names) if n == name]
        merged = dparams if name is None else cast_decode_params(reg.merge(dparams, name), cfg)
        refs.update(zip(idx, greedy_margins(merged, cfg, [prompts[i] for i in idx],
                                            [news[i] for i in idx], 8)))
        del merged
    return refs


def lora_gate(tag: str, streams, refs: dict, fp32: bool, fails: list) -> list:
    """Hold each stream to its merged-weights reference: equal in fp32;
    in bf16 it may part only at a step whose reference top-two margin is
    within ``MARGIN_TOL`` of that step's largest |logit| (the delta's sums
    and the merged weights round differently).  Returns the partings
    (request, step, margin, margin over the largest |logit|)."""
    parted = []
    for i, (toks, margins, peaks) in sorted(refs.items()):
        s = streams[i]
        if s == toks:
            continue
        k = next(j for j, (x, y) in enumerate(zip(s, toks)) if x != y)
        parted.append((i, k, round(margins[k], 5), round(margins[k] / peaks[k], 5)))
        if fp32 or margins[k] > MARGIN_TOL * peaks[k]:
            fails.append(f"{tag}: request {i} parts from its merged-weights reference at step "
                         f"{k} (top-two margin {margins[k]:.6f}, largest |logit| {peaks[k]:.4f})")
    return parted


def lora_probes(dparams, cache, slots: list) -> tuple[dict, dict]:
    """The two properties the LoRA path's exactness rests on, at layer 0
    of every target on the card (bf16): rows of the first 1, 2 and 4 of
    8 rows (random activations, random pool rows among ``slots`` and 0,
    ``ROW_TRIALS`` batches) whose ``linear`` output with the delta differs
    from the 8-row call's; and elements where the bf16-output GEMM (the
    LoRA-less path) differs from the rounded fp32-output one (the LoRA
    path, where a no-adapter row adds an exact 0), at 1, 2, 4 and 8
    decode rows and a 256-token chunk."""
    from mamba_distributed_tpu_torch.models.common import linear, mm_f32

    gen = torch.Generator(device="cuda").manual_seed(6)
    bf = torch.bfloat16
    choices = torch.tensor([0, *slots], device="cuda")
    rows, gemm = {}, {}
    with torch.no_grad():
        for path, pool in cache.pools.items():
            node = dparams
            for key in path.split("/"):
                node = node[key]
            w = node["kernel"][0]
            lora = {"A": pool["A"][0], "B": pool["B"][0]}
            d_in = w.shape[0]
            differ = {1: 0, 2: 0, 4: 0}
            for _ in range(ROW_TRIALS):
                x = torch.randn((8, d_in), generator=gen, device="cuda").to(bf)
                ids = choices[torch.randint(0, len(choices), (8,), generator=gen, device="cuda")]
                ref = linear({"kernel": w, "lora": {**lora, "ids": ids}}, x, bf)
                for n in differ:
                    got = linear({"kernel": w, "lora": {**lora, "ids": ids[:n]}}, x[:n], bf)
                    differ[n] += int((got != ref[:n]).any(dim=-1).sum())
            rows[path] = differ
            mism = {}
            for shape in ((1, d_in), (2, d_in), (4, d_in), (8, d_in), (1, 256, d_in)):
                x = torch.randn(shape, generator=gen, device="cuda").to(bf)
                mism[shape[-2]] = int((x @ w != mm_f32(x, w).to(bf)).sum())
            gemm[path] = mism
    return rows, gemm


def lora_substep(dparams, cfg, cache, ids) -> dict:
    """One decode sub-step (8 rows, 300 cached tokens a row) with the
    pools bound at ``ids`` and without them: (CUDA kernels by the
    profiler, device ms, event ms) each."""
    from mamba_distributed_tpu_torch.models.lm import lm_step
    from mamba_distributed_tpu_torch.serving.adapters import (
        attach_adapter_pools,
        bind_adapter_ids,
    )

    st = decode_state(cfg, 8, 300, cfg.kv_pages_per_slot)
    tok = torch.randint(0, cfg.vocab_size, (8,), device="cuda")
    bound = bind_adapter_ids(attach_adapter_pools(dparams, cache.pools), ids)
    out = {}
    with torch.no_grad():
        for route, p in (("on", bound), ("off", dparams)):
            step = lambda: lm_step(p, cfg, st, tok)  # noqa: E731
            out[route] = (kernel_events(step), sum(device_ms(step, 10).values()),
                          cuda_ms(step, 10))
    return out


def lora_uploads(reg) -> tuple[int, list]:
    """Factor bytes of one adapter in the device pools (bf16) and the ms
    of each upload on a one-row cache that evicts at every miss."""
    from mamba_distributed_tpu_torch.serving.adapters import AdapterCache

    cache = AdapterCache(reg, 1, compute_dtype=torch.bfloat16, device="cuda")
    ms = []
    for i in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        cache.acquire(f"tenant-{i}")
        torch.cuda.synchronize()
        ms.append(round((time.perf_counter() - t) * 1e3, 3))
        cache.release(f"tenant-{i}")
    return cache.nbytes_per_adapter, ms


def lora_preset(card: str, tag: str, dparams, cfg, sequential: bool) -> None:
    """One preset at full width (bf16, capacity 8; ``cfg``'s depth): the LoRA mix
    on a LoRA engine against the same prompts on a LoRA-less one (the
    no-adapter streams bit-identical), every stream against its
    merged-weights reference (``lora_gate``), with ``sequential`` the
    mixed engine against sequential per-tenant engines (streams equal),
    the hand kernels launched, every ref and page returned; printed:
    tokens/s, TTFT p50 and decode tick ms on against off, mixed against
    sequential tokens/s, the decode sub-step's kernels and ms on against
    off, factor bytes and upload ms, and the probes (``lora_probes``)."""
    import dataclasses

    from mamba_distributed_tpu_torch.serving import ServingEngine

    lcfg = dataclasses.replace(cfg, **LORA_KW)
    reg = lora_registry(lcfg, dparams)
    _, prompts, _ = serving_mix(cfg, LORA_NEW)
    names, news = LORA_NAMES, [LORA_NEW] * len(prompts)
    hybrid = bool(cfg.attn_layer_idx)
    if sequential:
        # warm-up of the LoRA path (the batched GEMMs' first calls), not counted
        ServingEngine(dparams, lcfg, capacity=8, adapters=reg).run(
            lora_requests(prompts[:2], names[:2], [2, 2]))
    off = timed_drive(ServingEngine(dparams, cfg, capacity=8),
                      lora_requests(prompts, [None] * len(prompts), news))
    eng = ServingEngine(dparams, lcfg, capacity=8, adapters=reg)
    on = timed_drive(eng, lora_requests(prompts, names, news))
    fails = []
    noop = [i for i, n in enumerate(names) if n is None]
    if any(on["streams"][i] != off["streams"][i] for i in noop):
        fails.append(f"the no-adapter requests {noop} differ from the LoRA-less engine's")
    # the delta is live: adapter streams unlike the base model's
    moved = sum(on["streams"][i] != off["streams"][i] for i, n in enumerate(names) if n)
    if not moved:
        fails.append("no adapter stream differs from the base model's")
    refs = lora_refs(dparams, cfg, reg, prompts, names, news)
    parted = lora_gate(f"lora {tag}", on["streams"], refs, False, fails)
    seq, seq_wall = list(on["streams"]), 0.0
    for name in dict.fromkeys(names) if sequential else ():
        idx = [i for i, n in enumerate(names) if n == name]
        run = timed_drive(ServingEngine(dparams, lcfg, capacity=8, adapters=reg),
                          lora_requests([prompts[i] for i in idx], [name] * len(idx),
                                        [news[i] for i in idx]))
        seq_wall += run["wall"]
        for j, i in enumerate(idx):
            seq[i] = run["streams"][j]
    if seq != on["streams"]:
        apart = [i for i, (a, b) in enumerate(zip(seq, on["streams"])) if a != b]
        fails.append(f"mixed streams {apart} differ from the sequential per-tenant engines'")
    need = ("ssd_fwd", "rms_norm_gated", "add_rms_norm") + (
        ("ragged_prefill", "ragged_decode") if hybrid else ())
    fails += [f"the LoRA run launched no {k}" for k in need if not on["launches"].get(k)]
    cache = eng.adapter_cache
    held = {n: cache.refcount(n) for n in cache.resident_names()}
    if any(held.values()):
        fails.append(f"adapter refs held at the end: {held}")
    if hybrid and eng.page_pool.pages_in_use:
        fails.append(f"{eng.page_pool.pages_in_use} KV pages leaked")
    slots = [cache.slot_of(f"tenant-{i}") for i in range(4)]
    rows, gemm = lora_probes(dparams, cache, slots)
    if any(any(v.values()) for v in rows.values()):
        fails.append(f"the LoRA linear depends on the row count: {rows}")
    if any(any(v.values()) for v in gemm.values()):
        fails.append(f"the bf16-output GEMM differs from the rounded fp32 one: {gemm}")
    sub = lora_substep(dparams, cfg, cache,
                       torch.tensor([cache.slot_of(n) if n else 0 for n in names],
                                    dtype=torch.int32, device="cuda"))
    nbytes, uploads = lora_uploads(reg)
    tokens = sum(map(len, on["streams"]))
    (ek, dk, ck), (eo, do, co) = sub["on"], sub["off"]
    keys = ("ssd_fwd", "ragged_prefill", "ragged_decode", "add_rms_norm", "rms_norm_gated")
    print(f"lora {tag} n_layer={cfg.n_layer} bf16 capacity 8, 4 adapters (rank 8, alpha 16, every "
          f"target: {list(reg.targets)}) over the serving mix (greedy, {LORA_NEW} new, adapters "
          f"{list(names)}): tokens/s LoRA on {on['tokens_per_s']:.1f} vs off "
          f"{off['tokens_per_s']:.1f}; TTFT p50 ms {p50(on['ttft'])} vs {p50(off['ttft'])}; "
          f"decode tick ms (median, 8 sub-steps) {on['tick_ms']} vs {off['tick_ms']}; "
          + (f"mixed {on['tokens_per_s']:.1f} vs sequential per-tenant engines "
             f"{tokens / seq_wall:.1f} tokens/s ({on['wall']:.3f} s vs {seq_wall:.3f} s), "
             f"streams equal {seq == on['streams']}; " if sequential else "")
          + f"adapter streams unlike the base model's {moved} of "
          f"{len(names) - len(noop)}; no-adapter streams == LoRA-less engine's: "
          f"{all(on['streams'][i] == off['streams'][i] for i in noop)}; parted from the "
          f"merged-weights references (request, step, top-two margin, over the step's "
          f"largest |logit|) {parted}; launches on {per_token(on['launches'], tokens, keys)} "
          f"vs off "
          f"{per_token(off['launches'], tokens, keys)} a token, LoRA run totals "
          f"{on['launches']} [{card}]", flush=True)
    print(f"lora {tag} decode sub-step (8 rows, 300 cached tokens a row, pools bound): CUDA "
          f"kernels {ek} on vs {eo} off (+{ek - eo}); device ms {dk:.4f} vs {do:.4f}; event ms "
          f"{ck:.4f} vs {co:.4f} [{card}]", flush=True)
    print(f"lora {tag} factors: {nbytes} B an adapter in the bf16 pools; upload ms per miss "
          f"{uploads}; cache {cache.hits} hits, {cache.misses} misses; probes: rows off the "
          f"8-row call's at 1, 2, 4 rows ({ROW_TRIALS} batches) {rows}; bf16-output vs "
          f"rounded fp32-output GEMM, elements apart by rows {gemm} [{card}]", flush=True)
    if fails:
        raise SystemExit(f"lora {tag}: {fails}")


def lora_cells(card: str, served: dict) -> None:
    """The cells on the first ``CUT_LAYERS`` layers (full width): compacted
    ticks, speculation, fp32, a hot swap, a cache of 2 rows over 4
    adapters, mamba1-280m; and the int8 rejection."""
    import dataclasses

    from mamba_distributed_tpu_torch.config import get_preset
    from mamba_distributed_tpu_torch.models.lm import init_lm_params
    from mamba_distributed_tpu_torch.serving import ServingEngine
    from mamba_distributed_tpu_torch.serving.prefill import cast_decode_params

    print(f"lora cells: depth cut from 64 to {CUT_LAYERS} layers (the first {CUT_LAYERS} "
          f"layers' weights), full width: compaction, spec, fp32, hot swap, cache of 2 rows, "
          f"mamba1-280m", flush=True)
    fails = []
    names = LORA_NAMES
    m2 = feature_cfg("mamba2-280m", CUT_LAYERS)
    m2p = layer_prefix(served["mamba2-280m"], m2)
    l2 = dataclasses.replace(m2, **LORA_KW)
    reg = lora_registry(l2, m2p)
    _, prompts, _ = serving_mix(m2, 1)
    news = list(FEATURE_NEW)
    # (a) compacted ticks: occupancy falls from 8 to 1
    runs = {}
    for on in (False, True):
        eng = ServingEngine(m2p, dataclasses.replace(l2, tick_compaction=on), capacity=8,
                            adapters=reg)
        runs[on] = drive(eng, lora_requests(prompts, names, news))
    hist = eng.metrics.summary()["compaction"]["bucket_histogram"]
    comp_equal = runs[True]["streams"] == runs[False]["streams"]
    if not comp_equal:
        fails.append("compacted LoRA streams differ from the full ticks'")
    # (b) speculation, K = 3: compacted spec streams equal spec streams
    spec = {}
    for on in (False, True):
        c = dataclasses.replace(l2, spec_tokens=SPEC_K, tick_compaction=on)
        spec[on] = drive(ServingEngine(m2p, c, capacity=8, adapters=reg),
                         lora_requests(prompts, names, news))
    if spec[True]["streams"] != spec[False]["streams"]:
        fails.append("compacted LoRA spec streams differ from the spec engine's")
    spec_same = sum(a == b for a, b in zip(spec[False]["streams"], runs[False]["streams"]))
    # (c) fp32: streams equal the merged references; spec equal to non-spec
    f32 = cut_layers(get_preset("mamba2-280m", ssm_impl="pallas", compute_dtype="float32"),
                     CUT_LAYERS)
    masters = init_lm_params(f32, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    f32p = cast_decode_params(masters, f32)
    del masters
    lf = dataclasses.replace(f32, **LORA_KW)
    freg = lora_registry(lf, f32p)
    f_run = drive(ServingEngine(f32p, lf, capacity=8, adapters=freg),
                  lora_requests(prompts, names, news))
    f_parted = lora_gate("lora mamba2-280m fp32", f_run["streams"],
                         lora_refs(f32p, f32, freg, prompts, names, news), True, fails)
    f_spec = drive(ServingEngine(f32p, dataclasses.replace(lf, spec_tokens=SPEC_K), capacity=8,
                                 adapters=freg), lora_requests(prompts, names, news))
    if f_spec["streams"] != f_run["streams"]:
        fails.append("fp32 LoRA spec streams differ from the non-spec ones")
    del f32p, freg
    # (d) a hot swap to tenant-0@v2 after the first decode tick
    eng = ServingEngine(m2p, l2, capacity=8, adapters=reg)
    reqs = lora_requests(prompts, names, [LORA_NEW] * len(prompts))
    rid = [eng.submit(r) for r in reqs][0]
    pre = []
    while not pre:
        eng.step()
        pre = list(next(t for t in eng._slots.values() if t.request_id == rid).new_tokens)
    reg.register_random("tenant-0", seed=100)
    swapped = eng.hot_swap_adapter(rid)
    while eng.pending:
        eng.step()
    final = eng.results[rid].new_tokens.tolist()
    if swapped != "tenant-0@v2" or len(final) != LORA_NEW or final[:len(pre)] != pre:
        fails.append(f"hot swap to {swapped}: {len(final)} tokens, prefix kept "
                     f"{final[:len(pre)] == pre}")
    cont = np.concatenate([prompts[0], np.asarray(pre)])
    v2 = cast_decode_params(reg.merge(m2p, "tenant-0@v2"), m2)
    ((toks, margins, peaks),) = greedy_margins(v2, m2, [cont], [LORA_NEW - len(pre)], 8)
    del v2
    swap_parted = lora_gate("lora hot swap", {0: final[len(pre):]}, {0: (toks, margins, peaks)},
                            False, fails)
    held = {n: eng.adapter_cache.refcount(n) for n in eng.adapter_cache.resident_names()}
    if any(held.values()):
        fails.append(f"adapter refs held after the hot swap run: {held}")
    # (e) a cache of 2 rows over 4 adapters (hybrid): admission waits and
    # evicts, the streams equal an unconstrained engine's
    hy = feature_cfg("hybrid-280m", CUT_LAYERS)
    hyp = layer_prefix(served["hybrid-280m"], hy)
    lh = dataclasses.replace(hy, **LORA_KW)
    hreg = lora_registry(lh, hyp)
    full = drive(ServingEngine(hyp, lh, capacity=8, adapters=hreg),
                 lora_requests(prompts, names, news))
    small = ServingEngine(hyp, dataclasses.replace(lh, lora_cache_slots=2), capacity=8,
                          adapters=hreg)
    waits, acquire = [0], small.adapter_cache.acquire

    def counted(name):
        slot = acquire(name)
        waits[0] += slot is None
        return slot

    small.adapter_cache.acquire = counted
    small_run = drive(small, lora_requests(prompts, names, news))
    ac = small.adapter_cache
    held = {n: ac.refcount(n) for n in ac.resident_names()}
    if (small_run["streams"] != full["streams"] or not waits[0] or not ac.evictions
            or any(held.values()) or small.page_pool.pages_in_use):
        fails.append(f"cache of 2 rows: streams equal {small_run['streams'] == full['streams']}, "
                     f"waits {waits[0]}, evictions {ac.evictions}, refs {held}, pages in use "
                     f"{small.page_pool.pages_in_use}")
    # (f) int8 weights with LoRA refuse to build
    try:
        ServingEngine(served["hybrid-280m int8"],
                      feature_cfg("hybrid-280m", **FEATURE_INT8, **LORA_KW), capacity=8)
        int8 = "built"
    except ValueError as e:
        int8 = str(e)
    if "ROADMAP residual" not in int8:
        fails.append(f"int8 hybrid-280m with LoRA: {int8}")
    # (g) mamba1-280m: x_proj is a target, m1_scan runs
    m1 = feature_cfg("mamba1-280m", CUT_LAYERS)
    m1p = layer_prefix(served["mamba1-280m"], m1)
    l1 = dataclasses.replace(m1, **LORA_KW)
    m1reg = lora_registry(l1, m1p)
    m1_run = drive(ServingEngine(m1p, l1, capacity=8, adapters=m1reg),
                   lora_requests(prompts, names, [LORA_NEW] * len(prompts)))
    m1_parted = lora_gate("lora mamba1-280m", m1_run["streams"],
                          lora_refs(m1p, m1, m1reg, prompts, names, [LORA_NEW] * len(prompts)),
                          False, fails)
    if "blocks/mixer/x_proj" not in m1reg.targets or not m1_run["launches"].get("m1_scan"):
        fails.append(f"mamba1-280m: targets {list(m1reg.targets)}, launches {m1_run['launches']}")
    print(f"lora cells ({CUT_LAYERS} layers): compacted == full ticks {comp_equal} (bucket "
          f"histogram {hist}); spec K={SPEC_K}: compacted spec == spec "
          f"{spec[True]['streams'] == spec[False]['streams']}, bf16 spec streams equal to "
          f"non-spec {spec_same} of {len(prompts)}, launches {spec[False]['launches']}; fp32: "
          f"parted from the merged references {f_parted}, spec == non-spec "
          f"{f_spec['streams'] == f_run['streams']}; hot swap to {swapped} after {len(pre)} "
          f"tokens: {len(final)} of {LORA_NEW} tokens, prefix kept, suffix parted from merged "
          f"v2 {swap_parted}; hybrid cache of 2 rows: admission waits {waits[0]}, evictions "
          f"{ac.evictions}, misses {ac.misses}, streams == 8-row cache's "
          f"{small_run['streams'] == full['streams']}, pages in use "
          f"{small.page_pool.pages_in_use}; int8 hybrid-280m with LoRA refused: "
          f"{'ROADMAP residual' in int8}; mamba1-280m parted {m1_parted}, launches "
          f"{m1_run['launches']} [{card}]", flush=True)
    if fails:
        raise SystemExit(f"lora cells: {fails}")


def lora_phase(card: str, params: dict) -> None:
    """Multi-tenant LoRA serving on the card (phase 3d), on the decode
    weights the serving phase cast (``params``: preset tag -> weights):
    ``lora_preset`` on mamba2-280m (with the sequential engines) and
    hybrid-280m on their first ``CUT_LAYERS`` layers (a cut that leaves
    the serving mesh phase room under the script's limit), then
    ``lora_cells``."""
    t0 = time.perf_counter()
    for tag in ("mamba2-280m", "hybrid-280m"):
        cfg = feature_cfg(tag, CUT_LAYERS)
        lora_preset(card, f"{tag} {CUT_LAYERS} layers", layer_prefix(params[tag], cfg), cfg,
                    sequential=tag == "mamba2-280m")
    lora_cells(card, params)
    print(f"lora phase: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)


# --------------------------------------------- data parallel over NCCL (7)


def step_kernels(trainer, accum: int) -> dict:
    """CUDA kernels of one more train step, by ``torch.profiler``: name ->
    (device ms, launches).  A profile that records no kernel is taken
    again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        x, y = trainer._batch(accum, trainer.train_loader)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trainer.train_step(trainer.params, x, y)
            torch.cuda.synchronize()
        kernels = {e.key: (e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.count}
        if kernels:
            return kernels
    raise SystemExit("parallel: torch.profiler recorded no kernel in three step profiles")


# the depth of the data-parallel and tensor-parallel phases' bf16 runs (cut
# from the presets' 64 to keep the script inside its time limit)
PARALLEL_LAYERS = 16


def parallel_run(card: str, micro: int, seq: int, accum: int, nccl: bool) -> dict:
    """mamba2-280m at full width cut to ``PARALLEL_LAYERS`` layers (bf16,
    pallas, remat) through
    the port's Trainer for 3 steps of ``accum`` micro-batches, with no
    process group (``nccl`` False) or as rank 0 of a world of one on NCCL
    (``init_distributed`` on a free local TCP port, mesh ``data=1``: the
    trainer's distributed path, its bucketed all-reduce included); then
    one more step under the profiler.  The group is destroyed by
    ``finish()``."""
    import os
    import shutil
    import socket

    from mamba_distributed_tpu_torch.config import DataConfig, get_preset, get_train_preset
    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
    from mamba_distributed_tpu_torch.parallel.mesh import init_distributed
    from mamba_distributed_tpu_torch.training import Trainer

    tag = "b" if nccl else "a"
    root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    log = root / f"log_parallel_{tag}"
    shutil.rmtree(log, ignore_errors=True)
    model = get_preset("mamba2-280m", ssm_impl="pallas", compute_dtype="bfloat16", remat=True,
                       n_layer=PARALLEL_LAYERS)
    cfg = get_train_preset(
        "mamba2-280m", model=model, micro_batch_size=micro,
        total_batch_size=micro * seq * accum, seq_len=seq, val_steps=1, log_dir=str(log),
        data=DataConfig(data_dir=str(root / "data"), synthetic_tokens_per_shard=1 << 20))
    if nccl:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1")
        init_distributed("cuda", init_method=f"tcp://127.0.0.1:{port}")
    trainer = None
    try:
        trainer = Trainer(cfg, device="cuda")
        if nccl != (trainer.mesh is not None):
            raise SystemExit(f"parallel ({tag}): the trainer's mesh is {trainer.mesh}")
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        torch.cuda.reset_peak_memory_stats()
        trainer.run(max_steps=3)
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        held = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        kernels = step_kernels(trainer, accum)
        step_peak = torch.cuda.max_memory_allocated() / 2**30
        comm = dict(trainer.train_step.comm)
        hist = [trainer.history[s] for s in range(3)]
    finally:
        if trainer is not None:
            trainer.finish()
        elif nccl:
            import torch.distributed as dist

            dist.destroy_process_group()
    recs = [json.loads(line) for line in (log / "metrics.jsonl").read_text().splitlines()]
    del trainer
    torch.cuda.empty_cache()
    return dict(hist=hist, launches=launches, peak_gib=peak, held_gib=held, step_peak_gib=step_peak,
                kernels=kernels, comm=comm,
                step_ms=[r["step_ms"] for r in recs if r["kind"] == "train"])


def parallel_phase(card: str) -> None:
    """Data parallel on the card (phase 7): ``parallel_run`` (16 layers) without a
    process group (a) and at a world of one on NCCL (b), micro-batch 32
    (16 if 32 does not fit), accum 2.  Fails unless (b)'s losses and
    pre-clip grad norms equal (a)'s bit for bit (a one-rank NCCL mean is
    a multiply by 1.0), the SSD kernels launched in (b) as in (a), and an
    NCCL kernel shows in (b)'s step profile.  Prints the step ms, the
    NCCL kernels' device ms and launches a step, the bytes and buckets
    all-reduced a step and each run's peak memory."""
    t0 = time.perf_counter()
    seq, accum = 1024, 2
    for micro in (32, 16):
        try:
            a = parallel_run(card, micro, seq, accum, nccl=False)
        except torch.cuda.OutOfMemoryError:
            print(f"parallel: micro-batch {micro} does not fit in device memory; halving",
                  flush=True)
            torch.cuda.empty_cache()
            continue
        break
    else:
        raise SystemExit("parallel: micro-batch 16 does not fit either")
    b = parallel_run(card, micro, seq, accum, nccl=True)
    ssd = ("ssd_fwd", "ssd_chunk_states", "ssd_bwd")
    fails = []
    if a["hist"] != b["hist"]:
        fails.append(f"losses/grad norms differ: plain {a['hist']}, NCCL {b['hist']}")
    for k in ssd:
        if not 0 < a["launches"][k] == b["launches"][k]:
            fails.append(f"{k} launches: plain {a['launches'][k]}, NCCL {b['launches'][k]}")
    only_b = {k: v for k, v in b["kernels"].items() if k not in a["kernels"]}
    nccl = {k: v for k, v in b["kernels"].items()
            if "nccl" in k.lower() or "onerank" in k.lower()}
    if not nccl:
        fails.append(f"no NCCL kernel in the profile of a step of (b); kernels only in (b): "
                     f"{sorted(only_b)}")
    tag = (f"mamba2-280m {PARALLEL_LAYERS} layers bf16 pallas remat micro={micro} seq={seq} "
           f"accum={accum} world=1")
    print(f"parallel {tag}: losses {[h[0] for h in a['hist']]}, grad norms "
          f"{[h[1] for h in a['hist']]}; plain and NCCL equal bit for bit: "
          f"{a['hist'] == b['hist']}", flush=True)
    print(f"parallel {tag}: step ms (a) no group {a['step_ms']}, (b) NCCL {b['step_ms']} "
          f"[{card}]", flush=True)
    print(f"parallel {tag}: NCCL kernels in one step of (b) (device ms, launches): {nccl}; "
          f"total {sum(v[0] for v in nccl.values()):.3f} ms, "
          f"{sum(v[1] for v in nccl.values())} launches [{card}]", flush=True)
    print(f"parallel {tag}: kernels in (b)'s step and not in (a)'s: {only_b}", flush=True)
    print(f"parallel {tag}: gradient all-reduce a step: {b['comm'].get('bytes')} bytes in "
          f"{b['comm'].get('buckets')} buckets (25 MiB buckets, fp32, the loss in the last)",
          flush=True)
    print(f"parallel {tag}: peak max_memory_allocated over the 3 steps (a) "
          f"{a['peak_gib']:.2f} GiB, (b) {b['peak_gib']:.2f} GiB; allocated after them (a) "
          f"{a['held_gib']:.2f}, (b) {b['held_gib']:.2f}; peak of the profiled step (a) "
          f"{a['step_peak_gib']:.2f}, (b) {b['step_peak_gib']:.2f} [{card}]", flush=True)
    print(f"parallel {tag}: launches (a) {a['launches']}, (b) {b['launches']}", flush=True)
    print(f"parallel phase: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    if fails:
        raise SystemExit(f"parallel phase: {fails}")


# ------------------------------------------- tensor parallel over gloo (8)

# the hand kernels of the hybrid train path, which every tensor rank must
# launch as often as the plain trainer does
TP_KERNELS = ("ssd_fwd", "ssd_chunk_states", "ssd_bwd", "flash_fwd", "flash_bwd_dq",
              "flash_bwd_dkv")
TP_WAIT_S = 420


def tensor_cfg(tag: str, dtype: str, n_layer: int | None, micro: int, tensor: int):
    """hybrid-280m at full width (pallas, remat; ``n_layer`` cuts its depth,
    attention every 8th layer from layer 3 then) for the tensor phase, seq
    1024, accum 1, one validation batch, synthetic shards under
    build/chip_smoke/."""
    from mamba_distributed_tpu_torch.config import (
        DataConfig,
        MeshConfig,
        get_preset,
        get_train_preset,
    )

    root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    cut = ({} if n_layer is None
           else dict(n_layer=n_layer, attn_layer_idx=tuple(range(3, n_layer, 8))))
    model = get_preset("hybrid-280m", ssm_impl="pallas", compute_dtype=dtype, remat=True, **cut)
    return get_train_preset(
        "hybrid-280m", model=model, mesh=MeshConfig(tensor=tensor), micro_batch_size=micro,
        total_batch_size=micro * 1024, seq_len=1024, val_steps=1,
        log_dir=str(root / f"log_tensor_{tag}"),
        data=DataConfig(data_dir=str(root / "data"), synthetic_tokens_per_shard=1 << 20))


def tensor_train(cfg, steps: int, profile: bool) -> dict:
    """``cfg`` through the port's Trainer on this process's card (one rank
    of a tensor group when one is up): ``steps`` steps from zeroed launch
    counts, then, with ``profile``, one more step under ``torch.profiler``
    (CPU and CUDA), the step and each tensor-group all-reduce in a
    ``record_function`` span of its own, the all-reduces counted and their
    shapes kept; then those all-reduces replayed back to back on their own
    (the time they take without the step around them).  Returns the
    history, launches, rank-0 step ms, peak memory, the trace's step and
    all-reduce spans, its all-reduce events and device busy time, and the
    replay's ms."""
    import gc
    import shutil

    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
    from mamba_distributed_tpu_torch.parallel import collectives
    from mamba_distributed_tpu_torch.training import Trainer

    shutil.rmtree(cfg.log_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    # verbose: the master writes metrics.jsonl (its step ms) and prints
    trainer = Trainer(cfg, device=f"cuda:{torch.cuda.current_device()}")
    out = {}
    try:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        torch.cuda.reset_peak_memory_stats()
        trainer.run(max_steps=steps)
        out["launches"] = dict(LAUNCHES)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["hist"] = [trainer.history[s] for s in range(steps)]
        if profile:
            x, y = trainer._batch(cfg.grad_accum_steps, trainer.train_loader)
            torch.cuda.synchronize()
            collectives.TP_COMM.update(calls=0, bytes=0)
            shapes, reduce_ = [], collectives.tp_all_reduce_

            def keep(t, group):  # the step's all-reduces, their shapes kept
                shapes.append((tuple(t.shape), t.dtype))
                # a span over the whole blocking call: gloo stages a CUDA
                # tensor through the host, so the host waits in it
                with record_function("tp_all_reduce"):
                    return reduce_(t, group)

            collectives.tp_all_reduce_ = keep
            try:
                t0 = time.perf_counter()
                with torch_profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
                    with record_function("tp_train_step"):
                        trainer.train_step(trainer.params, x, y)
                        torch.cuda.synchronize()
                out["profiled_ms"] = (time.perf_counter() - t0) * 1e3
            finally:
                collectives.tp_all_reduce_ = reduce_
            out["tp_comm"] = dict(collectives.TP_COMM)
            events = prof.key_averages()
            # the host spans (a span also shows as a device-side annotation)
            spans = {e.key: (e.count, e.cpu_time_total / 1e3) for e in events
                     if e.key in ("tp_train_step", "tp_all_reduce")
                     and e.device_type == DeviceType.CPU}
            if set(spans) != {"tp_train_step", "tp_all_reduce"} or not all(
                    ms > 0 for _, ms in spans.values()):
                raise SystemExit(f"tensor: the trace holds spans {spans}")
            out["trace_step_ms"] = spans["tp_train_step"][1]
            out["trace_reduce"] = spans["tp_all_reduce"]
            out["reduce_events"] = {
                e.key: (e.count, e.cpu_time_total / 1e3) for e in events
                if ("all_reduce" in e.key.lower() or "allreduce" in e.key.lower())
                and e.device_type == DeviceType.CPU and e.key not in spans}
            # kernels and copies: not the spans' device-side annotations
            out["device_busy_ms"] = sum(e.self_device_time_total for e in events
                                        if e.device_type == DeviceType.CUDA
                                        and e.key not in spans) / 1e3
            bufs = [torch.ones(s_, dtype=d_, device=trainer.device) for s_, d_ in shapes]
            torch.cuda.synchronize()
            dist.barrier(trainer.tp.group)
            t0 = time.perf_counter()
            for buf in bufs:
                dist.all_reduce(buf, group=trainer.tp.group)
            torch.cuda.synchronize()
            out["replay_ms"] = (time.perf_counter() - t0) * 1e3
            del bufs
    finally:
        trainer.finish()
    if trainer.master and (Path(cfg.log_dir) / "metrics.jsonl").exists():
        recs = [json.loads(s) for s in (Path(cfg.log_dir) / "metrics.jsonl").read_text()
                .splitlines()]
        out["step_ms"] = [r["step_ms"] for r in recs if r["kind"] == "train"]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tensor_worker(rank: int, world: int, ports: list[int], work: Path) -> int:
    """One rank of the tensor phase's world (``--tensor-worker``): two
    processes on ``cuda:0`` over an explicitly requested gloo group (NCCL
    refuses two ranks on one card).  Runs (d) fp32 8 layers 2 steps, then
    (b) bf16 16 layers 3 steps and one profiled step, each in a group of
    its own (``finish()`` destroys the group), and writes its results to
    ``work/rank{rank}.json``."""
    import os

    from mamba_distributed_tpu_torch.parallel.mesh import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(RANK=str(rank), LOCAL_RANK="0", WORLD_SIZE=str(world))
    res = {}
    for tag, port, cfg, steps, prof in (
            ("d", ports[0], tensor_cfg("d", "float32", 8, 8, world), 2, False),
            ("b", ports[1], tensor_cfg("b", "bfloat16", PARALLEL_LAYERS, 8, world), 3, True)):
        init_distributed("cuda:0", init_method=f"tcp://127.0.0.1:{port}", backend="gloo")
        res[tag] = tensor_train(cfg, steps, prof)
        res[tag]["tp_rank"] = rank
    (work / f"rank{rank}.json").write_text(json.dumps(res))
    return 0


def free_ports(n: int) -> list[int]:
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def run_workers(phase: str, wait_s: int, world: int = 2, n_ports: int = 2,
                inputs: dict | None = None) -> list[dict]:
    """Run ``python3 chip_smoke.py --{phase}-worker RANK WORLD PORTS DIR``
    in ``world`` processes sharing this card (``LOCAL_RANK=0``, gloo on the
    loopback, ``n_ports`` free ports: one group a run), each rank's log in
    ``build/chip_smoke/{phase}/log_{rank}.txt`` (``inputs``, if given, in
    its ``inputs.json``); a rank that fails or outlasts ``wait_s`` stops
    the phase with its log, and every rank is killed on the way out.
    Returns each rank's ``rank{r}.json``."""
    import os
    import shutil

    work = Path(__file__).resolve().parent / "build" / "chip_smoke" / phase
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    if inputs is not None:
        (work / "inputs.json").write_text(json.dumps(inputs))
    ports = free_ports(n_ports)
    env = {**os.environ, "OMP_NUM_THREADS": "4", "GLOO_SOCKET_IFNAME": "lo"}
    procs, logs = [], [work / f"log_{r}.txt" for r in range(world)]
    for r in range(world):
        with open(logs[r], "w") as lf:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), f"--{phase}-worker", str(r),
                 str(world), ",".join(map(str, ports)), str(work)], env=env, stdout=lf,
                stderr=subprocess.STDOUT))
    timed_out = False
    try:
        for p in procs:
            p.wait(timeout=wait_s)
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for p in procs:  # a dead rank leaves the other blocked in a collective
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if timed_out or p.returncode != 0:
            raise SystemExit(f"{phase} phase: rank {r} {'timed out' if timed_out else 'exited '}"
                             f"{'' if timed_out else p.returncode}; log:\n"
                             + logs[r].read_text()[-4000:])
    return [json.loads((work / f"rank{r}.json").read_text()) for r in range(world)]


def tensor_phase(card: str) -> None:
    """Tensor parallelism on the card (phase 8): hybrid-280m at full width
    through the port's Trainer, (a) one process with no group, bf16, 16
    layers, micro 8, 3 steps; (b) the same at mesh ``tensor=2`` in two
    processes on ``cuda:0`` over gloo; (c, d) as (a, b) in fp32 cut to 8
    layers, 2 steps.  Fails unless (d)'s losses and pre-clip grad norms
    are (c)'s within rtol 2e-4 (the JAX package's TP tolerance), (b)'s
    losses (a)'s within rtol 1e-3 and its pre-clip grad norms within 2e-3
    (a wrong or missing bf16 tensor-group sum moves the norms first; near
    ln V the loss hardly moves), every rank of (b) and (d) launches the
    hybrid train path's hand kernels as often as (a) and (c), both ranks
    exit 0 in time.  Prints the step ms, the tensor-group all-reduces
    of one profiled step of (b): count, bytes, and their share of the step
    two ways, from the trace (the host time inside the all-reduce spans
    over the step span's: an upper bound, since each blocking all-reduce
    also waits for the card to finish the work queued before it) and from
    a replay of the same all-reduces back to back (the collectives alone,
    on the host clock, over the step span), each rank's peak memory."""
    t0 = time.perf_counter()
    a = tensor_train(tensor_cfg("a", "bfloat16", PARALLEL_LAYERS, 8, 1), 3, False)
    c = tensor_train(tensor_cfg("c", "float32", 8, 8, 1), 2, False)
    t_plain = time.perf_counter() - t0
    ranks = run_workers("tensor", TP_WAIT_S)
    t_tp = time.perf_counter() - t0 - t_plain
    fails = []
    # (tag, plain run, rtol on the losses, on the grad norms)
    for tag, plain, tol, ntol, what in (("d", c, 2e-4, 2e-4, "fp32 8 layers"),
                                        ("b", a, 1e-3, 2e-3, f"bf16 {PARALLEL_LAYERS} layers")):
        ref = np.array(plain["hist"])
        for r, res in enumerate(ranks):
            got = np.array(res[tag]["hist"])
            gap = np.abs(got - ref) / np.abs(ref)
            print(f"tensor ({tag}) {what} rank {r}: losses {got[:, 0].tolist()} against "
                  f"{ref[:, 0].tolist()}, grad norms {got[:, 1].tolist()} against "
                  f"{ref[:, 1].tolist()}; largest gap rel loss {gap[:, 0].max():.3e}, "
                  f"grad norm {gap[:, 1].max():.3e} (tol {tol:.0e} on the losses, "
                  f"{ntol:.0e} on the grad norms)", flush=True)
            if (not np.isfinite(got).all() or gap[:, 0].max() > tol
                    or gap[:, 1].max() > ntol):
                fails.append(f"({tag}) rank {r}: rel loss {gap[:, 0].max():.3e} (tol {tol:.0e}), "
                             f"grad norm {gap[:, 1].max():.3e} (tol {ntol:.0e})")
            for k in TP_KERNELS:
                if not 0 < plain["launches"][k] == res[tag]["launches"][k]:
                    fails.append(f"({tag}) rank {r} {k} launches {res[tag]['launches'][k]}, "
                                 f"plain {plain['launches'][k]}")
    b0 = ranks[0]["b"]
    print(f"tensor hybrid-280m {PARALLEL_LAYERS} layers bf16 micro=8 seq=1024: step ms (a) one "
          f"process "
          f"{a['step_ms']}, (b) tensor=2 over gloo on one card {b0['step_ms']} [{card}]",
          flush=True)
    comm, step_ms = b0["tp_comm"], b0["trace_step_ms"]
    n_spans, span_ms = b0["trace_reduce"]
    if n_spans != comm["calls"]:
        fails.append(f"(b) the trace holds {n_spans} all-reduce spans, the step made "
                     f"{comm['calls']}")
    print(f"tensor (b) one profiled step of rank 0: {comm['calls']} tensor-group all-reduces, "
          f"{comm['bytes']} bytes; torch.profiler trace: step span {step_ms:.1f} ms "
          f"(host clock around the profile {b0['profiled_ms']:.1f} ms), {n_spans} all-reduce "
          f"spans {span_ms:.1f} ms, {span_ms / step_ms:.3f} of the step (upper bound: each "
          f"also waits for the card's queued work); the same all-reduces replayed back to back "
          f"{b0['replay_ms']:.1f} ms, {b0['replay_ms'] / step_ms:.3f} of the step span; "
          f"device busy {b0['device_busy_ms']:.1f} ms "
          f"({b0['device_busy_ms'] / step_ms:.3f} of the step: rank 0's kernels and copies); "
          f"the profile's all-reduce events (count, CPU ms) {b0['reduce_events']} [{card}]",
          flush=True)
    print(f"tensor peak max_memory_allocated: (a) {a['peak_gib']:.2f} GiB, (b) rank 0 "
          f"{ranks[0]['b']['peak_gib']:.2f}, rank 1 {ranks[1]['b']['peak_gib']:.2f}; (c) "
          f"{c['peak_gib']:.2f}, (d) {ranks[0]['d']['peak_gib']:.2f} / "
          f"{ranks[1]['d']['peak_gib']:.2f} [{card}]", flush=True)
    print(f"tensor launches (a) {a['launches']}, (b) rank 0 {ranks[0]['b']['launches']}",
          flush=True)
    print(f"tensor phase: {time.perf_counter() - t0:.1f} s (plain runs {t_plain:.1f}, the two "
          f"ranks {t_tp:.1f}) [{card}]", flush=True)
    if fails:
        raise SystemExit(f"tensor phase: {fails}")


# ------------------------------------------- expert parallel over gloo (9)

EP_WAIT_S = 420
# the MoE made of hybrid-280m's widths (no preset: the JAX package has no
# MoE preset): Mixtral-8x7B's routing (8 experts, top 2), d_intermediate
# 8/3 d_model, the JAX defaults' capacity factor and aux weight
EP_MOE = dict(d_intermediate=2048, moe_num_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
              moe_aux_weight=0.01)
# a near tie: the k-th and (k+1)-th router probabilities closer than this
EP_TIE = 1e-5


def expert_cfg(tag: str, dtype: str, n_layer: int, micro: int, expert: int):
    """hybrid-280m's widths made MoE (``EP_MOE``; pallas, remat), cut to
    ``n_layer`` layers (16: attention at 3 and 11, hybrid-280m's every-8th
    rule; 4: at 3), seq 1024, accum 1, at mesh ``expert``, one validation
    batch, synthetic shards under build/chip_smoke/."""
    from mamba_distributed_tpu_torch.config import (
        DataConfig,
        MeshConfig,
        get_preset,
        get_train_preset,
    )

    root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    model = get_preset("hybrid-280m", ssm_impl="pallas", compute_dtype=dtype, remat=True,
                       n_layer=n_layer, attn_layer_idx=(3, 11) if n_layer >= 12 else (3,),
                       **EP_MOE)
    return get_train_preset(
        "hybrid-280m", model=model, mesh=MeshConfig(expert=expert), micro_batch_size=micro,
        total_batch_size=micro * 1024 * expert, seq_len=1024, val_steps=1,
        log_dir=str(root / f"log_expert_{tag}"),
        data=DataConfig(data_dir=str(root / "data"), synthetic_tokens_per_shard=1 << 20))


def expert_train(cfg, steps: int, profile: bool) -> dict:
    """``cfg`` through the port's Trainer on this process's card (one rank
    of an expert group when one is up): ``steps`` steps from zeroed launch
    counts; the first MoE layer's input of the first training micro-batch
    is kept and routed again after the run (``lm.moe_route``: this rank's
    keep mask and each token's margin between its k-th and (k+1)-th router
    probabilities); then, with ``profile``, one more step under
    ``torch.profiler`` (CPU and CUDA), the step and each expert-group
    all-to-all in a ``record_function`` span of its own, ``EP_COMM``
    zeroed before it.  Returns the history, launches, step ms, peak
    memory, the keep mask and margins, and the trace's step and
    all-to-all spans and device busy time."""
    import gc
    import shutil

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    from mamba_distributed_tpu_torch.models import lm
    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
    from mamba_distributed_tpu_torch.parallel import collectives
    from mamba_distributed_tpu_torch.parallel.mesh import route_context
    from mamba_distributed_tpu_torch.training import Trainer

    shutil.rmtree(cfg.log_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    trainer = Trainer(cfg, device=f"cuda:{torch.cuda.current_device()}")
    out, first, moe_mlp = {}, [], lm._moe_mlp

    def keep_first(params, cfg_, x, *args, **kw):  # the first training call's input
        if not first and torch.is_grad_enabled():
            first.append(({k: v.detach().clone() for k, v in params["router"].items()},
                          x.detach().reshape(-1, x.shape[-1]).clone()))
        return moe_mlp(params, cfg_, x, *args, **kw)

    lm._moe_mlp = keep_first
    try:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        torch.cuda.reset_peak_memory_stats()
        try:
            trainer.run(max_steps=steps)
        finally:
            lm._moe_mlp = moe_mlp
        out["launches"] = dict(LAUNCHES)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["hist"] = [trainer.history[s] for s in range(steps)]
        router, xt = first[0]
        with torch.no_grad():
            route = lm.moe_route({"router": router}, cfg.model, xt, route_context(trainer.mesh)
                                 if trainer.mesh is not None else None)
        top = torch.topk(route.probs, cfg.model.moe_top_k + 1, dim=-1).values
        out["keep"] = route.keep.int().tolist()
        out["margin"] = (top[:, -2] - top[:, -1]).tolist()
        out["cap"] = route.cap
        out["coord"] = trainer.batch_rank
        del first[:], route, xt
        if profile:
            x, y = trainer._batch(cfg.grad_accum_steps, trainer.train_loader)
            torch.cuda.synchronize()
            collectives.EP_COMM.update(calls=0, bytes=0, route_calls=0, route_bytes=0)
            a2a = collectives._all_to_all

            def spanned(*args):  # a span over the whole blocking call
                with record_function("ep_all_to_all"):
                    return a2a(*args)

            collectives._all_to_all = spanned
            try:
                t0 = time.perf_counter()
                with torch_profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
                    with record_function("ep_train_step"):
                        trainer.train_step(trainer.params, x, y)
                        torch.cuda.synchronize()
                out["profiled_ms"] = (time.perf_counter() - t0) * 1e3
            finally:
                collectives._all_to_all = a2a
            out["ep_comm"] = dict(collectives.EP_COMM)
            events = prof.key_averages()
            spans = {e.key: (e.count, e.cpu_time_total / 1e3) for e in events
                     if e.key in ("ep_train_step", "ep_all_to_all")
                     and e.device_type == DeviceType.CPU}
            if set(spans) != {"ep_train_step", "ep_all_to_all"} or not all(
                    ms > 0 for _, ms in spans.values()):
                raise SystemExit(f"expert: the trace holds spans {spans}")
            out["trace_step_ms"] = spans["ep_train_step"][1]
            out["trace_a2a"] = spans["ep_all_to_all"]
            out["device_busy_ms"] = sum(e.self_device_time_total for e in events
                                        if e.device_type == DeviceType.CUDA
                                        and e.key not in spans) / 1e3
    finally:
        trainer.finish()
    if trainer.master and (Path(cfg.log_dir) / "metrics.jsonl").exists():
        recs = [json.loads(s) for s in (Path(cfg.log_dir) / "metrics.jsonl").read_text()
                .splitlines()]
        out["step_ms"] = [r["step_ms"] for r in recs if r["kind"] == "train"]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def expert_worker(rank: int, world: int, ports: list[int], work: Path) -> int:
    """One rank of the expert phase's world (``--expert-worker``): two
    processes on ``cuda:0`` over an explicitly requested gloo group.  Runs
    (d) fp32 4 layers 2 steps, then (b) bf16 16 layers 3 steps and one
    profiled step, each in a group of its own, and writes its results to
    ``work/rank{rank}.json``."""
    import os

    from mamba_distributed_tpu_torch.parallel.mesh import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(RANK=str(rank), LOCAL_RANK="0", WORLD_SIZE=str(world))
    res = {}
    for tag, port, cfg, steps, prof in (
            ("d", ports[0], expert_cfg("d", "float32", 4, 8 // world, world), 2, False),
            ("b", ports[1], expert_cfg("b", "bfloat16", 16, 8 // world, world), 3, True)):
        init_distributed("cuda:0", init_method=f"tcp://127.0.0.1:{port}", backend="gloo")
        res[tag] = expert_train(cfg, steps, prof)
    (work / f"rank{rank}.json").write_text(json.dumps(res))
    return 0


def expert_phase(card: str) -> None:
    """Expert parallelism on the card (phase 9): hybrid-280m's widths made
    MoE (``EP_MOE``) through the port's Trainer, (a) one process with no
    group, bf16, 16 layers, micro 8, seq 1024, 3 steps; (b) the same at
    mesh ``expert=2`` in two processes on ``cuda:0`` over gloo, micro 4
    each (the same global rows); (c, d) as (a, b) in fp32 cut to 4 layers,
    2 steps.  Fails unless (d)'s losses and pre-clip grad norms are (c)'s
    within rtol 2e-4 (the JAX package's EP tolerance), (b)'s losses (a)'s
    within 1e-3 and its grad norms within 2e-3, (d)'s two keep masks of
    the first MoE layer's first micro-batch, concatenated, are (c)'s but
    at near ties (tokens whose k-th and (k+1)-th router probabilities lie
    within ``EP_TIE``: counted and printed), every rank launches the SSD
    and flash kernels as often as the one-process run, and both ranks
    exit 0 in time.  Prints the step ms, the all-to-alls of one profiled
    step of (b) (count, bytes, and their share of the step from the
    trace's spans: an upper bound, since each blocking all-to-all also
    waits for the card's queued work), the dropped choices and each
    rank's peak memory."""
    t0 = time.perf_counter()
    a = expert_train(expert_cfg("a", "bfloat16", 16, 8, 1), 3, False)
    c = expert_train(expert_cfg("c", "float32", 4, 8, 1), 2, False)
    t_plain = time.perf_counter() - t0
    ranks = sorted(run_workers("expert", EP_WAIT_S), key=lambda r: r["d"]["coord"])
    t_ep = time.perf_counter() - t0 - t_plain
    fails = []
    for tag, plain, tol, ntol, what in (("d", c, 2e-4, 2e-4, "fp32 4 layers"),
                                        ("b", a, 1e-3, 2e-3, "bf16 16 layers")):
        ref = np.array(plain["hist"])
        for r, res in enumerate(ranks):
            got = np.array(res[tag]["hist"])
            gap = np.abs(got - ref) / np.abs(ref)
            print(f"expert ({tag}) {what} rank {r}: losses {got[:, 0].tolist()} against "
                  f"{ref[:, 0].tolist()}, grad norms {got[:, 1].tolist()} against "
                  f"{ref[:, 1].tolist()}; largest gap rel loss {gap[:, 0].max():.3e}, "
                  f"grad norm {gap[:, 1].max():.3e} (tol {tol:.0e} on the losses, "
                  f"{ntol:.0e} on the grad norms)", flush=True)
            if (not np.isfinite(got).all() or gap[:, 0].max() > tol
                    or gap[:, 1].max() > ntol):
                fails.append(f"({tag}) rank {r}: rel loss {gap[:, 0].max():.3e} (tol {tol:.0e}), "
                             f"grad norm {gap[:, 1].max():.3e} (tol {ntol:.0e})")
            for k in TP_KERNELS:
                if not 0 < plain["launches"][k] == res[tag]["launches"][k]:
                    fails.append(f"({tag}) rank {r} {k} launches {res[tag]['launches'][k]}, "
                                 f"plain {plain['launches'][k]}")
    # the kept choices of the first MoE layer's first micro-batch: (d)'s two
    # ranks together against (c), but at near ties; dropped counts of all four
    for tag, plain in (("d", c), ("b", a)):
        keep = np.array(plain["keep"], dtype=bool)
        got = np.concatenate([np.array(res[tag]["keep"], dtype=bool) for res in ranks])
        tie = np.array(plain["margin"]) < EP_TIE
        differ = (got != keep).any(-1)
        print(f"expert ({tag}) first MoE layer, first micro-batch: capacity {plain['cap']} "
              f"slots an expert ({ranks[0][tag]['cap']} on the ranks), dropped choices "
              f"{int((~keep).sum())} of {keep.size} in one process, "
              f"{int((~got).sum())} over the two ranks; tokens whose kept choices differ "
              f"{int(differ.sum())}, of them at a near tie (k-th and (k+1)-th router "
              f"probabilities within {EP_TIE:.0e}) {int((differ & tie).sum())}; near ties "
              f"{int(tie.sum())}", flush=True)
        if tag == "d" and ((differ & ~tie).any() or ranks[0][tag]["cap"] != plain["cap"]):
            fails.append(f"(d) keep masks differ from (c)'s at {int((differ & ~tie).sum())} "
                         f"tokens that are not near ties")
    b0 = ranks[0]["b"]
    print(f"expert hybrid-280m-MoE 16 layers bf16 micro=8 seq=1024: step ms (a) one process "
          f"{a['step_ms']}, (b) expert=2 over gloo on one card (micro 4 a rank) "
          f"{b0['step_ms']} [{card}]", flush=True)
    comm, step_ms = b0["ep_comm"], b0["trace_step_ms"]
    n_spans, span_ms = b0["trace_a2a"]
    if n_spans != comm["calls"]:
        fails.append(f"(b) the trace holds {n_spans} all-to-all spans, the step made "
                     f"{comm['calls']}")
    print(f"expert (b) one profiled step of rank 0: {comm['calls']} expert-group all-to-alls, "
          f"{comm['bytes']} bytes sent; {comm['route_calls']} routing exchanges (count "
          f"all-gathers and load-balance sums over the batch ranks), {comm['route_bytes']} "
          f"bytes; torch.profiler trace: step span {step_ms:.1f} ms (host clock around the "
          f"profile {b0['profiled_ms']:.1f} ms), {n_spans} all-to-all spans {span_ms:.1f} ms, "
          f"{span_ms / step_ms:.3f} of the step (upper bound: each also waits for the card's "
          f"queued work); device busy {b0['device_busy_ms']:.1f} ms "
          f"({b0['device_busy_ms'] / step_ms:.3f} of the step) [{card}]", flush=True)
    print(f"expert peak max_memory_allocated: (a) {a['peak_gib']:.2f} GiB, (b) rank 0 "
          f"{ranks[0]['b']['peak_gib']:.2f}, rank 1 {ranks[1]['b']['peak_gib']:.2f}; (c) "
          f"{c['peak_gib']:.2f}, (d) {ranks[0]['d']['peak_gib']:.2f} / "
          f"{ranks[1]['d']['peak_gib']:.2f} [{card}]", flush=True)
    print(f"expert launches (a) {a['launches']}, (b) rank 0 {ranks[0]['b']['launches']}",
          flush=True)
    print(f"expert phase: {time.perf_counter() - t0:.1f} s (plain runs {t_plain:.1f}, the two "
          f"ranks {t_ep:.1f}) [{card}]", flush=True)
    if fails:
        raise SystemExit(f"expert phase: {fails}")


# ----------------------------------------- sequence parallel over gloo (10)

SP_WAIT_S = 480
# the seq phase's models: tag -> (the preset whose widths, its depth cut,
# seq_len); bf16 runs (a)/(b), then fp32 runs (c)/(d)
SP_BF16 = {"ssd": ("mamba2-2.8b-sp32", dict(n_layer=4), 8192),
           "hybrid": ("hybrid-7b", dict(n_layer=4, attn_layer_idx=(3,)), 8192),
           "m1": ("mamba1-280m", dict(n_layer=8), 8192)}
SP_FP32 = {"hybrid": ("hybrid-7b", dict(n_layer=2, attn_layer_idx=(1,)), 2048),
           "m1": ("mamba1-280m", dict(n_layer=2), 2048)}
# the worker's runs, in order, each in a group of its own: (tag, dtype,
# model, attention under seq, profiled)
SP_WORKER_RUNS = (("d-hybrid", "float32", "hybrid", "ring", False),
                  ("d-m1", "float32", "m1", "ring", False),
                  ("b-ssd", "bfloat16", "ssd", "ring", False),
                  ("b-hybrid-ring", "bfloat16", "hybrid", "ring", True),
                  ("b-hybrid-ulysses", "bfloat16", "hybrid", "ulysses", False),
                  ("b-m1", "bfloat16", "m1", "ring", False))
SP_KERNELS = ("ssd_fwd", "ssd_chunk_states", "ssd_bwd", "flash_fwd", "flash_bwd_dq",
              "flash_bwd_dkv", "m1_scan", "m1_entry_states", "m1_bwd")


def seq_cfg(tag: str, dtype: str, model_tag: str, seq: int, attn_sp: str = "ring"):
    """The seq phase's run ``model_tag`` (``SP_BF16`` in bf16, ``SP_FP32``
    in fp32: the preset's widths at a cut depth; pallas, remat) at mesh
    ``seq``, micro 1, accum 1, one validation batch, synthetic shards
    under build/chip_smoke/."""
    from mamba_distributed_tpu_torch.config import (
        DataConfig,
        MeshConfig,
        get_preset,
        get_train_preset,
    )

    preset, cut, seq_len = (SP_BF16 if dtype == "bfloat16" else SP_FP32)[model_tag]
    root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    model = get_preset(preset, ssm_impl="pallas", compute_dtype=dtype, remat=True,
                       attn_sp_impl=attn_sp, **cut)
    return get_train_preset(
        preset, model=model, mesh=MeshConfig(seq=seq), micro_batch_size=1,
        total_batch_size=seq_len, seq_len=seq_len, val_steps=1,
        log_dir=str(root / f"log_seq_{tag}"),
        data=DataConfig(data_dir=str(root / "data"), synthetic_tokens_per_shard=1 << 20))


def seq_train(cfg, steps: int, profile: bool) -> dict:
    """``cfg`` through the port's Trainer on this process's card (one rank
    of a seq group when one is up): ``steps`` steps from zeroed launch
    counts; then, with ``profile``, one more step under ``torch.profiler``
    (CPU and CUDA), the step and each seq-group exchange in a
    ``record_function`` span of its own, ``SP_COMM`` zeroed before it.
    Returns the history, launches, step ms, peak memory, and the trace's
    step and exchange spans and device busy time."""
    import gc
    import shutil

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
    from mamba_distributed_tpu_torch.parallel import collectives
    from mamba_distributed_tpu_torch.training import Trainer

    shutil.rmtree(cfg.log_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    trainer = Trainer(cfg, device=f"cuda:{torch.cuda.current_device()}")
    out = {"seq_rank": trainer.seq.rank if trainer.seq is not None else 0}
    try:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        torch.cuda.reset_peak_memory_stats()
        trainer.run(max_steps=steps)
        out["launches"] = dict(LAUNCHES)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["hist"] = [trainer.history[s] for s in range(steps)]
        if profile:
            x, y = trainer._batch(cfg.grad_accum_steps, trainer.train_loader)
            torch.cuda.synchronize()
            collectives.SP_COMM.update(calls=0, bytes=0)
            originals = (collectives.seq_exchange, collectives._tiled_all_to_all)

            def spanned(fn):  # a span over the whole blocking call
                def run(*args):
                    with record_function("sp_exchange"):
                        return fn(*args)
                return run

            collectives.seq_exchange, collectives._tiled_all_to_all = map(spanned, originals)
            try:
                t0 = time.perf_counter()
                with torch_profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
                    with record_function("sp_train_step"):
                        trainer.train_step(trainer.params, x, y)
                        torch.cuda.synchronize()
                out["profiled_ms"] = (time.perf_counter() - t0) * 1e3
            finally:
                collectives.seq_exchange, collectives._tiled_all_to_all = originals
            out["sp_comm"] = dict(collectives.SP_COMM)
            out["step_comm"] = dict(trainer.train_step.comm)
            events = prof.key_averages()
            spans = {e.key: (e.count, e.cpu_time_total / 1e3) for e in events
                     if e.key in ("sp_train_step", "sp_exchange")
                     and e.device_type == DeviceType.CPU}
            if set(spans) != {"sp_train_step", "sp_exchange"} or not all(
                    ms > 0 for _, ms in spans.values()):
                raise SystemExit(f"seq: the trace holds spans {spans}")
            out["trace_step_ms"] = spans["sp_train_step"][1]
            out["trace_exchange"] = spans["sp_exchange"]
            out["device_busy_ms"] = sum(e.self_device_time_total for e in events
                                        if e.device_type == DeviceType.CUDA
                                        and e.key not in spans) / 1e3
    finally:
        trainer.finish()
    if trainer.master and (Path(cfg.log_dir) / "metrics.jsonl").exists():
        recs = [json.loads(s) for s in (Path(cfg.log_dir) / "metrics.jsonl").read_text()
                .splitlines()]
        out["step_ms"] = [r["step_ms"] for r in recs if r["kind"] == "train"]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def seq_worker(rank: int, world: int, ports: list[int], work: Path) -> int:
    """One rank of the seq phase's world (``--seq-worker``): two processes
    on ``cuda:0`` over an explicitly requested gloo group.  Runs
    ``SP_WORKER_RUNS`` in order (2 steps each, the ring hybrid then one
    profiled step), each in a group of its own, and writes its results to
    ``work/rank{rank}.json``."""
    import os

    from mamba_distributed_tpu_torch.parallel.mesh import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(RANK=str(rank), LOCAL_RANK="0", WORLD_SIZE=str(world))
    res = {}
    for (tag, dtype, model_tag, attn_sp, prof), port in zip(SP_WORKER_RUNS, ports, strict=True):
        init_distributed("cuda:0", init_method=f"tcp://127.0.0.1:{port}", backend="gloo")
        res[tag] = seq_train(seq_cfg(tag, dtype, model_tag, world, attn_sp), 2, prof)
    (work / f"rank{rank}.json").write_text(json.dumps(res))
    return 0


def seq_phase(card: str) -> None:
    """Sequence parallelism on the card (phase 10): through the port's
    Trainer, (a) one process with no group, bf16, micro 1, 2 steps, on
    ``SP_BF16`` (mamba2-2.8b-sp32's widths at 4 layers, hybrid-7b's at 4
    layers, mamba1-280m at 8 layers; seq 8192); (b) the same at mesh
    ``seq=2`` in two processes on ``cuda:0`` over gloo, each on its 4096
    tokens of the rows (the hybrid with ring attention, then Ulysses);
    (c, d) as (a, b) in fp32 on ``SP_FP32`` (2 layers, seq 2048; the
    hybrid with ring, Mamba-1).  Fails unless (b)'s losses are (a)'s
    within rtol 1e-3 and its pre-clip grad norms within 2e-3, (d)'s
    (c)'s within 1e-5, every rank launches the SSD kernels as often as
    (a) or (c), the scan kernels twice as often (two passes), and the
    flash kernels r + 1 times as often on seq rank r under ring (the hops
    not skipped) and as often under Ulysses, and both ranks exit 0 in
    time.  Prints the step ms, the seq-group exchanges of one profiled
    step of the ring hybrid (``SP_COMM``: count, bytes, and their share of
    the step from the trace's spans, an upper bound: each blocking
    exchange also waits for the card's queued work), device busy and each
    rank's peak memory."""
    t0 = time.perf_counter()
    plain = {}
    for tag in SP_BF16:
        plain[f"a-{tag}"] = seq_train(seq_cfg(f"a-{tag}", "bfloat16", tag, 1), 2, False)
    for tag in SP_FP32:
        plain[f"c-{tag}"] = seq_train(seq_cfg(f"c-{tag}", "float32", tag, 1), 2, False)
    t_plain = time.perf_counter() - t0
    ranks = sorted(run_workers("seq", SP_WAIT_S, n_ports=len(SP_WORKER_RUNS)),
                   key=lambda r: r["b-ssd"]["seq_rank"])
    t_sp = time.perf_counter() - t0 - t_plain
    fails = []
    for tag, _, model_tag, attn_sp, _ in SP_WORKER_RUNS:
        fp32 = tag.startswith("d")
        ref = plain[f"{'c' if fp32 else 'a'}-{model_tag}"]
        tol, ntol = (1e-5, 1e-5) if fp32 else (1e-3, 2e-3)
        preset, cut, seq_len = (SP_FP32 if fp32 else SP_BF16)[model_tag]
        what = (f"{preset} widths {cut['n_layer']} layers {'fp32' if fp32 else 'bf16'} "
                f"seq {seq_len}" + (f" {attn_sp}" if model_tag == "hybrid" else ""))
        want = np.array(ref["hist"])
        for r, res in enumerate(ranks):
            got_res = res[tag]
            got = np.array(got_res["hist"])
            gap = np.abs(got - want) / np.abs(want)
            print(f"seq ({tag}) {what} rank {r}: losses {got[:, 0].tolist()} against "
                  f"{want[:, 0].tolist()}, grad norms {got[:, 1].tolist()} against "
                  f"{want[:, 1].tolist()}; largest gap rel loss {gap[:, 0].max():.3e}, "
                  f"grad norm {gap[:, 1].max():.3e} (tol {tol:.0e} on the losses, "
                  f"{ntol:.0e} on the grad norms)", flush=True)
            if (not np.isfinite(got).all() or gap[:, 0].max() > tol
                    or gap[:, 1].max() > ntol):
                fails.append(f"({tag}) rank {r}: rel loss {gap[:, 0].max():.3e} (tol {tol:.0e}), "
                             f"grad norm {gap[:, 1].max():.3e} (tol {ntol:.0e})")
            # the launches a rank makes for each of one process's
            factor = {"m1_scan": 2, "m1_entry_states": 2, "m1_bwd": 2}
            if model_tag == "hybrid" and attn_sp == "ring":
                factor.update({k: got_res["seq_rank"] + 1
                               for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")})
            for k in SP_KERNELS:
                n_ref, n_got = ref["launches"].get(k, 0), got_res["launches"].get(k, 0)
                if n_got != factor.get(k, 1) * n_ref:
                    fails.append(f"({tag}) rank {r} {k} launches {n_got}, one process {n_ref} "
                                 f"(x{factor.get(k, 1)} expected)")
            print(f"seq ({tag}) rank {r} (seq rank {got_res['seq_rank']}) launches "
                  f"{ {k: got_res['launches'].get(k, 0) for k in SP_KERNELS} }, one process "
                  f"{ {k: ref['launches'].get(k, 0) for k in SP_KERNELS} }", flush=True)
        kernels = [k for k in SP_KERNELS if ref["launches"].get(k, 0)]
        if not kernels:
            fails.append(f"({tag}) one process launched no hand kernel")
    for tag, _, model_tag, attn_sp, _ in SP_WORKER_RUNS:
        if tag.startswith("b"):
            a = plain[f"a-{model_tag}"]
            print(f"seq ({tag}) step ms: (a) one process {a['step_ms']}, (b) seq=2 over gloo on "
                  f"one card, rank 0 {ranks[0][tag]['step_ms']}; peak max_memory_allocated (a) "
                  f"{a['peak_gib']:.2f} GiB, (b) rank 0 {ranks[0][tag]['peak_gib']:.2f}, rank 1 "
                  f"{ranks[1][tag]['peak_gib']:.2f} [{card}]", flush=True)
    for tag in SP_FP32:
        print(f"seq (c/d-{tag}) fp32 peak max_memory_allocated: (c) "
              f"{plain[f'c-{tag}']['peak_gib']:.2f} GiB, (d) "
              f"{ranks[0][f'd-{tag}']['peak_gib']:.2f} / {ranks[1][f'd-{tag}']['peak_gib']:.2f} "
              f"[{card}]", flush=True)
    for r, res in enumerate(ranks):
        b = res["b-hybrid-ring"]
        comm, step_ms = b["sp_comm"], b["trace_step_ms"]
        n_spans, span_ms = b["trace_exchange"]
        if n_spans != comm["calls"]:
            fails.append(f"(b-hybrid-ring) rank {r}: the trace holds {n_spans} exchange spans, "
                         f"the step made {comm['calls']}")
        print(f"seq (b-hybrid-ring) one profiled step of rank {r}: {comm['calls']} seq-group "
              f"exchanges (SP_COMM), {comm['bytes']} bytes sent; the step's gradient mean "
              f"{b['step_comm'].get('bytes')} bytes in {b['step_comm'].get('buckets')} buckets; "
              f"torch.profiler trace: step span {step_ms:.1f} ms (host clock around the profile "
              f"{b['profiled_ms']:.1f} ms), {n_spans} exchange spans {span_ms:.1f} ms, "
              f"{span_ms / step_ms:.3f} of the step (upper bound: each also waits for the "
              f"card's queued work); device busy {b['device_busy_ms']:.1f} ms "
              f"({b['device_busy_ms'] / step_ms:.3f} of the step) [{card}]", flush=True)
    print(f"seq phase: {time.perf_counter() - t0:.1f} s (plain runs {t_plain:.1f}, the two "
          f"ranks {t_sp:.1f}) [{card}]", flush=True)
    if fails:
        raise SystemExit(f"seq phase: {fails}")


CP_WAIT_S = 480
# the compose phase's runs: tag -> (preset whose widths, model overrides,
# mesh of (b), micro-batch a batch rank, accum, seq_len)
CP_RUNS = {"st": ("hybrid-7b", dict(n_layer=2, attn_layer_idx=(1,)), dict(seq=2, tensor=2),
                  1, 1, 8192),
           "se": ("hybrid-280m", dict(n_layer=4, attn_layer_idx=(3,), **EP_MOE),
                  dict(seq=2, expert=2), 1, 1, 8192),
           "pp": ("hybrid-280m", dict(n_layer=16, attn_layer_idx=(3, 11)),
                  dict(pipe=2, data=2), 4, 4, 1024)}
# fp32 (c)/(d): (i) at seq 2048
CP_FP32 = ("st", 2048)
# the world's runs, in order, each in a group of its own: (tag, dtype)
CP_WORKER_RUNS = (("b-st", "bfloat16"), ("b-se", "bfloat16"), ("b-pp", "bfloat16"),
                  ("d-st", "float32"))


def compose_cfg(tag: str, dtype: str, run: str, mesh: dict | None):
    """Compose run ``run`` (``CP_RUNS``; fp32 at ``CP_FP32``'s seq) at
    ``mesh`` (None: one process, its micro-batch the global one), pallas,
    remat, one validation batch, synthetic shards under build/chip_smoke/."""
    from mamba_distributed_tpu_torch.config import (
        DataConfig,
        MeshConfig,
        get_preset,
        get_train_preset,
    )

    preset, over, cp_mesh, micro, accum, seq_len = CP_RUNS[run]
    if dtype == "float32":
        seq_len = CP_FP32[1]
    dp = cp_mesh.get("data", 1) * cp_mesh.get("expert", 1)
    root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    model = get_preset(preset, ssm_impl="pallas", compute_dtype=dtype, remat=True, **over)
    return get_train_preset(
        preset, model=model, mesh=MeshConfig(**(mesh or {})), shard_params=False,
        micro_batch_size=micro if mesh else micro * dp, seq_len=seq_len,
        total_batch_size=micro * dp * accum * seq_len, val_steps=1,
        log_dir=str(root / f"log_compose_{tag}"),
        data=DataConfig(data_dir=str(root / "data"), synthetic_tokens_per_shard=1 << 20))


def compose_train(cfg, steps: int) -> dict:
    """``cfg`` through the port's Trainer on this process's card (one rank
    of a composed mesh when a group is up): ``steps`` steps from zeroed
    launch counts, then one more step, host-timed to a synchronize, with
    the seq, tensor, expert and pipe exchange counters zeroed before it.
    Returns the history, launches, the measured step's ms and exchanges,
    the ranks' coordinates and the peak memory."""
    import gc
    import shutil

    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
    from mamba_distributed_tpu_torch.parallel import collectives
    from mamba_distributed_tpu_torch.training import Trainer

    shutil.rmtree(cfg.log_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    trainer = Trainer(cfg, device=f"cuda:{torch.cuda.current_device()}")
    out = {"seq_rank": trainer.seq.rank if trainer.seq is not None else 0,
           "stage": trainer.pipe.rank if trainer.pipe is not None else 0}
    comms = {"sp": collectives.SP_COMM, "tp": collectives.TP_COMM, "ep": collectives.EP_COMM,
             "pp": collectives.PP_COMM}
    try:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        torch.cuda.reset_peak_memory_stats()
        trainer.run(max_steps=steps)
        out["launches"] = dict(LAUNCHES)
        out["hist"] = [trainer.history[s] for s in range(steps)]
        x, y = trainer._batch(cfg.grad_accum_steps, trainer.train_loader)
        torch.cuda.synchronize()
        for c in comms.values():
            for k in c:
                c[k] = 0
        t0 = time.perf_counter()
        trainer.train_step(trainer.params, x, y)
        torch.cuda.synchronize()
        out["step_ms"] = (time.perf_counter() - t0) * 1e3
        out["comm"] = {name: dict(c) for name, c in comms.items()}
        out["reduce"] = dict(trainer.train_step.comm)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    finally:
        trainer.finish()
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def compose_worker(rank: int, world: int, ports: list[int], work: Path) -> int:
    """One rank of the compose phase's world (``--compose-worker``): four
    processes on ``cuda:0`` over an explicitly requested gloo group, the
    runs of ``CP_WORKER_RUNS`` in turn, each in a group of its own;
    writes its results to ``work/rank{rank}.json``."""
    import os

    from mamba_distributed_tpu_torch.parallel.mesh import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(RANK=str(rank), LOCAL_RANK="0", WORLD_SIZE=str(world))
    res = {}
    for (tag, dtype), port in zip(CP_WORKER_RUNS, ports, strict=True):
        init_distributed("cuda:0", init_method=f"tcp://127.0.0.1:{port}", backend="gloo")
        run = tag.split("-")[1]
        res[tag] = compose_train(compose_cfg(tag, dtype, run, CP_RUNS[run][2]), 2)
    (work / f"rank{rank}.json").write_text(json.dumps(res))
    return 0


def compose_phase(card: str) -> None:
    """The composed meshes and the pipeline on the card (phase 11, module
    docstring): the one-process runs (a) and (c) here, then the world of
    four (b, d); the gates on the losses, grad norms and every rank's
    launches, and the exchanges, step ms and peaks printed."""
    t0 = time.perf_counter()
    plain = {f"a-{run}": compose_train(compose_cfg(f"a-{run}", "bfloat16", run, None), 2)
             for run in CP_RUNS}
    plain["c-st"] = compose_train(compose_cfg("c-st", "float32", "st", None), 2)
    t_plain = time.perf_counter() - t0
    ranks = run_workers("compose", CP_WAIT_S, world=4, n_ports=len(CP_WORKER_RUNS))
    t_world = time.perf_counter() - t0 - t_plain
    fails = []
    for tag, dtype in CP_WORKER_RUNS:
        fp32 = dtype == "float32"
        run = tag.split("-")[1]
        preset, over, mesh, micro, accum, seq_len = CP_RUNS[run]
        ref = plain[f"{'c' if fp32 else 'a'}-{run}"]
        tol, ntol = (1e-5, 1e-5) if fp32 else (1e-3, 2e-3)
        what = (f"{preset} widths {over['n_layer']} layers {'fp32' if fp32 else 'bf16'} "
                f"seq {CP_FP32[1] if fp32 else seq_len} mesh {mesh}")
        want = np.array(ref["hist"])
        for r, res in enumerate(ranks):
            got_res = res[tag]
            got = np.array(got_res["hist"])
            gap = np.abs(got - want) / np.abs(want)
            print(f"compose ({tag}) {what} rank {r}: losses {got[:, 0].tolist()} against "
                  f"{want[:, 0].tolist()}, grad norms {got[:, 1].tolist()} against "
                  f"{want[:, 1].tolist()}; largest gap rel loss {gap[:, 0].max():.3e}, "
                  f"grad norm {gap[:, 1].max():.3e} (tol {tol:.0e} on the losses, "
                  f"{ntol:.0e} on the grad norms)", flush=True)
            if (not np.isfinite(got).all() or gap[:, 0].max() > tol
                    or gap[:, 1].max() > ntol):
                fails.append(f"({tag}) rank {r}: rel loss {gap[:, 0].max():.3e} (tol {tol:.0e}), "
                             f"grad norm {gap[:, 1].max():.3e} (tol {ntol:.0e})")
            # a rank's launches against one process's: the ring's r + 1
            # hops on seq rank r; half the layers a stage
            factor = {}
            if "seq" in mesh:
                factor = {k: got_res["seq_rank"] + 1
                          for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
            for k in SP_KERNELS:
                n_ref, n_got = ref["launches"].get(k, 0), got_res["launches"].get(k, 0)
                want_n = n_ref * factor.get(k, 1) / mesh.get("pipe", 1)
                if n_got != want_n:
                    fails.append(f"({tag}) rank {r} {k} launches {n_got}, one process {n_ref} "
                                 f"({want_n} expected)")
            comm = got_res["comm"]
            print(f"compose ({tag}) rank {r} (seq rank {got_res['seq_rank']}, stage "
                  f"{got_res['stage']}) launches "
                  f"{ {k: got_res['launches'].get(k, 0) for k in SP_KERNELS} }, one process "
                  f"{ {k: ref['launches'].get(k, 0) for k in SP_KERNELS} }; one measured step: "
                  f"{got_res['step_ms']:.1f} ms, seq exchanges {comm['sp']['calls']} "
                  f"({comm['sp']['bytes']} bytes), tensor all-reduces and head gathers "
                  f"{comm['tp']['calls']} ({comm['tp']['bytes']} bytes), all-to-alls "
                  f"{comm['ep']['calls']} ({comm['ep']['bytes']} bytes) and routing exchanges "
                  f"{comm['ep']['route_calls']} ({comm['ep']['route_bytes']} bytes), pipe "
                  f"shifts {comm['pp']['calls']} ({comm['pp']['bytes']} bytes), gradient "
                  f"reduction {got_res['reduce'].get('bytes')} bytes in "
                  f"{got_res['reduce'].get('buckets')} buckets; peak max_memory_allocated "
                  f"{got_res['peak_gib']:.2f} GiB [{card}]", flush=True)
            if ("seq" in mesh) != (comm["sp"]["calls"] > 0) or (
                    ("pipe" in mesh) != (comm["pp"]["calls"] > 0)) or (
                    ("tensor" in mesh) != (comm["tp"]["calls"] > 0)) or (
                    ("expert" in mesh) != (comm["ep"]["calls"] > 0)):
                fails.append(f"({tag}) rank {r}: exchanges {comm} do not match mesh {mesh}")
        if not any(ref["launches"].get(k, 0) for k in SP_KERNELS):
            fails.append(f"({tag}) one process launched no hand kernel")
        print(f"compose ({tag}) one process: measured step {ref['step_ms']:.1f} ms, peak "
              f"max_memory_allocated {ref['peak_gib']:.2f} GiB [{card}]", flush=True)
    print(f"compose phase: {time.perf_counter() - t0:.1f} s (one-process runs {t_plain:.1f}, "
          f"the world of four {t_world:.1f}) [{card}]", flush=True)
    if fails:
        raise SystemExit(f"compose phase: {fails}")


# ------------------------------------------------------------ serving meshes

SM_WAIT_S = 900
# tag: (preset, layers (None: the preset's), (data, stage, model), compute dtype, overrides)
# every mesh at full width, its depth cut to keep the script under its
# limit: four ranks on one card stage every collective through the host,
# 5-13 ms each by the machine (PERF.md §4-§5), and a tick costs its
# collectives: hybrid-280m to 16 layers (attention at 3 and 11),
# hybrid-7b to 8 (one period of its pattern, attention at 3), mamba2-280m
# to 16; the fp32 meshes mamba1-280m and hybrid-280m (attention at 3) to 4
SM_RUNS = {
    "i": ("hybrid-280m", 16, (2, 1, 2), "bfloat16", dict(tick_compaction=True)),
    "ii": ("hybrid-7b", 8, (1, 1, 4), "bfloat16", {}),
    "iii": ("hybrid-280m", 16, (1, 2, 2), "bfloat16", {}),
    "iv": ("mamba2-280m", 16, (1, 4, 1), "bfloat16", dict(tick_compaction=True)),
    "f": ("mamba1-280m", 4, (2, 1, 2), "float32", {}),
    "g": ("hybrid-280m", 4, (2, 1, 2), "float32", {}),
}
# the hand kernels of the served path (rows 1, 4, 10, 11); a data rank runs
# the prefills of its own slots only
SM_KERNELS = ("ssd_fwd", "m1_scan", "ragged_decode", "ragged_prefill")
SM_PREFILL = ("ssd_fwd", "m1_scan", "ragged_prefill")
SM_NORMS = ("rms_norm_gated_sumsq",)
SM_NEW = 32
# the requests of the mix held to generate(mesh=) bit for bit: the
# sampled 700-token ones (three chunks), one on each data shard (requests
# 3 and 7 land in slots 3 and 7); a solo call decodes its 32 steps alone,
# over collectives of 5-13 ms each here, so the other streams are held by
# the CPU tests, and the greedy one to one process
SM_GATED = {1: (3,), 2: (3, 7)}
# the greedy request's logits at each of its 32 steps, its one-process
# stream fed to both sides, against one process's, relative to the step's
# largest |logit|: bf16 at most SM_BF16_GAP (the sound meshes read up to
# 2.3e-02, the planted fault of mesh SM_CONTROL, its embedding without the
# model sum, about 1.35: PERF.md §5), fp32 at most SM_FP32_GAP
SM_BF16_GAP = 5e-2
SM_FP32_GAP = 1e-5
SM_CONTROL = "i"


def mesh_cfg(tag: str):
    from mamba_distributed_tpu_torch.config import get_preset

    preset, layers, _, dtype, over = SM_RUNS[tag]
    return cut_layers(get_preset(preset, ssm_impl="pallas", compute_dtype=dtype, **over), layers)


def forced_logits(params, cfg, prompt, tokens, mesh=None) -> torch.Tensor:
    """The logits before each of ``tokens`` (len(tokens), V) fp32 on the
    host: ``prompt`` prefilled as the engine admits it (a hybrid's through
    the chunk step, a short pure-SSM prompt one-shot over its pow2
    bucket), then one decode step a token fed, at one row; on ``mesh``
    (its model and stage groups) when given."""
    from mamba_distributed_tpu_torch.inference.bucketing import next_pow2_bucket, pad_to_bucket
    from mamba_distributed_tpu_torch.models.lm import lm_prefill, lm_step
    from mamba_distributed_tpu_torch.serving.prefill import chunked_prefill

    emb = params["embedding"]
    dev = (emb["kernel"] if isinstance(emb, dict) else emb).device
    ids = torch.as_tensor(prompt, dtype=torch.int64)[None]
    kw = {} if mesh is None else dict(tp=mesh.tp, stage=mesh.stage_ctx)
    with torch.no_grad():
        if cfg.attn_layer_idx:
            logits, state = chunked_prefill(params, cfg, ids, max_len=len(prompt) + SM_NEW,
                                            mesh=mesh)
        else:
            padded, mask = pad_to_bucket(ids.to(dev), next_pow2_bucket(len(prompt)))
            logits, state = lm_prefill(params, cfg, padded, token_mask=mask, **kw)
        out = [logits[0]]
        for tok in tokens[:-1]:
            logits, state = lm_step(params, cfg, state, torch.tensor([tok], device=dev), **kw)
            out.append(logits[0])
    return torch.stack(out).float().cpu()


def no_embedding_sum():
    """A planted fault for the gap gate's control: the vocab-parallel
    embedding without its model-group sum (each rank keeps the rows of
    its own vocab block, zeros elsewhere).  Returns the undo."""
    from mamba_distributed_tpu_torch.models import lm

    real = lm.serve_all_reduce_

    def faulty(t, group, kind):
        return t if kind == "embed" else real(t, group, kind)

    lm.serve_all_reduce_ = faulty
    return lambda: setattr(lm, "serve_all_reduce_", real)


def mesh_serve(tag: str, work: Path) -> dict:
    """One mesh of the serving mesh phase on this rank: build this rank's
    shard of the seeded weights (hybrid-7b's ranks one at a time: the fp32
    masters are 35.5 GB at full depth), serve the mix (no warm-up: the
    first tick's setup falls out of the median), then the ``SM_GATED``
    requests again through ``generate(mesh=)``; the rank's streams, the
    requests' slots, launches, one decode tick's ``SERVE_COMM``, times,
    bytes and peak, and rank 0's ``forced_logits`` along one process's
    greedy stream (``work/inputs.json``) in ``work`` (for ``SM_CONTROL``
    also with ``no_embedding_sum`` planted)."""
    import torch.distributed as dist

    from mamba_distributed_tpu_torch.inference.generate import generate
    from mamba_distributed_tpu_torch.models.lm import init_lm_params
    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
    from mamba_distributed_tpu_torch.parallel.collectives import SERVE_COMM, reset_serve_comm
    from mamba_distributed_tpu_torch.parallel.mesh import serving_mesh
    from mamba_distributed_tpu_torch.serving import ServingEngine
    from mamba_distributed_tpu_torch.serving.prefill import serving_shard

    cfg = mesh_cfg(tag)
    D, S, M = SM_RUNS[tag][2]
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = serving_mesh(D, M, S, replicas=world // (D * S * M))
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    big = cfg.d_model >= 4096
    shard = None
    for r in (range(world) if big else [rank]):
        if r == rank:
            masters = init_lm_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                     device="cuda")
            shard = serving_shard(masters, cfg, mesh)
            del masters
            torch.cuda.empty_cache()
        if big:
            dist.barrier()
    build_gib = torch.cuda.max_memory_allocated() / 2**30
    t_build = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    lens, prompts, requests = serving_mix(cfg, SM_NEW)
    eng = ServingEngine(shard, cfg, capacity=8, mesh=mesh)
    reqs = requests()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t1 = time.perf_counter()
    ids = [eng.submit(r) for r in reqs]
    tracked = {t.request_id: t for t in eng.scheduler}
    ticks, comm, slots = [], None, [None] * len(ids)
    while eng.pending:
        prefill_pending = bool(eng.scheduler.depth or eng._prefill_queue)
        reset_serve_comm()
        ts = time.perf_counter()
        events = eng.step()
        for j, i in enumerate(ids):
            if slots[j] is None:
                slots[j] = tracked[i].slot
        if events and not prefill_pending:
            ticks.append((time.perf_counter() - ts) * 1e3)
            comm = {"calls": SERVE_COMM["calls"], "bytes": SERVE_COMM["bytes"],
                    "kinds": dict(SERVE_COMM["kinds"])}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {k: LAUNCHES[k] for k in (*SM_KERNELS, *SM_NORMS)}
    streams = [eng.results[i].new_tokens.tolist() for i in ids]
    ttft = sorted((tracked[i].t_first_token - tracked[i].t_submit) * 1e3 for i in ids)
    peak = torch.cuda.max_memory_allocated() / 2**30
    t2 = time.perf_counter()
    solo = [generate(shard, cfg, torch.from_numpy(p)[None], seed=i, max_new_tokens=SM_NEW,
                     top_k=1 if i == 0 else 50, decode_rows=8, mesh=mesh)[0, len(p):].tolist()
            for i, p in enumerate(prompts) if i in SM_GATED[D]]
    t_gen = time.perf_counter() - t2
    fed = json.loads((work / "inputs.json").read_text())[tag]
    forced = {"sound": forced_logits(shard, cfg, prompts[0], fed, mesh)}
    if tag == SM_CONTROL:
        undo = no_embedding_sum()
        try:
            forced["control"] = forced_logits(shard, cfg, prompts[0], fed, mesh)
        finally:
            undo()
    if rank == 0:
        torch.save(forced, work / f"forced_{tag}.pt")
    return dict(coords=[mesh.data_rank, mesh.stage_rank, mesh.model_rank], streams=streams,
                slots=slots, generate=solo, launches=launches, comm=comm, tick_ms=sorted(ticks),
                ttft_ms=ttft[len(ttft) // 2], tokens_per_s=sum(map(len, streams)) / wall,
                weight_bytes=eng.weight_bytes, peak_gib=peak, build_gib=build_gib,
                pages=eng.page_pool.pages_in_use if eng.hybrid else 0,
                pipeline=eng.metrics.summary()["pipeline"], build_s=t_build, serve_s=wall,
                generate_s=t_gen)


def mesh_worker(rank: int, world: int, ports: list[int], work: Path) -> int:
    """One rank of the serving mesh phase's world (``--mesh-worker``): four
    processes on ``cuda:0`` over an explicitly requested gloo group, the
    meshes of ``SM_RUNS`` in turn, each in a group of its own; writes its
    results to ``work/rank{rank}.json``."""
    import os

    import torch.distributed as dist

    from mamba_distributed_tpu_torch.parallel.mesh import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(RANK=str(rank), LOCAL_RANK="0", WORLD_SIZE=str(world))
    res = {}
    for tag, port in zip(SM_RUNS, ports, strict=True):
        init_distributed("cuda:0", init_method=f"tcp://127.0.0.1:{port}", backend="gloo")
        res[tag] = mesh_serve(tag, work)
        torch.cuda.empty_cache()
        dist.destroy_process_group()
        (work / f"rank{rank}.json").write_text(json.dumps(res))
    return 0


def mesh_reference(tag: str) -> dict:
    """One process's side of a mesh run on the same seeded weights: the
    engine's streams, launches, weight bytes, peak and serving numbers
    over the mix, the greedy stream's ``forced_logits`` and its top-two
    margins."""
    from mamba_distributed_tpu_torch.models.lm import init_lm_params
    from mamba_distributed_tpu_torch.serving import ServingEngine
    from mamba_distributed_tpu_torch.serving.prefill import serving_shard

    cfg = mesh_cfg(tag)
    preset = SM_RUNS[tag][0]
    masters = init_lm_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    dparams = serving_shard(masters, cfg)
    del masters
    torch.cuda.empty_cache()
    lens, prompts, requests = serving_mix(cfg, SM_NEW)
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(dparams, cfg, capacity=8)
    ref = timed_drive(eng, requests())
    ref.update(greedy=ref["streams"][0], weight_bytes=eng.weight_bytes,
               ttft_ms=ref["ttft"][len(ref["ttft"]) // 2],
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del eng
    ref["forced"] = forced_logits(dparams, cfg, prompts[0], ref["greedy"])
    (ref["margin_tokens"], ref["margins"], ref["peaks"]), = greedy_margins(
        dparams, cfg, prompts[:1], [SM_NEW], 8)
    del dparams
    torch.cuda.empty_cache()
    return ref


def serving_mesh_phase(card: str) -> dict:
    """The serving meshes on the card (phase 12, module docstring): one
    process's references here, then one world of four processes sharing
    the card over gloo (``--mesh-worker``) that serves the mix on every
    mesh of ``SM_RUNS`` in turn.  Gates: every rank's streams of the
    ``SM_GATED`` requests (one on each data shard) equal its
    ``generate(mesh=)`` streams bit for bit (sampling on); the greedy
    request's ``forced_logits`` (one process's greedy stream fed to both)
    within ``SM_BF16_GAP`` (fp32: ``SM_FP32_GAP``) of one process's at
    every step, relative to the step's largest |logit|, and the planted
    fault of ``SM_CONTROL`` beyond it; the greedy stream equal to one
    process's or parted only at a step whose top-two margin is within
    that tolerance (bf16: ``MARGIN_TOL``) of the step's largest |logit|;
    no page in use at the end; every rank launches rows 1, 4, 10 and 11
    as one process does (a stage its share; the prefills summed over the
    data ranks); a rank at model 4 holds under 0.3 of one process's
    weight bytes; the stage-only mesh runs the microbatched clock and
    bills its bubbles.  Printed: the logits gaps, launches, one decode
    tick's ``SERVE_COMM``, tick ms, TTFT and tokens/s, weight bytes and
    peaks a rank, the bubble lanes.  Returns rank 0's launches of runs
    (i) and (ii)."""
    t0 = time.perf_counter()
    refs = {tag: mesh_reference(tag) for tag in SM_RUNS}
    t_ref = time.perf_counter() - t0
    ranks = run_workers("mesh", SM_WAIT_S, world=4, n_ports=len(SM_RUNS),
                        inputs={tag: ref["greedy"] for tag, ref in refs.items()})
    t_world = time.perf_counter() - t0 - t_ref
    work = Path(__file__).resolve().parent / "build" / "chip_smoke" / "mesh"
    fails = []
    for tag, (preset, layers, (D, S, M), dtype, over) in SM_RUNS.items():
        ref = refs[tag]
        what = (f"{preset} {layers or 'all'} layers {dtype} mesh data={D} stage={S} model={M}"
                f"{' ' + str(over) if over else ''}")
        fp32 = dtype == "float32"
        limit = SM_FP32_GAP if fp32 else SM_BF16_GAP
        forced = torch.load(work / f"forced_{tag}.pt")
        scale = ref["forced"].abs().amax(dim=-1)
        for kind, got_logits in forced.items():
            gaps = (got_logits - ref["forced"]).abs().amax(dim=-1) / scale
            worst = int(gaps.argmax())
            print(f"mesh ({tag}) {what}{'' if kind == 'sound' else ', the embedding without '
                                         'its model sum planted'}: logits gap to one process "
                  f"along its greedy stream, of the step's largest |logit|: first step "
                  f"{gaps[0].item():.3e}, largest {gaps[worst].item():.3e} (step {worst} of "
                  f"{len(gaps)}; limit {limit:.0e})", flush=True)
            if kind == "sound" and not gaps.max().item() <= limit:
                fails.append(f"({tag}) logits gap {gaps.max().item():.3e} > {limit:.0e}")
            if kind == "control" and not gaps.max().item() > limit:
                fails.append(f"({tag}) the planted fault's logits gap {gaps.max().item():.3e} "
                             f"is within the limit {limit:.0e}")
        tie_tol = SM_FP32_GAP if fp32 else MARGIN_TOL
        gated_ids = SM_GATED[D]
        for r, res in enumerate(ranks):
            got = res[tag]
            d, s, m = got["coords"]
            gated = [got["streams"][i] for i in gated_ids] == got["generate"]
            if not gated:
                bad = [i for i, b in zip(gated_ids, got["generate"]) if got["streams"][i] != b]
                fails.append(f"({tag}) rank {r}: engine streams {bad} != generate(mesh=)")
            shards = sorted({got["slots"][i] // (8 // D) for i in gated_ids})
            if shards != list(range(D)):
                fails.append(f"({tag}) rank {r}: the gated requests {list(gated_ids)} sat on "
                             f"data shards {shards} of {D}")
            greedy, want = got["streams"][0], ref["greedy"]
            part = next((j for j, (a, b) in enumerate(zip(greedy, want)) if a != b), None)
            note = "equal"
            if part is not None:
                rel = ref["margins"][part] / ref["peaks"][part]
                note = f"parted at step {part}, margin {rel:.4f} of the largest |logit|"
                if ref["margin_tokens"][:part + 1] != want[:part + 1] or rel > tie_tol:
                    fails.append(f"({tag}) rank {r}: greedy stream {note}")
            if got["pages"]:
                fails.append(f"({tag}) rank {r}: {got['pages']} KV pages in use at the end")
            for k in SM_KERNELS:
                n_ref, n_got = ref["launches"].get(k, 0), got["launches"][k]
                if k in SM_PREFILL:
                    n_got = sum(x[tag]["launches"][k] for x in ranks
                                if x[tag]["coords"][1:] == [s, m])
                if n_ref % S or n_got != n_ref // S:
                    fails.append(f"({tag}) rank {r} {k}: {n_got} launches"
                                 f"{' over the data ranks' if k in SM_PREFILL else ''}, one "
                                 f"process {n_ref} ({n_ref / S} expected)")
            print(f"mesh ({tag}) rank {r} (data {d}, stage {s}, model {m}): streams "
                  f"{list(gated_ids)} (slots {[got['slots'][i] for i in gated_ids]}) == "
                  f"generate(mesh=): {gated}; greedy against one "
                  f"process: {note}; launches {got['launches']}, one process "
                  f"{ {k: ref['launches'].get(k, 0) for k in SM_KERNELS} }; KV pages in use "
                  f"{got['pages']}", flush=True)
            print(f"mesh ({tag}) rank {r}: one decode tick's collectives {got['comm']}; tick "
                  f"ms median {p50(got['tick_ms']) if got['tick_ms'] else None} of "
                  f"{len(got['tick_ms'])}, TTFT median {got['ttft_ms']:.1f} ms, "
                  f"{got['tokens_per_s']:.1f} tokens/s (one process: tick "
                  f"{ref['tick_ms']}, TTFT {ref['ttft_ms']:.1f}, tokens/s "
                  f"{ref['tokens_per_s']:.1f}); weight bytes {got['weight_bytes']} against "
                  f"{ref['weight_bytes']} ({got['weight_bytes'] / ref['weight_bytes']:.3f}x); "
                  f"peak max_memory_allocated {got['peak_gib']:.2f} GiB serving, "
                  f"{got['build_gib']:.2f} building (one process {ref['peak_gib']:.2f}); "
                  f"build {got['build_s']:.1f} s, "
                  f"serve {got['serve_s']:.1f} s, generate {got['generate_s']:.1f} s [{card}]",
                  flush=True)
            if M >= 4 and got["weight_bytes"] > 0.3 * ref["weight_bytes"]:
                fails.append(f"({tag}) rank {r}: {got['weight_bytes']} weight bytes, over 0.3 "
                             f"of one process's {ref['weight_bytes']}")
            if S > 1:
                pipe = got["pipeline"]
                print(f"mesh ({tag}) rank {r}: pipeline {pipe}", flush=True)
                clocked = D == 1 and M == 1 and not SM_RUNS[tag][0].startswith("hybrid")
                if pipe is None or (clocked and not (pipe["pipelined_ticks"]
                                                     and pipe["bubble_lanes"])):
                    fails.append(f"({tag}) rank {r}: the decode clock's bubbles {pipe}")
    print(f"serving mesh phase: {time.perf_counter() - t0:.1f} s (one-process references "
          f"{t_ref:.1f}, the world of four {t_world:.1f}) [{card}]", flush=True)
    if fails:
        raise SystemExit(f"serving mesh phase: {fails}")
    return {tag: ranks[0][tag]["launches"] for tag in ("i", "ii")}


def check_tp_shapes(gen) -> None:
    """The hand kernels at the per-rank shapes of tensor parallelism:
    ``ssd_fwd``, ``ssd_chunk_states`` and ``ssd_bwd`` at hybrid-7b's 64,
    32 and 16 SSD heads a rank (tensor 2, 4, 8; b 4, t 4096, d_state 128),
    the flash kernels at its 16q/4kv, 8q/2kv and 4q/1kv heads of 128
    (b 4, t 4096, the plain versions at b 1), and ``m1_scan`` and ``m1_bwd``
    at mamba1-280m's d_inner 768 a rank at tensor 2 (fp32, b 32, t 1024),
    each against its plain version at the tolerance of its dtype, timed
    beside its bound."""
    from mamba_distributed_tpu_torch.ops.cuda import flash_kernels as fk
    from mamba_distributed_tpu_torch.ops.cuda import scan_kernels as mk
    from mamba_distributed_tpu_torch.ops.cuda import ssd_kernels as sk
    from mamba_distributed_tpu_torch.ops.cuda.flash_kernels import flash_work
    from mamba_distributed_tpu_torch.ops.ssd import chunk_log_decay, ssd_chunked, state_passing

    bf16, l, b, t = torch.bfloat16, 256, 4, 4096
    failures = []

    def show(name, shape, err, tol, ms, plain_ms, work):
        bound_ms, bound_by = (m1_bound(*work) if len(work) == 3 else bound(*work))
        print(f"time {name} tensor-parallel {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
              f" bound {bound_ms:.6f} ms ({bound_by}); max_abs_err={err[0]:.3e} (rel "
              f"{err[1]:.2e}), tol rel {tol:.0e}", flush=True)
        if not err[1] <= tol:
            failures.append(f"{name} {shape}: rel {err[1]:.3e}")

    for n, h in ((2, 64), (4, 32), (8, 16)):
        shape = f"hybrid-7b tensor {n}: b={b} t={t} h={h}"
        inp = ssd_inputs(gen, b, t, 1, bf16, False, h=h)
        kw = dict(chunk_size=l, return_final_state=True, compute_dtype=bf16)
        yk, fk_ = sk.ssd_chunked_kernel(**inp, **kw)
        yp, fp = ssd_chunked(**inp, **kw)
        err = max(rel_err(yk, yp), rel_err(fk_, fp), key=lambda e: e[1])
        args = (inp["x"], inp["dt"], inp["A"], inp["B"], inp["C"], l, inp["initial_state"], bf16)
        show("ssd_fwd", shape, err, TOL[bf16],
             sum(device_ms(lambda: sk._ssd_fwd(*args), 10).values()),
             cuda_ms(lambda: ssd_chunked(**inp, **kw), 2, 1),
             ssd_work(b, t, h, 1, 64, 128, l, bf16, False))
        del yk, fk_, yp, fp
        x, dt, A, B, C = (inp[k] for k in ("x", "dt", "A", "B", "C"))
        a4 = chunk_log_decay(dt, A, l)
        a_cum = a4.reshape(b, t, h).contiguous()
        st_k = sk.ssd_chunk_states_kernel(x, dt, a_cum, B, l, bf16)
        st_p = sk.ssd_chunk_states_plain(x, dt, a_cum, B, l, bf16)
        prev = state_passing(st_p, torch.exp(a4[:, :, -1]), None)[0].contiguous()
        dy = torch.randn((b, t, h, 64), generator=gen, device="cuda").to(bf16)
        bargs = (x, dt, a_cum, B, C, prev, dy, None, l, bf16)
        got, ref = sk.ssd_bwd_kernel(*bargs), sk.ssd_bwd_plain(*bargs)
        w2, w3 = ssd_bwd_work(b, t, h, 1, 64, 128, l, bf16, False, False)
        show("ssd_chunk_states", shape, rel_err(st_k, st_p), TOL[bf16],
             sum(device_ms(lambda: sk.ssd_chunk_states_kernel(x, dt, a_cum, B, l, bf16),
                           10).values()),
             cuda_ms(lambda: sk.ssd_chunk_states_plain(x, dt, a_cum, B, l, bf16), 2, 1), w2)
        show("ssd_bwd", shape, max((rel_err(g_, r_) for g_, r_ in zip(got, ref)),
                                   key=lambda e: e[1]), TOL[bf16],
             cuda_ms(lambda: sk.ssd_bwd_kernel(*bargs), 5),
             cuda_ms(lambda: sk.ssd_bwd_plain(*bargs), 2, 1), w3)
        del inp, x, dt, A, B, C, a4, a_cum, st_k, st_p, prev, dy, bargs, got, ref
        torch.cuda.empty_cache()

    hd = 128
    for n, nh, nkv in ((2, 16, 4), (4, 8, 2), (8, 4, 1)):
        shape = f"hybrid-7b tensor {n}: b={b} t={t} nh={nh} nkv={nkv} hd={hd}"
        qt, kt, vt, do = flash_inputs(gen, b, t, t, nh, nkv, hd, bf16)
        one = (qt[:1], kt[:1], vt[:1])
        o_k, lse_k = fk.flash_fwd(qt, kt, vt, 0, t)
        delta = (do.float() * o_k.float()).sum(-1).contiguous()
        bwd = (qt, kt, vt, do, lse_k, delta, 0, t)
        bwd1 = (*one, do[:1], lse_k[:1], delta[:1], 0, t)
        errs = (rel_err(o_k[:1], fk.flash_fwd_plain(*one, 0, t)[0]),
                rel_err(fk.flash_bwd_dq(*bwd)[:1], fk.flash_bwd_dq_plain(*bwd1)),
                max((rel_err(g_[:1], r_) for g_, r_ in zip(fk.flash_bwd_dkv(*bwd),
                                                         fk.flash_bwd_dkv_plain(*bwd1))),
                    key=lambda e: e[1]))
        timed = (("flash_fwd", lambda: fk.flash_fwd(qt, kt, vt, 0, t),
                  lambda: fk.flash_fwd_plain(*one, 0, t)),
                 ("flash_bwd_dq", lambda: fk.flash_bwd_dq(*bwd),
                  lambda: fk.flash_bwd_dq_plain(*bwd1)),
                 ("flash_bwd_dkv", lambda: fk.flash_bwd_dkv(*bwd),
                  lambda: fk.flash_bwd_dkv_plain(*bwd1)))
        for (name, kern, plain), err, work in zip(timed, errs,
                                                  flash_work(b, t, t, nh, nkv, hd, 0, bf16)):
            show(name, shape + " (plain at b=1)", err, TOL[bf16], cuda_ms(kern, 5),
                 cuda_ms(plain, 2, 1), work)
        del qt, kt, vt, do, o_k, lse_k, delta, bwd, bwd1
        torch.cuda.empty_cache()

    mb, mt, d = 32, 1024, 768
    u, dt, A, B, C, _ = m1_inputs(gen, mb, mt, d, False)
    dy = torch.randn((mb, mt, d), generator=gen, device="cuda")
    states = mk.m1_entry_states_plain(u, dt, A, B)
    works = m1_work(mb, mt, d, 16, False, False)
    for (name, kern, plain), work in zip(
            (("m1_scan", lambda: mk.m1_scan(u, dt, A, B, C),
              lambda: mk.m1_scan_plain(u, dt, A, B, C)),
             ("m1_bwd", lambda: mk.m1_bwd(u, dt, A, B, C, states, dy),
              lambda: mk.m1_bwd_plain(u, dt, A, B, C, states, dy))), (works[0], works[2])):
        err = max((rel_err(g_, r_) for g_, r_ in zip(kern(), plain())), key=lambda e: e[1])
        show(name, f"mamba1-280m tensor 2: fp32 b={mb} t={mt} d={d}", err, TOL[torch.float32],
             cuda_ms(kern, 5), cuda_ms(plain, 2, 1), work)
    del u, dt, A, B, C, dy, states
    torch.cuda.empty_cache()
    if failures:
        raise SystemExit("tensor-parallel kernel shapes disagree with the plain versions:\n"
                         + "\n".join(failures))


def check_serving_shapes(gen, rows: dict) -> None:
    """Rows 1, 10 and 11 at the per-rank shapes of the serving mesh phase:
    ``ssd_fwd`` at the serving chunk (b 1, t 256, seeded) on hybrid-280m's
    24 SSD heads cut by model 2 (12) and hybrid-7b's 128 cut by model 4
    (32); ``rpa_fwd`` over a data rank's 4 slots of hybrid-280m at data 2
    on 12/2 = 6 query and 4/2 = 2 KV heads of 64, and over hybrid-7b's 8
    slots at model 4 on 8 query and 2 KV heads of 128; ``rpp_fwd`` at the
    second chunk of a 700-token prompt on the same heads.  Each is held
    against its plain version within the bf16 tolerance and timed beside
    its bound and SDPA; each result goes into its row's ``shapes`` with
    ``path`` "mesh-i" or "mesh-ii", for the launches of those mesh runs."""
    from mamba_distributed_tpu_torch.ops.cuda import attention_kernels as ak
    from mamba_distributed_tpu_torch.ops.cuda import ssd_kernels as sk
    from mamba_distributed_tpu_torch.ops.ssd import ssd_chunked

    bf16, l = torch.bfloat16, 256
    failures = []

    def add(name, path, shape, err, ms, plain_ms, nbytes, flops, library_ms=None):
        bound_ms, bound_by = bound(nbytes, flops)
        lib = "" if library_ms is None else f", SDPA {library_ms:.4f} ms"
        print(f"time {name} serving mesh {shape}: kernel {ms:.4f} ms (device time), plain "
              f"{plain_ms:.4f} ms{lib}, bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, "
              f"{flops} FLOP); max_abs_err={err[0]:.3e} (rel {err[1]:.2e}), tol rel "
              f"{TOL[bf16]:.0e}", flush=True)
        if not err[1] <= TOL[bf16]:
            failures.append(f"{name} {shape}: rel {err[1]:.3e}")
        rows[name].setdefault("shapes", []).append(dict(
            shape=f"serving mesh {shape}", path=path, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms, max_abs_err=err[0],
            launches=None))

    for path, tag, h in (("mesh-i", "hybrid-280m model 2", 12),
                         ("mesh-ii", "hybrid-7b model 4", 32)):
        inp = ssd_inputs(gen, 1, 256, 1, bf16, True, h=h)
        kw = dict(chunk_size=l, return_final_state=True, compute_dtype=bf16)
        yk, fk_ = sk.ssd_chunked_kernel(**inp, **kw)
        yp, fp = ssd_chunked(**inp, **kw)
        args = (inp["x"], inp["dt"], inp["A"], inp["B"], inp["C"], l, inp["initial_state"], bf16)
        add("ssd_fwd", path, f"{tag}: b=1 t=256 l={l} h={h} seeded",
            max(rel_err(yk, yp), rel_err(fk_, fp), key=lambda e: e[1]),
            sum(device_ms(lambda: sk._ssd_fwd(*args), 20).values()),
            cuda_ms(lambda: ssd_chunked(**inp, **kw), 3, 1),
            *ssd_work(1, 256, h, 1, 64, 128, l, bf16, True))
    for path, tag, S, nh, nkv, hd in (("mesh-i", "hybrid-280m data 2 x model 2", 4, 6, 2, 64),
                                      ("mesh-ii", "hybrid-7b model 4", 8, 8, 2, 128)):
        lens = RPA_TIMED[-1][:S]
        args = rpa_case(gen, S, nh, nkv, hd, 64, 16, lens, bf16, False)
        q, kp, vp, tbl, kv_len = args
        kk, vv = ak.gather_kv_pages(kp, vp, tbl, None, dtype=bf16)
        kk, vv = (v.transpose(1, 2).repeat_interleave(nh // nkv, dim=1).contiguous()
                  for v in (kk, vv))
        mask = torch.arange(16 * 64, device="cuda") < kv_len.clamp(min=1)[:, None]
        sdpa = sum(device_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kk, vv, attn_mask=mask[:, None, None]), 50).values())
        add("rpa_fwd", path, f"{tag}: S={S} nh={nh} nkv={nkv} hd={hd} kv_len={lens}",
            rel_err(ak.ragged_paged_decode_attention(*args),
                    ak.ragged_paged_decode_attention_plain(*args)),
            sum(device_ms(lambda: ak.ragged_paged_decode_attention(*args), 50).values()),
            cuda_ms(lambda: ak.ragged_paged_decode_attention_plain(*args), 10), *rpa_work(args),
            library_ms=sdpa)
        args, real = rpp_case(gen, 1, 256, nh, nkv, 64, 16, [188], [256], bf16, False, hd=hd)
        q, kc, vc, kp, vp, tbl, ln, cr = args
        got = ak.ragged_paged_prefill_attention(q, kc, vc, kp.clone(), vp.clone(), tbl, ln, cr)[0]
        ref = ak.ragged_paged_prefill_attention_plain(q, kc, vc, kp.clone(), vp.clone(), tbl, ln,
                                                      cr)[0]
        kk, vv = ak.gather_kv_pages(kp, vp, tbl, None, dtype=bf16)
        kk, vv = (v[:, :444].transpose(1, 2).repeat_interleave(nh // nkv, dim=1).contiguous()
                  for v in (kk, vv))
        qpos = 188 + torch.arange(256, device="cuda")
        mask = torch.arange(444, device="cuda")[None, :] <= qpos[:, None]
        sdpa = sum(device_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2).contiguous(), kk, vv, attn_mask=mask), 50).values())
        add("rpp_fwd", path, f"{tag}: b=1 c=256 nh={nh} nkv={nkv} hd={hd} lengths=[188] "
            f"chunk_real=[256]", rel_err(got[real], ref[real]),
            sum(device_ms(lambda: ak.ragged_paged_prefill_attention(*args), 50).values()),
            cuda_ms(lambda: ak.ragged_paged_prefill_attention_plain(*args), 10),
            *rpp_work(args), library_ms=sdpa)
    torch.cuda.empty_cache()
    if failures:
        raise SystemExit("serving mesh kernel shapes disagree with the plain versions:\n"
                         + "\n".join(failures))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels, skip the serving and training runs")
    ap.add_argument("--tensor-worker", nargs=4, metavar=("RANK", "WORLD", "PORTS", "DIR"),
                    help=argparse.SUPPRESS)  # one rank of tensor_phase's world
    ap.add_argument("--expert-worker", nargs=4, metavar=("RANK", "WORLD", "PORTS", "DIR"),
                    help=argparse.SUPPRESS)  # one rank of expert_phase's world
    ap.add_argument("--seq-worker", nargs=4, metavar=("RANK", "WORLD", "PORTS", "DIR"),
                    help=argparse.SUPPRESS)  # one rank of seq_phase's world
    ap.add_argument("--compose-worker", nargs=4, metavar=("RANK", "WORLD", "PORTS", "DIR"),
                    help=argparse.SUPPRESS)  # one rank of compose_phase's world
    ap.add_argument("--mesh-worker", nargs=4, metavar=("RANK", "WORLD", "PORTS", "DIR"),
                    help=argparse.SUPPRESS)  # one rank of serving_mesh_phase's world
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    for worker, fn in ((args.tensor_worker, tensor_worker), (args.expert_worker, expert_worker),
                       (args.seq_worker, seq_worker), (args.compose_worker, compose_worker),
                       (args.mesh_worker, mesh_worker)):
        if worker:
            rank, world, ports, work = worker
            return fn(int(rank), int(world), [int(p) for p in ports.split(",")], Path(work))
    from mamba_distributed_tpu_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    # the host C++ of the data path (g++): the shard reader and the BPE merge loop
    from mamba_distributed_tpu_torch.data import native, native_bpe

    t1 = time.perf_counter()
    for mod in (native, native_bpe):
        if not mod.available():
            raise SystemExit(f"{mod.__name__} did not build: {mod.unavailable_reason()}")
    print(f"built the native shard reader and BPE merge loop in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    for name, log in logs.items():
        inst = build.ptxas_instances(log)
        regs, spills = [r for _, r, _ in inst], [sp for _, _, sp in inst]
        print(f"ptxas {name}: {len(regs)} kernel instances, registers {min(regs)}-{max(regs)}, "
              f"spill stores up to {max(spills)} bytes")
    # no tensor-core instance may spill: the flash forward, dq and dk/dv
    # (3 head dims each), the paged prefill attend (3 head dims x bf16 and
    # int8 pages), the SSD forward (d_state 64 and 128) and the SSD chunk
    # states and backward's two kernels (d_state 64 and 128); nor may the
    # split decode (its walk: 2 dtypes x 2 page types x 4 row counts; its
    # combine: 2 dtypes), the Mamba-1 forward scan or the Mamba-1 backward;
    # the fp32 CUDA-core ones are printed beside them
    for src, tag, expected in (("flash_attention", "_tc_kernel", 9),
                               ("ragged_paged_attention", "_tc_kernel", 6),
                               ("ragged_paged_attention", "rpa_", 18),
                               ("ssd_fwd", "_tc_kernel", 2),
                               ("ssd_bwd", "_tc_kernel", 6),
                               ("selective_scan", "m1_scan", 1),
                               ("selective_scan", "m1_bwd", 1)):
        inst = build.ptxas_instances(logs[src])
        for kname, regs, sp in inst:
            if tag in kname or (tag == "_tc_kernel" and ("flash_" in kname
                                                         or "rpp_attend" in kname)):
                print(f"ptxas {src} {kname}: {regs} registers, {sp} bytes spill stores")
        tc = [(k, sp) for k, _, sp in inst if tag in k]
        if len(tc) != expected or any(sp for _, sp in tc):
            raise SystemExit(f"{tag} instances of {src} ({expected} expected) missing or "
                             f"spilling registers: {tc}")
    # the tensor-core SSD forward, chunk states and backward run wgmma
    for src, tag, expected in (("ssd_fwd", "ssd_fwd_tc_kernel", 2),
                               ("ssd_bwd", "_tc_kernel", 6)):
        hgmma = {k: v for k, v in build.hgmma_counts(build.library_path(src)).items() if tag in k}
        print(f"SASS HGMMA instructions, {src}: {hgmma}")
        if len(hgmma) != expected or not all(hgmma.values()):
            raise SystemExit(f"a tensor-core kernel of {src} has no HGMMA instruction: {hgmma}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_kernel_tables()
    rpa, rpa_int8 = check_rpa(gen)
    rpp, rpp_int8 = check_rpp(gen)
    rows = [check_ssd(gen), *check_ssd_bwd(gen), rpa, rpp, *check_flash(gen, micro=32),
            *check_m1(gen), rpa_int8, rpp_int8]
    check_7b_shapes(gen, {r["name"]: r for r in rows})
    check_tp_shapes(gen)
    check_serving_shapes(gen, {r["name"]: r for r in rows})
    check_verify_shapes(gen, {r["name"]: r for r in rows})
    # the RMSNorm kernels, which have no pallas_call counterpart
    rows += check_norms(gen)
    if not args.kernels_only:
        card = smi()
        norms = tuple(NORM_SHAPES)
        ssd_serve = serve("mamba2-280m", ("ssd_fwd", *norms), keep_params=True)
        ssd_launches = ssd_serve["launches"]
        hybrid = serve("hybrid-280m", ("ssd_fwd", "ragged_decode", "ragged_prefill", *norms),
                       keep_params=True)
        launches = hybrid["launches"]
        q8 = serve_int8(hybrid, keep_params=True)
        q8_launches = q8["launches"]
        m1_serve = serve("mamba1-280m", ("m1_scan", "add_rms_norm"), keep_params=True)
        m1_launches = m1_serve["launches"]
        # the admission and occupancy features, then speculative decoding,
        # on the weights cast above
        served = {"mamba2-280m": ssd_serve.pop("params"), "hybrid-280m": hybrid.pop("params"),
                  "hybrid-280m int8": q8.pop("params"), "mamba1-280m": m1_serve.pop("params")}
        engine_features_phase(card, served)
        spec_phase(card, served)
        lora_phase(card, served)
        del served
        torch.cuda.empty_cache()
        big_serve, _ = serve_7b()
        torch.cuda.empty_cache()
        mesh_launches = serving_mesh_phase(card)
        torch.cuda.empty_cache()
        eval_and_import(card)
        print(f"torch.mm(..., out_dtype=torch.float32) differentiable: "
              f"{mm_out_dtype_has_grad()}", flush=True)
        ssd_train = ("ssd_fwd", "ssd_chunk_states", "ssd_bwd")
        train_launches = train_run(card, "mamba2-280m", ssd_train)["launches"]
        train_checks(card)
        flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
        hyb = train_run(card, "hybrid-280m", ssd_train + flash)
        hyb_launches = hyb["launches"]
        if hyb["micro"] != 32:
            print(f"note: the flash kernels were timed at micro-batch 32, the hybrid train "
                  f"run took {hyb['micro']}")
        train_checks(card, "hybrid-280m", attn_layer_idx=(1, 3))
        m1_train = ("m1_scan", "m1_entry_states", "m1_bwd")
        m1_train_launches = train_run(card, "mamba1-280m", m1_train)["launches"]
        train_checks(card, "mamba1-280m")
        # hybrid-7b at full width, cut to one period of its attention
        # pattern (8 layers, attention at layer 3), at the preset's seq
        # 4096 and micro-batch 4 (2 if 4 does not fit): the dense loss,
        # then the blocked one
        cut = dict(n_layer=8, attn_layer_idx=(3,))
        print("train hybrid-7b: depth cut from 32 to 8 layers (one period, attention at "
              "layer 3), full width", flush=True)
        big_train = {impl: train_run(card, "hybrid-7b", ssd_train + flash, seq=4096,
                                     micros=(4, 2), loss_impl=impl, **cut)
                     for impl in ("dense", "blocked")}
        d, bl = big_train["dense"], big_train["blocked"]
        print(f"train hybrid-7b 8 layers: peak device memory dense loss {d['peak_gib']:.2f} GiB, "
              f"blocked loss {bl['peak_gib']:.2f} GiB; step ms dense {d['step_ms']}, blocked "
              f"{bl['step_ms']} [{card}]", flush=True)
        loss_peaks(card)
        # the blocked loss and the remat policies on mamba2-280m's 3-step
        # run, beside the dense loss and "all" above; then one step of
        # each 280m preset under every policy
        train_run(card, "mamba2-280m", ssd_train, loss_impl="blocked")
        for policy in ("dots", "mixer"):
            train_run(card, "mamba2-280m", ssd_train, remat_policy=policy)
        remat_checks(card)
        # the model options at a small size: an MoE, an untied head,
        # xla_conv and the blocked loss on 4-layer hybrid-tiny
        train_checks(card, "hybrid-tiny", gate_bf16_grads=False, d_intermediate=256,
                     moe_num_experts=4, moe_top_k=2)
        for opts in (dict(tie_embeddings=False), dict(conv_impl="xla_conv"),
                     dict(loss_impl="blocked")):
            train_checks(card, "hybrid-tiny", **opts)
        torch.cuda.empty_cache()
        telemetry_phase(card, {"mamba2-280m": ssd_serve, "hybrid-280m": hybrid,
                               "hybrid-280m int8": q8})
        parallel_phase(card)
        tensor_phase(card)
        expert_phase(card)
        seq_phase(card)
        compose_phase(card)
        # the hybrid-7b shapes' launches on their own paths
        paths = {"serve": big_serve["launches"], "train": big_train["dense"]["launches"],
                 "mesh-i": mesh_launches["i"], "mesh-ii": mesh_launches["ii"]}
        keys = {"rpa_fwd": "ragged_decode", "rpp_fwd": "ragged_prefill"}
        for row in rows:
            for entry in row.get("shapes", ()):
                if "path" in entry:
                    entry["launches"] = paths[entry["path"]].get(
                        keys.get(row["name"], row["name"]))
        # each kernel's launches on its own path: the mamba2 serving run
        # for ssd_fwd, the mamba2 training run for the SSD backward
        # kernels, the hybrid serving run for the paged attention kernels,
        # the hybrid training run for the flash kernels, the mamba1
        # serving run for m1_scan, the mamba1 training run for the scan
        # backward kernels, the int8 hybrid serving run for the int8
        # branches of the paged attention kernels, the mamba2 serving run
        # for the two norm kernels, the serving mesh's run (i) (rank 0) for
        # the model-split gated norm's sum of squares
        for row, n in zip(rows, (ssd_launches["ssd_fwd"], train_launches["ssd_chunk_states"],
                                 train_launches["ssd_bwd"], launches["ragged_decode"],
                                 launches["ragged_prefill"], *(hyb_launches[k] for k in flash),
                                 m1_launches["m1_scan"], m1_train_launches["m1_entry_states"],
                                 m1_train_launches["m1_bwd"], q8_launches["ragged_decode_int8"],
                                 q8_launches["ragged_prefill_int8"],
                                 *(ssd_launches[k] for k in NORM_SHAPES),
                                 *(mesh_launches["i"][k] for k in NORM_TP_SHAPES)), strict=True):
            row["launches"] = n
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s from the build to here", flush=True)
    print(smi())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
