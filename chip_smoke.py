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
   and, for attention, SDPA (``check_7b_shapes``);
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
4. eval and import (after serving, about a minute and a half): the
   HellaSwag scorer (``evaluate_hellaswag``) over
   ``tests/data/hellaswag_tiny.jsonl`` (16 examples, ``example_batch`` 8,
   so 32 rows) with a word-level tokenizer of 1, 6 and 18 ids a word
   (rows padded to 32, 96 and 288 tokens: SSD chunks of 32, 96 and 144)
   on full-width, full-depth mamba2-280m, hybrid-280m and mamba1-280m
   (bf16, seeded weights), once with "pallas"/"auto" and once with "xla":
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
6. print the serving and training numbers beside the card's name and
   power limit, one ``{"kernels": [...]}`` line, and last ``{"ok": true,
   "device": ...}``.

Before each serving, eval and training run the kernels' launch counts
are zeroed, and after it every kernel of that path must have launched.

It imports nothing of JAX or of the JAX package, and exits nonzero when
no card is visible or the port's package is not beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

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
    a multiple of 8, tq 1, hd 32 and 128 at tq != tk, tk_valid < tk); the
    mixer's strided views and contiguous head-major copies; two launches
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


def serve(preset: str, path_kernels: tuple[str, ...], params=None, **overrides) -> dict:
    """Serve 8 requests on a full-width engine of ``preset`` (config
    fields ``overrides``, e.g. the int8 knobs); returns the run's launch
    counts, the greedy stream and the serving numbers.  Every kernel in
    ``path_kernels`` (keys of ``build.LAUNCHES``) must have launched in
    it.  ``params``: decode weights already cast for this config (the
    engine, ``generate()`` and the chunk step then share them, since a
    cast of cast weights returns the same tensors); by default fp32
    masters are made here from a seeded generator."""
    from mamba_distributed_tpu_torch.config import get_preset
    from mamba_distributed_tpu_torch.inference.generate import generate
    from mamba_distributed_tpu_torch.models.lm import init_lm_params, init_lm_state
    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
    from mamba_distributed_tpu_torch.ops.quant import param_bytes
    from mamba_distributed_tpu_torch.serving import GenerationRequest, ServingEngine
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
    lens = [12, 100, 300, 700, 12, 100, 300, 700]
    prompt_gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (t,), generator=prompt_gen).numpy()
               for t in lens]

    def requests():
        # request 0 is greedy: its stream is checked against generate()
        return [GenerationRequest(prompt_ids=p.copy(), max_new_tokens=new,
                                  top_k=1 if i == 0 else 50, seed=i)
                for i, p in enumerate(prompts)]

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
                tokens_per_s=n_tokens / wall, ttft_ms=ttft[len(ttft) // 2],
                chunk_ms=chunk_ms, tick_ms=tick_ms, weight_bytes=param_bytes(dparams),
                kv_bytes=kv_bytes, peak_gib=peak_gib)


def serve_int8(bf16: dict, preset: str = "hybrid-280m", params=None) -> dict:
    """The int8 hybrid serving run of ``preset`` (int8 weights and int8 KV
    pages, the same requests; ``params`` as for ``serve``), against the
    bf16 run ``bf16`` of this call: the int8 branches of both paged
    kernels must launch; resident weight and KV pool bytes, the greedy
    agreement with bf16 (printed, not gated) and the serving numbers side
    by side."""
    card = smi()
    q8 = serve(preset, ("ssd_fwd", "ragged_decode_int8", "ragged_prefill_int8"), params=params,
               kv_page_dtype="int8", serving_weight_dtype="int8")
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

    from mamba_distributed_tpu_torch.config import get_preset, get_train_preset
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
        cfg = get_train_preset("hybrid-7b", model=m, micro_batch_size=4,
                               total_batch_size=4 * 4096)
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
    import shutil

    from mamba_distributed_tpu_torch.config import DataConfig, get_preset, get_train_preset
    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
    from mamba_distributed_tpu_torch.training import Trainer

    root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    shutil.rmtree(root / "log", ignore_errors=True)
    model = get_preset(preset, ssm_impl="pallas", compute_dtype="bfloat16", remat=True,
                       **model_fields)
    for micro in micros:
        cfg = get_train_preset(
            preset, model=model, micro_batch_size=micro, total_batch_size=micro * seq,
            seq_len=seq, val_steps=2, log_dir=str(root / "log"),
            data=DataConfig(data_dir=str(root / "data"), synthetic_tokens_per_shard=1 << 20))
        trainer = Trainer(cfg, device="cuda")
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        torch.cuda.reset_peak_memory_stats()
        try:
            trainer.run(max_steps=3)
        except torch.cuda.OutOfMemoryError:
            print(f"train run: micro-batch {micro} does not fit in device memory; halving",
                  flush=True)
            trainer.finish()
            del trainer
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
    ``example_batch`` 8: R 32) on a seeded full-width, full-depth
    ``preset`` (bf16) with "pallas"/"auto" and with "xla", at each word
    width; the logits (RMS error over RMS) and the per-row summed and
    mean losses of the two must agree at the bf16 tolerance, and the pallas run must launch every kernel of
    ``path_kernels`` (the xla run none).  Returns the padded lengths."""
    import dataclasses

    from mamba_distributed_tpu_torch.config import get_preset
    from mamba_distributed_tpu_torch.eval import evaluate_hellaswag, iterate_examples
    from mamba_distributed_tpu_torch.eval.hellaswag import pack_batch, render_example, score_rows
    from mamba_distributed_tpu_torch.models.lm import init_lm_params
    from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES
    from mamba_distributed_tpu_torch.ops.dispatch import check_kernel_shapes
    from mamba_distributed_tpu_torch.ops.ssd import _divisor_chunk

    cfg = get_preset(preset, ssm_impl="pallas", compute_dtype="bfloat16")
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
        if launches["xla"]:
            raise SystemExit(f"the {preset} xla eval launched hand kernels: {launches['xla']}")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels, skip the serving and training runs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
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
    if not args.kernels_only:
        card = smi()
        ssd_launches = serve("mamba2-280m", ("ssd_fwd",))["launches"]
        hybrid = serve("hybrid-280m", ("ssd_fwd", "ragged_decode", "ragged_prefill"))
        launches = hybrid["launches"]
        q8_launches = serve_int8(hybrid)["launches"]
        m1_launches = serve("mamba1-280m", ("m1_scan",))["launches"]
        torch.cuda.empty_cache()
        big_serve, _ = serve_7b()
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
        # the hybrid-7b shapes' launches on their own paths
        paths = {"serve": big_serve["launches"], "train": big_train["dense"]["launches"]}
        keys = {"rpa_fwd": "ragged_decode", "rpp_fwd": "ragged_prefill"}
        for row in rows:
            for entry in row.get("shapes", ()):
                if "path" in entry:
                    entry["launches"] = paths[entry["path"]][keys.get(row["name"], row["name"])]
        # each kernel's launches on its own path: the mamba2 serving run
        # for ssd_fwd, the mamba2 training run for the SSD backward
        # kernels, the hybrid serving run for the paged attention kernels,
        # the hybrid training run for the flash kernels, the mamba1
        # serving run for m1_scan, the mamba1 training run for the scan
        # backward kernels, the int8 hybrid serving run for the int8
        # branches of the paged attention kernels
        for row, n in zip(rows, (ssd_launches["ssd_fwd"], train_launches["ssd_chunk_states"],
                                 train_launches["ssd_bwd"], launches["ragged_decode"],
                                 launches["ragged_prefill"], *(hyb_launches[k] for k in flash),
                                 m1_launches["m1_scan"], m1_train_launches["m1_entry_states"],
                                 m1_train_launches["m1_bwd"], q8_launches["ragged_decode_int8"],
                                 q8_launches["ragged_prefill_int8"]), strict=True):
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
