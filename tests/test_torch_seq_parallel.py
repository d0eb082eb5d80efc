"""The port's sequence parallelism (``parallel/seq_parallel.py``,
``ring_attention.py``, ``ulysses.py`` and the mixers' ``seq=``) against
the JAX package, on the CPU, in worlds of 2 and 4 gloo processes.

Every case cuts a full-sequence input (numpy seeds) into the ranks'
blocks, runs the port's sequence-parallel function on each rank, and
holds the blocks put back together against the JAX package's
full-sequence function on the whole input; the gradients of a loss that
weighs every output element differently against JAX's full-sequence
gradients (a replicated input's gradient summed over the ranks):

* ``sp_conv1d`` with and without bias and at width 1: atol 1e-5;
* ``_incoming_state`` against a sequential fold of the ranks' (decay,
  state) summaries: fp32, 1e-6;
* ``sp_ssd``, both branches ("xla", and "pallas": the kernels' plain
  versions on the CPU), at seq 2 and 4 and at one chunk a shard: 1e-4,
  gradients 2e-3 (the JAX tests' tolerances);
* ``sp_selective_scan``, both impls, with gradients;
* ring attention, both branches, GQA rep 3, hd 32, output and gradients;
  Ulysses likewise, and its refusal of heads the seq size does not
  divide;
* ``lm_loss`` cut over seq (each rank's mean, averaged over the ranks)
  against the JAX ``lm_loss`` on the whole sequence at rtol 1e-5: Mamba-2
  (both impls), Mamba-1, the hybrid with ring and with Ulysses (rotary
  on), and the blocked loss, the weights through
  ``convert.params_from_jax``.

Each world runs in one spawn of ``python -m tests.test_torch_seq_parallel
CASE RANK WORLD DIR`` (``tests/test_torch_parallel.start``), shared by
the tests through module-scoped fixtures; the JAX references are
computed while the workers run.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mamba_distributed_tpu_torch.config import ModelConfig
from tests.test_torch_parallel import HYBRID_OVER, TINY_MODEL, join_group, start

pytestmark = pytest.mark.torch

MODULE = "tests.test_torch_seq_parallel"
B, T = 2, 64
# the models of the lm_loss cases (fp32); each runs at world 2, those
# named in WORLD4 at world 4 too
LM_MODELS = {
    "mamba2": dict(TINY_MODEL, ssm_impl="xla"),
    "mamba2-pallas": dict(TINY_MODEL, ssm_impl="pallas"),
    "mamba1": dict(TINY_MODEL, ssm_layer="mamba1", d_state=16, ssm_impl="pallas"),
    "hybrid-ring": dict(TINY_MODEL, **HYBRID_OVER, ssm_impl="pallas"),
    "hybrid-ring-xla": dict(TINY_MODEL, **HYBRID_OVER, ssm_impl="xla", attn_impl="xla"),
    "hybrid-ulysses": dict(TINY_MODEL, **HYBRID_OVER, ssm_impl="pallas",
                           attn_sp_impl="ulysses"),
    "blocked": dict(TINY_MODEL, ssm_impl="pallas", loss_impl="blocked",
                    loss_vocab_blocks=4),
}
WORLD4 = ("mamba2-pallas", "hybrid-ring")
# the routing case's MoE layer, at capacity factor 1.0 so that choices drop
ROUTE_MODEL = dict(d_model=32, d_intermediate=24, moe_num_experts=4, moe_top_k=2,
                   moe_capacity_factor=1.0, compute_dtype="float32", vocab_size=256)
# (chunk, world) of the SSD cases: two chunks a shard, then one
SSD_CASES = {2: (16, 32), 4: (16,)}


def _rng(seed):
    return np.random.default_rng(seed)


def op_inputs() -> dict:
    """The ops' full-sequence inputs, fp32, from numpy seeds."""
    r = _rng(7)
    f = (lambda *s: r.standard_normal(s).astype(np.float32))
    sp = (lambda v: np.log1p(np.exp(v)).astype(np.float32))  # softplus
    d, h, p, n, g = 16, 4, 8, 16, 2
    inp = {
        "conv": {"x": f(B, T, d), "w": 0.3 * f(d, 4), "bias": 0.1 * f(d), "w1": 0.3 * f(d, 1)},
        "ssd": {"x": f(B, T, h, p), "dt": sp(f(B, T, h)),
                "A": -np.exp(0.5 * f(h)).astype(np.float32), "B": f(B, T, g, n),
                "C": f(B, T, g, n), "D": f(h)},
        "scan": {"u": f(B, T, d), "dt": 0.5 * f(B, T, d),
                 "A": -np.exp(0.5 * f(d, 8)).astype(np.float32), "B": f(B, T, 8),
                 "C": f(B, T, 8), "D": f(d), "z": f(B, T, d), "bias": 0.1 * f(d)},
        "attn": {"q": f(B, T, 6, 32), "k": f(B, T, 2, 32), "v": f(B, T, 2, 32)},
        "state": {"decay": r.uniform(0.5, 1.0, (4, B, h)).astype(np.float32),
                  "final": f(4, B, h, p, n)},
    }
    for name, v in inp.items():  # the loss weights of every output element
        shape = {"conv": (B, T, d), "ssd": (B, T, h, p), "scan": (B, T, d),
                 "attn": (B, T, 6, 32)}.get(name)
        if shape is not None:
            v["wts"] = f(*shape)
    # heads that split over tensor 2 and then over seq 2 (4 and 2 a rank)
    inp["attn8"] = {"q": f(B, T, 8, 16), "k": f(B, T, 4, 16), "v": f(B, T, 4, 16),
                    "wts": f(B, T, 8, 16)}
    # the pipeline's stacked layers (4) and microbatches (3)
    inp["pipe"] = {"w": 0.3 * f(4, d, d), "b": 0.1 * f(4, d), "xs": f(3, B, d),
                   "wts": f(3, B, d), "act": f(3, 1, 32, 64), "act_wts": f(3, 1, 32, 64)}
    return inp


def lm_inputs():
    """Each lm_loss model's params (JAX's init; the port's through
    ``convert.params_from_jax``) and one (B, T) batch: (the port's
    inputs, the JAX params)."""
    import jax

    from mamba_distributed_tpu.config import ModelConfig as JaxConfig
    from mamba_distributed_tpu.models import init_lm_params as jax_init
    from mamba_distributed_tpu_torch import convert

    r = _rng(11)
    out, jparams, seen = {}, {}, {}
    for name, kw in LM_MODELS.items():
        key = _init_key(kw)
        if key not in seen:  # the cases of one tree share params and batch
            jp = jax.jit(jax_init, static_argnums=1)(jax.random.PRNGKey(3),
                                                     JaxConfig(**_jax_kw(kw)))
            seen[key] = (jp, {"params": convert.params_from_jax(jax.tree.map(np.asarray, jp)),
                              "x": r.integers(0, kw["vocab_size"], (B, T)),
                              "y": r.integers(0, kw["vocab_size"], (B, T))})
        jparams[name], out[name] = seen[key]
    return out, jparams


def _init_key(kw: dict) -> tuple:
    return kw.get("ssm_layer"), kw.get("attn_layer_idx"), kw.get("d_state")


def _jax_kw(kw: dict) -> dict:
    """The JAX config of an lm case: the plain SSD and scan (the JAX
    kernels run in interpret mode on the CPU, slowly; the port's two impls
    compute the same function)."""
    return {k: v for k, v in kw.items() if k not in ("ssm_impl", "attn_impl")}


def _torchify(tree):
    if isinstance(tree, dict):
        return {k: _torchify(v) for k, v in tree.items()}
    return torch.as_tensor(tree) if isinstance(tree, np.ndarray) else tree


# -------------------------------------------------------------- the workers


def _block(v: torch.Tensor, seq, dim: int = 1) -> torch.Tensor:
    tl = v.shape[dim] // seq.size
    return v.narrow(dim, seq.rank * tl, tl).contiguous()


def _grads(fn, local: dict, rep: dict, wts: torch.Tensor):
    """fn(**local, **rep) -> this rank's output block; returns the block
    and the gradients of sum(out * wts) w.r.t. every input."""
    leaves = {k: v.clone().requires_grad_() for k, v in {**local, **rep}.items()}
    out = fn(**leaves)
    g = torch.autograd.grad((out * wts).sum(), list(leaves.values()))
    return {"out": out.detach(), **{f"d{k}": gi for k, gi in zip(leaves, g)}}


def _ops(seq, inp: dict) -> dict:
    from mamba_distributed_tpu_torch.parallel.collectives import SP_COMM
    from mamba_distributed_tpu_torch.parallel.ring_attention import ring_attention
    from mamba_distributed_tpu_torch.parallel.seq_parallel import (
        _incoming_state,
        sp_conv1d,
        sp_selective_scan,
        sp_ssd,
    )
    from mamba_distributed_tpu_torch.parallel.ulysses import ulysses_attention

    res = {}
    c = inp["conv"]
    x = _block(c["x"], seq)
    wts = _block(c["wts"], seq)
    res["conv"] = _grads(lambda x, w, bias: sp_conv1d(seq, x, w, bias)[0], {"x": x},
                         {"w": c["w"], "bias": c["bias"]}, wts)
    res["conv_nobias"] = sp_conv1d(seq, x, c["w"], None, activation=None)[0]
    res["conv_w1"] = sp_conv1d(seq, x, c["w1"], c["bias"])[0]

    st = inp["state"]
    res["state"] = _incoming_state(seq, st["decay"][seq.rank], st["final"][seq.rank])

    s = inp["ssd"]
    for chunk in SSD_CASES[seq.size]:
        for impl in ("xla", "pallas"):
            res[f"ssd_{impl}_{chunk}"] = _grads(
                lambda x, dt, B, C, A, D: sp_ssd(seq, x, dt, A, B, C, chunk, D=D,
                                                 compute_dtype=torch.float32,
                                                 ssm_impl=impl)[0],
                {k: _block(s[k], seq) for k in ("x", "dt", "B", "C")},
                {"A": s["A"], "D": s["D"]}, _block(s["wts"], seq))

    m = inp["scan"]
    for impl in ("xla", "pallas"):
        res[f"scan_{impl}"] = _grads(
            lambda u, dt, B, C, z, A, D, bias: sp_selective_scan(
                seq, u, dt, A, B, C, D=D, z=z, delta_bias=bias, delta_softplus=True,
                ssm_impl=impl)[0],
            {k: _block(m[k], seq) for k in ("u", "dt", "B", "C", "z")},
            {"A": m["A"], "D": m["D"], "bias": m["bias"]}, _block(m["wts"], seq))

    a = inp["attn"]
    qkv = {k: _block(a[k], seq) for k in ("q", "k", "v")}
    for impl in ("xla", "auto"):
        SP_COMM.update(calls=0, bytes=0)
        res[f"ring_{impl}"] = _grads(lambda q, k, v: ring_attention(seq, q, k, v, impl=impl),
                                     qkv, {}, _block(a["wts"], seq))
        res[f"ring_{impl}"]["comm"] = dict(SP_COMM)
    if seq.size == 2:
        for impl in ("xla", "auto"):
            SP_COMM.update(calls=0, bytes=0)
            res[f"ulysses_{impl}"] = _grads(
                lambda q, k, v: ulysses_attention(seq, q, k, v, impl=impl), qkv, {},
                _block(a["wts"], seq))
            res[f"ulysses_{impl}"]["comm"] = dict(SP_COMM)
    else:  # 2 KV heads over 4 seq ranks
        try:
            ulysses_attention(seq, *qkv.values())
            res["ulysses_refused"] = ""
        except ValueError as e:
            res["ulysses_refused"] = str(e)
    return res


def _lm(seq, lm: dict, names) -> dict:
    import torch.distributed as dist

    from mamba_distributed_tpu_torch.models.lm import lm_loss

    out = {}
    for name in names:
        case = lm[name]
        cfg = ModelConfig(**LM_MODELS[name])
        with torch.no_grad():
            loss = lm_loss(case["params"], cfg, _block(case["x"], seq), _block(case["y"], seq),
                           seq=seq)
        dist.all_reduce(loss, op=dist.ReduceOp.AVG, group=seq.group)
        out[name] = float(loss)
    return out


# the seq x tensor cases: each input's tensor axis (None: whole on every
# tensor rank), the sequence being axis 1 of every input and output
TP_AXES = {"conv": {"x": 2, "w": 0, "bias": 0},
           "ssd": {"x": 2, "dt": 2, "B": 2, "C": 2, "A": 0, "D": 0},
           "scan": {"u": 2, "dt": 2, "B": None, "C": None, "z": 2, "A": 0, "D": 0, "bias": 0},
           "attn": {"q": 2, "k": 2, "v": 2}, "attn8": {"q": 2, "k": 2, "v": 2}}
# the inputs that are not cut over seq (their gradients sum over it)
WHOLE_OVER_SEQ = ("w", "bias", "A", "D")
TP_LM = ("mamba2-pallas", "mamba1", "hybrid-ring", "hybrid-ulysses")


def _tp_ops(inp: dict) -> dict:
    """The sequence-parallel ops at seq=2 x tensor=2 on this rank's heads
    or channels (``TP_AXES``) of its block of the sequence."""
    from mamba_distributed_tpu_torch.config import MeshConfig
    from mamba_distributed_tpu_torch.parallel.mesh import build_mesh, seq_context, tensor_context
    from mamba_distributed_tpu_torch.parallel.ring_attention import ring_attention
    from mamba_distributed_tpu_torch.parallel.seq_parallel import (
        sp_conv1d,
        sp_selective_scan,
        sp_ssd,
    )
    from mamba_distributed_tpu_torch.parallel.ulysses import ulysses_attention

    mesh = build_mesh(MeshConfig(seq=2, tensor=2), "cpu")
    seq, tp = seq_context(mesh), tensor_context(mesh)

    def mine(name):
        out = {}
        for k, ax in TP_AXES[name].items():
            v = inp[name][k] if ax is None else inp[name][k].chunk(tp.size, ax)[tp.rank]
            out[k] = v.contiguous() if k in WHOLE_OVER_SEQ else _block(v, seq)
        wts = inp[name]["wts"].chunk(tp.size, 2)[tp.rank]
        return out, _block(wts, seq)

    res = {"seq": seq.rank, "tp": tp.rank}
    args, wts = mine("conv")
    res["conv"] = _grads(lambda x, w, bias: sp_conv1d(seq, x, w, bias)[0], args, {}, wts)
    args, wts = mine("ssd")
    for impl in ("xla", "pallas"):
        res[f"ssd_{impl}"] = _grads(
            lambda x, dt, B, C, A, D: sp_ssd(seq, x, dt, A, B, C, 16, D=D,
                                             compute_dtype=torch.float32, ssm_impl=impl)[0],
            args, {}, wts)
    args, wts = mine("scan")
    for impl in ("xla", "pallas"):
        res[f"scan_{impl}"] = _grads(
            lambda u, dt, B, C, z, A, D, bias: sp_selective_scan(
                seq, u, dt, A, B, C, D=D, z=z, delta_bias=bias, delta_softplus=True,
                ssm_impl=impl)[0], args, {}, wts)
    for name in ("attn", "attn8"):
        args, wts = mine(name)
        for impl in ("xla", "auto"):
            res[f"ring_{name}_{impl}"] = _grads(
                lambda q, k, v: ring_attention(seq, q, k, v, impl=impl), args, {}, wts)
            # attn: 3 q and 1 KV heads a rank do not split over seq 2, so the
            # heads are gathered over tensor first; attn8: 4 and 2 do
            res[f"ulysses_{name}_{impl}"] = _grads(
                lambda q, k, v: ulysses_attention(seq, q, k, v, impl=impl, tp=tp), args, {},
                wts)
    return res


def _tp_lm(lm: dict) -> dict:
    """``lm_loss`` at seq=2 x tensor=2 on this rank's packed params and
    its block of the tokens, averaged over the seq ranks."""
    import torch.distributed as dist

    from mamba_distributed_tpu_torch.config import MeshConfig
    from mamba_distributed_tpu_torch.models.lm import lm_loss
    from mamba_distributed_tpu_torch.parallel.mesh import build_mesh, seq_context, tensor_context
    from mamba_distributed_tpu_torch.parallel.tp_layout import pack_tp, tp_plan

    mesh = build_mesh(MeshConfig(seq=2, tensor=2), "cpu")
    seq, tp = seq_context(mesh), tensor_context(mesh)
    out = {}
    for name in TP_LM:
        cfg = ModelConfig(**LM_MODELS[name])
        params = pack_tp(lm[name]["params"], tp_plan(cfg, tp.size), tp.rank)
        with torch.no_grad():
            loss = lm_loss(params, cfg, _block(lm[name]["x"], seq), _block(lm[name]["y"], seq),
                           tp=tp, seq=seq)
        dist.all_reduce(loss, op=dist.ReduceOp.AVG, group=seq.group)
        out[name] = float(loss)
    return out


def _queue(r: dict) -> dict:
    """The MoE's routing at data=2 x seq=2: each rank routes its 2 rows'
    block of tokens (``moe_route``) and runs ``_moe_mlp`` on it."""
    from mamba_distributed_tpu_torch.config import MeshConfig
    from mamba_distributed_tpu_torch.models import lm
    from mamba_distributed_tpu_torch.parallel.mesh import build_mesh, route_context

    route = route_context(build_mesh(MeshConfig(data=2, seq=2), "cpu"))
    cfg = ModelConfig(**ROUTE_MODEL)
    p = {"router": {"kernel": r["router"]}, "w1": r["w1"], "w2": r["w2"]}
    b, t = r["x"].shape[0] // route.size, r["x"].shape[1] // route.seq
    x = r["x"][route.coord * b:(route.coord + 1) * b,
               route.seq_rank * t:(route.seq_rank + 1) * t]
    got = lm.moe_route(p, cfg, x.reshape(-1, x.shape[-1]), route, rows=b)
    out, aux = lm._moe_mlp(p, cfg, x, torch.float32, route=route)
    return {"coord": route.coord, "seq_rank": route.seq_rank, "pos": got.pos.reshape(b, t, -1),
            "keep": got.keep.reshape(b, t, -1), "cap": got.cap, "aux": float(aux), "out": out}


def _pipe(inp: dict, lm: dict) -> dict:
    """``pipelined_layers`` at pipe=2 (4 stacked layers, 3 microbatches):
    an affine body and Mamba-2 blocks, the last stage's outputs and every
    stage's gradients of a loss the last stage weighs; and
    ``lm_loss_pipelined`` of the periodic hybrid (2 microbatches of one
    row)."""
    from mamba_distributed_tpu_torch.config import MeshConfig
    from mamba_distributed_tpu_torch.models.lm import lm_loss_pipelined
    from mamba_distributed_tpu_torch.parallel.collectives import PP_COMM
    from mamba_distributed_tpu_torch.parallel.mesh import build_mesh, pipe_context
    from mamba_distributed_tpu_torch.parallel.pipeline import from_last_stage
    from mamba_distributed_tpu_torch.parallel.sharding import param_specs, stage_block

    from mamba_distributed_tpu_torch.parallel.pipeline import _shift

    pipe = pipe_context(build_mesh(MeshConfig(pipe=2), "cpu"))
    res = {"stage": pipe.rank}
    # the schedule's shifts: one stage on (zeros into stage 0) and back
    # (zeros into the last stage)
    mark = torch.full((3,), float(pipe.rank + 1))
    res["shifts"] = (_shift(mark, pipe, 1), _shift(mark, pipe, -1))
    for name in PIPE_BODIES:
        params, xs, wts = _pipe_case(name, inp["pipe"])
        half = _map_tree(params, lambda v: v.chunk(pipe.size, 0)[pipe.rank])
        PP_COMM.update(calls=0, bytes=0)
        res[name] = _pipe_grads(name, half, xs, wts, pipe, from_last_stage)
        res[name]["comm"] = dict(PP_COMM)
    cfg = ModelConfig(**LM_MODELS["hybrid-ring"])
    case = lm["hybrid-ring"]
    params = stage_block(case["params"], param_specs(case["params"], False, 1, 1, 2), pipe)
    with torch.no_grad():
        res["lm"] = float(lm_loss_pipelined(params, cfg, case["x"][:, None], case["y"][:, None],
                                            pipe))
    return res


def _case(rank: int, world: int, work: Path) -> dict:
    from mamba_distributed_tpu_torch.config import MeshConfig
    from mamba_distributed_tpu_torch.parallel.mesh import build_mesh, seq_context

    join_group(world, work)
    inp = torch.load(work / "inputs.pt", weights_only=True)
    seq = seq_context(build_mesh(MeshConfig(seq=world), "cpu"))
    names = list(LM_MODELS) if world == 2 else list(WORLD4)
    out = {"rank": seq.rank, "ops": _ops(seq, inp["ops"]), "lm": _lm(seq, inp["lm"], names)}
    if world == 4:  # then the composed meshes, one after another
        out.update(tp_ops=_tp_ops(inp["ops"]), tp_lm=_tp_lm(inp["lm"]),
                   queue=_queue(inp["route"]))
    else:
        out["pipe"] = _pipe(inp["ops"], inp["lm"])
    return out


# the pipeline bodies, run by the workers and in the test process alike
PIPE_BODIES = ("affine", "mamba2")


def _pipe_case(name: str, inp: dict):
    """(stacked params of 4 layers, microbatches, the loss weights)."""
    if name == "affine":
        return {"w": torch.as_tensor(inp["w"]), "b": torch.as_tensor(inp["b"])}, inp["xs"], \
            inp["wts"]
    from mamba_distributed_tpu_torch.models.lm import init_lm_params

    cfg = ModelConfig(**{**TINY_MODEL, "n_layer": 4})
    blocks = init_lm_params(cfg, torch.Generator().manual_seed(0))["blocks"]
    return blocks, inp["act"], inp["act_wts"]


def _pipe_body(name: str):
    if name == "affine":
        return lambda a, p: torch.tanh(a @ p["w"] + p["b"])
    from mamba_distributed_tpu_torch.models.lm import _train_block

    cfg = ModelConfig(**{**TINY_MODEL, "n_layer": 4})
    return lambda a, p: _train_block(p, cfg, a, False)[0]


def _flat_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _flat_leaves(v)]
    return [tree]


def _pipe_grads(name: str, params, xs, wts, pipe, from_last_stage=None) -> dict:
    """``pipelined_layers`` of body ``name``: the outputs and the gradients
    of sum(outs * wts) w.r.t. the microbatches and every param leaf (with
    ``pipe``: the last stage's loss, broadcast to every stage)."""
    from mamba_distributed_tpu_torch.parallel.pipeline import pipelined_layers

    leaves = [t.clone().requires_grad_() for t in _flat_leaves(params)]
    it = iter(leaves)
    params = _rebuild_tree(params, it)
    xs = xs.clone().requires_grad_()
    outs = pipelined_layers(_pipe_body(name), params, xs, pipe)
    loss = (outs * wts).sum()
    if pipe is not None:
        loss = from_last_stage(loss if pipe.rank == pipe.size - 1 else outs.sum() * 0.0, pipe)
    g = torch.autograd.grad(loss, [xs, *leaves])
    return {"out": outs.detach(), "dxs": g[0], "dparams": list(g[1:])}


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _rebuild_tree(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild_tree(v, it) for k, v in tree.items()}
    return next(it)


def _plain_layers(name: str, params, xs, wts) -> dict:
    """The plain loop of body ``name`` over the 4 layers, each microbatch
    alone: outputs and the gradients ``_pipe_grads`` takes."""
    leaves = [t.clone().requires_grad_() for t in _flat_leaves(params)]
    p = _rebuild_tree(params, iter(leaves))
    xs = xs.clone().requires_grad_()
    body = _pipe_body(name)
    outs = []
    for x in xs:
        for i in range(4):
            x = body(x, _layer(p, i))
        outs.append(x)
    outs = torch.stack(outs)
    g = torch.autograd.grad((outs * wts).sum(), [xs, *leaves])
    return {"out": outs.detach(), "dxs": g[0], "dparams": list(g[1:])}


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# --------------------------------------------------------- the references


def _jax_grads(fn, args: dict, wts):
    """JAX full-sequence output and the gradients of sum(out * wts), one
    jitted vjp."""
    import jax
    import jax.numpy as jnp

    names = list(args)

    @jax.jit
    def both(*a):
        out, vjp = jax.vjp(lambda *v: fn(**dict(zip(names, v))), *a)
        return out, vjp(jnp.asarray(wts))

    out, g = both(*(jnp.asarray(v) for v in args.values()))
    return {"out": np.asarray(out), **{f"d{k}": np.asarray(gi) for k, gi in zip(names, g)}}


def jax_refs(inp: dict) -> dict:
    import jax.numpy as jnp

    from mamba_distributed_tpu.ops.blockwise_attention import blockwise_sdpa_causal
    from mamba_distributed_tpu.ops.conv import causal_conv1d
    from mamba_distributed_tpu.ops.scan import selective_scan
    from mamba_distributed_tpu.ops.ssd import ssd_chunked

    ref = {}
    c = inp["conv"]
    ref["conv"] = _jax_grads(lambda x, w, bias: causal_conv1d(x, w, bias),
                             {"x": c["x"], "w": c["w"], "bias": c["bias"]}, c["wts"])
    ref["conv_nobias"] = np.asarray(causal_conv1d(c["x"], c["w"], None, activation=None))
    ref["conv_w1"] = np.asarray(causal_conv1d(c["x"], c["w1"], c["bias"]))
    s = inp["ssd"]
    for chunk in sorted({c for cs in SSD_CASES.values() for c in cs}):
        ref[f"ssd_{chunk}"] = _jax_grads(
            lambda x, dt, B, C, A, D: ssd_chunked(x, dt, A, B, C, chunk_size=chunk, D=D,
                                                  compute_dtype=jnp.float32),
            {k: s[k] for k in ("x", "dt", "B", "C", "A", "D")}, s["wts"])
    m = inp["scan"]
    ref["scan"] = _jax_grads(
        lambda u, dt, B, C, z, A, D, bias: selective_scan(u, dt, A, B, C, D=D, z=z,
                                                          delta_bias=bias,
                                                          delta_softplus=True),
        {k: m[k] for k in ("u", "dt", "B", "C", "z", "A", "D", "bias")}, m["wts"])
    for name in ("attn", "attn8"):
        a = inp[name]
        ref[name] = _jax_grads(blockwise_sdpa_causal, {k: a[k] for k in ("q", "k", "v")},
                               a["wts"])
    return ref


def route_inputs() -> dict:
    """One MoE layer's weights and a (4, 16, 32) batch: 2 rows a batch
    rank at data=2, 8 tokens a row a seq rank at seq=2 (numpy seed)."""
    rng = _rng(12)
    d, di, E = ROUTE_MODEL["d_model"], ROUTE_MODEL["d_intermediate"], ROUTE_MODEL["moe_num_experts"]
    return {"router": rng.standard_normal((d, E)).astype(np.float32),
            "w1": (rng.standard_normal((E, d, 2 * di)) / np.sqrt(d)).astype(np.float32),
            "w2": (rng.standard_normal((E, di, d)) / np.sqrt(di)).astype(np.float32),
            "x": rng.standard_normal((4, 16, d)).astype(np.float32)}


def jax_route(r: dict) -> dict:
    """The JAX ``_moe_mlp`` on the whole routing batch: its queue slots
    (the argument of its slot one-hot), capacity, aux and output."""
    import jax
    import jax.numpy as jnp

    from mamba_distributed_tpu.config import ModelConfig as JaxConfig
    from mamba_distributed_tpu.models import lm as jlm

    seen, one_hot = [], jax.nn.one_hot

    def spy(x, n, **kw):
        seen.append((np.asarray(x), n))
        return one_hot(x, n, **kw)

    cfg = JaxConfig(**ROUTE_MODEL)
    p = {"router": {"kernel": jnp.asarray(r["router"])}, "w1": jnp.asarray(r["w1"]),
         "w2": jnp.asarray(r["w2"])}
    jax.nn.one_hot = spy
    try:
        out, aux = jlm._moe_mlp(p, cfg, jnp.asarray(r["x"]), jnp.float32)
    finally:
        jax.nn.one_hot = one_hot
    (pos, cap), = [(x, n) for x, n in seen if n != cfg.moe_num_experts]
    return {"pos": pos, "cap": cap, "aux": float(aux), "out": np.asarray(out)}


def jax_losses(lm: dict, jparams: dict) -> dict:
    """The JAX ``lm_loss`` of every case on the whole sequence (one jit a
    distinct JAX config and tree)."""
    import jax
    import jax.numpy as jnp

    from mamba_distributed_tpu.config import ModelConfig as JaxConfig
    from mamba_distributed_tpu.models import lm_loss

    res, seen = {}, {}
    for name, kw in LM_MODELS.items():
        jkw = _jax_kw(kw)
        key = (_init_key(kw), jkw.get("loss_impl"))
        if key not in seen:
            cfg = JaxConfig(**jkw)
            seen[key] = float(jax.jit(lambda p, x, y: lm_loss(p, cfg, x, y))(
                jparams[name], jnp.asarray(lm[name]["x"], jnp.int32),
                jnp.asarray(lm[name]["y"], jnp.int32)))
        res[name] = seen[key]
    return res


# ---------------------------------------------------------------- fixtures


def _run_world(tmp_path_factory, world: int, ops: dict, lm: dict, route: dict):
    work = tmp_path_factory.mktemp(f"sp_{world}")
    torch.save({"ops": _torchify(ops), "lm": _torchify(lm), "route": _torchify(route)},
               work / "inputs.pt")
    return start(MODULE, "run", world, work)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' workers, started together, and the JAX references
    computed while they run."""
    ops, (lm, jparams), route = op_inputs(), lm_inputs(), route_inputs()
    waits = {w: _run_world(tmp_path_factory, w, ops, lm, route) for w in WORLDS}
    refs, losses = jax_refs(ops), jax_losses(lm, jparams)
    refs["route"] = jax_route(route)
    outs = {w: sorted(wait(), key=lambda o: o["rank"]) for w, wait in waits.items()}
    return outs, ops, refs, losses


WORLDS = (2, 4)


def _cat(outs, key, part="out", dim=1):
    vals = [o["ops"][key] if part is None else o["ops"][key][part] for o in outs]
    return torch.cat(vals, dim).numpy()


def _summed(outs, key, part):
    return sum(o["ops"][key][part] for o in outs).numpy()


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=msg)


# -------------------------------------------------------------------- tests


@pytest.mark.parametrize("world", WORLDS)
def test_sp_conv1d_matches_jax_full_sequence(runs, world):
    outs, ops, refs, _ = runs
    assert [o["rank"] for o in outs[world]] == list(range(world))
    _close(_cat(outs[world], "conv"), refs["conv"]["out"], 1e-5)
    _close(_cat(outs[world], "conv_nobias", None), refs["conv_nobias"], 1e-5)
    _close(_cat(outs[world], "conv_w1", None), refs["conv_w1"], 1e-5)
    # the halo's gradient reaches the previous rank's inputs
    _close(_cat(outs[world], "conv", "dx"), refs["conv"]["dx"], 1e-5)
    for k in ("dw", "dbias"):
        _close(_summed(outs[world], "conv", k), refs["conv"][k], 1e-4, k)


@pytest.mark.parametrize("world", WORLDS)
def test_incoming_state_equals_the_sequential_fold(runs, world):
    outs, ops, _, _ = runs
    decay, final = ops["state"]["decay"][:world], ops["state"]["final"][:world]
    s = np.zeros_like(final[0])
    for r, o in enumerate(outs[world]):  # the state entering rank r
        np.testing.assert_allclose(o["ops"]["state"].numpy(), s, rtol=1e-6, atol=1e-6)
        s = s * decay[r][..., None, None] + final[r]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("world,chunk", [(w, c) for w in WORLDS for c in SSD_CASES[w]])
def test_sp_ssd_matches_jax_full_sequence(runs, world, chunk, impl):
    outs, _, refs, _ = runs
    key, ref = f"ssd_{impl}_{chunk}", refs[f"ssd_{chunk}"]
    _close(_cat(outs[world], key), ref["out"], 1e-4)
    for k in ("dx", "dB", "dC"):
        _close(_cat(outs[world], key, k), ref[k], 2e-3, k)
    _close(_cat(outs[world], key, "ddt"), ref["ddt"], 2e-3, "ddt")
    for k in ("dA", "dD"):
        _close(_summed(outs[world], key, k), ref[k], 2e-3, k)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("world", WORLDS)
def test_sp_selective_scan_matches_jax_full_sequence(runs, world, impl):
    outs, _, refs, _ = runs
    key, ref = f"scan_{impl}", refs["scan"]
    _close(_cat(outs[world], key), ref["out"], 1e-4)
    for k in ("du", "ddt", "dB", "dC", "dz"):
        _close(_cat(outs[world], key, k), ref[k], 2e-3, k)
    for k in ("dA", "dD", "dbias"):
        _close(_summed(outs[world], key, k), ref[k], 2e-3, k)


def _check_attention(outs, key, ref):
    _close(_cat(outs, key), ref["out"], 1e-5)
    for k in ("dq", "dk", "dv"):
        _close(_cat(outs, key, k), ref[k], 1e-4, k)


@pytest.mark.parametrize("impl", ["xla", "auto"])
@pytest.mark.parametrize("world", WORLDS)
def test_ring_attention_matches_jax_full_sequence(runs, world, impl):
    outs, _, refs, _ = runs
    _check_attention(outs[world], f"ring_{impl}", refs["attn"])
    comm = outs[world][0]["ops"][f"ring_{impl}"]["comm"]
    # forward: S - 1 hops of the stacked (k, v); backward: the kernels'
    # ring sends (k, v) S - 1 times and (dk, dv) S times, autograd's the
    # gradient back along each forward hop
    hops = (world - 1) + ((world - 1) + world if impl == "auto" else world - 1)
    assert comm["calls"] == hops, comm


@pytest.mark.parametrize("impl", ["xla", "auto"])
def test_ulysses_attention_matches_jax_full_sequence(runs, impl):
    outs, _, refs, _ = runs
    _check_attention(outs[2], f"ulysses_{impl}", refs["attn"])
    # q, the stacked (k, v) and the output, and each one's reverse
    assert outs[2][0]["ops"][f"ulysses_{impl}"]["comm"]["calls"] == 6


def test_ulysses_refuses_heads_the_seq_size_does_not_divide(runs):
    outs, _, _, _ = runs
    for o in outs[4]:
        assert "num_kv_heads (2) divisible by the seq axis size (4)" in \
            o["ops"]["ulysses_refused"]


@pytest.mark.parametrize("name,world", [(n, 2) for n in LM_MODELS] + [(n, 4) for n in WORLD4])
def test_lm_loss_seq_sharded_matches_jax(runs, name, world):
    outs, _, _, losses = runs
    for o in outs[world]:
        np.testing.assert_allclose(o["lm"][name], losses[name], rtol=1e-5, err_msg=name)


# each seq x tensor output and gradient: (its tensor axis or None when it
# is summed over the tensor ranks, its seq axis or None when summed over seq)
TP_PARTS = {"out": (2, 1), "dx": (2, 1), "dw": (0, None), "dbias": (0, None), "ddt": (2, 1),
            "dB": (2, 1), "dC": (2, 1), "dA": (0, None), "dD": (0, None), "du": (2, 1),
            "dz": (2, 1), "dq": (2, 1), "dk": (2, 1), "dv": (2, 1)}
# the scan's B and C are whole on every tensor rank
SCAN_PARTS = {"dB": (None, 1), "dC": (None, 1)}
TP_OPS = {"conv": "conv", "ssd_xla": "ssd_16", "ssd_pallas": "ssd_16", "scan_xla": "scan",
          "scan_pallas": "scan", **{f"{kind}_{a}_{impl}": a for kind in ("ring", "ulysses")
                                    for a in ("attn", "attn8") for impl in ("xla", "auto")}}


def _assemble(outs: list, key: str, part: str, axes) -> np.ndarray:
    """The seq x tensor ranks' blocks of ``part`` put back together:
    concatenated along a cut axis, summed over a whole one."""
    t_ax, s_ax = axes
    rows = []
    for s in (0, 1):
        blocks = [o["tp_ops"][key][part] for o in sorted(outs, key=lambda o: o["tp_ops"]["tp"])
                  if o["tp_ops"]["seq"] == s]
        rows.append(torch.cat(blocks, t_ax) if t_ax is not None else sum(blocks))
    return (torch.cat(rows, s_ax) if s_ax is not None else sum(rows)).numpy()


@pytest.mark.parametrize("key", list(TP_OPS))
def test_sp_ops_at_seq2_tensor2_match_jax_full_sequence(runs, key):
    """Each op on a rank's heads or channels of its block of the sequence
    (the attn Ulysses cases gather their heads over tensor), put back
    together, against JAX's full-sequence op on all the heads."""
    outs, _, refs, _ = runs
    ref = refs[TP_OPS[key]]
    assert sorted((o["tp_ops"]["seq"], o["tp_ops"]["tp"]) for o in outs[4]) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for part in ref:
        axes = SCAN_PARTS.get(part, TP_PARTS[part]) if key.startswith("scan") else TP_PARTS[part]
        tol = 1e-5 if part == "out" and TP_OPS[key].startswith(("attn", "conv")) else (
            1e-4 if part == "out" or TP_OPS[key].startswith("attn") else 2e-3)
        _close(_assemble(outs[4], key, part, axes), ref[part], tol, f"{key} {part}")


@pytest.mark.parametrize("name", TP_LM)
def test_lm_loss_at_seq2_tensor2_matches_jax(runs, name):
    outs, _, _, losses = runs
    for o in outs[4]:
        np.testing.assert_allclose(o["tp_lm"][name], losses[name], rtol=1e-5, err_msg=name)


def test_moe_queue_order_at_data2_seq2_matches_jax(runs):
    """Each rank's slots and keep masks, put back as the global (rows,
    tokens) batch, equal the JAX slots on the whole batch exactly: every
    choice-j token after every choice-(j-1) one, then the rows in order,
    a row's seq blocks one after another (a queue over whole ranks' blocks
    gets them wrong); the aux and the output too."""
    outs, _, refs, _ = runs
    ref = refs["route"]
    q = {(o["queue"]["coord"], o["queue"]["seq_rank"]): o["queue"] for o in outs[4]}
    assert sorted(q) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    pos = torch.cat([torch.cat([q[(c, s)]["pos"] for s in (0, 1)], 1) for c in (0, 1)])
    keep = torch.cat([torch.cat([q[(c, s)]["keep"] for s in (0, 1)], 1) for c in (0, 1)])
    out = torch.cat([torch.cat([q[(c, s)]["out"] for s in (0, 1)], 1) for c in (0, 1)])
    want = ref["pos"].reshape(pos.shape)
    assert all(o["cap"] == ref["cap"] for o in q.values())
    np.testing.assert_array_equal(pos.numpy(), want)
    np.testing.assert_array_equal(keep.numpy(), want < ref["cap"])
    assert not keep.all()  # capacity factor 1.0: some choices drop
    for o in q.values():
        np.testing.assert_allclose(o["aux"], ref["aux"], rtol=1e-6)
    np.testing.assert_allclose(out.numpy(), ref["out"], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", PIPE_BODIES)
def test_pipelined_layers_match_a_plain_layer_loop(runs, name):
    """pipe=2: the last stage's outputs, stage 0's microbatch gradients
    and each stage's gradients of its half of the layers equal a plain
    loop over all 4 layers; every stage makes the same shifts."""
    outs, ops, _, _ = runs
    params, xs, wts = _pipe_case(name, ops["pipe"])
    ref = _plain_layers(name, params, torch.as_tensor(xs), torch.as_tensor(wts))
    got = {o["pipe"]["stage"]: o["pipe"][name] for o in outs[2]}
    tol = 1e-6 if name == "affine" else 2e-5
    _close(got[1]["out"].numpy(), ref["out"].numpy(), tol, "out")
    assert not got[0]["out"].any()  # only the last stage holds outputs
    _close(got[0]["dxs"].numpy(), ref["dxs"].numpy(), tol, "dxs")
    for i, g in enumerate(ref["dparams"]):
        both = torch.cat([got[0]["dparams"][i], got[1]["dparams"][i]])
        _close(both.numpy(), g.numpy(), tol, f"param {i}")
    # 3 microbatches over 2 stages: 4 ticks, a shift after each but the last,
    # forward and backward
    assert got[0]["comm"] == got[1]["comm"] and got[0]["comm"]["calls"] == 6


def test_pipe_shifts_are_not_cyclic(runs):
    """A shift hands each stage the previous stage's value and stage 0
    zeros (the last stage's output goes nowhere); the backward's shift
    goes the other way, zeros into the last stage."""
    outs, _, _, _ = runs
    got = {o["pipe"]["stage"]: o["pipe"]["shifts"] for o in outs[2]}
    assert got[0][0].tolist() == [0.0] * 3 and got[1][0].tolist() == [1.0] * 3
    assert got[0][1].tolist() == [2.0] * 3 and got[1][1].tolist() == [0.0] * 3


@pytest.mark.parametrize("name", PIPE_BODIES)
def test_pipelined_layers_one_stage_is_the_plain_loop(name):
    params, xs, wts = _pipe_case(name, op_inputs()["pipe"])
    xs, wts = torch.as_tensor(xs), torch.as_tensor(wts)
    got = _pipe_grads(name, params, xs, wts, None)
    ref = _plain_layers(name, params, xs, wts)
    for k in ("out", "dxs"):
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0)
    for a, b in zip(got["dparams"], ref["dparams"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_lm_loss_pipelined_periodic_hybrid_matches_lm_loss(runs):
    """The hybrid (attention at 1 and 3 of 4 layers: 2 supersteps) in 2
    microbatches of one row, pipelined over 2 stages and on one stage,
    against the JAX ``lm_loss`` on the whole batch."""
    from mamba_distributed_tpu_torch.models.lm import lm_loss_pipelined

    outs, _, _, losses = runs
    for o in outs[2]:
        np.testing.assert_allclose(o["pipe"]["lm"], losses["hybrid-ring"], rtol=1e-5)
    lm, _ = lm_inputs()
    case = lm["hybrid-ring"]
    x, y = torch.as_tensor(case["x"]), torch.as_tensor(case["y"])
    with torch.no_grad():
        one = lm_loss_pipelined(case["params"], ModelConfig(**LM_MODELS["hybrid-ring"]),
                                x[:, None], y[:, None])
    np.testing.assert_allclose(float(one), losses["hybrid-ring"], rtol=1e-5)


CASES = {"run": _case}

if __name__ == "__main__":
    case, rank, world, work = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    result = CASES[case](rank, world, work)
    torch.save(result, work / f"out_{rank}.pt")
    import torch.distributed as dist

    dist.destroy_process_group()
