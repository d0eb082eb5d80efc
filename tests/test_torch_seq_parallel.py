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


def _case(rank: int, world: int, work: Path) -> dict:
    from mamba_distributed_tpu_torch.config import MeshConfig
    from mamba_distributed_tpu_torch.parallel.mesh import build_mesh, seq_context

    join_group(world, work)
    inp = torch.load(work / "inputs.pt", weights_only=True)
    seq = seq_context(build_mesh(MeshConfig(seq=world), "cpu"))
    names = list(LM_MODELS) if world == 2 else list(WORLD4)
    return {"rank": seq.rank, "ops": _ops(seq, inp["ops"]), "lm": _lm(seq, inp["lm"], names)}


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
    a = inp["attn"]
    ref["attn"] = _jax_grads(blockwise_sdpa_causal, {k: a[k] for k in ("q", "k", "v")},
                             a["wts"])
    return ref


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


def _run_world(tmp_path_factory, world: int, ops: dict, lm: dict):
    work = tmp_path_factory.mktemp(f"sp_{world}")
    torch.save({"ops": _torchify(ops), "lm": _torchify(lm)}, work / "inputs.pt")
    return start(MODULE, "run", world, work)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' workers, started together, and the JAX references
    computed while they run."""
    ops, (lm, jparams) = op_inputs(), lm_inputs()
    waits = {w: _run_world(tmp_path_factory, w, ops, lm) for w in WORLDS}
    refs, losses = jax_refs(ops), jax_losses(lm, jparams)
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


CASES = {"run": _case}

if __name__ == "__main__":
    case, rank, world, work = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    result = CASES[case](rank, world, work)
    torch.save(result, work / f"out_{rank}.pt")
    import torch.distributed as dist

    dist.destroy_process_group()
