"""The port's tensor-parallel training (``parallel/tp_layout.py``, the
blocks' column/row collectives, the mesh train step over ``tensor``)
against the JAX package and the port's one-device functions, on the CPU.

* the packed layout: on tiny Mamba-2 (``ngroups`` 1 and 2), Mamba-1,
  hybrid-with-gated-MLP and MoE trees, and hybrid and Mamba-1 trees with
  ``proj_bias``, at tensor 2 and 4, ``unpack_tp``
  of every rank's ``pack_tp`` gives back each full leaf, the leaf kinds
  are pinned, and a block whose heads the size does not divide is
  replicated whole; ``param_specs`` still equals JAX's at tensor 2 and
  4;
* the mixers and FFNs in 2 and 4 gloo processes: ``mamba2_mixer``
  (``ngroups`` 1 and 2), ``mamba1_mixer``, ``attention_mixer``,
  ``_gated_mlp`` and ``_moe_mlp`` on each rank's packed params (and the
  three mixers with ``proj_bias`` and random biases) equal the
  one-device function, forward, input gradient and gathered parameter
  gradients, at fp32 atol 1e-5; the three-kind global norm equals
  ``global_norm`` of the full gradients (tensor 2, and fsdp 2 x tensor
  2);
* two gloo processes run the port's train step at ``tensor=2`` (2 steps,
  accum 2) on the JAX params and batch: losses and grad norms equal the
  JAX mesh step's on the conftest's CPU devices at rtol 2e-4, the
  gathered params at atol 1e-5;
* ``data=2 x tensor=2`` and ``fsdp=2 x tensor=2`` (4 processes), the
  hybrid with a gated MLP (also with ``proj_bias``) and Mamba-1 at
  ``tensor=2`` equal the port's
  one-device step at rtol 2e-4 (5e-4 where axes combine, as the JAX
  ``test_tp_with_fsdp_and_dp``).

Workers are ``python -m tests.test_torch_tensor_parallel CASE RANK WORLD
DIR``, launched by ``tests/test_torch_parallel.spawn``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mamba_distributed_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from tests.test_torch_parallel import (
    HYBRID_OVER,
    MOE_OVER,
    TINY_MODEL,
    TREES,
    _jax_port_trees,
    batches,
    flat,
    join_group,
    port_single,
    spawn,
)

pytestmark = pytest.mark.torch

MODULE = "tests.test_torch_tensor_parallel"
LAYOUT_TREES = {**TREES, "mamba2-ngroups2": dict(ngroups=2),
                "hybrid-bias": {**HYBRID_OVER, "proj_bias": True},
                "mamba1-bias": {**TREES["mamba1"], "proj_bias": True}}
# the attention case: GQA 8 query / 4 KV heads of 16, split at 2 and 4
ATTN_OVER = dict(n_layer=2, attn_layer_idx=(1,), attn_num_heads=8, attn_num_kv_heads=4,
                 attn_head_dim=16)
MIXER_CASES = {
    "mamba2": ({}, "ssm", "mixer"),
    "mamba2-ngroups2": (dict(ngroups=2), "ssm", "mixer"),
    "mamba1": (dict(ssm_layer="mamba1", d_state=16), "ssm", "mixer"),
    "attention": (ATTN_OVER, "attn", "mixer"),
    "mamba2-bias": (dict(proj_bias=True), "ssm", "mixer"),
    "mamba1-bias": (dict(ssm_layer="mamba1", d_state=16, proj_bias=True), "ssm", "mixer"),
    "attention-bias": ({**ATTN_OVER, "proj_bias": True}, "attn", "mixer"),
    "gated_mlp": (HYBRID_OVER, "ffn", "mlp"),
    "moe": ({**HYBRID_OVER, **MOE_OVER}, "ffn", "moe"),
}


# --------------------------------------------------------------- the layout


def _tree(over: dict):
    from mamba_distributed_tpu_torch.models.lm import init_lm_params

    cfg = ModelConfig(**{**TINY_MODEL, **over})
    return cfg, init_lm_params(cfg, torch.Generator().manual_seed(0))


def _random_biases(tree: dict, seed: int) -> dict:
    """``tree`` with the bias of every ``in_proj``, ``wqkv`` and
    ``out_proj`` (``proj_bias``; init makes them zero) drawn at random,
    so the forward reads each bias segment."""
    g = torch.Generator().manual_seed(seed)

    def walk(t, name=""):
        if not isinstance(t, dict):
            return t
        out = {k: walk(v, k) for k, v in t.items()}
        if name in ("in_proj", "wqkv", "out_proj") and "bias" in t:
            out["bias"] = 0.1 * torch.randn(t["bias"].shape, generator=g)
        return out

    return walk(tree)


def _kinds(tree: dict, plan) -> dict:
    """Dotted path -> kind of every leaf of ``tree`` under ``plan``."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, (*path, str(k)))
        else:
            out[".".join(path)] = plan.leaf(path).kind

    walk(tree, ())
    return out


# pinned kinds of every leaf a split block holds (the rest are "full"),
# and of the projections' biases with proj_bias: a row-parallel
# projection's bias is added once after the sum, so it is "full"
MAMBA2_KINDS = {"in_proj.kernel": "partial", "conv.kernel": "partial", "conv.bias": "partial",
                "dt_bias": "split", "A_log": "split", "D": "split", "norm.weight": "split",
                "out_proj.kernel": "split"}
KINDS = {
    "mamba2": {f"blocks.mixer.{k}": v for k, v in MAMBA2_KINDS.items()},
    "mamba2-ngroups2": {f"blocks.mixer.{k}": "split" for k in MAMBA2_KINDS},
    "mamba1": {f"blocks.mixer.{k}": "split" for k in (
        "in_proj.kernel", "conv.kernel", "conv.bias", "x_proj.kernel", "dt_proj.kernel",
        "dt_proj.bias", "A_log", "D", "out_proj.kernel")},
}
KINDS["hybrid"] = {**KINDS["mamba2"], "attn_blocks.mixer.wqkv.kernel": "split",
                   "attn_blocks.mixer.out_proj.kernel": "split",
                   **{f"{s}.mlp.{k}.kernel": "split" for s in ("blocks", "attn_blocks")
                      for k in ("fc1", "fc2")}}
KINDS["hybrid-bias"] = {**KINDS["hybrid"], "blocks.mixer.in_proj.bias": "partial",
                       "blocks.mixer.out_proj.bias": "full",
                       "attn_blocks.mixer.wqkv.bias": "split",
                       "attn_blocks.mixer.out_proj.bias": "full"}
KINDS["mamba1-bias"] = {**KINDS["mamba1"], "blocks.mixer.in_proj.bias": "split",
                        "blocks.mixer.out_proj.bias": "full"}
KINDS["moe"] = {**{k: v for k, v in KINDS["hybrid"].items() if ".mlp." not in k},
                **{f"{s}.moe.{k}": "split" for s in ("blocks", "attn_blocks")
                   for k in ("w1", "w2")}}
# the blocks that run whole at tensor 4: ngroups 2 and 2 KV heads do not divide
WHOLE_AT_4 = {"mamba2-ngroups2": ("blocks.mixer.",), "hybrid": ("attn_blocks.mixer.",),
              "hybrid-bias": ("attn_blocks.mixer.",), "moe": ("attn_blocks.mixer.",)}


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("tree", sorted(LAYOUT_TREES))
def test_pack_unpack_round_trip_and_kinds(tree, size):
    from mamba_distributed_tpu_torch.parallel.tp_layout import pack_tp, tp_plan, unpack_tp

    cfg, full = _tree(LAYOUT_TREES[tree])
    plan = tp_plan(cfg, size)
    shards = [pack_tp(full, plan, r) for r in range(size)]
    back = unpack_tp(shards, plan)
    for k, v in flat(full).items():
        assert torch.equal(flat(back)[k], v), k
    kinds = _kinds(full, plan)
    whole = WHOLE_AT_4.get(tree, ()) if size == 4 else ()
    want = {k: ("full" if k.startswith(whole) else v) for k, v in KINDS[tree].items()}
    assert {k: kinds[k] for k in want} == want
    assert {k: v for k, v in kinds.items() if v != "full"} == {
        k: v for k, v in want.items() if v != "full"}
    for k, v in flat(full).items():
        local = flat(shards[0])[k]
        if kinds[k] == "full":  # replicated whole: every rank holds the leaf
            assert local is v or torch.equal(local, v), k
        elif kinds[k] == "split":  # 1/size of the packed axis a rank
            assert local.numel() * size == v.numel(), k
        else:  # B and C whole on every rank
            assert v.numel() < local.numel() * size < v.numel() * size, k
    # the split mixer's local shapes are its own heads'
    if tree == "mamba2" and size == 2:
        di, ds, nh = cfg.d_inner, cfg.effective_d_state, cfg.nheads
        assert tuple(shards[1]["blocks"]["mixer"]["in_proj"]["kernel"].shape[-1:]) == (
            2 * (di // 2) + 2 * ds + nh // 2,)


def test_pack_takes_each_segment_and_whole_heads():
    from mamba_distributed_tpu_torch.parallel.tp_layout import pack_leaf, tp_plan

    cfg = ModelConfig(**TINY_MODEL)
    di, ds, nh = cfg.d_inner, cfg.effective_d_state, cfg.nheads
    lp = tp_plan(cfg, 2).leaf(("blocks", "mixer", "in_proj", "kernel"))
    cols = torch.arange(2 * di + 2 * ds + nh, dtype=torch.float32)[None]
    h = di // 2
    want = torch.cat([cols[0, h:di], cols[0, di + h:2 * di],
                      cols[0, 2 * di:2 * di + 2 * ds], cols[0, 2 * di + 2 * ds + nh // 2:]])
    assert torch.equal(pack_leaf(cols, lp, 1)[0], want)
    assert lp.shared == tuple(range(2 * h, 2 * h + 2 * ds))
    # wqkv by heads: q_r | k_r | v_r
    hc = ModelConfig(**{**TINY_MODEL, **ATTN_OVER})
    lp = tp_plan(hc, 4).leaf(("attn_blocks", "mixer", "wqkv", "kernel"))
    hd = 16
    heads = torch.arange(16, dtype=torch.float32).repeat_interleave(hd)[None]  # 8 q, 4 k, 4 v
    got = pack_leaf(heads, lp, 3)[0].reshape(-1, hd)[:, 0].tolist()
    assert got == [6.0, 7.0, 11.0, 15.0]


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("tree", sorted(TREES))
def test_param_specs_match_jax_at_tensor(tree, size):
    import jax
    from jax.sharding import PartitionSpec as P

    from mamba_distributed_tpu.parallel.sharding import param_specs as jax_specs
    from mamba_distributed_tpu_torch.parallel.sharding import param_specs

    shapes, params = _jax_port_trees(TREES[tree])
    for kw in (dict(fsdp_size=1, tensor_size=size), dict(fsdp_size=2, tensor_size=size)):
        jspec = jax_specs(shapes, True, **kw)
        want = {jax.tree_util.keystr(path).replace("']['", ".").strip("[']"): tuple(s)
                for path, s in jax.tree_util.tree_flatten_with_path(
                    jspec, is_leaf=lambda s: isinstance(s, P))[0]}
        assert flat(param_specs(params, True, **kw)) == want


# ------------------------------------------------------------------ workers


def _layer0(tree):
    """Layer 0 of a layer-stacked tree."""
    return {k: _layer0(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


def _run_block(name: str, cfg: ModelConfig, bp: dict, u: torch.Tensor, tp):
    from mamba_distributed_tpu_torch.models.attention import attention_mixer
    from mamba_distributed_tpu_torch.models.lm import _gated_mlp, _moe_mlp
    from mamba_distributed_tpu_torch.models.mamba1 import mamba1_mixer
    from mamba_distributed_tpu_torch.models.mamba2 import mamba2_mixer

    cd = cfg.torch_compute_dtype
    if name == "gated_mlp":
        return _gated_mlp(bp, u, cd, tp), None
    if name == "moe":
        return _moe_mlp(bp, cfg, u, cd, tp)
    fn = {"attention": attention_mixer, "mamba1": mamba1_mixer}.get(name.split("-")[0],
                                                                    mamba2_mixer)
    return fn(bp, cfg, u, tp=tp), None


def _case_mixers(rank: int, world: int, work: Path) -> dict:
    import torch.distributed as dist

    from mamba_distributed_tpu_torch.models.lm import init_lm_params
    from mamba_distributed_tpu_torch.parallel.collectives import (
        TP_COMM,
        all_gather_list,
        sum_shared_,
    )
    from mamba_distributed_tpu_torch.parallel.tp_layout import (
        TPContext,
        block_tp,
        pack_tp,
        plan_tree,
        tp_plan,
        unpack_leaf,
    )
    from mamba_distributed_tpu_torch.training.optimizer import tree_leaves

    join_group(world, work)
    tp = TPContext(dist.group.WORLD, world, rank)
    out = {}
    for name, (over, kind, sub) in MIXER_CASES.items():
        cfg = ModelConfig(**{**TINY_MODEL, **over})
        full = _random_biases(init_lm_params(cfg, torch.Generator().manual_seed(0)), 2)
        plan = tp_plan(cfg, world)
        stack = "attn_blocks" if kind == "attn" else "blocks"
        ref = _layer0(full[stack][sub])
        mine = _layer0(pack_tp(full, plan, rank)[stack][sub])
        plans = tree_leaves(plan_tree(ref, plan, (stack, sub)))
        g = torch.Generator().manual_seed(1)
        u = torch.randn(2, 64, cfg.d_model, generator=g)
        cot = torch.randn(2, 64, cfg.d_model, generator=g)
        res = {}
        for tag, tree, ctx in (("one", ref, None), ("tp", mine, block_tp(tp, cfg, kind))):
            leaves = [t.clone().requires_grad_() for t in tree_leaves(tree)]
            it = iter(leaves)
            bp = _rebuild(tree, it)
            x = u.clone().requires_grad_()
            y, aux = _run_block(name, cfg, bp, x, ctx)
            # a token-mean loss, as the LM's
            loss = (y * cot).sum() / (2 * 64) + (0.7 * aux if aux is not None else 0.0)
            du, *grads = torch.autograd.grad(loss, [x, *leaves])
            res[tag] = (y.detach(), du, grads, ctx is not None)
        y1, du1, g1, _ = res["one"]
        yt, dut, gt, split = res["tp"]
        if split:
            sum_shared_(gt, plans, tp.group)
            gt = [unpack_leaf(all_gather_list(gr, tp.group), lp) for gr, lp in zip(gt, plans)]
        out[name] = {"split": split, "out": float((yt - y1).abs().max()),
                     "du": float((dut - du1).abs().max()),
                     "grads": [float((a - b).abs().max()) for a, b in zip(gt, g1)],
                     "rel": [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                             for a, b in zip(gt, g1)]}
    out["tp_comm_calls"] = TP_COMM["calls"]
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    return next(it)


def _case_norm(rank: int, world: int, work: Path) -> dict:
    """The three-kind global norm from packed (and fsdp-narrowed) random
    gradients of a tiny Mamba-2 + MoE hybrid against ``global_norm``."""
    from mamba_distributed_tpu_torch.parallel.collectives import tp_global_norm
    from mamba_distributed_tpu_torch.parallel.mesh import build_mesh, tensor_context
    from mamba_distributed_tpu_torch.parallel.sharding import (
        executed_specs,
        fsdp_axis,
        param_specs,
        shard_params,
    )
    from mamba_distributed_tpu_torch.parallel.tp_layout import pack_tp, plan_tree, tp_plan
    from mamba_distributed_tpu_torch.training.optimizer import global_norm, tree_leaves, tree_map

    join_group(world, work)
    mesh_cfg = MeshConfig(tensor=2, fsdp=world // 2)
    mesh = build_mesh(mesh_cfg, "cpu")
    tp = tensor_context(mesh)
    cfg, full = _tree({**HYBRID_OVER, **MOE_OVER})
    g = torch.Generator().manual_seed(3)
    grads = tree_map(lambda t: torch.randn(t.shape, generator=g), full)
    plan = tp_plan(cfg, tp.size)
    local = pack_tp(grads, plan, tp.rank)
    specs = executed_specs(param_specs(full, True, mesh_cfg.fsdp, 2), local, mesh_cfg.fsdp, plan)
    fsdp_group = mesh.get_group("fsdp") if mesh_cfg.fsdp > 1 else None
    mine = shard_params(local, specs, fsdp_group) if fsdp_group is not None else local
    spec_leaves = tree_leaves(specs)
    norm = tp_global_norm(tree_leaves(mine), tree_leaves(plan_tree(specs, plan)),
                          [fsdp_group is not None and fsdp_axis(s) is not None
                           for s in spec_leaves], tp.group, fsdp_group)
    return {"norm": float(norm), "ref": float(global_norm(grads)),
            "cut": sum(fsdp_axis(s) is not None for s in spec_leaves)}


def _step_cfg(model: dict, mesh: dict, shard: bool, micro: int, T: int, accum: int):
    dp = mesh.get("data", 1) * mesh.get("fsdp", 1)
    return TrainConfig(model=ModelConfig(**model), mesh=MeshConfig(**mesh), shard_params=shard,
                       micro_batch_size=micro, seq_len=T, total_batch_size=micro * T * dp * accum,
                       warmup_steps=2, max_steps=10)


def _case_step(rank: int, world: int, work: Path) -> dict:
    from mamba_distributed_tpu_torch.parallel.collectives import TP_COMM
    from mamba_distributed_tpu_torch.parallel.mesh import build_mesh, tensor_context
    from mamba_distributed_tpu_torch.parallel.sharding import (
        batch_coordinate,
        executed_specs,
        gather_params,
        param_specs,
        shard_params,
    )
    from mamba_distributed_tpu_torch.parallel.tp_layout import pack_tp, tp_plan
    from mamba_distributed_tpu_torch.training.optimizer import AdamW, tree_map
    from mamba_distributed_tpu_torch.training.train_step import is_fsdp, make_train_step

    join_group(world, work)
    inp = torch.load(work / "inputs.pt", weights_only=True)
    cfg = _step_cfg(inp["model"], inp["mesh"], inp["shard"], inp["micro"], inp["T"],
                    inp["accum"])
    mesh = build_mesh(cfg.mesh, "cpu")
    m = cfg.mesh
    tp = tensor_context(mesh)
    plan = tp_plan(cfg.model, tp.size)
    specs = param_specs(inp["params"], cfg.shard_params, m.fsdp, m.tensor, m.pipe, m.expert)
    params = pack_tp(inp["params"], plan, tp.rank)
    specs = executed_specs(specs, params, m.fsdp, plan)
    fsdp = is_fsdp(cfg)
    group = mesh.get_group("fsdp") if fsdp else None
    if fsdp:
        params = shard_params(params, specs, group)
    params = tree_map(lambda t: t.clone().requires_grad_(), params)
    opt = AdamW(cfg, params)
    step = make_train_step(cfg, opt, mesh, specs)
    c, B = batch_coordinate(mesh), cfg.micro_batch_size
    losses, norms = [], []
    TP_COMM.update(calls=0, bytes=0)
    for x, y in zip(inp["x"], inp["y"]):
        loss, norm = step(params, x[:, c * B:(c + 1) * B], y[:, c * B:(c + 1) * B])
        losses.append(float(loss))
        norms.append(float(norm))
    comm = dict(TP_COMM)
    full = gather_params(params, specs, group, tp, plan)
    return {"losses": losses, "norms": norms, "coordinate": c, "tp_rank": tp.rank,
            "params": {k: v.detach() for k, v in flat(full).items()},
            "local": {k: v.numel() for k, v in flat(params).items()},
            "moments": {k: v.numel() for k, v in flat(opt.mu).items()},
            "tp_comm": comm}


def _run_step(work: Path, model: dict, mesh: dict, shard: bool, params: dict, x, y,
              micro: int = 2, T: int = 64, accum: int = 2) -> list:
    world = int(np.prod(list(mesh.values())))
    work.mkdir(parents=True, exist_ok=True)
    torch.save({"model": model, "mesh": mesh, "shard": shard, "micro": micro, "T": T,
                "accum": accum, "params": params, "x": torch.from_numpy(x),
                "y": torch.from_numpy(y)}, work / "inputs.pt")
    return spawn(MODULE, "step", world, work)


# ----------------------------------------------------- the mixers and norm


@pytest.fixture(scope="module")
def mixer_runs(tmp_path_factory):
    return {w: spawn(MODULE, "mixers", w, tmp_path_factory.mktemp(f"mixers{w}"))
            for w in (2, 4)}


# the blocks that run whole at tensor 4 (module docstring of tp_layout)
WHOLE = {(4, "mamba2-ngroups2")}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(MIXER_CASES))
def test_block_matches_single_device(mixer_runs, name, world):
    for o in mixer_runs[world]:
        r = o[name]
        assert r["split"] == ((world, name) not in WHOLE)
        assert r["out"] <= 1e-5 and r["du"] <= 1e-5, r
        assert max(r["grads"]) <= 1e-5, r
        # and relative to each leaf's largest gradient, for the small ones
        assert max(r["rel"]) <= 1e-4, r
        assert o["tp_comm_calls"] > 0


@pytest.mark.parametrize("world", [2, 4], ids=["tensor2", "fsdp2-tensor2"])
def test_three_kind_global_norm(tmp_path, world):
    outs = spawn(MODULE, "norm", world, tmp_path)
    for o in outs:
        np.testing.assert_allclose(o["norm"], o["ref"], rtol=1e-6)
        if world == 4:
            assert o["cut"] > 0
    assert len({o["norm"] for o in outs}) == 1


# -------------------------------------------------------------- the steps


def _jax_steps(model: dict, mesh: dict, x, y, micro: int = 2, T: int = 64, accum: int = 2):
    """The JAX package's mesh train step at ``mesh`` on the conftest's CPU
    devices: (losses, norms, final params by port name, initial params as
    the port's tree)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mamba_distributed_tpu.config import MeshConfig as JaxMesh
    from mamba_distributed_tpu.config import ModelConfig as JaxConfig
    from mamba_distributed_tpu.config import TrainConfig as JaxTrainConfig
    from mamba_distributed_tpu.models import init_lm_params as jax_init
    from mamba_distributed_tpu.parallel.mesh import build_mesh
    from mamba_distributed_tpu.parallel.sharding import opt_state_shardings, param_shardings
    from mamba_distributed_tpu.training.optimizer import make_optimizer
    from mamba_distributed_tpu.training.train_step import make_train_step
    from mamba_distributed_tpu_torch import convert

    dp = mesh.get("data", 1) * mesh.get("fsdp", 1)
    jcfg = JaxTrainConfig(model=JaxConfig(**model), mesh=JaxMesh(**mesh), shard_params=False,
                          micro_batch_size=micro, seq_len=T,
                          total_batch_size=micro * T * dp * accum, warmup_steps=2,
                          max_steps=10)
    jmesh = build_mesh(jcfg.mesh, jax.devices()[:jcfg.mesh.num_devices])
    params = jax_init(jax.random.PRNGKey(0), jcfg.model)
    start = convert.params_from_jax(jax.tree.map(np.asarray, params))
    pshard = param_shardings(params, jmesh, False)
    p = jax.device_put(jax.tree.map(jnp.copy, params), pshard)
    optimizer = make_optimizer(jcfg)
    oshard = opt_state_shardings(jax.eval_shape(optimizer.init, p), params, pshard, jmesh)
    state = jax.jit(optimizer.init, out_shardings=oshard)(p)
    step = make_train_step(jcfg, optimizer, jmesh, p, state)
    ashard = NamedSharding(jmesh, P(None, ("data", "fsdp")))
    tensor_cut = any("tensor" in str(s.spec) for s in jax.tree.leaves(pshard))
    losses, norms = [], []
    for xs, ys in zip(x, y):
        p, state, loss, norm = step(p, state, jax.device_put(xs.astype(np.int32), ashard),
                                    jax.device_put(ys.astype(np.int32), ashard))
        losses.append(float(loss))
        norms.append(float(norm))
    final = flat(convert.params_from_jax(jax.tree.map(np.asarray, p)))
    return losses, norms, final, start, tensor_cut


def test_two_rank_tensor_step_matches_jax_mesh_step(tmp_path):
    x, y = batches(1, 2, 2, 2, 64, TINY_MODEL["vocab_size"])
    jl, jn, jparams, start, cut = _jax_steps(TINY_MODEL, dict(tensor=2), x, y)
    assert cut  # the JAX step really shards over tensor
    outs = _run_step(tmp_path, TINY_MODEL, dict(tensor=2), False, start, x, y)
    assert sorted(o["tp_rank"] for o in outs) == [0, 1]
    assert [o["coordinate"] for o in outs] == [0, 0]  # one batch rank
    for o in outs:
        np.testing.assert_allclose(o["losses"], jl, rtol=2e-4)
        np.testing.assert_allclose(o["norms"], jn, rtol=2e-4)
        assert set(o["params"]) == set(jparams)
        for k, v in o["params"].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jparams[k]), atol=1e-5, rtol=0,
                                       err_msg=k)
        assert o["tp_comm"]["calls"] > 0 and o["tp_comm"]["bytes"] > 0
        # the mixer's split leaves hold half a rank, their moments too
        assert o["local"]["blocks.mixer.out_proj.kernel"] * 2 == o["params"][
            "blocks.mixer.out_proj.kernel"].numel()
        assert o["moments"] == o["local"]
    assert outs[0]["losses"] == outs[1]["losses"] and outs[0]["norms"] == outs[1]["norms"]


def _single(tmp_path, model: dict, mesh: dict, shard: bool, rtol: float, micro: int = 2):
    from mamba_distributed_tpu_torch.models.lm import init_lm_params

    dp = mesh.get("data", 1) * mesh.get("fsdp", 1)
    params = _random_biases(init_lm_params(ModelConfig(**model), torch.Generator().manual_seed(0)), 2)
    x, y = batches(2, 2, 2, micro * dp, 64, model["vocab_size"])
    sl, sn, sp = port_single(model, params, x, y, micro * dp)
    outs = _run_step(tmp_path, model, mesh, shard, params, x, y, micro=micro)
    assert sorted(o["coordinate"] for o in outs) == sorted(
        c for c in range(dp) for _ in range(mesh.get("tensor", 1)))
    for o in outs:
        np.testing.assert_allclose(o["losses"], sl, rtol=rtol)
        np.testing.assert_allclose(o["norms"], sn, rtol=rtol)
        for k, v in o["params"].items():
            np.testing.assert_allclose(v.numpy(), sp[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
    return outs


def test_data2_tensor2_matches_single_device(tmp_path):
    _single(tmp_path, TINY_MODEL, dict(data=2, tensor=2), False, 5e-4)


def test_fsdp2_tensor2_matches_single_device(tmp_path):
    outs = _single(tmp_path, TINY_MODEL, dict(fsdp=2, tensor=2), True, 5e-4)
    full = {k: v.numel() for k, v in outs[0]["params"].items()}
    for o in outs:  # both axes cut the mixer's out_proj: a quarter a rank
        assert o["local"]["blocks.mixer.out_proj.kernel"] * 4 == full[
            "blocks.mixer.out_proj.kernel"]
        assert o["moments"] == o["local"]


def test_hybrid_mlp_tensor2_matches_single_device(tmp_path):
    _single(tmp_path, {**TINY_MODEL, **HYBRID_OVER}, dict(tensor=2), False, 2e-4)


def test_proj_bias_hybrid_tensor2_matches_single_device(tmp_path):
    # B|C of in_proj.bias summed over the group, the row-parallel biases
    # added once after the sum
    _single(tmp_path, {**TINY_MODEL, **HYBRID_OVER, "proj_bias": True}, dict(tensor=2), False,
            2e-4)


def test_mamba1_tensor2_matches_single_device(tmp_path):
    _single(tmp_path, {**TINY_MODEL, "ssm_layer": "mamba1", "d_state": 16}, dict(tensor=2),
            False, 2e-4)


CASES = {"mixers": _case_mixers, "norm": _case_norm, "step": _case_step}

if __name__ == "__main__":
    case, rank, world, work = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    result = CASES[case](rank, world, work)
    torch.save(result, work / f"out_{rank}.pt")
    import torch.distributed as dist

    dist.destroy_process_group()
