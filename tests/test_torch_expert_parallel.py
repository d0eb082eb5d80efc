"""The port's MoE over a mesh (global routing over the batch ranks, expert
parallelism over ``torch.distributed``) against the JAX package and the
port's one-device step, on the CPU.  Every case routes at capacity
factor 1.0, so choices drop.

* the fault this slice repairs: two gloo ranks of the port at
  ``data=2`` train a MoE model 2 steps (accum 2) on the JAX params and
  global batch, and the losses and pre-clip grad norms equal the JAX
  mesh step's at ``data=2`` at rtol 1e-4, the first micro-batch's MoE
  aux term the JAX ``lm_forward``'s at 1e-6 (each rank used to route
  only its own rows);
* the routing: at worlds 2 and 4 the ranks' global queue slots and keep
  masks (``lm.moe_route``), gathered, equal exactly the slots the JAX
  ``_moe_mlp`` computes on the concatenated batch, and each rank's aux
  equals JAX's at 1e-6;
* the dispatch and combine: ``_moe_mlp`` at ``expert=2`` (the rows'
  all-to-alls) equals the one-device dense einsums on the whole batch at
  fp32 atol 1e-6, output, input gradient and the gathered expert and
  router gradients; ``EP_COMM`` counts its all-to-alls and counts;
* the slice: ``expert=2`` (2 ranks) and ``data=2 x expert=2`` (4 ranks)
  against the JAX mesh step at the same mesh, ``fsdp=2 x expert=2`` and
  ``tensor=2 x expert=2`` against the port's one-device step, at rtol
  1e-4 (losses, grad norms) and atol 1e-5 (params); each rank holds half
  of every expert stack and of its Adam moments;
* the four-kind global norm (replicated, tensor-partial, fsdp and expert
  shards) against ``global_norm`` of the full gradients at
  ``tensor=2 x expert=2`` and ``fsdp=2 x expert=2``.

The 2-rank and the 4-rank cases each run in one spawn of
``python -m tests.test_torch_expert_parallel CASE RANK WORLD DIR``
(``tests/test_torch_parallel.spawn``), shared by the tests through
module-scoped fixtures.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mamba_distributed_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from tests.test_torch_parallel import TINY_MODEL, batches, flat, join_group, port_single, spawn

pytestmark = pytest.mark.torch

MODULE = "tests.test_torch_expert_parallel"
# a MoE after every mixer, routed at capacity factor 1.0 so that choices drop
MOE_MODEL = {**TINY_MODEL, "d_intermediate": 32, "moe_num_experts": 4, "moe_top_k": 2,
             "moe_capacity_factor": 1.0}
# the meshes of the step cases, by name: (mesh, shard_params)
STEPS = {"data2": (dict(data=2), False), "expert2": (dict(expert=2), False),
         "data2-expert2": (dict(data=2, expert=2), False),
         "fsdp2-expert2": (dict(fsdp=2, expert=2), True),
         "tensor2-expert2": (dict(tensor=2, expert=2), False)}
TWO = ("data2", "expert2")
FOUR = ("data2-expert2", "fsdp2-expert2", "tensor2-expert2")
MICRO, T, ACCUM = 2, 64, 2
# the routing cases: rows a rank, tokens a row, width
ROUTE_B, ROUTE_T, ROUTE_D = 2, 16, 32


def batch_ranks(mesh: dict) -> int:
    return mesh.get("data", 1) * mesh.get("fsdp", 1) * mesh.get("expert", 1)


def step_cfg(mesh: dict, shard: bool) -> TrainConfig:
    return TrainConfig(model=ModelConfig(**MOE_MODEL), mesh=MeshConfig(**mesh),
                       shard_params=shard, micro_batch_size=MICRO, seq_len=T,
                       total_batch_size=MICRO * T * batch_ranks(mesh) * ACCUM, warmup_steps=2,
                       max_steps=10)


def route_cfg() -> dict:
    return dict(d_model=ROUTE_D, d_intermediate=24, moe_num_experts=4, moe_top_k=2,
                moe_capacity_factor=1.0, compute_dtype="float32")


def route_inputs(world: int) -> dict:
    """One MoE layer's weights and the global (world x ROUTE_B, ROUTE_T,
    ROUTE_D) batch, from a seed (numpy)."""
    rng = np.random.default_rng(10 + world)
    c = route_cfg()
    d, di, E = c["d_model"], c["d_intermediate"], c["moe_num_experts"]
    return {"router": rng.standard_normal((d, E)).astype(np.float32),
            "w1": (rng.standard_normal((E, d, 2 * di)) / np.sqrt(d)).astype(np.float32),
            "w2": (rng.standard_normal((E, di, d)) / np.sqrt(di)).astype(np.float32),
            "x": rng.standard_normal((world * ROUTE_B, ROUTE_T, d)).astype(np.float32)}


# -------------------------------------------------------------- the workers


def _mesh_step(name: str, inp: dict) -> dict:
    """The port's mesh train step at ``STEPS[name]`` on the full params
    ``inp[name]["params"]`` and the global batches: this rank's expert
    block, tensor pack and fsdp block, 2 steps, then the gathered params."""
    from mamba_distributed_tpu_torch.parallel.collectives import EP_COMM
    from mamba_distributed_tpu_torch.parallel.mesh import (
        build_mesh,
        expert_context,
        tensor_context,
    )
    from mamba_distributed_tpu_torch.parallel.sharding import (
        batch_coordinate,
        executed_specs,
        expert_shard,
        gather_params,
        param_specs,
        shard_params,
    )
    from mamba_distributed_tpu_torch.parallel.tp_layout import pack_tp, tp_plan
    from mamba_distributed_tpu_torch.training.optimizer import AdamW, tree_map
    from mamba_distributed_tpu_torch.training.train_step import is_fsdp, make_train_step

    mesh_kw, shard = STEPS[name]
    case = inp[name]
    cfg = step_cfg(mesh_kw, shard)
    m = cfg.mesh
    mesh = build_mesh(m, "cpu")
    tp, ep = tensor_context(mesh), expert_context(mesh)
    plan = tp_plan(cfg.model, tp.size) if tp is not None else None
    specs = param_specs(case["params"], shard, m.fsdp, m.tensor, m.pipe, m.expert)
    params = expert_shard(case["params"], specs, ep) if ep is not None else case["params"]
    if tp is not None:
        params = pack_tp(params, plan, tp.rank)
        specs = executed_specs(specs, params, m.fsdp, plan)
    group = mesh.get_group("fsdp") if is_fsdp(cfg) else None
    if group is not None:
        params = shard_params(params, specs, group)
    params = tree_map(lambda t: t.clone().requires_grad_(), params)
    opt = AdamW(cfg, params)
    step = make_train_step(cfg, opt, mesh, specs)
    c = batch_coordinate(mesh)
    rows = slice(c * MICRO, (c + 1) * MICRO)
    out = {"coordinate": c, "losses": [], "norms": []}
    if "aux_x" in case:  # the first micro-batch's MoE aux at the initial params
        from mamba_distributed_tpu_torch.models.lm import lm_forward
        from mamba_distributed_tpu_torch.parallel.mesh import route_context

        with torch.no_grad():
            _, aux = lm_forward(params, cfg.model, case["aux_x"][rows], return_aux=True,
                                route=route_context(mesh), ep=ep)
        out["aux"] = float(aux)
    EP_COMM.update(calls=0, bytes=0, route_calls=0, route_bytes=0)
    for x, y in zip(case["x"], case["y"]):
        loss, norm = step(params, x[:, rows], y[:, rows])
        out["losses"].append(float(loss))
        out["norms"].append(float(norm))
    out["ep_comm"] = dict(EP_COMM)
    full = gather_params(params, specs, group, tp, plan, ep)
    out["params"] = {k: v.detach() for k, v in flat(full).items()}
    out["local"] = {k: v.numel() for k, v in flat(params).items()}
    out["moments"] = {k: v.numel() for k, v in flat(opt.mu).items()}
    return out


def _routing(world: int, inp: dict) -> dict:
    """``moe_route`` and ``_moe_mlp`` on this rank's block of the routing
    batch over the batch ranks of ``data=world``."""
    from mamba_distributed_tpu_torch.models import lm
    from mamba_distributed_tpu_torch.parallel.mesh import build_mesh, route_context

    mesh = build_mesh(MeshConfig(data=world), "cpu")
    route = route_context(mesh)
    cfg = ModelConfig(**MOE_MODEL | route_cfg())
    r = inp["route"]
    p = {"router": {"kernel": r["router"]}, "w1": r["w1"], "w2": r["w2"]}
    x = r["x"][route.coord * ROUTE_B:(route.coord + 1) * ROUTE_B]
    got = lm.moe_route(p, cfg, x.reshape(-1, ROUTE_D), route)
    out, aux = lm._moe_mlp(p, cfg, x, torch.float32, route=route)
    return {"coordinate": route.coord, "pos": got.pos, "keep": got.keep, "cap": got.cap,
            "aux": float(aux), "out": out}


def _dispatch(inp: dict) -> dict:
    """``_moe_mlp`` at ``expert=2`` on this rank's rows against the
    one-device dense ``_moe_mlp`` on the whole batch: output, input
    gradient, gathered weight gradients."""
    from mamba_distributed_tpu_torch.models import lm
    from mamba_distributed_tpu_torch.parallel.collectives import EP_COMM, all_gather_leaf
    from mamba_distributed_tpu_torch.parallel.mesh import (
        build_mesh,
        expert_context,
        route_context,
    )

    mesh = build_mesh(MeshConfig(expert=2), "cpu")
    route, ep = route_context(mesh), expert_context(mesh)
    cfg = ModelConfig(**MOE_MODEL | route_cfg())
    r = inp["route"]
    el = cfg.moe_num_experts // ep.size
    mine = slice(ep.rank * el, (ep.rank + 1) * el)
    full = {"router": {"kernel": r["router"].clone().requires_grad_()},
            "w1": r["w1"].clone().requires_grad_(), "w2": r["w2"].clone().requires_grad_()}
    local = {"router": {"kernel": r["router"].clone().requires_grad_()},
             "w1": r["w1"][mine].clone().requires_grad_(),
             "w2": r["w2"][mine].clone().requires_grad_()}
    x = r["x"].clone().requires_grad_()
    rows = slice(route.coord * ROUTE_B, (route.coord + 1) * ROUTE_B)
    xl = r["x"][rows].clone().requires_grad_()
    # a loss that weights every output element differently
    wts = torch.linspace(-1, 1, x[0].numel()).reshape(x.shape[1:])
    R = route.size
    ref, ref_aux = lm._moe_mlp(full, cfg, x, torch.float32)
    EP_COMM.update(calls=0, bytes=0, route_calls=0, route_bytes=0)
    out, aux = lm._moe_mlp(local, cfg, xl, torch.float32, route=route, ep=ep)
    # the global loss is the mean over the ranks of (out * wts).sum() + aux
    ref_leaves = [x, full["router"]["kernel"], full["w1"], full["w2"]]
    g_ref = torch.autograd.grad((ref * wts).sum() / R + ref_aux, ref_leaves)
    loc_leaves = [xl, local["router"]["kernel"], local["w1"], local["w2"]]
    g = torch.autograd.grad((out * wts).sum() + aux, loc_leaves)
    comm = dict(EP_COMM)
    # as the step takes them: the batch mean of the replicated router, the
    # expert leaves divided by the expert size (their all-to-all backward
    # summed the group's tokens); a rank's own loss weighs its rows R times
    router = g[1].clone()
    torch.distributed.all_reduce(router)
    diff = {"out": (out - ref[rows]).abs().max(), "aux": (aux - ref_aux).abs(),
            "dx": (g[0] / R - g_ref[0][rows]).abs().max(),
            "router": (router / R - g_ref[1]).abs().max(),
            "w1": (all_gather_leaf(g[2], 0, ep.group) / ep.size - g_ref[2]).abs().max(),
            "w2": (all_gather_leaf(g[3], 0, ep.group) / ep.size - g_ref[3]).abs().max()}
    return {"diff": {k: float(v) for k, v in diff.items()}, "comm": comm,
            "scale": float(max(t.abs().max() for t in (ref, *g_ref)))}


def _norms(inp: dict) -> dict:
    """``tp_global_norm`` with the expert cut, from this rank's shards of
    a random full gradient tree, against ``global_norm`` of the tree, at
    ``tensor=2 x expert=2`` and ``fsdp=2 x expert=2``."""
    from mamba_distributed_tpu_torch.parallel.collectives import tp_global_norm
    from mamba_distributed_tpu_torch.parallel.mesh import (
        build_mesh,
        expert_context,
        tensor_context,
    )
    from mamba_distributed_tpu_torch.parallel.sharding import (
        executed_specs,
        expert_axis,
        expert_shard,
        fsdp_axis,
        param_specs,
        shard_params,
    )
    from mamba_distributed_tpu_torch.parallel.tp_layout import (
        FULL_LEAF,
        pack_tp,
        plan_tree,
        tp_plan,
    )
    from mamba_distributed_tpu_torch.training.optimizer import global_norm, tree_leaves

    grads = inp["grads"]
    res = {}
    for name in ("tensor2-expert2", "fsdp2-expert2"):
        mesh_kw, shard = STEPS[name]
        cfg = step_cfg(mesh_kw, shard)
        m = cfg.mesh
        mesh = build_mesh(m, "cpu")
        tp, ep = tensor_context(mesh), expert_context(mesh)
        specs = param_specs(grads, shard, m.fsdp, m.tensor, m.pipe, m.expert)
        mine = expert_shard(grads, specs, ep)
        if tp is not None:
            plan = tp_plan(cfg.model, tp.size)
            mine = pack_tp(mine, plan, tp.rank)
            specs = executed_specs(specs, mine, m.fsdp, plan)
            plans = tree_leaves(plan_tree(specs, plan))
        else:
            plans = [FULL_LEAF] * len(tree_leaves(specs))
        fsdp_group = mesh.get_group("fsdp") if shard else None
        if shard:
            mine = shard_params(mine, specs, fsdp_group)
        spec_leaves = tree_leaves(specs)
        norm = tp_global_norm(tree_leaves(mine), plans,
                              [shard and fsdp_axis(s) is not None for s in spec_leaves],
                              tp.group if tp is not None else None, fsdp_group,
                              [expert_axis(s) is not None for s in spec_leaves], ep.group)
        res[name] = {"norm": float(norm), "ref": float(global_norm(grads)),
                     "kinds": sorted({(fsdp_axis(s) is not None, expert_axis(s) is not None)
                                      for s in spec_leaves})}
    return res


def _case_two(rank: int, world: int, work: Path) -> dict:
    join_group(world, work)
    inp = torch.load(work / "inputs.pt", weights_only=True)
    out = {name: _mesh_step(name, inp) for name in TWO}
    out["routing"] = _routing(world, inp)
    out["dispatch"] = _dispatch(inp)
    return out


def _case_four(rank: int, world: int, work: Path) -> dict:
    join_group(world, work)
    inp = torch.load(work / "inputs.pt", weights_only=True)
    out = {name: _mesh_step(name, inp) for name in FOUR}
    out["routing"] = _routing(world, inp)
    out["norms"] = _norms(inp)
    return out


# --------------------------------------------------------- the references


def jax_mesh_steps(mesh: dict, x, y):
    """The JAX package's mesh train step at ``mesh`` on the conftest's CPU
    devices, on the MoE model: (losses, norms, final params by port name,
    initial params as the port's tree, the first micro-batch's aux)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mamba_distributed_tpu.config import MeshConfig as JaxMesh
    from mamba_distributed_tpu.config import ModelConfig as JaxConfig
    from mamba_distributed_tpu.config import TrainConfig as JaxTrainConfig
    from mamba_distributed_tpu.models import init_lm_params as jax_init
    from mamba_distributed_tpu.models.lm import lm_forward
    from mamba_distributed_tpu.parallel.mesh import build_mesh
    from mamba_distributed_tpu.parallel.sharding import (
        batch_spec,
        opt_state_shardings,
        param_shardings,
    )
    from mamba_distributed_tpu.training.optimizer import make_optimizer
    from mamba_distributed_tpu.training.train_step import make_train_step
    from mamba_distributed_tpu_torch import convert

    jcfg = JaxTrainConfig(model=JaxConfig(**MOE_MODEL), mesh=JaxMesh(**mesh),
                          micro_batch_size=MICRO, seq_len=T,
                          total_batch_size=MICRO * T * batch_ranks(mesh) * ACCUM,
                          warmup_steps=2, max_steps=10)
    jmesh = build_mesh(jcfg.mesh, jax.devices()[:jcfg.mesh.num_devices])
    params = jax_init(jax.random.PRNGKey(0), jcfg.model)
    start = convert.params_from_jax(jax.tree.map(np.asarray, params))
    _, aux = lm_forward(params, jcfg.model, jnp.asarray(x[0, 0].astype(np.int32)),
                        return_aux=True)
    pshard = param_shardings(params, jmesh, False)
    p = jax.device_put(jax.tree.map(jnp.copy, params), pshard)
    optimizer = make_optimizer(jcfg)
    oshard = opt_state_shardings(jax.eval_shape(optimizer.init, p), params, pshard, jmesh)
    state = jax.jit(optimizer.init, out_shardings=oshard)(p)
    step = make_train_step(jcfg, optimizer, jmesh, p, state)
    ashard = NamedSharding(jmesh, P(None, *batch_spec(jmesh)))
    expert_cut = [s.spec for s in jax.tree.leaves(pshard) if "expert" in str(s.spec)]
    losses, norms = [], []
    for xs, ys in zip(x, y):
        p, state, loss, norm = step(p, state, jax.device_put(xs.astype(np.int32), ashard),
                                    jax.device_put(ys.astype(np.int32), ashard))
        losses.append(float(loss))
        norms.append(float(norm))
    final = flat(convert.params_from_jax(jax.tree.map(np.asarray, p)))
    return losses, norms, final, start, float(aux), expert_cut


def jax_routing(world: int, monkeypatch):
    """The JAX ``_moe_mlp`` on the whole routing batch: its queue slots
    (the argument of its slot one-hot), capacity and aux."""
    import jax
    import jax.numpy as jnp

    from mamba_distributed_tpu.config import ModelConfig as JaxConfig
    from mamba_distributed_tpu.models import lm as jlm

    r = route_inputs(world)
    seen, one_hot = [], jax.nn.one_hot

    def spy(x, n, **kw):
        seen.append((np.asarray(x), n))
        return one_hot(x, n, **kw)

    monkeypatch.setattr(jax.nn, "one_hot", spy)
    cfg = JaxConfig(**MOE_MODEL | route_cfg())
    p = {"router": {"kernel": jnp.asarray(r["router"])}, "w1": jnp.asarray(r["w1"]),
         "w2": jnp.asarray(r["w2"])}
    out, aux = jlm._moe_mlp(p, cfg, jnp.asarray(r["x"]), jnp.float32)
    monkeypatch.setattr(jax.nn, "one_hot", one_hot)
    (pos, cap), = [(x, n) for x, n in seen if n != cfg.moe_num_experts]
    return pos, cap, float(aux), np.asarray(out)


# ---------------------------------------------------------------- fixtures


def _inputs(names, world: int) -> dict:
    """Each step case's params and batches (JAX's params where a JAX mesh
    step is the reference, the port's one-device init otherwise), the
    routing batch, and a random gradient tree for the norm."""
    from mamba_distributed_tpu_torch.models.lm import init_lm_params

    inp = {"route": {k: torch.from_numpy(v) for k, v in route_inputs(world).items()}}
    port = init_lm_params(ModelConfig(**MOE_MODEL), torch.Generator().manual_seed(0))
    for name in names:
        mesh = STEPS[name][0]
        x, y = batches(3 + batch_ranks(mesh), 2, ACCUM, MICRO * batch_ranks(mesh), T,
                       MOE_MODEL["vocab_size"])
        inp[name] = {"x": torch.from_numpy(x), "y": torch.from_numpy(y), "params": port}
    g = torch.Generator().manual_seed(1)
    inp["grads"] = _map(port, lambda t: torch.randn(t.shape, generator=g))
    return inp


def _map(tree, fn):
    return {k: _map(v, fn) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _jax_refs(names, inp) -> dict:
    refs = {}
    for name in names:
        mesh, _ = STEPS[name]
        if "tensor" in mesh or "fsdp" in mesh:
            continue
        x, y = inp[name]["x"].numpy(), inp[name]["y"].numpy()
        jl, jn, final, start, aux, cut = jax_mesh_steps(mesh, x, y)
        inp[name]["params"] = start
        inp[name]["aux_x"] = torch.from_numpy(x[0, 0])
        refs[name] = {"losses": jl, "norms": jn, "params": final, "aux": aux, "cut": cut}
    return refs


@pytest.fixture(scope="module")
def two_runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("ep_two")
    inp = _inputs(TWO, 2)
    refs = _jax_refs(TWO, inp)
    torch.save(inp, work / "inputs.pt")
    return spawn(MODULE, "two", 2, work), refs, inp


@pytest.fixture(scope="module")
def four_runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("ep_four")
    inp = _inputs(FOUR, 4)
    refs = _jax_refs(FOUR, inp)
    for name in ("fsdp2-expert2", "tensor2-expert2"):  # the one-device port, whole batch
        case = inp[name]
        sl, sn, sp = port_single(MOE_MODEL, case["params"], case["x"].numpy(),
                                 case["y"].numpy(), MICRO * batch_ranks(STEPS[name][0]), T,
                                 ACCUM)
        refs[name] = {"losses": sl, "norms": sn, "params": sp}
    torch.save(inp, work / "inputs.pt")
    return spawn(MODULE, "four", 4, work), refs, inp


def _check_step(outs, ref, name):
    mesh, _ = STEPS[name]
    assert sorted(o[name]["coordinate"] for o in outs) == sorted(
        c for c in range(batch_ranks(mesh)) for _ in range(mesh.get("tensor", 1)))
    for o in outs:
        got = o[name]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(got["norms"], ref["norms"], rtol=1e-4, err_msg=name)
        assert set(got["params"]) == set(ref["params"])
        for k, v in got["params"].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(ref["params"][k]), atol=1e-5,
                                       rtol=0, err_msg=f"{name} {k}")
        assert got["moments"] == got["local"]
    return outs


# -------------------------------------------------------------------- tests


def test_moe_data2_routes_the_global_batch_like_the_jax_mesh_step(two_runs):
    """The fault: each rank of a data-parallel MoE step routed only its
    own rows (a local capacity, local slots, a local aux)."""
    outs, refs, _ = two_runs
    _check_step(outs, refs["data2"], "data2")
    for o in outs:
        np.testing.assert_allclose(o["data2"]["aux"], refs["data2"]["aux"], rtol=0, atol=1e-6)
        assert o["data2"]["ep_comm"]["calls"] == 0 and o["data2"]["ep_comm"]["route_calls"] > 0


@pytest.mark.parametrize("world", [2, 4])
def test_routing_slots_equal_jax_on_the_concatenated_batch(two_runs, four_runs, world,
                                                           monkeypatch):
    outs = (two_runs if world == 2 else four_runs)[0]
    pos, cap, aux, out = jax_routing(world, monkeypatch)
    runs = sorted((o["routing"] for o in outs), key=lambda r: r["coordinate"])
    assert [r["coordinate"] for r in runs] == list(range(world))
    assert all(r["cap"] == cap for r in runs)
    got_pos = np.concatenate([r["pos"].numpy() for r in runs])
    got_keep = np.concatenate([r["keep"].numpy() for r in runs])
    np.testing.assert_array_equal(got_pos, pos)
    np.testing.assert_array_equal(got_keep, pos < cap)
    assert 0 < (~got_keep).sum() < got_keep.size  # some choices drop, not all
    for r in runs:
        np.testing.assert_allclose(r["aux"], aux, rtol=0, atol=1e-6)
    got_out = np.concatenate([r["out"].numpy() for r in runs]).reshape(out.shape)
    np.testing.assert_allclose(got_out, out, rtol=0, atol=1e-5)


def test_expert2_dispatch_and_combine_match_the_dense_einsums(two_runs):
    outs, _, _ = two_runs
    for o in outs:
        assert o["dispatch"]["scale"] > 1e-2
        assert max(o["dispatch"]["diff"].values()) <= 1e-6, o["dispatch"]["diff"]
        # one count exchange and one aux sum forward, the aux sum backward;
        # the dispatch and combine all-to-alls forward and backward
        assert o["dispatch"]["comm"]["route_calls"] == 3
        assert o["dispatch"]["comm"]["calls"] == 4 and o["dispatch"]["comm"]["bytes"] > 0


@pytest.mark.parametrize("name", ["expert2", "data2-expert2"])
def test_expert_mesh_step_matches_the_jax_mesh_step(two_runs, four_runs, name):
    outs, refs, _ = two_runs if name in TWO else four_runs
    assert refs[name]["cut"]  # the JAX step really shards the experts
    _check_step(outs, refs[name], name)
    for o in outs:  # half of each expert stack a rank, and of its moments
        got = o[name]
        assert got["local"]["blocks.moe.w1"] * 2 == got["params"]["blocks.moe.w1"].numel()
        assert got["local"]["blocks.moe.router.kernel"] == got["params"][
            "blocks.moe.router.kernel"].numel()
        # 2 steps x accum 2 x 2 layers x (dispatch, combine) x (forward, recompute, backward)
        assert got["ep_comm"]["calls"] == 2 * ACCUM * 2 * 2 * 3


@pytest.mark.parametrize("name", ["fsdp2-expert2", "tensor2-expert2"])
def test_expert_mesh_step_matches_one_device(four_runs, name):
    outs, refs, _ = four_runs
    _check_step(outs, refs[name], name)
    full = {k: v.numel() for k, v in outs[0][name]["params"].items()}
    for o in outs:  # the expert axis and fsdp or tensor: a quarter of each expert stack
        assert o[name]["local"]["blocks.moe.w1"] * 4 == full["blocks.moe.w1"]


@pytest.mark.parametrize("name", ["tensor2-expert2", "fsdp2-expert2"])
def test_four_kind_global_norm(four_runs, name):
    outs, _, _ = four_runs
    for o in outs:
        r = o["norms"][name]
        np.testing.assert_allclose(r["norm"], r["ref"], rtol=1e-6)
        # (fsdp-cut, expert-cut) leaves: fsdp cuts every leaf it divides there
        assert r["kinds"] == ([(False, False), (False, True)] if name.startswith("tensor")
                              else [(True, False), (True, True)])
    assert len({o["norms"][name]["norm"] for o in outs}) == 1


CASES = {"two": _case_two, "four": _case_four}

if __name__ == "__main__":
    case, rank, world, work = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    result = CASES[case](rank, world, work)
    torch.save(result, work / f"out_{rank}.pt")
    import torch.distributed as dist

    dist.destroy_process_group()
