"""The port's training path against the JAX package's, on the CPU in fp32.

* ``lm_loss`` and every parameter gradient of a tiny Mamba-2 model equal
  ``jax.value_and_grad(lm_loss)`` on weights carried across by
  ``convert.params_from_jax``, with remat on and off and with
  ``ssm_impl`` "xla" and "pallas" (the SSD Function through its plain
  kernel versions), at 1e-4 of the largest JAX value;
* one train step with grad accumulation 2 equals the JAX
  ``make_train_step`` on a one-device mesh in loss, pre-clip grad norm and
  gradients (1e-4), and three optimizer steps fed the same gradients
  give the same parameters as optax (1e-6), the clip triggered once;
* the LR schedule and the decay mask equal the JAX functions, the FLOPs
  accounting and the configs' shared fields equal the JAX package's, the
  loader yields the JAX loader's batches, the log lines are the JAX
  logger's;
* ``Trainer`` on a cut-down ``mamba2-tiny`` over synthetic shards: the
  loss is finite and falls, and a checkpoint resume reproduces the
  uninterrupted run's losses exactly;
* without ``device="cpu"`` the trainer and the CLI raise on a host with
  no card;
* hybrid stacks (``hybrid-tiny``, attention at layers 1 and 3): the loss
  and every gradient equal JAX's with remat on and off and with
  ``attn_impl``/``ssm_impl`` "xla" and "pallas" (the flash Function
  through its plain kernel versions), one accum-2 train step and the
  optimizer equal JAX's, the training presets, FLOPs accounting and
  decay mask equal JAX's, and the CLI trains ``hybrid-tiny`` on the CPU.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mamba_distributed_tpu.config import DataConfig as JaxDataConfig
from mamba_distributed_tpu.config import ModelConfig as JaxConfig
from mamba_distributed_tpu.config import TrainConfig as JaxTrainConfig
from mamba_distributed_tpu.config import get_preset as jax_get_preset
from mamba_distributed_tpu.data.loader import ShardedTokenLoader as JaxLoader
from mamba_distributed_tpu.models import lm as jlm
from mamba_distributed_tpu.parallel.mesh import build_mesh
from mamba_distributed_tpu.training import optimizer as jopt
from mamba_distributed_tpu.training.train_step import make_train_step as jax_train_step
from mamba_distributed_tpu.utils import flops as jflops
from mamba_distributed_tpu.utils.metrics import MetricsLogger as JaxLogger
from mamba_distributed_tpu_torch import convert
from mamba_distributed_tpu_torch import train as cli
from mamba_distributed_tpu_torch.config import (
    DataConfig,
    MeshConfig,
    ModelConfig,
    TrainConfig,
    get_preset,
    get_train_preset,
)
from mamba_distributed_tpu_torch.data import ShardedTokenLoader, ensure_synthetic_shards
from mamba_distributed_tpu_torch.models import lm
from mamba_distributed_tpu_torch.training import Trainer
from mamba_distributed_tpu_torch.training.optimizer import (
    AdamW,
    decay_mask,
    lr_schedule,
    tree_map,
)
from mamba_distributed_tpu_torch.training.train_step import loss_and_grads, make_train_step
from mamba_distributed_tpu_torch.utils import flops
from mamba_distributed_tpu_torch.utils.metrics import MetricsLogger

pytestmark = pytest.mark.torch

TINY = dict(d_model=32, n_layer=2, vocab_size=64, headdim=8, chunk_size=16,
            d_state=16, compute_dtype="float32")


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / max(np.abs(ref).max(), 1e-30))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _leaves_np(tree):
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in _flat(tree).items()}


@pytest.fixture(scope="module")
def pair():
    jcfg = JaxConfig(**TINY, remat=False)
    jparams = jlm.init_lm_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, convert.params_from_jax(jax.tree.map(np.asarray, jparams))


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 64, shape).astype(np.int32)


def _trainable(params):
    return tree_map(lambda t: t.clone().requires_grad_(), params)


@pytest.fixture(scope="module")
def jax_loss_grads(pair):
    jcfg, jparams, _ = pair
    x, y = _ids(1, (2, 32)), _ids(2, (2, 32))
    loss, grads = jax.value_and_grad(jlm.lm_loss)(jparams, jcfg, jnp.asarray(x), jnp.asarray(y))
    return x, y, float(loss), _leaves_np(grads)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("ssm_impl", ["xla", "pallas"])
def test_lm_loss_and_grads_match_jax(pair, jax_loss_grads, remat, ssm_impl):
    _, _, params = pair
    x, y, jloss, jgrads = jax_loss_grads
    cfg = ModelConfig(**TINY, remat=remat, ssm_impl=ssm_impl)
    p = _trainable(params)
    loss = lm.lm_loss(p, cfg, torch.from_numpy(x).long(), torch.from_numpy(y).long())
    loss.backward()
    assert abs(loss.item() - jloss) <= 1e-4 * abs(jloss)
    grads = _leaves_np(tree_map(lambda t: t.grad, p))
    assert set(grads) == set(jgrads)
    for k in jgrads:
        assert _rel(grads[k], jgrads[k]) <= 1e-4, k


def _train_cfgs(tmp, accum=2, micro=2, T=32):
    model = dict(TINY, remat=False)
    kw = dict(micro_batch_size=micro, seq_len=T, total_batch_size=micro * T * accum,
              warmup_steps=2, max_steps=10)
    data = dict(data_dir=os.path.join(str(tmp), "data"), synthetic_tokens_per_shard=50_000)
    return (JaxTrainConfig(model=JaxConfig(**model), data=JaxDataConfig(**data), **kw),
            TrainConfig(model=ModelConfig(**model), data=DataConfig(**data), **kw))


def test_train_step_accum2_and_optimizer_match_jax(pair, tmp_path):
    _, jparams, params = pair
    jcfg, cfg = _train_cfgs(tmp_path)
    assert cfg.grad_accum_steps == jcfg.grad_accum_steps == 2
    x, y = _ids(3, (2, 2, 32)), _ids(4, (2, 2, 32))

    # the JAX jitted step on a one-device mesh (params replicated; the
    # step donates its buffers, so it gets a copy)
    mesh = build_mesh(jcfg.mesh, jax.devices()[:1])
    rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    jp = jax.device_put(jax.tree.map(jnp.copy, jparams), rep)
    optimizer = jopt.make_optimizer(jcfg)
    jstate = jax.device_put(optimizer.init(jp), rep)
    step = jax_train_step(jcfg, optimizer, mesh, jp, jstate)
    _, _, jloss, jnorm = step(jp, jstate, jax.device_put(jnp.asarray(x), rep),
                              jax.device_put(jnp.asarray(y), rep))
    # its gradients, summed over the accum axis and averaged, as the step does
    g0 = jax.grad(jlm.lm_loss)(jparams, jcfg.model, jnp.asarray(x[0]), jnp.asarray(y[0]))
    g1 = jax.grad(jlm.lm_loss)(jparams, jcfg.model, jnp.asarray(x[1]), jnp.asarray(y[1]))
    jgrads = _leaves_np(jax.tree.map(lambda a, b: (a + b) / 2, g0, g1))

    p = _trainable(params)
    tx, ty = torch.from_numpy(x).long(), torch.from_numpy(y).long()
    loss, grads = loss_and_grads(p, cfg, tx, ty)
    assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    for k, v in _leaves_np(grads).items():
        assert _rel(v, jgrads[k]) <= 1e-4, k
    opt = AdamW(cfg, p)
    loss2, norm = make_train_step(cfg, opt)(p, tx, ty)
    assert float(loss2) == float(loss)
    assert abs(float(norm) - float(jnorm)) <= 1e-4 * float(jnorm)

    # three optimizer steps on the SAME gradients on both sides; the
    # second is scaled past the clip limit
    jp, jstate = jparams, optimizer.init(jparams)
    tp = _trainable(params)
    topt = AdamW(cfg, tp)
    jg = jax.tree.map(lambda a, b: (a + b) / 2, g0, g1)
    for scale in (1.0, 5.0 / float(optax.global_norm(jg)), 0.5):
        gs = jax.tree.map(lambda a: a * scale, jg)
        upd, jstate = optimizer.update(gs, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.step(tp, convert.params_from_jax(jax.tree.map(np.asarray, gs)))
    got, ref = _leaves_np(tp), _leaves_np(jp)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-6, rtol=0, err_msg=k)
    assert topt.count == 3


def test_schedule_and_decay_mask_match_jax(pair):
    _, jparams, params = pair
    jcfg, cfg = JaxTrainConfig(), TrainConfig()
    js, ts = jopt.lr_schedule(jcfg), lr_schedule(cfg)
    for step in (0, 1, 100, 714, 715, 716, 5000, 19072, 19073, 19074, 30000):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6, err_msg=str(step))
    jm = {k: bool(v) for k, v in _flat(jopt.decay_mask(jparams)).items()}
    assert _flat(decay_mask(params)) == jm
    assert jm["embedding"] and not jm["blocks.mixer.A_log"] and not jm["blocks.norm.weight"]


def test_configs_flops_and_logger_match_jax(tmp_path):
    jt, tt = JaxTrainConfig(), TrainConfig()
    for f in dataclasses.fields(TrainConfig):
        if f.name not in ("model", "mesh", "data", "telemetry"):
            assert getattr(tt, f.name) == getattr(jt, f.name), f.name
    assert dataclasses.asdict(tt.data) == dataclasses.asdict(jt.data)
    assert dataclasses.asdict(tt.telemetry) == dataclasses.asdict(jt.telemetry)
    for name in ("mamba2-tiny", "mamba2-280m"):
        j, t = jax_get_preset(name), get_train_preset(name)
        assert (t.seq_len, t.micro_batch_size, t.total_batch_size, t.max_steps,
                t.warmup_steps, t.val_every, t.grad_accum_steps) == (
            j.seq_len, j.micro_batch_size, j.total_batch_size, j.max_steps,
            j.warmup_steps, j.val_every, j.grad_accum_steps)
        assert (t.model.d_model, t.model.n_layer, t.model.remat) == (
            j.model.d_model, j.model.n_layer, j.model.remat)
        for conv in ("hardware", "model"):
            assert flops.flops_per_token(t.model, t.seq_len, convention=conv) == \
                jflops.flops_per_token(j.model, j.seq_len, convention=conv)
    with pytest.raises(ValueError, match="cpu"):
        flops.peak_flops("cpu")
    # the log files the two loggers write for the same calls
    for cls, sub in ((JaxLogger, "j"), (MetricsLogger, "t")):
        lg = cls(str(tmp_path / sub), True)
        lg.val(0, 8.31234)
        lg.train_step(0, 8.3456789, 3e-5, 1.23456, 0.5, 1000.0, 0.12345)
    for f in ("log.txt", "metrics.jsonl"):
        assert (tmp_path / "j" / f).read_text() == (tmp_path / "t" / f).read_text(), f


def test_config_rejects_later_slices():
    with pytest.raises(ValueError, match="remat_policy"):
        ModelConfig(**TINY, remat_policy="none")
    with pytest.raises(ValueError, match="loss_vocab_blocks"):
        ModelConfig(**TINY, loss_impl="blocked", loss_vocab_blocks=7)
    with pytest.raises(ValueError, match="divisible"):
        TrainConfig(total_batch_size=1000)
    with pytest.raises(ValueError, match="moe_num_experts"):
        get_preset("hybrid-tiny", d_intermediate=64, moe_num_experts=1)


def test_loader_matches_jax_loader(tmp_path):
    d = str(tmp_path / "data")
    ensure_synthetic_shards(d, vocab_size=500, tokens_per_shard=4000, num_shards=2, seed=3)
    names = sorted(os.listdir(d))
    assert names == ["synthetic_train_000000.npy", "synthetic_train_000001.npy",
                     "synthetic_val_000000.npy"]
    a = ShardedTokenLoader(4, 100, d, master_process=False)
    b = JaxLoader(4, 100, d, master_process=False, backend="numpy")
    for i in range(14):  # crosses both shard ends
        if i == 5:
            st = a.state()
            assert st == {k: int(v) for k, v in b.state().items()}
        (xa, ya), (xb, yb) = a.next_batch(), b.next_batch()
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    a.restore(st)
    b.restore(st)
    np.testing.assert_array_equal(a.next_batch()[0], b.next_batch()[0])
    a.close()
    b.close()


def _tiny_trainer_cfg(tmp):
    return get_train_preset(
        "mamba2-tiny", micro_batch_size=2, seq_len=64, total_batch_size=128,
        max_lr=3e-3, warmup_steps=2, val_every=3, val_steps=1, checkpoint_every=3,
        log_dir=os.path.join(str(tmp), "log"),
        data=DataConfig(data_dir=os.path.join(str(tmp), "data"),
                        synthetic_tokens_per_shard=40_000),
    )


def test_trainer_loss_falls_and_resume_is_exact(tmp_path):
    cfg = _tiny_trainer_cfg(tmp_path)
    ck = str(tmp_path / "ck")
    a = Trainer(cfg, device="cpu", sample_prompt_ids=[1, 2, 3]).run(
        max_steps=6, checkpoint_dir=ck)
    losses = [a.history[s][0] for s in range(6)]
    assert all(np.isfinite(losses)) and all(np.isfinite(a.history[s][1]) for s in range(6))
    assert losses[-1] < losses[0] - 0.05, losses
    out = a.sample(num_return=2, max_new_tokens=4)
    assert tuple(out.shape) == (2, 7) and out[:, :3].tolist() == [[1, 2, 3]] * 2
    a.finish()
    assert sorted(os.listdir(ck)) == ["ckpt_00000003.pt"]
    log = (tmp_path / "log" / "log.txt").read_text().splitlines()
    assert log[0].startswith("0 val ") and log[1].startswith("0 train ")

    b = Trainer(cfg, device="cpu", verbose=False)
    b.restore_checkpoint(ck)
    assert b.step == 3
    b.run(max_steps=6)
    b.finish()
    assert [b.history[s] for s in range(3, 6)] == [a.history[s] for s in range(3, 6)]


def test_trainer_and_cli_need_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    cfg = _tiny_trainer_cfg(tmp_path)
    with pytest.raises(RuntimeError, match="--device cpu"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--preset", "mamba2-tiny", "--max-steps", "1",
                  "--data-dir", str(tmp_path / "data")])
    assert not (tmp_path / "data").exists()  # raised before touching the data
    args = cli.parse_args(["--preset", "mamba2-tiny", "--ssm-impl", "pallas",
                           "--chunk-size", "32", "--micro-batch-size", "4",
                           "--total-batch-size", "2048", "--seq-len", "256"])
    built = cli.build_config(args)
    assert (built.model.ssm_impl, built.model.chunk_size, built.grad_accum_steps) == (
        "pallas", 32, 2)


# -------------------------------------------------------------- hybrid stacks

# hybrid-tiny (attention at layers 1 and 3, 4 query / 2 KV heads, head
# dim 32) in fp32
HYBRID_TINY = dict(compute_dtype="float32")


@pytest.fixture(scope="module")
def hybrid_pair():
    jcfg = dataclasses.replace(jax_get_preset("hybrid-tiny").model, compute_dtype="float32",
                               remat=False, attn_impl="xla", ssm_impl="xla")
    jparams = jlm.init_lm_params(jax.random.PRNGKey(3), jcfg)
    return jcfg, jparams, convert.params_from_jax(jax.tree.map(np.asarray, jparams))


def _hyb_ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 4096, shape).astype(np.int32)


@pytest.fixture(scope="module")
def hybrid_jax_loss_grads(hybrid_pair):
    jcfg, jparams, _ = hybrid_pair
    x, y = _hyb_ids(5, (2, 64)), _hyb_ids(6, (2, 64))
    loss, grads = jax.value_and_grad(jlm.lm_loss)(jparams, jcfg, jnp.asarray(x), jnp.asarray(y))
    return x, y, float(loss), _leaves_np(grads)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_hybrid_lm_loss_and_grads_match_jax(hybrid_pair, hybrid_jax_loss_grads, remat, impl):
    _, _, params = hybrid_pair
    x, y, jloss, jgrads = hybrid_jax_loss_grads
    cfg = get_preset("hybrid-tiny", **HYBRID_TINY, remat=remat, attn_impl=impl, ssm_impl=impl)
    p = _trainable(params)
    loss = lm.lm_loss(p, cfg, torch.from_numpy(x).long(), torch.from_numpy(y).long())
    loss.backward()
    assert abs(loss.item() - jloss) <= 1e-4 * abs(jloss)
    grads = _leaves_np(tree_map(lambda t: t.grad, p))
    assert set(grads) == set(jgrads)
    assert any(k.startswith("attn_blocks.") for k in grads)
    for k in jgrads:
        assert _rel(grads[k], jgrads[k]) <= 1e-4, k


def test_hybrid_train_step_accum2_and_optimizer_match_jax(hybrid_pair, tmp_path):
    _, jparams, params = hybrid_pair
    kw = dict(micro_batch_size=2, seq_len=64, total_batch_size=256, warmup_steps=2,
              max_steps=10)
    jcfg = jax_get_preset("hybrid-tiny", **kw)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, compute_dtype="float32", remat=False, attn_impl="xla"))
    cfg = get_train_preset("hybrid-tiny", model=get_preset("hybrid-tiny", **HYBRID_TINY,
                                                           ssm_impl="pallas"), **kw)
    assert cfg.grad_accum_steps == jcfg.grad_accum_steps == 2
    x, y = _hyb_ids(7, (2, 2, 64)), _hyb_ids(8, (2, 2, 64))
    g = [jax.value_and_grad(jlm.lm_loss)(jparams, jcfg.model, jnp.asarray(x[i]),
                                         jnp.asarray(y[i])) for i in range(2)]
    jloss = (float(g[0][0]) + float(g[1][0])) / 2
    jg = jax.tree.map(lambda a, b: (a + b) / 2, g[0][1], g[1][1])
    jgrads = _leaves_np(jg)

    p = _trainable(params)
    tx, ty = torch.from_numpy(x).long(), torch.from_numpy(y).long()
    loss, grads = loss_and_grads(p, cfg, tx, ty)
    assert abs(float(loss) - jloss) <= 1e-4 * abs(jloss)
    for k, v in _leaves_np(grads).items():
        assert _rel(v, jgrads[k]) <= 1e-4, k
    # the step: the same loss and the pre-clip norm of optax
    loss2, norm = make_train_step(cfg, AdamW(cfg, p))(p, tx, ty)
    assert float(loss2) == float(loss)
    assert abs(float(norm) - float(optax.global_norm(jg))) <= 1e-4 * float(norm)
    # AdamW against optax on the SAME gradients (the attention leaves
    # included): Adam's first update is about lr * sign(g), so gradients
    # that agree to 1e-4 can still move a near-zero entry differently
    optimizer = jopt.make_optimizer(jcfg)
    upd, _ = optimizer.update(jg, optimizer.init(jparams), jparams)
    ref = _leaves_np(optax.apply_updates(jparams, upd))
    tp = _trainable(params)
    AdamW(cfg, tp).step(tp, convert.params_from_jax(jax.tree.map(np.asarray, jg)))
    got = _leaves_np(tp)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["hybrid-tiny", "hybrid-280m"])
def test_hybrid_train_presets_flops_and_decay_mask_match_jax(name, hybrid_pair):
    j, t = jax_get_preset(name), get_train_preset(name)
    assert (t.seq_len, t.micro_batch_size, t.total_batch_size, t.max_steps,
            t.warmup_steps, t.val_every, t.grad_accum_steps) == (
        j.seq_len, j.micro_batch_size, j.total_batch_size, j.max_steps,
        j.warmup_steps, j.val_every, j.grad_accum_steps)
    for f in ("d_model", "n_layer", "remat", "attn_layer_idx", "effective_attn_num_heads",
              "effective_attn_num_kv_heads", "effective_attn_head_dim", "attn_impl"):
        assert getattr(t.model, f) == getattr(j.model, f), f
    for conv in ("hardware", "model"):
        assert flops.flops_per_token(t.model, t.seq_len, convention=conv) == \
            jflops.flops_per_token(j.model, j.seq_len, convention=conv)
    _, jparams, params = hybrid_pair
    jm = {k: bool(v) for k, v in _flat(jopt.decay_mask(jparams)).items()}
    assert _flat(decay_mask(params)) == jm
    assert jm["attn_blocks.mixer.wqkv.kernel"] and not jm["attn_blocks.norm.weight"]


def test_cli_trains_hybrid_tiny_on_cpu(tmp_path):
    """``--preset hybrid-tiny --device cpu`` (cut to seq 64, micro 2): the
    loss is finite at every step and the log has a validation line."""
    cli.main(["--preset", "hybrid-tiny", "--device", "cpu", "--max-steps", "2",
              "--seq-len", "64", "--micro-batch-size", "2", "--total-batch-size", "128",
              "--data-dir", str(tmp_path / "data"), "--log-dir", str(tmp_path / "log")])
    log = (tmp_path / "log" / "log.txt").read_text().splitlines()
    train = [ln for ln in log if " train " in ln]
    assert log[0].startswith("0 val ") and len(train) == 2
    assert all(np.isfinite(float(ln.split()[2])) for ln in train)
