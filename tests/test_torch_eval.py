"""The port's HellaSwag harness (``eval/hellaswag.py``) against the JAX
package's, on the CPU in fp32.

The cases of the JAX ``tests/test_eval.py`` (render shapes and mask, the
" "-prefix rule, the cap, sum against mean argmin, the log line,
batching) run on torch forwards; then 2-layer Mamba-2, Mamba-1 and hybrid
models whose params come from JAX through ``convert.params_from_jax``
score ``tests/data/hellaswag_tiny.jsonl``: the per-row summed and mean
losses equal JAX's ``_scores_fn`` at 1e-4, and the counts and the
appended log line are identical.
"""

import json
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mamba_distributed_tpu.config import ModelConfig as JaxConfig
from mamba_distributed_tpu.eval import hellaswag as jhs
from mamba_distributed_tpu.models import lm as jlm
from mamba_distributed_tpu_torch import convert
from mamba_distributed_tpu_torch.config import ModelConfig
from mamba_distributed_tpu_torch.eval import evaluate_hellaswag, render_example
from mamba_distributed_tpu_torch.eval import hellaswag as hs
from mamba_distributed_tpu_torch.models.lm import lm_forward

pytestmark = pytest.mark.torch

TINY_FILE = Path(__file__).resolve().parent / "data" / "hellaswag_tiny.jsonl"
EXAMPLE = {
    "ctx": "the cat sat",
    "label": 2,
    "endings": ["on a mat", "under a tree now", "by the door", "up"],
}


def fake_encode(text: str) -> list[int]:
    """Deterministic word-level encoder (the JAX tests' own)."""
    return [zlib.crc32(piece.encode()) % 97 + 1 for piece in text.split(" ")]


def _evaluate(forward, examples, **kw):
    return evaluate_hellaswag(forward, examples, fake_encode, device="cpu", **kw)


def test_render_example_equals_jax():
    data, tokens, mask, label = render_example(EXAMPLE, fake_encode)
    jdata, jtokens, jmask, jlabel = jhs.render_example(EXAMPLE, fake_encode)
    assert data == jdata and label == jlabel == 2
    np.testing.assert_array_equal(tokens, jtokens)
    np.testing.assert_array_equal(mask, jmask)
    ctx_len = len(data["ctx_tokens"])
    lens = [len(e) for e in data["ending_tokens"]]
    assert tokens.shape == (4, ctx_len + max(lens))
    for i in range(4):
        assert (mask[i, :ctx_len] == 0).all()
        assert (mask[i, ctx_len:ctx_len + lens[i]] == 1).all()
        assert (mask[i, ctx_len + lens[i]:] == 0).all()
    assert data["ending_tokens"][0] == fake_encode(" " + EXAMPLE["endings"][0])


def _const_forward(base: torch.Tensor):
    return lambda tokens: base.expand(*tokens.shape, base.shape[0])


def test_evaluate_prefers_low_loss_ending_and_caps():
    base = torch.zeros(128)
    base[list(set(fake_encode(" " + EXAMPLE["endings"][2])))] = 10.0
    result = _evaluate(_const_forward(base), [EXAMPLE] * 5, limit=4)
    assert result["num_total"] == 4
    assert result["acc"] == result["acc_norm"] == 1.0


def test_sum_vs_mean_argmin_can_differ():
    ex = {"ctx": "c", "label": 0,
          "endings": ["a b c d e f g h", "z", "qq rr ss", "ww vv uu"]}
    long_toks = set(fake_encode(" " + ex["endings"][0]))
    short_toks = set(fake_encode(" " + ex["endings"][1])) - long_toks
    base = torch.full((128,), -20.0)
    base[list(long_toks)] = 9.0
    base[list(short_toks)] = 8.0
    r_sum = _evaluate(_const_forward(base), [dict(ex, label=1)], limit=1)
    r_mean = _evaluate(_const_forward(base), [dict(ex, label=0)], limit=1)
    assert r_sum["acc"] == 1.0 and r_sum["acc_norm"] == 0.0
    assert r_mean["acc"] == 0.0 and r_mean["acc_norm"] == 1.0


def test_log_line_format(tmp_path):
    log = tmp_path / "hs.txt"
    _evaluate(_const_forward(torch.zeros(128)), [EXAMPLE] * 3, limit=2, log_path=str(log))
    parts = log.read_text().split()
    assert parts[0] == "2" and "/" in parts[1] and len(parts[2].split(".")[1]) == 4


TINY = dict(d_model=32, n_layer=2, vocab_size=128, headdim=8, chunk_size=16, d_state=16,
            compute_dtype="float32")
ARCHS = {
    "mamba2": TINY,
    "mamba1": dict(TINY, ssm_layer="mamba1", d_state=8),
    "hybrid": dict(TINY, attn_layer_idx=(1,), attn_num_heads=4, attn_num_kv_heads=2),
}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def pair(request):
    kw = ARCHS[request.param]
    jcfg = JaxConfig(**kw)
    jparams = jlm.init_lm_params(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    cfg = ModelConfig(**kw)
    return (lambda t: jlm.lm_forward(jparams, jcfg, t),
            lambda t: lm_forward(params, cfg, t))


def _examples():
    return [json.loads(line) for line in TINY_FILE.read_text().splitlines()]


def test_row_losses_equal_jax_scores(pair):
    jfwd, fwd = pair
    rendered = [render_example(ex, fake_encode) for ex in _examples()]
    for batch in (rendered[:8], rendered[8:13]):
        pt, pm = hs.pack_batch(batch, 8)
        want_sum, want_avg = jhs._scores_fn(jfwd)(pt, pm)
        got_sum, got_avg = hs.score_rows(fwd, torch.from_numpy(pt).long(),
                                         torch.from_numpy(pm))
        assert got_sum.dtype == got_avg.dtype == torch.float32 and got_sum.shape == (32,)
        assert not got_sum.requires_grad  # scored under inference_mode
        for got, want in ((got_sum, want_sum), (got_avg, want_avg)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max())


def test_counts_and_log_line_equal_jax(pair, tmp_path):
    jfwd, fwd = pair
    want = jhs.evaluate_hellaswag(jfwd, _examples(), fake_encode, limit=13,
                                  log_path=str(tmp_path / "jax.txt"))
    got = _evaluate(fwd, _examples(), limit=13, log_path=str(tmp_path / "port.txt"))
    assert got == want
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()


def test_example_batching_is_equivalent(pair):
    _, fwd = pair
    one = _evaluate(fwd, _examples(), limit=16, example_batch=1)
    assert one == _evaluate(fwd, _examples(), limit=16, example_batch=8)
