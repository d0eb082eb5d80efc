"""The port's evaluation and generation CLIs, and ``train.py``'s sampling
flags, with ``--device cpu`` on tiny models, the CLIs in subprocesses
(as the JAX ``tests/test_cli.py`` runs its own).

``-m custom`` reads a port checkpoint directory, ``-m hugging_face`` a
directory that ``chip_smoke.hf_state_dict``/``hf_config_json`` wrote;
each CLI's result and log line equal an in-process
``evaluate_hellaswag`` on the same params and tokenizer, and
``generate`` prints the tokens of an in-process ``generate()`` with the
same seed.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
from mamba_distributed_tpu_torch import train as train_cli
from mamba_distributed_tpu_torch.config import ModelConfig, get_preset
from mamba_distributed_tpu_torch.data.gpt2_bpe import GPT2BPE
from mamba_distributed_tpu_torch.eval import __main__ as eval_cli
from mamba_distributed_tpu_torch.eval import evaluate_hellaswag, iterate_examples
from mamba_distributed_tpu_torch.inference.generate import generate
from mamba_distributed_tpu_torch.models.lm import init_lm_params, lm_forward
from mamba_distributed_tpu_torch.training.checkpoint import save_checkpoint
from tests.conftest import make_toy_bpe

pytestmark = pytest.mark.torch

REPO = Path(__file__).resolve().parents[1]
TINY_FILE = str(REPO / "tests" / "data" / "hellaswag_tiny.jsonl")
HYBRID = dict(d_model=64, n_layer=3, headdim=16, d_state=32, chunk_size=32, vocab_size=1000,
              attn_layer_idx=(1,), attn_num_heads=4, attn_num_kv_heads=2)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A toy BPE, a port checkpoint of mamba2-tiny and an HF directory of
    a tiny hybrid."""
    root = tmp_path_factory.mktemp("cli")
    merges = [("t", "h"), ("th", "e"), ("Ġ", "t"), ("Ġ", "a"), ("e", "r"), ("i", "n")]
    bpe = make_toy_bpe(root / "bpe", merges)
    cfg = get_preset("mamba2-tiny")
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))
    save_checkpoint(str(root / "ckpt"), 7, params, {}, {"current_shard": 0,
                                                        "current_position": 0},
                    torch.Generator().get_state())
    hcfg = ModelConfig(**HYBRID)
    hparams = init_lm_params(hcfg, torch.Generator().manual_seed(1))
    (root / "hf").mkdir()
    (root / "hf" / "config.json").write_text(json.dumps(chip_smoke.hf_config_json(hcfg)))
    torch.save(chip_smoke.hf_state_dict(hparams, hcfg), str(root / "hf" / "pytorch_model.bin"))
    return dict(root=root, bpe=bpe, ckpt=str(root / "ckpt"), hf=str(root / "hf"),
                params=params, cfg=cfg, hparams=hparams, hcfg=hcfg)


def _run(module: str, *args, env=None):
    p = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                       env={**os.environ, **(env or {})}, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    return p.stdout


def _in_process(params, cfg, bpe_dir, log_path):
    cfg = dataclasses.replace(cfg, ssm_impl="pallas")
    return evaluate_hellaswag(lambda t: lm_forward(params, cfg, t),
                              iterate_examples(TINY_FILE), GPT2BPE.from_dir(bpe_dir).encode,
                              log_path=log_path, device="cpu")


@pytest.mark.parametrize("source", ["custom", "hugging_face"])
def test_eval_cli_equals_in_process(files, source, tmp_path):
    log = tmp_path / "cli.txt"
    where = (["--checkpoint", files["ckpt"], "--preset", "mamba2-tiny"] if source == "custom"
             else ["--hf-path", files["hf"]])
    out = _run("mamba_distributed_tpu_torch.eval", "-m", source, *where, "--device", "cpu",
               "--data-file", TINY_FILE, "--bpe-dir", files["bpe"], "--log-file", str(log))
    assert f"tokenizer: GPT-2 BPE from {files['bpe']}, merge loop native" in out
    params, cfg = ((files["params"], files["cfg"]) if source == "custom"
                   else (files["hparams"], files["hcfg"]))
    want = _in_process(params, cfg, files["bpe"], str(tmp_path / "in.txt"))
    assert out.strip().splitlines()[-1] == str(want)
    assert log.read_text() == (tmp_path / "in.txt").read_text()
    n, frac, acc = log.read_text().split()
    assert n == "16" and frac == f"{want['num_correct_norm']}/16" and acc == f"{want['acc_norm']:.4f}"


def test_generate_cli_equals_in_process(files):
    out = _run("mamba_distributed_tpu_torch.generate", "--hf-path", files["hf"],
               "--prompt-ids", "5,17,300,2", "--seed", "42", "--num-return", "2",
               "--max-new-tokens", "6", "--device", "cpu")
    want = generate(files["hparams"], dataclasses.replace(files["hcfg"], ssm_impl="pallas"),
                    torch.tensor([[5, 17, 300, 2]] * 2), seed=42, max_new_tokens=6)
    assert out.strip().splitlines() == [f"> tokens {row}" for row in want.tolist()]


def test_generate_cli_prompt_text_from_a_checkpoint(files):
    out = _run("mamba_distributed_tpu_torch.generate", "--checkpoint", files["ckpt"],
               "--preset", "mamba2-tiny", "--prompt", "the cat", "--num-return", "1",
               "--max-new-tokens", "4", "--device", "cpu", env={"GPT2_BPE_DIR": files["bpe"]})
    lines = out.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("> the cat")


def test_custom_checkpoint_preset_mismatch_message(files):
    with pytest.raises(SystemExit, match="checkpoint/preset mismatch: embedding"):
        eval_cli.load_custom(files["ckpt"], "mamba2-280m")
    params, cfg = eval_cli.load_custom(files["ckpt"], "mamba2-tiny", "cpu")
    assert torch.equal(params["embedding"], files["params"]["embedding"])


def test_custom_pt_preset_mismatch_message(files, tmp_path):
    """A reference-style ``.pt`` is held to the preset's embedding shape
    after the import: a short vocab is padded, an oversized one refused."""
    cfg = files["cfg"]
    big = dataclasses.replace(cfg, vocab_size=cfg.vocab_size_padded + 64)
    path = str(tmp_path / "model_00007.pt")
    torch.save({"model": chip_smoke.hf_state_dict(
        init_lm_params(big, torch.Generator().manual_seed(2)), big)}, path)
    with pytest.raises(SystemExit, match="checkpoint/preset mismatch: embedding"):
        eval_cli.load_custom(path, "mamba2-tiny", "cpu")
    short = chip_smoke.hf_state_dict(files["params"], cfg)
    short["backbone.embedding.weight"] = short["backbone.embedding.weight"][:cfg.vocab_size - 3]
    torch.save(short, path)
    params, _ = eval_cli.load_custom(path, "mamba2-tiny", "cpu")
    assert params["embedding"].shape == (cfg.vocab_size_padded, cfg.d_model)
    assert torch.equal(params["embedding"][:cfg.vocab_size - 3],
                       files["params"]["embedding"][:cfg.vocab_size - 3])


def test_entry_points_need_a_card_unless_cpu(files):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="--device cpu"):
        eval_cli.main(["-m", "hugging_face", "--hf-path", files["hf"]])
    from mamba_distributed_tpu_torch import generate as gen_cli

    with pytest.raises(RuntimeError, match="--device cpu"):
        gen_cli.main(["--hf-path", files["hf"], "--prompt-ids", "1,2"])


def test_train_cli_sampling_flags(files, monkeypatch):
    """--sample-prompt-ids and --sample-prompt reach the Trainer's
    sample_prompt_ids/decode_fn."""
    args = train_cli.parse_args(["--sample-prompt-ids", "3,4,5"])
    assert train_cli.resolve_sampling(args) == ([3, 4, 5], None)
    monkeypatch.setenv("GPT2_BPE_DIR", files["bpe"])
    ids, decode = train_cli.resolve_sampling(train_cli.parse_args(["--sample-prompt", "the"]))
    assert decode(ids) == "the" and ids == GPT2BPE.from_dir(files["bpe"]).encode("the")
    assert train_cli.resolve_sampling(train_cli.parse_args([])) == (None, None)
    seen = {}

    class FakeTrainer:
        def __init__(self, cfg, device, sample_prompt_ids, decode_fn):
            seen.update(ids=sample_prompt_ids, decode=decode_fn)

        def run(self, **kw):
            pass

        def finish(self):
            pass

    monkeypatch.setattr("mamba_distributed_tpu_torch.training.Trainer", FakeTrainer)
    train_cli.main(["--preset", "mamba2-tiny", "--device", "cpu", "--sample-prompt", "the"])
    assert seen["ids"] == ids and seen["decode"](ids) == "the"
