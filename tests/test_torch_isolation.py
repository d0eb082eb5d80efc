"""The port stands alone: no module of ``mamba_distributed_tpu_torch/``
and not ``chip_smoke.py`` imports ``jax`` or anything of the JAX package
(checked on the sources with ``ast``, and by importing the port in a
fresh interpreter), and no module-level import of theirs needs a package
that the card machine lacks: only the standard library, ``torch``,
``numpy``, ``scipy``, ``einops``, ``triton`` and the port itself (the JAX
package's tokenizer imports ``regex``, which is not there)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.torch

REPO = Path(__file__).resolve().parents[1]
SOURCES = sorted((REPO / "mamba_distributed_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "mamba_distributed_tpu")
# what the card machine has besides the standard library
CARD_INSTALLS = ("torch", "numpy", "scipy", "einops", "triton", "mamba_distributed_tpu_torch")


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            mods.append(node.module)
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            mods.append(node.args[0].value)
    return mods


def _module_level_imports(path: Path) -> list[str]:
    """Modules imported when ``path`` is imported: its import statements
    outside function bodies (class bodies and module-level if/try blocks
    run at import), relative imports left out (the port itself)."""
    def walk(nodes):
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(node, ast.Import):
                yield from (a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                yield node.module
            yield from walk(ast.iter_child_nodes(node))

    return list(walk(ast.parse(path.read_text(), filename=str(path)).body))


def _outside_card_installs(mod: str) -> bool:
    root = mod.split(".")[0]
    return root not in sys.stdlib_module_names and root not in CARD_INSTALLS


def _forbidden(mod: str) -> bool:
    root = mod.split(".")[0]
    return root in FORBIDDEN


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_module_level_imports_are_on_the_card(path):
    bad = [m for m in _module_level_imports(path) if _outside_card_installs(m)]
    assert not bad, f"{path.name} imports {bad} at module level"


def test_install_rule_catches_the_next_regex(tmp_path):
    assert _outside_card_installs("regex") and _outside_card_installs("tiktoken")
    assert not _outside_card_installs("re") and not _outside_card_installs("unicodedata")
    assert not _outside_card_installs("torch.nn.functional")
    assert not _outside_card_installs("mamba_distributed_tpu_torch.data.gpt2_bpe")
    src = tmp_path / "m.py"
    src.write_text("import os\ntry:\n    import regex\nexcept ImportError:\n    pass\n"
                   "class A:\n    import tiktoken\n"
                   "def f():\n    import yaml\n")
    assert [m for m in _module_level_imports(src) if _outside_card_installs(m)] == [
        "regex", "tiktoken"]


def test_forbidden_rule_tells_the_packages_apart():
    assert _forbidden("jax.numpy") and _forbidden("mamba_distributed_tpu.config")
    assert not _forbidden("mamba_distributed_tpu_torch.config")


def test_port_imports_without_jax_loaded():
    code = (
        "import sys, importlib, pkgutil\n"
        "import mamba_distributed_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'mamba_distributed_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("rel", ["mamba_distributed_tpu_torch/serving/spec_decode.py",
                                 "mamba_distributed_tpu_torch/ops/cuda/norm_kernels.py",
                                 "mamba_distributed_tpu_torch/ops/norm.py",
                                 "chip_smoke.py"])
def test_speculation_and_norm_modules_stand_alone(rel):
    """The speculative decoding and norm-kernel modules, and the chip
    script that drives them, are among the checked sources and import
    neither jax nor the JAX package, at module level or inside a
    function."""
    path = REPO / rel
    assert path in SOURCES
    assert not [m for m in _imported_modules(path) if _forbidden(m)]
    assert not [m for m in _module_level_imports(path) if _outside_card_installs(m)]
