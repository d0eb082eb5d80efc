"""The port's GPT-2 BPE (``data/gpt2_bpe.py``, ``data/native_bpe.py``)
against the JAX package's, on synthetic merge tables.

The port pre-splits with the standard library's ``re`` (letter and
number classes built from ``unicodedata``, ``\\s`` as the Unicode
White_Space property); the JAX package uses the ``regex`` module's
``\\p{L}``/``\\p{N}``/``\\s``.  Held here: the classes over every codepoint
(a codepoint on which they differ must be one that this Python's Unicode
database leaves unassigned: the ``regex`` module may carry a newer Unicode
version), the pre-split and the ids on ASCII, contractions, digit and
whitespace runs and text of many scripts and categories, the native merge
against the Python merge, and the loader's order and messages.
"""

import os
import random
import sys
import unicodedata

import numpy as np
import pytest
import regex

from mamba_distributed_tpu.data import gpt2_bpe as jbpe
from mamba_distributed_tpu_torch.data import gpt2_bpe, native_bpe
from tests.conftest import make_toy_bpe

pytestmark = pytest.mark.torch

# one codepoint of each L*/N* category (Lu Ll Lt Lm Lo Nd Nl No), then
# several scripts, combining marks, symbols, emoji, the separators
# U+001C..U+001F (whitespace to re, not to regex) and unassigned-free
# astral letters and digits
MIXED = ("A a ǅ ʰ 中 ٣ Ⅻ ½ — Ωμέγα Привет مرحبا नमस्ते 한국어 สวัสดี 𝒜𝟙 🙂x "
         "\x1c\x1dfoo\x1e \x1f bar　baz qux   ok")
TEXTS = {
    "ascii": "Hello, I'm a language model, and I like tea.",
    "contractions": "we'll they're it's I've she'd you'll'd 'S 's'",
    "digits": "2024 was 12345678 times 3.14159 or 1,000,000x 42abc",
    "whitespace": "  a  \t\tb\n\n  c   \r\n d    ",
    "mixed": MIXED,
}
ALPHABET = "abcdefgh el'2 "


def _merge_table(seed: int = 7, n: int = 60):
    """A random chain of merges over ``ALPHABET``'s byte symbols."""
    rng = random.Random(seed)
    b2u = gpt2_bpe.bytes_to_unicode()
    pieces = [b2u[ord(c)] for c in ALPHABET]
    merges, seen = [], set()
    for _ in range(n):
        a, b = rng.choice(pieces), rng.choice(pieces)
        if (a, b) not in seen:
            seen.add((a, b))
            merges.append((a, b))
            pieces.append(a + b)
    return merges


@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    return make_toy_bpe(tmp_path_factory.mktemp("bpe") / "bpe", _merge_table())


def _python_only(bpe):
    bpe._native_tried = True  # forces the Python merge loop
    return bpe


def test_bytes_to_unicode_equals_jax():
    assert gpt2_bpe.bytes_to_unicode() == jbpe.bytes_to_unicode()


def test_classes_equal_regex_over_every_codepoint():
    """[\\p{L}], [\\p{N}] and \\s of the port against the regex module's,
    over range(sys.maxunicode + 1)."""
    import re

    L, N = gpt2_bpe.letter_number_classes()
    ours = [re.compile(f"[{L}]"), re.compile(f"[{N}]"), re.compile(f"[{gpt2_bpe._WS}]")]
    theirs = [regex.compile(r"\p{L}"), regex.compile(r"\p{N}"), regex.compile(r"\s")]
    differ = {"L": [], "N": [], "s": []}
    for cp in range(sys.maxunicode + 1):
        c = chr(cp)
        for key, a, b in zip(differ, ours, theirs):
            if bool(a.match(c)) != bool(b.match(c)):
                differ[key].append(cp)
    print(f"codepoints that differ from regex: L {len(differ['L'])}, N {len(differ['N'])}, "
          f"\\s {len(differ['s'])} (Python's Unicode {unicodedata.unidata_version}, "
          f"regex {regex.__version__})")
    assert not differ["s"]
    # every difference is a codepoint this Python's database leaves
    # unassigned (a letter or number of a later Unicode version)
    unexplained = [hex(cp) for cp in differ["L"] + differ["N"]
                   if unicodedata.category(chr(cp)) != "Cn"]
    assert not unexplained, unexplained[:20]


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_presplit_and_ids_equal_jax(bpe_dir, name):
    text = TEXTS[name]
    assert gpt2_bpe.pretokenizer().findall(text) == jbpe._PAT.findall(text)
    want = _python_only(jbpe.GPT2BPE.from_dir(bpe_dir)).encode(text)
    port = gpt2_bpe.GPT2BPE.from_dir(bpe_dir)
    assert port.uses_native == native_bpe.available()
    assert port.encode(text) == want
    assert _python_only(gpt2_bpe.GPT2BPE.from_dir(bpe_dir)).encode(text) == want
    assert port.decode(want) == text


def test_presplit_equals_jax_on_random_text():
    """Random strings over a pool of codepoints of every general category
    split the same way."""
    rng = np.random.default_rng(0)
    pool = [chr(cp) for cp in range(0x20000)
            if unicodedata.category(chr(cp)) not in ("Cn", "Cs")]
    pool += list(" \t\n\r\x0b\x0c\x1c\x1f\x85\xa0 　'sltdm0123456789")
    pat = gpt2_bpe.pretokenizer()
    for _ in range(200):
        s = "".join(pool[i] for i in rng.integers(0, len(pool), rng.integers(1, 40)))
        assert pat.findall(s) == jbpe._PAT.findall(s), repr(s)


def test_native_merge_equals_python_merge(bpe_dir):
    """The C++ id-level merge loop against the Python string-level loop,
    on random strings over the merge table's alphabet."""
    if not native_bpe.available():
        pytest.fail(f"native BPE did not build: {native_bpe.unavailable_reason()}")
    rng = random.Random(11)
    native = gpt2_bpe.GPT2BPE.from_dir(bpe_dir)
    python = _python_only(gpt2_bpe.GPT2BPE.from_dir(bpe_dir))
    assert native._native_table() is not None
    for _ in range(100):
        s = "".join(rng.choice(ALPHABET) for _ in range(rng.randint(1, 60)))
        assert native.encode(s) == python.encode(s), s
        assert native.decode(native.encode(s)) == s


def test_native_bpe_env_disable(bpe_dir, monkeypatch):
    monkeypatch.setenv("MDT_NATIVE_BPE", "0")
    native_bpe._load.cache_clear()
    try:
        assert not native_bpe.available()
        assert native_bpe.unavailable_reason() == "MDT_NATIVE_BPE=0"
        bpe = gpt2_bpe.GPT2BPE.from_dir(bpe_dir)
        assert not bpe.uses_native
        assert bpe.encode("he'll") == jbpe.GPT2BPE.from_dir(bpe_dir).encode("he'll")
    finally:
        native_bpe._load.cache_clear()


def test_hf_filenames_and_oov_decode(tmp_path):
    d = make_toy_bpe(tmp_path / "hf", [("h", "e")])
    os.rename(os.path.join(d, "encoder.json"), os.path.join(d, "vocab.json"))
    os.rename(os.path.join(d, "vocab.bpe"), os.path.join(d, "merges.txt"))
    bpe = gpt2_bpe.GPT2BPE.from_dir(d)
    assert bpe.encode("he") == [bpe.encoder["he"]]
    assert bpe.decode([ord("h"), 99999, ord("i")]) == "h�i"
    assert gpt2_bpe.ENDOFTEXT_ID == jbpe.ENDOFTEXT_ID == 50256


def test_load_encoder_order_and_messages(tmp_path, monkeypatch):
    """``bpe_dir`` before ``$GPT2_BPE_DIR`` before ``./gpt2_bpe``; without
    data (and without tiktoken) a FileNotFoundError names both causes.
    tiktoken is made unimportable: its "gpt2" encoding would be fetched
    from the network."""
    monkeypatch.setitem(sys.modules, "tiktoken", None)
    first = make_toy_bpe(tmp_path / "first", [("a", "b")])
    second = make_toy_bpe(tmp_path / "second", [])
    monkeypatch.setenv("GPT2_BPE_DIR", second)
    encode, decode = gpt2_bpe.load_encoder(first)
    assert encode("ab") == [256] and decode(encode("abc")) == "abc"
    encode, _ = gpt2_bpe.load_encoder()
    assert encode("ab") == [ord("a"), ord("b")]
    monkeypatch.delenv("GPT2_BPE_DIR")
    monkeypatch.chdir(tmp_path)
    make_toy_bpe(tmp_path / "gpt2_bpe", [("a", "b"), ("ab", "c")])
    encode, _ = gpt2_bpe.load_encoder()
    assert encode("abc") == [257]
    monkeypatch.setenv("GPT2_BPE_DIR", str(tmp_path / "nope"))
    with pytest.raises(FileNotFoundError, match="absent"):
        gpt2_bpe.load_encoder()
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="incomplete"):
        gpt2_bpe.load_encoder(str(tmp_path / "empty"))
    (tmp_path / "half").mkdir()
    (tmp_path / "half" / "encoder.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="merges.txt"):
        gpt2_bpe.GPT2BPE.from_dir(str(tmp_path / "half"))
