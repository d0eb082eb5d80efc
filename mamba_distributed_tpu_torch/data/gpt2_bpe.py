"""Zero-egress GPT-2 byte-level BPE tokenizer (counterpart of the JAX
package's ``data/gpt2_bpe.py``).

The *algorithm* (byte -> unicode table, pre-split pattern, ranked-merge
BPE) is here in full; the *data* is the standard OpenAI release pair
every GPT-2 distribution ships, loaded from a local directory:

    <dir>/encoder.json   token -> id map (50257 entries incl. <|endoftext|>)
    <dir>/vocab.bpe      ranked merges, one pair per line (version header)

HF checkpoints carry the same data as ``vocab.json``/``merges.txt``;
both filename conventions are accepted.  Point ``GPT2_BPE_DIR`` (or the
``bpe_dir`` argument) at the directory.

The pre-split pattern is GPT-2's, run by the standard library's ``re``:
its ``\\p{L}``/``\\p{N}`` become character classes built once from the
``unicodedata`` categories ``L*``/``N*``, and ``\\s`` becomes the Unicode
White_Space property (``re``'s own ``\\s`` also matches U+001C..U+001F,
which the ``regex`` module's does not).  The port runs this one path
everywhere; a test holds it to the ``regex`` pattern over every
codepoint.

The merge loop runs natively when ``g++`` is present: the id-level C++
kernel (``data/native/bpe_merge.cc``) is built at first use by
``data/native_bpe.py``; ``MDT_NATIVE_BPE=0`` forces the Python loop,
which gives the same ids.
"""

from __future__ import annotations

import functools
import json
import os
import re
import sys
import unicodedata

from mamba_distributed_tpu_torch.data import native_bpe

ENDOFTEXT = "<|endoftext|>"
ENDOFTEXT_ID = 50256

# the Unicode White_Space property, what \s means in GPT-2's pattern
_WS = "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"


def _class_body(codepoints: list[int]) -> str:
    """A ``re`` character-class body matching exactly the sorted
    ``codepoints``, as ranges of ``\\U`` escapes."""
    parts, i = [], 0
    while i < len(codepoints):
        j = i
        while j + 1 < len(codepoints) and codepoints[j + 1] == codepoints[j] + 1:
            j += 1
        parts.append(f"\\U{codepoints[i]:08x}"
                     + (f"-\\U{codepoints[j]:08x}" if j > i else ""))
        i = j + 1
    return "".join(parts)


@functools.cache
def letter_number_classes() -> tuple[str, str]:
    """The bodies of ``[\\p{L}]`` and ``[\\p{N}]``: every codepoint whose
    ``unicodedata`` category starts with L, resp. N (built once)."""
    letters, numbers = [], []
    for cp in range(sys.maxunicode + 1):
        major = unicodedata.category(chr(cp))[0]
        if major == "L":
            letters.append(cp)
        elif major == "N":
            numbers.append(cp)
    return _class_body(letters), _class_body(numbers)


@functools.cache
def pretokenizer() -> re.Pattern:
    """GPT-2's pre-tokenization pattern (contractions, letter runs,
    number runs, punctuation runs, trailing-space handling)."""
    L, N = letter_number_classes()
    return re.compile(
        rf"""'s|'t|'re|'ve|'m|'ll|'d| ?[{L}]+| ?[{N}]+| ?[^{_WS}{L}{N}]+"""
        rf"""|[{_WS}]+(?![^{_WS}])|[{_WS}]+""")


@functools.cache
def bytes_to_unicode() -> dict[int, str]:
    """The reversible byte -> printable-unicode table byte-level BPE uses.

    Printable ASCII + two latin-1 ranges map to themselves; the remaining
    68 bytes map to 256+offset codepoints so every byte has a visible,
    non-whitespace character and merge files stay plain text.
    """
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _find_file(bpe_dir: str, names: tuple[str, ...]) -> str | None:
    for name in names:
        p = os.path.join(bpe_dir, name)
        if os.path.exists(p):
            return p
    return None


class GPT2BPE:
    """Byte-level BPE with GPT-2 semantics over a loaded vocab."""

    def __init__(self, encoder: dict[str, int], merges: list[tuple[str, str]]):
        self.encoder = encoder
        self.decoder = {v: k for k, v in encoder.items()}
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_enc = bytes_to_unicode()
        self.byte_dec = {v: k for k, v in self.byte_enc.items()}
        # the only cache is id-level, keyed by pre-token; _bpe itself is
        # uncached (it runs at most once per distinct pre-token)
        self._id_cache: dict[str, tuple[int, ...]] = {}
        self._native = None
        self._native_tried = False

    def _native_table(self):
        """Lazy id-level merge table on the C++ merge loop
        (data/native_bpe.py); None when the loop did not build or the
        vocab cannot be merged by id (a merge whose parts or result have
        no id, or a byte symbol without one)."""
        if self._native_tried:
            return self._native
        self._native_tried = True
        if not native_bpe.available():
            return None
        triples = []
        for (sa, sb), _rank in sorted(self.ranks.items(), key=lambda kv: kv[1]):
            a, b = self.encoder.get(sa), self.encoder.get(sb)
            c = self.encoder.get(sa + sb)
            if a is None or b is None or c is None:
                return None  # vocab/merge mismatch: stay on the Python path
            triples.append((a, b, c))
        # id-level BPE needs every single-byte symbol to have an id
        if any(s not in self.encoder for s in self.byte_enc.values()):
            return None
        # raw byte -> id, skipping the unicode-symbol detour entirely
        self._byte_ids = [self.encoder[self.byte_enc[b]] for b in range(256)]
        self._native = native_bpe.NativeBpeTable(triples)
        return self._native

    @property
    def uses_native(self) -> bool:
        """Whether ``encode`` merges in C++."""
        return self._native_table() is not None

    @classmethod
    def from_dir(cls, bpe_dir: str) -> "GPT2BPE":
        enc_path = _find_file(bpe_dir, ("encoder.json", "vocab.json"))
        bpe_path = _find_file(bpe_dir, ("vocab.bpe", "merges.txt"))
        if enc_path is None or bpe_path is None:
            raise FileNotFoundError(
                f"GPT-2 BPE data not found in {bpe_dir!r}: need "
                "encoder.json (or vocab.json) + vocab.bpe (or merges.txt); "
                "copy them from any GPT-2 distribution (module docstring)."
            )
        with open(enc_path, encoding="utf-8") as f:
            encoder = json.load(f)
        with open(bpe_path, encoding="utf-8") as f:
            lines = f.read().split("\n")
        # the standard first-line "#version: ..." header is metadata, not a
        # merge (a real merge CAN start with '#', so only line 0 is special)
        if lines and lines[0].startswith("#version"):
            lines = lines[1:]
        merges = []
        for line in lines:
            parts = line.split()
            if len(parts) == 2:
                merges.append((parts[0], parts[1]))
            # blank / malformed lines are skipped
        return cls(encoder, merges)

    def _bpe(self, token: str) -> tuple[str, ...]:
        word = tuple(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            first, second = best
            merged = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        return word

    def encode(self, text: str) -> list[int]:
        native = self._native_table()
        toks = pretokenizer().findall(text)
        cache = self._id_cache
        if native is not None:
            # batch every cache miss of this call into ONE native call
            misses = list({t for t in toks if t not in cache})
            if misses:
                flat: list[int] = []
                offsets = [0]
                byte_ids = self._byte_ids
                for t in misses:
                    flat.extend(byte_ids[b] for b in t.encode("utf-8"))
                    offsets.append(len(flat))
                lens, merged = native.apply_spans(flat, offsets)
                pos = 0
                for t, ln in zip(misses, lens):
                    cache[t] = tuple(merged[pos:pos + ln])
                    pos += ln
        ids: list[int] = []
        for tok in toks:
            cached = cache.get(tok)
            if cached is None:  # pure-Python path (no native table)
                mapped = "".join(self.byte_enc[b] for b in tok.encode("utf-8"))
                cached = tuple(self.encoder[piece] for piece in self._bpe(mapped))
                cache[tok] = cached
            ids.extend(cached)
        return ids

    def decode(self, ids) -> str:
        # ids outside the vocab (e.g. the 50257..50303 padding range a
        # model's padded head can emit) render as U+FFFD instead of raising
        text = "".join(self.decoder.get(int(i), "�") for i in ids)
        data = bytearray()
        for c in text:
            b = self.byte_dec.get(c)
            if b is None:
                data.extend("�".encode("utf-8"))
            else:
                data.append(b)
        return data.decode("utf-8", errors="replace")


def load_encoder(bpe_dir: str | None = None):
    """Zero-egress (encode, decode) pair.

    Order: ``bpe_dir``, else ``$GPT2_BPE_DIR``, else ``./gpt2_bpe``; then
    tiktoken, only if it is installed and can load its "gpt2" encoding;
    else ``FileNotFoundError`` naming both causes.
    """
    bpe_dir = bpe_dir or os.environ.get("GPT2_BPE_DIR", "gpt2_bpe")
    local_err = None
    if os.path.isdir(bpe_dir):
        try:
            bpe = GPT2BPE.from_dir(bpe_dir)
            return bpe.encode, bpe.decode
        except FileNotFoundError as e:
            # dir exists but lacks the data files: still try tiktoken
            local_err = e
    try:
        import tiktoken

        enc = tiktoken.get_encoding("gpt2")
        return enc.encode, enc.decode
    except Exception as e:  # not installed, or no cached encoding
        raise FileNotFoundError(
            f"no GPT-2 BPE available: local dir {bpe_dir!r} "
            f"{'incomplete (' + str(local_err) + ')' if local_err else 'absent'} "
            f"and tiktoken failed ({type(e).__name__}: {e}). Drop "
            "encoder.json/vocab.bpe (or vocab.json/merges.txt) into "
            f"{bpe_dir!r} — see mamba_distributed_tpu_torch/data/gpt2_bpe.py."
        ) from e
