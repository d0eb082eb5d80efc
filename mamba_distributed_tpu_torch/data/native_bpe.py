"""ctypes binding + lazy build for the native BPE merge loop
(counterpart of the JAX package's ``data/native_bpe.py``).

``data/native/bpe_merge.cc`` is built at first use the way the shard
reader is (``native.build_library``: ``g++ -O3 -shared -fPIC`` into
``build/torch_native/``, a temporary name renamed into place).
``available()`` gates the tokenizer's native path: with
``MDT_NATIVE_BPE=0``, or when the build fails (a warning, and the error
kept in ``unavailable_reason()``), ``GPT2BPE`` runs the pure-Python
merge, which gives the same ids.
"""

from __future__ import annotations

import ctypes
import functools
import os
import warnings

from mamba_distributed_tpu_torch.data.native import SRC_DIR, build_library

_SRC = SRC_DIR / "bpe_merge.cc"


@functools.cache
def _load() -> tuple[ctypes.CDLL | None, str | None]:
    """(the library with its C signatures declared, None), or (None, why)."""
    if os.environ.get("MDT_NATIVE_BPE") == "0":
        return None, "MDT_NATIVE_BPE=0"
    try:
        lib = ctypes.CDLL(str(build_library(_SRC)))
    except (RuntimeError, OSError) as e:
        warnings.warn(f"native BPE unavailable: {e}")
        return None, str(e)
    lib.bpe_table_new.restype = ctypes.c_void_p
    lib.bpe_table_new.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
    ]
    lib.bpe_table_free.argtypes = [ctypes.c_void_p]
    lib.bpe_apply.restype = ctypes.c_int32
    lib.bpe_apply.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
    ]
    lib.bpe_apply_spans.restype = ctypes.c_int32
    lib.bpe_apply_spans.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib, None


def available() -> bool:
    return _load()[0] is not None


def unavailable_reason() -> str | None:
    """Why the merge loop is not native (None when it is)."""
    return _load()[1]


class NativeBpeTable:
    """Owns a C-side (a, b) -> (rank, merged) table."""

    def __init__(self, triples: list[tuple[int, int, int]]):
        lib, why = _load()
        if lib is None:
            raise RuntimeError(f"native BPE unavailable: {why}")
        self._lib = lib
        n = len(triples)
        Arr = ctypes.c_int32 * n
        a = Arr(*(t[0] for t in triples))
        b = Arr(*(t[1] for t in triples))
        c = Arr(*(t[2] for t in triples))
        self._handle = lib.bpe_table_new(a, b, c, n)

    def apply(self, ids: list[int]) -> list[int]:
        n = len(ids)
        buf = (ctypes.c_int32 * n)(*ids)
        out_n = self._lib.bpe_apply(self._handle, buf, n)
        return buf[:out_n]

    def apply_spans(self, flat: list[int], offsets: list[int]):
        """Merge many concatenated spans in ONE native call.

        flat = span0 + span1 + ...; offsets has len(spans)+1 entries.
        Returns (per-span merged lengths, compacted merged ids).
        """
        n_spans = len(offsets) - 1
        buf = (ctypes.c_int32 * len(flat))(*flat)
        offs = (ctypes.c_int32 * len(offsets))(*offsets)
        lens = (ctypes.c_int32 * n_spans)()
        total = self._lib.bpe_apply_spans(self._handle, buf, offs, n_spans, lens)
        return lens[:n_spans], buf[:total]

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.bpe_table_free(handle)
            self._handle = None
