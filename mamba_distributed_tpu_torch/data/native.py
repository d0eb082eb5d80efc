"""ctypes binding + lazy build for the native C++ shard reader
(counterpart of the JAX package's ``data/native.py``).

``data/native/shard_reader.cc`` compiles, at first use, with ``g++ -O3
-shared -fPIC`` into ``build/torch_native/`` at the root of the checkout
(listed in ``.gitignore``).  The library's name carries a hash of its
source and flags, so an edited source is rebuilt and a stale library is
never loaded; it is compiled to a per-process temporary name and renamed
into place, so concurrent builds never load a half-written library.
``build_library`` does the same for the tokenizer's merge loop
(``data/native_bpe.py``).

``NativeShard`` is an mmap-backed ``.npy`` token shard whose x/y batch
is assembled in one C++ pass.  ``available()`` says whether the reader
built; a failed build warns once and keeps its error
(``unavailable_reason()``), so the loader's ``backend="auto"`` takes the
numpy path and ``backend="native"`` raises with the compiler's message.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import warnings
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
_SRC = SRC_DIR / "shard_reader.cc"


def build_library(src: Path) -> Path:
    """The built library of the C++ source ``src``, compiling it first
    when it is missing; ``RuntimeError`` with the compiler's output when
    the compiler is absent or fails."""
    digest = hashlib.sha1(" ".join(GXX_FLAGS).encode() + src.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {src.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def _load() -> tuple[ctypes.CDLL | None, str | None]:
    """(the library with its C signatures declared, None), or (None, why)."""
    try:
        lib = ctypes.CDLL(str(build_library(_SRC)))
    except (RuntimeError, OSError) as e:
        warnings.warn(f"native shard reader unavailable: {e}")
        return None, str(e)
    lib.shard_open.restype = ctypes.c_void_p
    lib.shard_open.argtypes = [ctypes.c_char_p]
    lib.shard_close.argtypes = [ctypes.c_void_p]
    lib.shard_len.restype = ctypes.c_int64
    lib.shard_len.argtypes = [ctypes.c_void_p]
    lib.shard_fill_batch.restype = ctypes.c_int
    lib.shard_fill_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    return lib, None


def available() -> bool:
    return _load()[0] is not None


def unavailable_reason() -> str | None:
    """Why the reader did not build (None when it did)."""
    return _load()[1]


class NativeShard:
    """mmap-backed token shard; x/y assembly happens in C++."""

    def __init__(self, path: str):
        lib, why = _load()
        if lib is None:
            raise RuntimeError(f"native shard reader unavailable: {why}")
        self._lib = lib
        self._handle = lib.shard_open(path.encode())
        if not self._handle:
            raise OSError(f"cannot open npy shard: {path}")
        self.path = path

    def __len__(self) -> int:
        return int(self._lib.shard_len(self._handle))

    def fill_batch(self, pos: int, B: int, T: int):
        """tokens[pos : pos+B*T(+1)] -> x, y of shape (B, T) int32."""
        x = np.empty(B * T, np.int32)
        y = np.empty(B * T, np.int32)
        rc = self._lib.shard_fill_batch(
            self._handle, pos, B * T,
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if rc != 0:
            raise IndexError(
                f"batch window [{pos}, {pos + B * T + 1}) out of range "
                f"for shard of {len(self)} tokens"
            )
        return x.reshape(B, T), y.reshape(B, T)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.shard_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
