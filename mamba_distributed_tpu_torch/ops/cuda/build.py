"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each source under ``csrc/`` compiles, at first use, into a shared
library with a plain C interface under ``build/torch_kernels/`` at the
root of the checkout (listed in ``.gitignore``).  The library name
carries a hash of the source, the ``csrc/*.cuh`` headers it includes
and the flags, so an edited source or header is rebuilt and a stale
library is never loaded.  ``build_all`` starts one
``nvcc`` per source, all at once, and waits for them together.

Nothing here runs at import time: the CPU tests import every module of
the port on a host with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
# every kernel source of the port, by library name
SOURCES = {
    "ssd_fwd": CSRC / "ssd_fwd.cu",
    "ssd_bwd": CSRC / "ssd_bwd.cu",
    "ragged_paged_attention": CSRC / "ragged_paged_attention.cu",
    "flash_attention": CSRC / "flash_attention.cu",
    "selective_scan": CSRC / "selective_scan.cu",
    "rms_norm": CSRC / "rms_norm.cu",
}
# launches of every kernel of the port, by kernel: each wrapper adds one
# where it launches its kernel, and nowhere else (a run reads these to
# show that its main path went through the kernels)
LAUNCHES = {"ssd_fwd": 0, "ssd_chunk_states": 0, "ssd_bwd": 0,
            "ragged_decode": 0, "ragged_prefill": 0,
            "ragged_decode_int8": 0, "ragged_prefill_int8": 0,
            "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "m1_scan": 0, "m1_entry_states": 0, "m1_bwd": 0,
            "add_rms_norm": 0, "rms_norm_gated": 0}
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler, or RuntimeError when there is none."""
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.is_file():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from source at first use"
        )
    return found


def source_digest(src: Path) -> str:
    """Hash of a source, the headers it includes from its own directory
    (``#include "x.cuh"``, followed into what they include) and the
    flags: an edited header rebuilds every library that includes it."""
    seen, todo, h = set(), [src], hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(path.name.encode() + b"\0" + text)
        todo += [path.parent / m.decode()
                 for m in re.findall(rb'^\s*#\s*include\s+"([^"]+)"', text, re.M)]
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{source_digest(SOURCES[name])}.so"


def start_nvcc(src: Path, out: Path) -> subprocess.Popen:
    """Start ``nvcc`` compiling ``src`` into the library ``out`` with
    ``NVCC_FLAGS``; its log is the process's stdout."""
    out.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def _start(name: str) -> subprocess.Popen | None:
    out = library_path(name)
    if out.exists():
        return None
    return start_nvcc(SOURCES[name], out.with_suffix(f".{os.getpid()}.tmp"))


def _finish(name: str, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name].name}:\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)
    return log


def build_all(names=None) -> dict[str, str]:
    """Compile every missing library in parallel; returns each source's
    compiler log (``-Xptxas=-v`` prints registers and shared memory)."""
    names = list(SOURCES) if names is None else list(names)
    procs = {n: _start(n) for n in names}
    logs = {}
    for n, proc in procs.items():
        if proc is None:
            log_file = library_path(n).with_suffix(".log")
            logs[n] = log_file.read_text() if log_file.exists() else ""
        else:
            logs[n] = _finish(n, proc)
    return logs


def ptxas_instances(log: str) -> list[tuple[str, int, int]]:
    """(mangled kernel name, registers, spill-store bytes) of every kernel
    instance in an ``nvcc -Xptxas=-v`` log."""
    out = []
    for chunk in log.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        spills = re.search(r"(\d+) bytes spill stores", chunk)
        out.append((name, int(regs.group(1)) if regs else 0,
                    int(spills.group(1)) if spills else 0))
    return out


def hgmma_counts(lib: Path) -> dict[str, int]:
    """HGMMA instructions per kernel in a built library's SASS
    (``cuobjdump -sass``, beside ``nvcc``)."""
    sass = subprocess.run([str(Path(nvcc_path()).with_name("cuobjdump")), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    return {chunk.split("\n", 1)[0].strip(): len(re.findall(r"\bHGMMA\.", chunk))
            for chunk in sass.split("Function : ")[1:]}


def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (building it first if needed)."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
