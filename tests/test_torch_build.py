"""The build cache of the port's CUDA sources (``ops/cuda/build.py``): a
library's name carries a hash of its source, of the ``csrc/*.cuh``
headers the source includes and of the flags, so an edited header
rebuilds every library that includes it and no other.  Plain Python over
a temporary copy of ``csrc/``; no ``nvcc`` is needed."""

from __future__ import annotations

import re
import shutil

import pytest

from mamba_distributed_tpu_torch.ops.cuda import build

pytestmark = pytest.mark.torch

HEADER = "hopper.cuh"
INCLUDERS = ("flash_attention", "ragged_paged_attention", "ssd_fwd", "ssd_bwd")


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that ``build.SOURCES`` points into."""
    dst = tmp_path / "csrc"
    shutil.copytree(build.CSRC, dst)
    for name, src in build.SOURCES.items():
        monkeypatch.setitem(build.SOURCES, name, dst / src.name)
    return dst


def test_the_copy_names_the_same_libraries(csrc_copy):
    """The hash reads contents, not paths: the copy's libraries are the
    checkout's."""
    for name, src in build.SOURCES.items():
        assert build.source_digest(src) == build.source_digest(build.CSRC / src.name)


def test_the_shared_header_is_included_where_it_is_used():
    for name in INCLUDERS:
        assert f'#include "{HEADER}"' in build.SOURCES[name].read_text()


@pytest.mark.parametrize("name", INCLUDERS)
def test_an_edited_header_changes_the_library_path(csrc_copy, name):
    before = {n: build.library_path(n) for n in build.SOURCES}
    header = csrc_copy / HEADER
    header.write_text(header.read_text() + "\n// an edit\n")
    after = {n: build.library_path(n) for n in build.SOURCES}
    assert after[name] != before[name]
    # sources that do not include the header keep their libraries
    for other in set(build.SOURCES) - set(INCLUDERS):
        assert after[other] == before[other]


def test_a_header_included_by_a_header_is_followed(csrc_copy):
    header = csrc_copy / HEADER
    (csrc_copy / "inner.cuh").write_text("#pragma once\n")
    header.write_text('#include "inner.cuh"\n' + header.read_text())
    before = build.library_path("flash_attention")
    (csrc_copy / "inner.cuh").write_text("#pragma once\n// an edit\n")
    assert build.library_path("flash_attention") != before


def test_an_edited_source_changes_only_its_library(csrc_copy):
    before = {n: build.library_path(n) for n in build.SOURCES}
    src = build.SOURCES["ssd_fwd"]
    src.write_text(src.read_text() + "\n// an edit\n")
    after = {n: build.library_path(n) for n in build.SOURCES}
    assert [n for n in build.SOURCES if after[n] != before[n]] == ["ssd_fwd"]


def test_every_source_and_header_is_hashed_into_a_library():
    """Each ``.cu`` under ``csrc/`` is a library's source and each ``.cuh``
    is included by one, so that no edited kernel file can leave a stale
    library in place."""
    sources = {src.name for src in build.SOURCES.values()}
    headers = set()
    for src in build.SOURCES.values():
        headers |= set(re.findall(r'^\s*#\s*include\s+"([^"]+)"', src.read_text(), re.M))
    for path in build.CSRC.iterdir():
        if path.suffix == ".cu":
            assert path.name in sources, f"{path.name} is not built"
        elif path.suffix == ".cuh":
            assert path.name in headers, f"{path.name} is included by no source"


@pytest.mark.parametrize("name", sorted(build.SOURCES))
def test_an_edit_of_any_source_changes_its_library(csrc_copy, name):
    before = build.library_path(name)
    src = build.SOURCES[name]
    src.write_text(src.read_text() + "\n// an edit\n")
    assert build.library_path(name) != before
