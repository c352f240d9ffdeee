"""The kernel build cache (whisperseg_torch/ops/_build.py): a library's name
carries the hash of its source and of every csrc header the source
includes, so editing either rebuilds it. Runs without nvcc: only the
hashing is exercised."""

import os

import pytest

from whisperseg_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    files = {
        "k.cu": '#include <cuda_runtime.h>\n#include "outer.cuh"\nint k;\n',
        "outer.cuh": '#pragma once\n  #  include "inner.cuh"\n',
        "inner.cuh": "#pragma once\nint inner;\n",
        "other.cuh": "int other;\n",
    }
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    return tmp_path


def test_sources_follow_quoted_includes(csrc):
    assert [os.path.basename(p) for p in _build._sources("k")] == \
        ["k.cu", "outer.cuh", "inner.cuh"]


@pytest.mark.parametrize("edited, rebuilds", [
    ("k.cu", True), ("outer.cuh", True), ("inner.cuh", True),
    ("other.cuh", False)])
def test_target_changes_with_every_included_file(csrc, edited, rebuilds):
    before = _build._target("k")
    with open(csrc / edited, "a") as f:
        f.write("// edited\n")
    assert (_build._target("k") != before) == rebuilds


def test_attention_backward_hashes_its_tile_header():
    names = [os.path.basename(p) for p in _build._sources("attention_bwd")]
    assert names == ["attention_bwd.cu", "mma_tiles.cuh"]
