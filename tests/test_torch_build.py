"""The port's kernel build (tony_tpu_torch/ops/_build.py) on the CPU: what
the library's name hashes, and that the sources' includes resolve inside
``csrc/``. Nothing here runs nvcc."""

import re
import shutil

import pytest

from tony_tpu_torch.ops import _build

INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of csrc/'s sources and headers, and _build pointed at it."""
    for f in list(_build.CSRC.glob("*.cu")) + list(_build.CSRC.glob("*.cuh")):
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return tmp_path


@pytest.mark.parametrize("name", ["flash_attention", "grouped_mm", "fused_ce", "quant_mm",
                                  "overlap"])
def test_header_edit_changes_library_name(csrc_copy, name):
    """An edit to a header the source includes gives the library another
    name, so a stale build is never loaded; an unchanged tree keeps it."""
    before = _build.library_path(name)
    assert before == _build.library_path(name)
    assert before.parent == csrc_copy / "build"
    header = csrc_copy / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path(name).name != before.name


def test_includes_name_files_in_csrc():
    """Every ``#include "..."`` of a csrc/*.cu source names a file in
    csrc/, and the five wgmma sources share sm90.cuh."""
    included = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for inc in INCLUDE.findall(src.read_text()):
            assert (_build.CSRC / inc).is_file(), f"{src.name} includes missing {inc}"
            included.setdefault(inc, set()).add(src.name)
    assert included.get("sm90.cuh") == {"flash_attention.cu", "grouped_mm.cu", "fused_ce.cu",
                                        "quant_mm.cu", "overlap.cu"}
