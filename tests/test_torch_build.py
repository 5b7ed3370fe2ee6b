"""The kernel build's cache key (vaw_torch/ops/_build.py): a library is
named by its source and every shared header under csrc/, so an edit to a
header rebuilds each kernel that may include it. Runs on the CPU: it only
hashes files, nothing is compiled."""

from __future__ import annotations

import shutil

from vaw_torch.ops import _build


def test_library_path_follows_sources_and_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert sorted(p.name for p in csrc.glob("*.cuh")) == ["flash_common.cuh"]
    before = {name: _build.library_path(name) for name in _build.KERNEL_SOURCES}
    assert before == {name: _build.library_path(name) for name in _build.KERNEL_SOURCES}

    header = csrc / "flash_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.KERNEL_SOURCES}
    assert all(after[n] != before[n] for n in _build.KERNEL_SOURCES)

    source = csrc / "flash_fwd.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    again = {name: _build.library_path(name) for name in _build.KERNEL_SOURCES}
    assert again["flash_fwd"] != after["flash_fwd"]
    assert again["flash_bwd"] == after["flash_bwd"]


def test_every_kernel_source_is_built():
    sources = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert sources == set(_build.KERNEL_SOURCES)
    assert {"flash_fwd", "flash_bwd"} <= sources
